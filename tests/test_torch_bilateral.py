"""PyTorch port: guide smoothing and the joint bilateral filter against the
JAX package (ops/bilateral.py) on the CPU.

Tolerances.  XLA on the CPU contracts a*b+c into FMAs and its exp differs
from PyTorch's in the last ulp on ~10% of inputs, so f32 results are not
bitwise equal:
  * guide (u8 after round-half-even): equal on >= 99.9% of values, off by at
    most 1 elsewhere;
  * JBF on the same guide: within 1e-3 mm on >= 99.9% of pixels and within
    2e-3 mm (8 f32 ulps at 2.3 m) everywhere.
XLA on the CPU also flushes subnormal results to zero, where PyTorch (and the
CUDA kernel, built without -ftz) keep them.  Without the colour term, a
depth-edge pixel can see only subnormal pass-2 weights: the JAX package then
outputs 0 (no support) and the port the weighted mean.  That case runs with
PyTorch's CPU flush-denormal mode on, single-threaded (the mode is per
thread), to compare like with like.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import JBFParams
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import bilateral as jbil
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import bilateral as tbil
from kinectdepthmapenhancement_tpu_torch.ops import cuda_bilateral

torch.set_num_threads(2)


def _scene(seed, h=96, w=128):
    color, noisy, _ = make_noisy_scene(h, w, default_kinect_intrinsics(w, h), seed=seed)
    return color, noisy


def _jbf_kw(p):
    return dict(
        window=p.window, spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma, depth_sigma=p.depth_sigma,
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_guide_matches_jax(seed):
    color, _ = _scene(seed)
    jp = JBFParams()
    want = np.asarray(jbil.guide_bilateral(jnp.asarray(color), jp)).astype(np.int32)
    got = tbil.guide_bilateral(torch.from_numpy(color)[None], convert.config_from_jax(jp))
    got = got[0].numpy().astype(np.int32)
    assert (got == want).mean() >= 0.999
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize(
    "params",
    [JBFParams(), JBFParams(color_sigma=0.0), JBFParams(depth_sigma=0.0, window=7)],
    ids=["default", "no_color_term", "no_depth_term_w7"],
)
def test_jbf_matches_jax_on_same_guide(params):
    color, noisy = _scene(0)
    guide = np.asarray(jbil.guide_bilateral(jnp.asarray(color), params)).astype(np.float32)
    want = np.asarray(jbil._jbf_core(jnp.asarray(noisy), jnp.asarray(guide), **_jbf_kw(params)))
    flush = params.color_sigma == 0.0
    threads = torch.get_num_threads()
    if flush:
        torch.set_num_threads(1)
        torch.set_flush_denormal(True)
    try:
        got = tbil._jbf_core(
            torch.from_numpy(noisy)[None], torch.from_numpy(guide)[None], **_jbf_kw(params)
        )[0].numpy()
    finally:
        if flush:
            torch.set_flush_denormal(False)
            torch.set_num_threads(threads)
    d = np.abs(got - want)
    assert (d <= 1e-3).mean() >= 0.999
    assert d.max() <= 2e-3
    assert ((got == 0.0) == (want == 0.0)).all()  # the no-support zeros agree exactly


def test_joint_bilateral_filter_batched_equals_per_frame():
    """The batch dimension is written out: a batch of two scenes gives
    exactly the per-frame results."""
    scenes = [_scene(0), _scene(3)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes]))
    depth = torch.from_numpy(np.stack([s[1] for s in scenes]))
    p = JBFParams()
    both = tbil.joint_bilateral_filter(depth, color, p)
    for i in range(2):
        one = tbil.joint_bilateral_filter(depth[i : i + 1], color[i : i + 1], p)
        assert torch.equal(both[i : i + 1], one)


def test_jbf_wrapper_takes_plain_version_on_cpu():
    color, noisy = _scene(3, 48, 64)
    p = JBFParams()
    guide = tbil.guide_bilateral(torch.from_numpy(color)[None], p).float()
    before = cuda_bilateral.launches
    got = cuda_bilateral.jbf(torch.from_numpy(noisy)[None], guide, **_jbf_kw(p))
    want = cuda_bilateral.jbf_plain(torch.from_numpy(noisy)[None], guide, **_jbf_kw(p))
    assert cuda_bilateral.launches == before
    assert torch.equal(got, want)
