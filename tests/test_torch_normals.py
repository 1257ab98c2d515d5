"""PyTorch port: CM normals (depth-change map, chamfer DT, covariance sweep,
eigensolver, rest-normal fill) against the JAX package (ops/normals.py) on
the CPU.

Tolerances:
  * depth-change map and chamfer DT: bitwise (integer tests; min-plus is
    exact and order-free in f32);
  * covariance count: exact; entries: |d| <= 2e-6 x the pixel's largest
    entry magnitude (each entry is s2 - s1^2/n, an f32 cancellation, and XLA
    contracts the products into FMAs — measured 5.9e-7);
  * normals: validity flags equal, and |n.n'| > 0.9999 on >= 99.9% of the
    pixels valid on both sides (pixels where both sides are the zero vector
    agree by construction, as in tests/test_oracle_pipeline.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu.core.config import NormalParams
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import normals as jn
from kinectdepthmapenhancement_tpu.ops import pallas_cov
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import cuda_cov, cuda_dt
from kinectdepthmapenhancement_tpu_torch.ops import normals as tn

torch.set_num_threads(2)

# the JAX side's XLA routes (the Pallas routes are what the port's kernels
# replace; interpret mode is used only for the covariance entries below)
JP = NormalParams(cov_impl="xla", dt_impl="xla")


def _t(a):
    return torch.tensor(np.asarray(a))[None]


@pytest.fixture(scope="module")
def scene():
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    _, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    points = np.asarray(projective_to_real(jnp.asarray(noisy), intr))
    vm = points / 1000.0
    return dict(points=points, vm=vm)


def _normals_agree(got, want, frac=0.999):
    gv, wv = (got != -1.0).any(-1), (want != -1.0).any(-1)
    assert (gv == wv).all()
    both_zero = (np.linalg.norm(got, axis=-1) < 1e-6) & (np.linalg.norm(want, axis=-1) < 1e-6)
    ok = both_zero | (np.abs(np.sum(got * want, axis=-1)) > 0.9999)
    assert ok[gv & wv].mean() >= frac


def test_dci_and_smoothing_map_exact(scene):
    vm = scene["vm"]
    want = np.asarray(jn.dci_map(jnp.asarray(vm), JP.max_depth_change_factor))
    got = tn.dci_map(_t(vm), JP.max_depth_change_factor)[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    sm_want = np.asarray(jn.smoothing_map(jnp.asarray(vm), JP))
    sm_got = tn.smoothing_map(_t(vm), convert.config_from_jax(JP))[0].numpy()
    np.testing.assert_array_equal(sm_got, sm_want)


@pytest.mark.parametrize("source", ["scene", "random"])
def test_distance_transform_bitwise(scene, source):
    if source == "scene":
        dci = np.asarray(jn.dci_map(jnp.asarray(scene["vm"]), 0.05))
        iters = 26
    else:  # sparse zeros: distances exceed the horizon, and two chunks of rounds
        rng = np.random.default_rng(2)
        dci = np.where(rng.random((40, 70)) < 0.004, 0, 255).astype(np.int32)
        iters = 30
    want = np.asarray(jn.distance_transform(jnp.asarray(dci), iters))
    got = cuda_dt.distance_transform(_t(dci), iters)[0].numpy()
    assert got.tobytes() == want.tobytes()


def test_cov_count_exact_entries_close(scene):
    """Against the JAX package's covariance kernel (pallas_cov, interpret
    mode) on a 48x64 crop, which tests/test_pallas.py holds against the XLA
    sweep."""
    vm = scene["vm"]
    sm = np.asarray(jn.smoothing_map(jnp.asarray(vm), JP))
    v = np.ascontiguousarray(vm[24:72, 32:96]).astype(np.float32)
    rect = sm[24:72, 32:96].astype(np.int32)
    jc, je = pallas_cov._cm_covariances_batched(
        jnp.asarray(v)[None], jnp.asarray(rect)[None], tile=48, interpret=True
    )
    jc, je = np.asarray(jc)[0], np.asarray(je)[0]
    tc, te = cuda_cov.cm_covariances(_t(v), _t(rect))
    tc, te = tc[0].numpy(), te[0].numpy()
    np.testing.assert_array_equal(tc, jc)
    scale = np.abs(je).max(-1, keepdims=True)
    assert (np.abs(te - je) <= 2e-6 * scale).all()


def test_cm_normals_match_jax(scene):
    vm = scene["vm"]
    sm = np.asarray(jn.smoothing_map(jnp.asarray(vm), JP))
    want = np.asarray(jn.cm_normals(jnp.asarray(vm), jnp.asarray(sm), 20, cov_impl="xla"))
    got = tn.cm_normals(_t(vm), _t(sm), 20)[0].numpy()
    _normals_agree(got, want)


def test_generate_normal_map_matches_jax(scene):
    points = scene["points"]
    want = np.asarray(jn.generate_normal_map(jnp.asarray(points), JP))
    got = tn.generate_normal_map(_t(points), convert.config_from_jax(JP))[0].numpy()
    _normals_agree(got, want)


def test_smallest_eigenvector_matches_jax():
    """Random symmetric PSD 3x3 covariances, plus degenerate (rank-1, zero)
    ones: eigenvalue within 1e-5 of the largest entry, |v.v'| > 0.9999 where
    the smallest eigenvalue is simple."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    a[:, 2] *= rng.uniform(0.01, 1.0, (500, 1)).astype(np.float32)
    cov = np.einsum("nij,nkj->nik", a, a).astype(np.float32)
    cov[0] = 0.0
    cov[1] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    jval, jvec = (np.asarray(x) for x in jn.smallest_eigenvector(jnp.asarray(cov)))
    tval, tvec = (x.numpy() for x in tn.smallest_eigenvector(torch.from_numpy(cov)))
    scale = np.abs(cov).reshape(-1, 9).max(-1)
    assert (np.abs(tval - jval) <= 1e-5 * np.maximum(scale, 1.0)).all()
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    simple = (ev[:, 1] - ev[:, 0]) > 1e-2 * np.maximum(ev[:, 2], 1e-12)
    dots = np.abs(np.sum(tvec * jvec, axis=-1))
    assert (dots[simple] > 0.9999).all()


def test_unported_methods_raise(scene):
    for method in ("sdc", "bilateral"):
        with pytest.raises(NotImplementedError):
            tn.generate_normal_map(_t(scene["points"]), convert.config_from_jax(
                NormalParams(method=method)))
