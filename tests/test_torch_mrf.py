"""PyTorch port: the MRF baseline (ops/bilateral.py::markov_random_field,
models/pipelines.py::mrf_pipeline) against the JAX package and the NumPy
oracle on the CPU.

Tolerances, and why:
  * against the JAX package: rtol 1e-6 (measured: equal at the default
    MRFParams, whose colour weights are exp(-50 d^2) with integer d^2,
    so 1, exp(-50) or flushed to 0; 2.7e-7 at color_sigma = 0.01, where
    the exp's implementations differ by an ulp);
  * against the oracle (f64): the bar of tests/test_bilateral.py:60-68,
    rtol 1e-4 / atol 0.25 mm;
  * an invalid centre with no valid neighbours stays 0 (test_bilateral.py:71-76);
  * mrf_pipeline on [H, W] equals markov_random_field, and on [B, H, W]
    each frame equals its own call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.config import MRFParams
from kinectdepthmapenhancement_tpu.ops import bilateral as jb
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.ops import bilateral as tb

import oracle

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.mark.parametrize("color_sigma", [50.0, 0.01, 0.0])
def test_mrf_matches_jax(small_scene, color_sigma):
    """color_sigma 0.01 spreads the colour weights over (0, 1]; 0 turns the
    colour term off (the numerator and denominator keep their seeds)."""
    color, depth = small_scene["color"], small_scene["depth"]
    p = MRFParams(color_sigma=color_sigma)
    want = np.asarray(jb.markov_random_field(jnp.asarray(depth), jnp.asarray(color), p))
    got = tb.markov_random_field(_t(depth), _t(color), convert.config_from_jax(p))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if color_sigma == 0.0:
        np.testing.assert_array_equal(got, depth)


def test_mrf_matches_oracle(small_scene):
    color = small_scene["color"][:40, :48]
    depth = small_scene["depth"][:40, :48]
    want = oracle.markov_random_field(depth.astype(np.float64), color)
    got = tb.markov_random_field(_t(depth), _t(color))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.25)


def test_mrf_preserves_invalid_center_zero_neighbors():
    depth = torch.zeros((1, 8, 8))
    color = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert torch.equal(tb.markov_random_field(depth, color), depth)


def test_mrf_pipeline_batching(small_scene):
    color, depth = small_scene["color"], small_scene["depth"]
    one = pipelines.mrf_pipeline(torch.from_numpy(depth), torch.from_numpy(color))
    assert one.shape == depth.shape
    assert torch.equal(one, tb.markov_random_field(_t(depth), _t(color))[0])
    d2 = torch.from_numpy(np.stack([depth, depth[::-1].copy()]))
    c2 = torch.from_numpy(np.stack([color, color[::-1].copy()]))
    both = pipelines.mrf_pipeline(d2, c2)
    assert both.shape == d2.shape
    for i in range(2):
        assert torch.equal(both[i], pipelines.mrf_pipeline(d2[i], c2[i]))
