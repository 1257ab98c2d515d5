"""PyTorch port: edge-refined superpixels (ops/ers.py) against the JAX
package and the NumPy oracle on the CPU.

Bars:
  * edge_refine: labels EXACT and depth bitwise against the JAX op and the
    oracle (it only selects and zeroes);
  * depth_enhance against the JAX op, on the labels and refined depth of
    the JAX RGBF / SPDSP runs at 96x128 (tests/golden/
    dasp_jax_96x128_seed0.npz): the same pixels without support (0), the
    rest within rtol 2e-6.  Measured: 5.5e-7 (1.5e-3 mm at ~2.6 m), the
    ulps of XLA's FMA contraction of the weighted sums, which the port does
    not contract; tests/test_ers.py:49-50 hold the JAX op to the f64
    oracle at rtol 2e-3 / 2 mm, which the port also meets here.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.ops import ers as jers
from kinectdepthmapenhancement_tpu_torch.ops import ers as ters
from kinectdepthmapenhancement_tpu_torch.utils import golden

import oracle_ers

torch.set_num_threads(2)

FIXTURE = os.path.join(golden.FIXTURES, "dasp_jax_96x128_seed0.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.fixture(scope="module")
def fixture():
    _, color, noisy = golden.scene_96x128()
    with np.load(FIXTURE) as z:
        arr = {k: z[k] for k in z.files}
    return color, noisy, arr


def _blocky(small_scene, h, w):
    """tests/test_ers.py:_labels_setup: colour / depth label maps whose
    boundaries are 2 px apart."""
    color = small_scene["color"][:h, :w]
    depth = small_scene["depth"][:h, :w].astype(np.float32)
    cl = np.zeros((h, w), np.int32)
    dl = np.zeros((h, w), np.int32)
    cl[:, 20:] = 1
    cl[22:, :] += 2
    dl[:, 22:] = 1
    dl[24:, :] += 2
    return color, depth, cl, dl


@pytest.mark.parametrize("pipeline", ["rgbf", "spdsp"])
def test_edge_refine_exact_against_jax_and_oracle(fixture, pipeline):
    """On the JAX runs' colour and depth SLIC labels at 96x128 (1 and 5
    iterations): the port's labels and depth equal the JAX op's and the
    oracle's, and the JAX pipeline's refined labels."""
    _, noisy, arr = fixture
    cl = arr[f"{pipeline}__color_labels"].astype(np.int32)
    dl = arr[f"{pipeline}__depth_labels"].astype(np.int32)
    got = ters.edge_refine(_t(cl), _t(dl), _t(noisy))
    want = jers.edge_refine(jnp.asarray(cl), jnp.asarray(dl), jnp.asarray(noisy))
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.depth[0].numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.labels[0].numpy(), arr[f"{pipeline}__refined_labels"])
    wl, wd = oracle_ers.edge_refine(cl.astype(np.int64), dl.astype(np.int64),
                                    noisy.astype(np.float64))
    np.testing.assert_array_equal(got.labels[0].numpy(), wl)
    np.testing.assert_array_equal(got.depth[0].numpy(), wd.astype(np.float32))


def test_edge_refine_blocky_and_identity(small_scene):
    """tests/test_ers.py:24-76 on the port: offset boundaries against the
    oracle, uniform labels change nothing, a depth edge 2 px right of the
    colour edge snaps to it."""
    color, depth, cl, dl = _blocky(small_scene, 40, 48)
    got = ters.edge_refine(_t(cl), _t(dl), _t(depth))
    wl, wd = oracle_ers.edge_refine(cl.astype(np.int64), dl.astype(np.int64),
                                    depth.astype(np.float64))
    np.testing.assert_array_equal(got.labels[0].numpy(), wl)
    np.testing.assert_allclose(got.depth[0].numpy(), wd, rtol=1e-6)
    zeros = np.zeros((16, 16), np.int32)
    same = ters.edge_refine(_t(zeros), _t(zeros), _t(depth[:16, :16]))
    np.testing.assert_array_equal(same.labels[0].numpy(), zeros)
    np.testing.assert_array_equal(same.depth[0].numpy(), depth[:16, :16])
    cl = np.zeros((8, 16), np.int32)
    cl[:, 8:] = 1
    dl = np.zeros((8, 16), np.int32)
    dl[:, 10:] = 1
    lab = ters.edge_refine(_t(cl), _t(dl), torch.full((1, 8, 16), 2000.0)).labels[0].numpy()
    assert lab[0, 8] == 1 and lab[0, 9] == 1 and lab[0, 7] == 0 and lab[0, 10] == 1


@pytest.mark.parametrize("pipeline", ["rgbf", "spdsp"])
def test_edge_refined_superpixel_against_jax_pipeline(fixture, pipeline):
    """The whole stage on the JAX runs' SLIC labels: refined labels exact,
    the refined depth as the JAX pipeline's to the module's bar."""
    color, noisy, arr = fixture
    cl = arr[f"{pipeline}__color_labels"].astype(np.int32)
    dl = arr[f"{pipeline}__depth_labels"].astype(np.int32)
    got = ters.edge_refined_superpixel(_t(cl), _t(dl), _t(noisy), _t(color))
    want = arr[f"{pipeline}__refined_depth"]
    np.testing.assert_array_equal(got.labels[0].numpy(), arr[f"{pipeline}__refined_labels"])
    d = got.depth[0].numpy()
    np.testing.assert_array_equal(d > 0.0, want > 0.0)
    np.testing.assert_allclose(d, want, rtol=2e-6, atol=0)


def test_depth_enhance_against_jax_op_and_oracle(small_scene):
    """depth_enhance alone on tests/test_ers.py:33-50's 28x32 input: the
    JAX op to the module's bar, the f64 oracle to test_ers.py's."""
    color, depth, cl, dl = _blocky(small_scene, 28, 32)
    refined = ters.edge_refine(_t(cl), _t(dl), _t(depth))
    got = ters.depth_enhance(refined, _t(color))[0].numpy()
    jr = jers.edge_refine(jnp.asarray(cl), jnp.asarray(dl), jnp.asarray(depth))
    want = np.asarray(jers.depth_enhance(jr, jnp.asarray(color)))
    np.testing.assert_array_equal(got > 0.0, want > 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    oracle = oracle_ers.depth_enhance(refined.depth[0].numpy().astype(np.float64),
                                      refined.labels[0].numpy(), color)
    assert (np.abs(got - oracle) < 1.0).mean() > 0.98
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2.0)


def test_batched_equals_per_frame(fixture):
    """[B, H, W] inputs (the two pipelines' label maps as two frames) give
    each frame's result alone, bitwise."""
    color, noisy, arr = fixture
    cls = [arr[f"{p}__color_labels"].astype(np.int32) for p in ("rgbf", "spdsp")]
    dls = [arr[f"{p}__depth_labels"].astype(np.int32) for p in ("rgbf", "spdsp")]
    both = ters.edge_refined_superpixel(
        torch.from_numpy(np.stack(cls)), torch.from_numpy(np.stack(dls)),
        torch.from_numpy(np.stack([noisy, noisy])), torch.from_numpy(np.stack([color, color])))
    for i in range(2):
        one = ters.edge_refined_superpixel(_t(cls[i]), _t(dls[i]), _t(noisy), _t(color))
        assert torch.equal(both.labels[i], one.labels[0])
        assert torch.equal(both.depth[i], one.depth[0])
