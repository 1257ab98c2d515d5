"""PyTorch port: the SP and DASP SLIC variants (ops/slic.py) against the
NumPy oracle and the JAX package on the CPU.

Bars (tests/test_slic.py:_compare): labels and cluster xy EXACT, rgb
within 1e-4, centres within rtol 1e-4 / 0.05 mm (the oracle sums in f64).
Against the JAX package, with its seeds: labels and xy exact, centres
within rtol 1e-5 / 1e-3 mm (the port sums cell-local, the JAX package on
the CPU by one-hot segment sums).  The colour seed gradient's seeds are
equal.  The capped route (r = 3 after later iterations) and the global one
give equal labels; their tables differ in summation order only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import projective_to_real
from kinectdepthmapenhancement_tpu.core.config import GridParams, SLICParams
from kinectdepthmapenhancement_tpu.ops import slic as js
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

import oracle_slic

torch.set_num_threads(2)

GRID = GridParams(rows=3, cols=4)
TGRID = convert.config_from_jax(GRID)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.fixture(scope="module")
def scene(small_scene):
    """The 48x64 crop tests/test_slic.py:_setup takes, with its points."""
    h, w = 48, 64
    color = small_scene["color"][:h, :w]
    depth = small_scene["depth"][:h, :w]
    points = np.asarray(projective_to_real(jnp.asarray(depth), small_scene["intr"]))
    return color, depth, points.astype(np.float32)


def _segment(color, points, sig, iters, variant, **kw):
    p = convert.config_from_jax(SLICParams(*sig, iters))
    p = dataclasses.replace(p, **kw)
    return ts.segment(_t(color), None if variant == "sp" else _t(points), grid=TGRID,
                      params=p, variant=variant)


def _compare(got, want):
    np.testing.assert_array_equal(got.labels[0].numpy(), want["labels"])
    np.testing.assert_allclose(got.clusters.rgb[0].numpy(), want["rgb"], atol=1e-4)
    np.testing.assert_array_equal(got.clusters.xy[0].numpy(), want["xy"])
    np.testing.assert_allclose(got.clusters.center[0].numpy(), want["center"],
                               rtol=1e-4, atol=0.05)


@pytest.mark.parametrize(
    "variant,sig,iters",
    [("sp", (200.0, 40.0, 0.0, 0.0), 2), ("dasp", (100.0, 20.0, 200.0, 0.0), 2),
     ("dasp", (200.0, 10.0, 0.0, 0.0), 1)],
    ids=["sp", "dasp", "dasp_depth_sigma0"],
)
def test_segment_matches_oracle(scene, variant, sig, iters):
    """tests/test_slic.py:45-79 on the port: SP, DASP, and DASP with
    depth_sigma = 0 (the colour SLIC of RGBF / SPDSP: no -1 labels)."""
    color, depth, points = scene
    want = oracle_slic.slic_segment(
        color, None if variant == "sp" else points, None, 3, 4, *sig, iters, variant)
    got = _segment(color, points, sig, iters, variant)
    _compare(got, want)
    lab = got.labels[0].numpy()
    if sig[2] != 0.0:
        assert np.all(lab[depth < 50.0] == -1)
    else:
        assert np.all(lab >= 0)


@pytest.mark.parametrize("variant,window", [("sp", 16), ("dasp", 4)])
def test_color_seeds_equal_jax(small_scene, variant, window):
    """The colour seed gradient's argmin picks the JAX package's seeds at
    48x64 (SP's window 16 reads the whole-frame gradient, DASP's window 4
    the sub-grid) and at 96x128 (both on the sub-grid)."""
    for h, w in ((48, 64), (96, 128)):
        cf = small_scene["color"][:h, :w].astype(np.float32)
        assert ts._subgrid_ok(TGRID, h, w, window) == (variant == "dasp" or h == 96)
        want = np.asarray(js._compute_seeds(jnp.asarray(cf), None, GRID, h, w, window, variant,
                                            grad_impl="xla"))
        got = ts._compute_seeds(_t(cf), None, TGRID, h, w, window)[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "sig,capped", [((200.0, 10.0, 0.0, 0.0), False), ((0.0, 10.0, 200.0, 0.0), True)],
    ids=["color_slic", "depth_slic"])
def test_dasp_five_iterations_routes(scene, sig, capped):
    """SPDSP / TOF's 5-iteration DASP against the global route ("global")
    and the JAX package's segment (its global route on the CPU): labels and
    xy exactly, rgb within 1e-3, centres within rtol 1e-5 / 1e-3 mm
    (tests/test_slic.py:179-217's bars).  The depth SLIC's labels stay
    within the cap of 3, so "auto" and "cell" take the capped route (each
    later update cell-local at r = 3); the colour SLIC's (spatial sigma 10
    of 210) leave it, so "auto" falls back to the global index."""
    color, _, points = scene
    base = _segment(color, points, sig, 5, "dasp", locality="global")
    jres = js.segment(jnp.asarray(color), jnp.asarray(points), None, grid=GRID,
                      params=SLICParams(*sig, 5), variant="dasp")
    np.testing.assert_array_equal(base.labels[0].numpy(), np.asarray(jres.labels))
    np.testing.assert_array_equal(base.clusters.xy[0].numpy(), np.asarray(jres.clusters.xy))
    np.testing.assert_allclose(base.clusters.center[0].numpy(),
                               np.asarray(jres.clusters.center), rtol=1e-5, atol=1e-3)
    assert bool(ts.labels_within_cap(base.labels, TGRID, 3, 48, 64).all()) == capped
    for locality in ("auto", "cell") if capped else ("auto",):
        fast = _segment(color, points, sig, 5, "dasp", locality=locality)
        np.testing.assert_array_equal(fast.labels.numpy(), base.labels.numpy())
        np.testing.assert_array_equal(fast.clusters.xy.numpy(), base.clusters.xy.numpy())
        np.testing.assert_allclose(fast.clusters.rgb.numpy(), base.clusters.rgb.numpy(),
                                   atol=1e-3)
        np.testing.assert_allclose(fast.clusters.center.numpy(),
                                   base.clusters.center.numpy(), rtol=1e-5, atol=1e-3)


def test_dasp_label_index_takes_the_variant_cap(scene):
    """After later iterations a DASP update takes the cell index at the
    variant's cap, r = 3 (NASP's is 5); a label outside the cap sends it to
    the global index; an unknown variant raises."""
    color, _, points = scene
    p = convert.config_from_jax(SLICParams(0.0, 10.0, 200.0, 0.0, 5))
    lab = _segment(color, points, (0.0, 10.0, 200.0, 0.0), 5, "dasp").labels
    idx = ts.label_index(lab, TGRID, p, "dasp")
    assert isinstance(idx, ts._CellIndex) and idx.r == 3
    assert ts.label_index(lab, TGRID, p, "nasp").r == 5
    far = lab.clone()
    far[0, :8, :8] = 3  # cell (0, 0) claims cluster (0, 3): dx = 3 > cap - 1
    assert isinstance(ts.label_index(far, TGRID, p, "dasp"), ts._GlobalIndex)
    with pytest.raises(ValueError):
        ts.label_index(lab, TGRID, p, "bogus")


def test_batched_segment_equals_per_frame(small_scene):
    """[B, H, W] frames segment as each frame alone (two crops of the
    scene, 5-iteration depth SLIC: per-frame cap checks, batched sweeps)."""
    intr = small_scene["intr"]
    pts = np.asarray(projective_to_real(jnp.asarray(small_scene["depth"]), intr), np.float32)
    crops = [(slice(0, 48), slice(0, 64)), (slice(48, 96), slice(64, 128))]
    colors = [small_scene["color"][c] for c in crops]
    points = [pts[c] for c in crops]
    p = convert.config_from_jax(SLICParams(0.0, 10.0, 200.0, 0.0, 5))
    both = ts.segment(torch.from_numpy(np.stack(colors)), torch.from_numpy(np.stack(points)),
                      grid=TGRID, params=p, variant="dasp")
    for i in range(2):
        one = ts.segment(_t(colors[i]), _t(points[i]), grid=TGRID, params=p, variant="dasp")
        np.testing.assert_array_equal(both.labels[i].numpy(), one.labels[0].numpy())
        np.testing.assert_array_equal(both.clusters.xy[i].numpy(), one.clusters.xy[0].numpy())
