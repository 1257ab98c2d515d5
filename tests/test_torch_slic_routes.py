"""PyTorch port: the global and capped NASP routes (later iterations, grids
that do not divide the frame) on the CPU at 96x128.  Every later iteration
assigns by the global sweep; the routes differ in the update's index
(cell-local at r = 5 on the capped route, global otherwise).

Tolerances:
  * labels_within_cap: EQUAL to the JAX function's answer;
  * the capped route against the global route over 3 iterations: labels and
    cluster xy / size EXACT, rgb atol 1e-3, centres rtol 1e-5 / atol 1e-3,
    normals rtol 1e-5 / atol 1e-5 — the tolerances of the JAX package's own
    route test (tests/test_slic.py:179-212), sums differing in order only;
    the last sweep's distances rtol 1e-5 / atol 1e-2 (to cluster tables
    summed in two orders: the centres' 1e-3 mm through the distance);
  * the global index against the cell index on cell-local labels: gathers
    and counts EXACT, segment sums rtol 1e-6, pair existence EXACT.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.ops import slic as js
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, normals
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
NASP = KDEConfig().nasp


@pytest.fixture(scope="module")
def frame():
    """The port's own JBF points and CM normals of the 96x128 scene."""
    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=0)
    cfg = KDEConfig()
    c = torch.from_numpy(color)[None]
    points = projective_to_real(
        bilateral.joint_bilateral_filter(torch.from_numpy(noisy)[None], c, cfg.jbf), intr)
    return c, points, normals.generate_normal_map(points, cfg.normals)


def _segment(frame, grid=GRID, **kw):
    return ts.segment(*frame, grid=grid, params=dataclasses.replace(NASP, **kw))


def _clusters_close(got, want):
    assert torch.equal(got.xy, want.xy) and torch.equal(got.size, want.size)
    np.testing.assert_allclose(got.rgb.numpy(), want.rgb.numpy(), atol=1e-3)
    np.testing.assert_allclose(got.center.numpy(), want.center.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.normal.numpy(), want.normal.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def global_3(frame):
    """Three iterations on the global route, by stats route."""
    return {impl: _segment(frame, iterations=3, locality="global", stats_impl=impl)
            for impl in ("auto", "xla")}


@pytest.mark.parametrize("locality, stats_impl", [("auto", "auto"), ("cell", "auto"),
                                                  ("auto", "xla")])
def test_capped_route_matches_global_3_iterations(frame, global_3, locality, stats_impl):
    """Iterations 2-3 on the capped route (r = 5 cell sums) against the
    global route (one-hot sums)."""
    want = global_3[stats_impl]
    got = _segment(frame, iterations=3, locality=locality, stats_impl=stats_impl)
    assert torch.equal(got.labels, want.labels)
    # the last sweep's distances are to cluster tables summed in two orders
    np.testing.assert_allclose(got.distance.numpy(), want.distance.numpy(), rtol=1e-5, atol=1e-2)
    _clusters_close(got.clusters, want.clusters)
    # the later iterations move labels, so the routes are exercised
    assert (_segment(frame).labels != got.labels).any()
    assert bool(ts.labels_within_cap(got.labels, GRID, 5, H, W).all())


def test_capped_fallback_on_drifted_labels(frame):
    """The locality guard (tests/test_slic.py:220): labels_within_cap
    rejects a label state whose block in the last cell claims cluster 0 and
    accepts the grid init, as the JAX function does; a later iteration fed
    labels far off the cap takes the global route ("auto") and equals it."""
    labels = ts.init_labels(GRID, H, W).clone()
    labels[-8:, -8:] = 0  # cell offset (-2, -3) from the last cell
    for lab, cap, want in ((labels, 1, False), (ts.init_labels(GRID, H, W), 1, True),
                           (labels, 3, True)):
        got = bool(ts.labels_within_cap(lab[None], GRID, cap, H, W)[0])
        assert got == want == bool(js.labels_within_cap(jnp.asarray(lab.numpy()), GRID, cap, H, W))
    # the batch answer is per frame; one frame off the cap sends the batch
    # to the global route
    both = torch.stack([ts.init_labels(GRID, H, W), labels])
    assert ts.labels_within_cap(both, GRID, 1, H, W).tolist() == [True, False]
    # a later iteration from a state with a label far outside the cap, on
    # a 12x16 grid (at 3x4 every label lies within the cap of 5)
    grid = GridParams(rows=12, cols=16)
    seg = _segment(frame, grid=grid)
    far = seg.labels.clone()
    far[0, -4:, -4:] = 0
    assert ts._within_cap(seg.labels, grid, 5, H, W) and not ts._within_cap(far, grid, 5, H, W)
    args = (seg.clusters, frame[0].float(), *frame[1:], grid, NASP, 8.0)
    lab_g, _ = ts._assign_global(far, seg.distance, *args)
    assert not ts._within_cap(lab_g, grid, 5, H, W)
    # off the cap the r = 5 cell index drops labels outside its candidates
    cell = ts._CellIndex(lab_g, grid, 5, H, W)
    assert not torch.equal(cell.counts(), ts._GlobalIndex(lab_g, grid.num_clusters).counts())
    assert isinstance(ts.label_index(lab_g, grid, dataclasses.replace(NASP, iterations=2)),
                      ts._GlobalIndex)
    state = (far, seg.distance, seg.clusters, frame[0].float(), *frame[1:])
    out = {
        locality: ts.later_iteration(*state, grid=grid, params=dataclasses.replace(
            NASP, iterations=2, locality=locality))
        for locality in ("auto", "global")
    }
    assert torch.equal(out["auto"][0], lab_g)
    assert torch.equal(out["auto"][0], out["global"][0])
    assert torch.equal(out["auto"][1], out["global"][1])
    _clusters_close(out["auto"][2], out["global"][2])


def test_non_dividing_grid_global_route(frame):
    """A 5x6 grid leaves 96x128 a remainder: the grid init carries ids past
    the grid in the last rows and columns, the first sweep replaces them,
    and the global index serves the updates."""
    grid = GridParams(rows=5, cols=6)
    init = ts.init_labels(grid, H, W)
    assert int(init.max()) >= grid.num_clusters
    seg = _segment(frame, grid=grid)
    assert int(seg.labels.min()) >= -1 and int(seg.labels.max()) < grid.num_clusters
    assert isinstance(ts.cell_index(seg.labels, grid, 8), ts._GlobalIndex)
    assert isinstance(ts.label_index(seg.labels, grid, NASP), ts._GlobalIndex)
    # the kernel and plain stats routes agree: both are plain off the cell route
    other = _segment(frame, grid=grid, stats_impl="xla")
    assert torch.equal(seg.labels, other.labels)
    _clusters_close(seg.clusters, other.clusters)


def test_global_index_matches_cell_index():
    """_GlobalIndex on cell-local labels (invalids, every candidate offset)
    against _CellIndex: the same gathers, counts, sums and pairs."""
    rng = np.random.default_rng(9)
    h, w, rows, cols, r = 48, 64, 3, 4, 4
    cy = np.arange(h)[:, None] // (h // rows)
    cx = np.arange(w)[None, :] // (w // cols)
    ny = np.clip(cy + rng.integers(-r, r, (2, h, w)), 0, rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (2, h, w)), 0, cols - 1)
    labels = (ny * cols + nx).astype(np.int32)
    labels[rng.random((2, h, w)) < 0.07] = -1
    k = rows * cols
    lab = torch.from_numpy(labels)
    cell = ts._CellIndex(lab, GridParams(rows, cols), r, h, w)
    glob = ts._GlobalIndex(lab, k)
    table = torch.from_numpy(rng.normal(size=(2, k, 5)).astype(np.float32) * 1000.0)
    assert torch.equal(glob.gather(table), cell.gather(table))
    feats = torch.from_numpy(rng.normal(size=(2, h, w, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, h, w)) < 0.8)
    np.testing.assert_allclose(glob.segment_sum(feats, mask).numpy(),
                               cell.segment_sum(feats, mask).numpy(), rtol=1e-6, atol=1e-4)
    assert torch.equal(glob.counts(), cell.counts())
    right = torch.cat([lab[:, :, 1:], torch.full((2, h, 1), -1, dtype=torch.int32)], dim=2)
    assert torch.equal(glob.pair_counts(right) > 0, cell.pair_counts(right) > 0)
