"""PyTorch port: the KDE quality extensions — the plane-consistency merge
(ccl.merge_planes), the plane hole fill (plane.plane_hole_fill) and their
place in kde_pipeline — on the CPU at 96x128.

Tolerances:
  * merge_planes against the JAX op on the inputs of tests/test_ccl.py:153
    and :201, and on the JAX package's own JBF points and NASP labels of
    the 96x128 scene (tests/golden/torch_stages_96x128_seed0.npz), on the
    port's cell and global routes: merged labels, rep and sizes EXACT,
    cluster_nd rtol = atol = 1e-4, variance rtol 1e-5 / atol 1e-5;
  * plane_hole_fill against the JAX op on a random trust map: labels the
    same, output within 1e-3 mm (the projection's division);
  * the pipeline asserts of tests/test_pipelines.py:160 (hole fill) and
    :214 (two-plane merge) on the port alone, against ground truth, with
    their thresholds.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.ops import ccl as jccl
from kinectdepthmapenhancement_tpu.ops import plane as jplane
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    normalized_rays,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import _plane_depth
from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import ccl as tccl
from kinectdepthmapenhancement_tpu_torch.ops import plane as tplane
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
K = GRID.num_clusters
# jitted once, for one shape: the JAX op's eager dispatch compiles each
# primitive (~7 s)
_jax_merge_planes = jax.jit(functools.partial(jccl.merge_planes, k=K))
STAGES = os.path.join(os.path.dirname(__file__), "golden", "torch_stages_96x128_seed0.npz")


def _planes_input(case):
    """The vertices of tests/test_ccl.py:153 (two planes, seed 3) and :201
    (one plane with 1% holes, seed 7)."""
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    if case == "two_surfaces":
        rng = np.random.default_rng(3)
        za = 2000.0 + 1.5 * u + 0.5 * v
        zb = 3000.0 - 1.0 * u + 0.8 * v
        z = np.where(u < W // 2, za, zb) + rng.normal(0, 1.0, (H, W))
    else:
        rng = np.random.default_rng(7)
        z = 2500.0 + 0.8 * u + 0.6 * v + rng.normal(0, 2.0, (H, W))
    pts = np.stack([u * 4.0 + 0 * v, v * 4.0 + 0 * u, z], -1).astype(np.float32)
    if case == "holes":
        pts[rng.random((H, W)) < 0.01] = 0.0
    return pts


@pytest.mark.parametrize("route", ["cell", "global"])
@pytest.mark.parametrize("case", ["two_surfaces", "holes"])
def test_merge_planes_matches_jax(case, route):
    pts = _planes_input(case)
    labels = ts.init_labels(GRID, H, W)
    got = _merge_both(pts, labels, route)
    if case == "two_surfaces":
        # each half collapses to one component (the merge does happen)
        lab = got.labels[0].numpy()
        assert len(np.unique(lab[:, : W // 2])) == 1 and len(np.unique(lab[:, W // 2:])) == 1
        assert lab[0, 0] != lab[0, -1]
    else:
        # sizes count valid-depth pixels only (JAX ccl.py:405)
        reps = np.unique(got.labels[0].numpy())
        assert got.sizes[0, reps[reps >= 0]].sum() == int((pts[..., 2] > 50.0).sum())


def _merge_both(pts, labels, route):
    """merge_planes of the JAX package and of the port (on `route`) on
    the same points [H, W, 3] and labels [H, W]; asserts the stated
    tolerances and returns the port's result."""
    want = _jax_merge_planes(jnp.asarray(pts), jnp.asarray(labels.numpy()))
    lab = labels[None]
    index = ts.cell_index(lab, GRID, 8) if route == "cell" else ts._GlobalIndex(lab, K)
    got = tccl.merge_planes(torch.from_numpy(pts)[None], lab, K, index=index)
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rep[0].numpy(), np.asarray(want.rep))
    np.testing.assert_array_equal(got.sizes[0].numpy(), np.asarray(want.sizes))
    np.testing.assert_allclose(got.cluster_nd[0].numpy(), np.asarray(want.cluster_nd),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.variance[0].numpy(), np.asarray(want.variance),
                               rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.parametrize("route", ["cell", "global"])
def test_merge_planes_exact_on_jax_nasp(route):
    """merge_planes on real superpixels: the JAX package's JBF points and
    NASP labels of the 96x128 scene (grid 3x4), the inputs kde_pipeline
    gives it with plane_merge=True."""
    with np.load(STAGES) as z:
        pts = z["points"]
        labels = torch.from_numpy(z["nasp_labels"].astype(np.int32))
    got = _merge_both(pts, labels, route)
    # the scene's planes merge superpixels (the merge is exercised)
    assert len(np.unique(got.rep[0].numpy())) < K


def test_plane_hole_fill_matches_jax():
    rng = np.random.default_rng(2)
    intr = default_kinect_intrinsics(W, H)
    rays = normalized_rays(intr, H, W)
    labels = ts.init_labels(GRID, H, W).numpy()
    labels[rng.random((H, W)) < 0.02] = -1
    nd = np.concatenate([np.tile([[0.1, 0.2, 0.97]], (H * W, 1)).reshape(H, W, 3),
                         (2000.0 + labels * 10.0)[..., None]], -1).astype(np.float32)
    trust = rng.random((H, W)) < 0.7
    invalid = rng.random((H, W)) < 0.2
    opt = rng.normal(2000.0, 5.0, (H, W, 3)).astype(np.float32)
    want = np.asarray(jplane.plane_hole_fill(
        jnp.asarray(opt), jnp.asarray(rays.numpy()), jnp.asarray(labels), jnp.asarray(nd),
        jnp.asarray(trust), jnp.asarray(invalid), 3))
    got = tplane.plane_hole_fill(
        torch.from_numpy(opt)[None], rays, torch.from_numpy(labels)[None],
        torch.from_numpy(nd)[None], torch.from_numpy(trust)[None],
        torch.from_numpy(invalid)[None], 3)[0].numpy()
    filled = (want != opt).any(-1)
    assert filled.sum() > 100
    np.testing.assert_array_equal((got != opt).any(-1), filled)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _textured_color(rng):
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    return (
        (128.0 + 60.0 * np.sin(u / 9.0) + 50.0 * np.cos(v / 7.0))[..., None]
        + rng.normal(0, 6.0, (H, W))[..., None] * np.ones((1, 1, 3))
    ).clip(0, 255).astype(np.uint8)


def _kde(noisy, color, intr, cfg):
    return kde_pipeline(torch.from_numpy(noisy), torch.from_numpy(color), intr, cfg)


def test_kde_plane_hole_fill():
    """tests/test_pipelines.py:160 on the port: an 8x8 dropout inside one
    slanted plane is filled along the merged plane with fill_holes=4 and
    left empty without; outside the hole the two agree within 1e-3 mm."""
    intr = default_kinect_intrinsics(W, H)
    rng = np.random.default_rng(5)
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    gt = 2200.0 + 1.2 * u + 0.8 * v
    noisy = (gt + rng.normal(0.0, 2.0, gt.shape)).astype(np.float32)
    color = _textured_color(rng)
    hy, hx = 40, 60
    noisy[hy : hy + 8, hx : hx + 8] = 0.0
    base = dataclasses.replace(KDEConfig(), grid=GRID, min_cluster_size=300)
    z0 = _kde(noisy, color, intr, base).optimized_points[..., 2].numpy()
    z4 = _kde(noisy, color, intr, dataclasses.replace(base, fill_holes=4)).optimized_points[
        ..., 2].numpy()
    centre = (slice(hy + 3, hy + 5), slice(hx + 3, hx + 5))
    assert np.all(z0[centre] <= 50.0)
    assert np.all(z4[centre] > 50.0)
    assert np.abs(z4[centre] - gt[centre]).max() < 40.0
    outside = np.ones_like(z0, bool)
    outside[hy - 4 : hy + 12, hx - 4 : hx + 12] = False
    np.testing.assert_allclose(z4[outside], z0[outside], rtol=0, atol=1e-3)


def test_kde_plane_merge_small_scene():
    """tests/test_pipelines.py:214 on the port: on two genuine 3-D planes
    the plane merge collapses each surface's interior cells to one
    component, and its projection reaches the noise level (RMSE < 2.5 mm)
    without regressing against the normal merge (<= 1.05x)."""
    intr = default_kinect_intrinsics(W, H)
    rng = np.random.default_rng(9)
    u = np.arange(W, dtype=np.float32)[None, :]
    left = _plane_depth(intr, H, W, np.array([0.25, 0.1, 0.96]), 2300.0)
    right = _plane_depth(intr, H, W, np.array([-0.2, 0.05, 0.98]), 3000.0)
    gt = np.where(u < W // 2, left, right)
    noisy = (gt + rng.normal(0.0, 2.0, gt.shape)).astype(np.float32)
    color = _textured_color(rng)
    base = dataclasses.replace(KDEConfig(), grid=GRID, min_cluster_size=300)
    r0 = _kde(noisy, color, intr, base)
    r1 = _kde(noisy, color, intr, dataclasses.replace(base, plane_merge=True))
    lab = r1.merged_labels.numpy()
    li = lab[16:-16, 8 : W // 2 - 16]
    ri = lab[16:-16, 100:120]
    assert len(np.unique(li)) == 1 and len(np.unique(ri)) == 1
    assert li[0, 0] != ri[0, 0]
    z1 = r1.optimized_points[..., 2].numpy()
    z0 = r0.optimized_points[..., 2].numpy()
    m = (z1 > 50.0) & np.broadcast_to(np.abs(u - 64.0) > 16.0, z1.shape)
    rmse_pm = float(np.sqrt(np.mean((z1 - gt)[m] ** 2)))
    rmse0 = float(np.sqrt(np.mean((z0 - gt)[m] ** 2)))
    assert rmse_pm < 2.5, (rmse_pm, rmse0)
    assert rmse_pm <= rmse0 * 1.05
