"""PyTorch port: the PCA plane stage of SPDSP / TOF (ops/plane.py) and the
PCA merge (ops/ccl.py::merge_pca) against the JAX ops on the CPU, on both
label-index routes (the cell-local one, with the label-cell kernels' plain
versions, and the global one).

Bars:
  * pca_planes: point counts exact; centres within rtol 1e-5 / 1e-4 mm
    (measured 1.8e-5 mm); plane normals within 1e-4 of the JAX op's on
    planar clusters and 1e-3 on the isotropic random blob, whose smallest
    eigenvalue is barely separated (measured 2.3e-4; the same closed-form
    eigensolver on moments summed in another order); d within rtol 1e-5
    (1e-3 on the blob: d = n . centroid follows the normal, measured
    8.2e-5);
    eigenvalues within 1e-3 of the larger of 1 and the JAX value; the
    (5, 5, 5, 0) sentinel exact;
  * the projections: rtol 1e-6 (XLA contracts the ray dot product into
    FMAs, the port does not);
  * mrf_optimization: rtol 2e-6 after 20 sweeps (measured 5.5e-7, 1.1e-3
    mm at 2 m: XLA's contracted FMAs, compounded over the sweeps);
  * merge_pca: labels, rep and sizes EXACT (tests/test_ccl.py:52, 67's
    inputs); merged planes, variance, eigenvalues and the eigen map within
    1e-5 (relative, 1e-4 mm absolute).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, normalized_rays
from kinectdepthmapenhancement_tpu.core.config import ProjectionParams
from kinectdepthmapenhancement_tpu.ops import ccl as jccl
from kinectdepthmapenhancement_tpu.ops import plane as jplane
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams
from kinectdepthmapenhancement_tpu_torch.ops import ccl as tccl
from kinectdepthmapenhancement_tpu_torch.ops import plane as tplane
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

ROUTES = ["cell", "global"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _index(labels, grid, route):
    """The route's label index over [H, W] labels: a cell index at r = 4
    (its candidates cover every cluster of these small grids), or the
    global one."""
    lab = _t(labels.astype(np.int32))
    if route == "cell":
        idx = ts.cell_index(lab, grid, 8)
        assert isinstance(idx, ts._CellIndex)
        return idx
    return ts._GlobalIndex(lab, grid.num_clusters)


def _planes_scene():
    """tests/test_plane.py:116-135: three labelled regions on known planes
    and a 1-pixel cluster, 48x64, grid 2x2 (K = 4)."""
    h, w = 48, 64
    intr = default_kinect_intrinsics(w, h)
    rng = np.random.default_rng(1)
    labels = np.zeros((h, w), np.int64)
    labels[:, 24:48] = 1
    labels[:, 48:] = 2
    labels[0, 0] = 3
    planes_n = np.array([[0.0, 0.0, 1.0], [0.3, 0.1, 0.949], [-0.2, 0.2, 0.959]])
    planes_n /= np.linalg.norm(planes_n, axis=-1, keepdims=True)
    rays = np.asarray(normalized_rays(intr, h, w), np.float64)
    pts = np.zeros((h, w, 3))
    for k, d in enumerate((2000.0, 2500.0, 1800.0)):
        z = d / (rays @ planes_n[k])
        pts[labels == k] = (rays * z[..., None])[labels == k]
    pts += rng.normal(0, 0.5, pts.shape)
    return pts.astype(np.float32), labels, intr


def _random_scene():
    """tests/test_plane.py:163-166: a Gaussian blob in four label runs."""
    h, w = 24, 32
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 100.0, (h, w, 3)) + np.array([0, 0, 2000.0])
    labels = (np.arange(h * w).reshape(h, w) // ((h * w) // 4)).clip(0, 3)
    return pts.astype(np.float32), labels, default_kinect_intrinsics(w, h)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scene", [_planes_scene, _random_scene], ids=["planes", "random"])
def test_pca_planes_matches_jax(scene, route):
    pts, labels, _ = scene()
    want = jplane.pca_planes(jnp.asarray(pts), jnp.asarray(labels, jnp.int32), 4)
    got = tplane.pca_planes(_t(pts), _t(labels.astype(np.int32)), 4,
                            index=_index(labels, GridParams(2, 2), route))
    np.testing.assert_array_equal(got.count[0].numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.centers[0].numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-4)
    gn, wn = got.nd[0].numpy(), np.asarray(want.nd)
    planar = scene is _planes_scene
    np.testing.assert_allclose(gn[:, :3], wn[:, :3], atol=1e-4 if planar else 1e-3)
    np.testing.assert_allclose(gn[:, 3], wn[:, 3], rtol=1e-5 if planar else 1e-3)
    ge, we = got.eigenvalues[0].numpy(), np.asarray(want.eigenvalues)
    assert np.all(np.abs(ge - we) <= 1e-3 * np.maximum(np.abs(we), 1.0))
    if scene is _planes_scene:
        np.testing.assert_array_equal(gn[3], [5.0, 5.0, 5.0, 0.0])
        assert np.all(gn[:3, 3] >= 0.0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("strict", [False, True])
def test_set_pseudo_depth_cluster_matches_jax(route, strict):
    """The per-cluster projection (SPDSP: |nd.x| < 1; TOF: <= 1) of the
    planes scene, with the sentinel cluster, one plane at |nd.x| == 1 and
    a -1 label."""
    pts, labels, intr = _planes_scene()
    labels[5, :7] = -1
    h, w = labels.shape
    planes = jplane.pca_planes(jnp.asarray(pts), jnp.asarray(labels, jnp.int32), 4)
    nd = np.asarray(planes.nd).copy()
    nd[2] = [1.0, 0.0, 0.0, 1500.0]  # on the strict / non-strict edge
    rays = normalized_rays(intr, h, w)
    want = np.asarray(jplane.set_pseudo_depth_cluster(
        jnp.asarray(pts), rays, jnp.asarray(nd), jnp.asarray(labels, jnp.int32), strict=strict))
    got = tplane.set_pseudo_depth_cluster(
        _t(pts), torch.from_numpy(np.asarray(rays)), _t(nd), _t(labels.astype(np.int32)),
        strict=strict, index=_index(labels, GridParams(2, 2), route))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    moved = (got != pts).any(-1)
    assert moved[labels == 2].all() == strict and not moved[labels < 0].any()


@pytest.mark.parametrize("route", ROUTES)
def test_set_pseudo_depth_normals_matches_jax(route):
    pts, labels, intr = _planes_scene()
    h, w = labels.shape
    planes = jplane.pca_planes(jnp.asarray(pts), jnp.asarray(labels, jnp.int32), 4)
    normals = np.asarray(planes.nd)[:, :3]
    centers = np.asarray(planes.centers)
    variance = np.array([0.99, 0.5, 1.0 + 1e-7, 0.95], np.float32)
    rays = normalized_rays(intr, h, w)
    want = np.asarray(jplane.set_pseudo_depth_normals(
        jnp.asarray(pts), rays, jnp.asarray(normals), jnp.asarray(centers),
        jnp.asarray(labels, jnp.int32), jnp.asarray(variance)))
    got = tplane.set_pseudo_depth_normals(
        _t(pts), torch.from_numpy(np.asarray(rays)), _t(normals), _t(centers),
        _t(labels.astype(np.int32)), _t(variance),
        index=_index(labels, GridParams(2, 2), route))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("gated", [False, True])
def test_mrf_optimization_matches_jax(gated):
    """tests/test_plane.py:94-107's noisy plane, 20 sweeps, with and
    without the plane-confidence gate (a block of pixels gated off)."""
    h, w = 24, 32
    intr = default_kinect_intrinsics(w, h)
    rays = np.asarray(normalized_rays(intr, h, w))
    rng = np.random.default_rng(0)
    z = (2000.0 + rng.normal(0, 3.0, (h, w))).astype(np.float32)
    z[3, 4] = 0.0  # an invalid tap
    opt = rays * z[..., None]
    pf = rays * np.full((h, w, 1), 2000.0, np.float32)
    gate = np.ones((h, w), bool)
    gate[8:16, 8:20] = False
    p = ProjectionParams()
    want = np.asarray(jplane.mrf_optimization(
        jnp.asarray(opt), jnp.asarray(pf), jnp.asarray(rays), p,
        gate_mask=jnp.asarray(gate) if gated else None))
    got = tplane.mrf_optimization(
        _t(opt), _t(pf), torch.from_numpy(rays), convert.config_from_jax(p),
        gate_mask=_t(gate) if gated else None)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    smoothed = z > 50.0
    if gated:
        np.testing.assert_array_equal(got[8:16, 8:20], opt[8:16, 8:20])
        smoothed[8:16, 8:20] = False
    smoothed[:2] = smoothed[-2:] = smoothed[:, :2] = smoothed[:, -2:] = False
    assert np.std(got[..., 2][smoothed]) < np.std(z[smoothed]) * 0.9


def test_eigenvalue_optimization_matches_jax():
    h, w = 24, 32
    intr = default_kinect_intrinsics(w, h)
    rays = np.asarray(normalized_rays(intr, h, w))
    rng = np.random.default_rng(4)
    z = (2000.0 + rng.normal(0, 5.0, (h, w))).astype(np.float32)
    opt = rays * z[..., None]
    pf = rays * np.full((h, w, 1), 2003.0, np.float32)
    eig = rng.uniform(0.0, 40.0, (h, w)).astype(np.float32)
    labels = np.where(rng.random((h, w)) < 0.1, -1, 0).astype(np.int32)
    want = np.asarray(jplane.eigenvalue_optimization(
        jnp.asarray(opt), jnp.asarray(pf), jnp.asarray(rays), jnp.asarray(eig),
        jnp.asarray(labels), 100.0))
    got = tplane.eigenvalue_optimization(
        _t(opt), _t(pf), torch.from_numpy(rays), _t(eig), _t(labels), 100.0)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _toy_setup(seed):
    """tests/test_ccl.py:_toy_setup: a blocky 24x32 label map over 12
    clusters, near-identical planes 0-2, an invalid cluster 5."""
    rng = np.random.default_rng(seed)
    h, w, k = 24, 32, 12
    labels = np.repeat(np.repeat(rng.integers(0, k, size=(4, 4)), h // 4, axis=0),
                       w // 4, axis=1).astype(np.int64)
    labels[0, :3] = -1
    normals = rng.normal(size=(k, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    for i in (1, 2):
        normals[i] = normals[0] + rng.normal(scale=1e-3, size=3)
        normals[i] /= np.linalg.norm(normals[i])
    normals[5] = -1.0
    centers = rng.uniform(500, 3000, size=(k, 3))
    for i in (1, 2):
        centers[i] = centers[0] + rng.normal(scale=10.0, size=3)
    return labels, normals.astype(np.float32), centers.astype(np.float32)


def _pca_inputs(case):
    """tests/test_ccl.py:52 (equal planes, 8x8, K = 2, grid 1x2) and :67
    (the toy map, K = 12, grid 3x4)."""
    if case == "equal_planes":
        labels = np.zeros((8, 8), np.int64)
        labels[:, 4:] = 1
        nd = np.array([[0.0, 0.0, 1.0, 1000.0], [0.0, 0.0, 1.0, 1000.0]], np.float32)
        c = np.array([[0.0, 0.0, 1000.0], [0.0, 0.0, 1000.0]], np.float32)
        return labels, nd, c, np.zeros(2, np.float32), GridParams(1, 2)
    rng = np.random.default_rng(3)
    labels, normals, centers = _toy_setup(seed=3)
    d = np.abs(np.sum(normals * centers, axis=-1))
    nd = np.concatenate([normals, d[:, None]], axis=-1).astype(np.float32)
    nd[5] = 5.0
    eig = rng.uniform(0, 50, size=normals.shape[0]).astype(np.float32)
    return labels, nd, centers, eig, GridParams(3, 4)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["equal_planes", "toy"])
def test_merge_pca_matches_jax(case, route):
    labels, nd, centers, eig, grid = _pca_inputs(case)
    want = jccl.merge_pca(jnp.asarray(labels, jnp.int32), jnp.asarray(nd),
                          jnp.asarray(centers), jnp.asarray(eig))
    got = tccl.merge_pca(_t(labels.astype(np.int32)), _t(nd), _t(centers), _t(eig),
                         index=_index(labels, grid, route))
    for f in ("labels", "rep", "sizes"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)))
    for f in ("nd_map", "cluster_nd", "variance", "eigenvalues", "eigen_map"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-4)
    lab = got.labels[0].numpy()
    if case == "equal_planes":
        assert lab[0, 0] == 0 and lab[0, 7] == 0  # equal planes merge under PCA
    else:
        assert len(np.unique(lab[lab >= 0])) < len(np.unique(labels[labels >= 0]))


def test_normal_and_plane_merges_return_zero_eigen_fields():
    """merge_normals and merge_planes fill the PCA fields with zeros, as
    the JAX ops do (ccl.py:161-186, :407-408)."""
    labels, normals, centers = _toy_setup(seed=0)
    idx = _index(labels, GridParams(3, 4), "global")
    res = tccl.merge_normals(_t(labels.astype(np.int32)), _t(normals), _t(centers), index=idx)
    assert res.eigenvalues.shape == (1, 12) and res.eigen_map.shape == (1, 24, 32)
    assert not res.eigenvalues.any() and not res.eigen_map.any()
    pts = np.random.default_rng(5).normal(0, 50.0, (24, 32, 3)).astype(np.float32) + [0, 0, 2e3]
    pm = tccl.merge_planes(_t(pts), _t(labels.astype(np.int32)), 12, index=idx)
    assert pm.eigenvalues.shape == (1, 12) and not pm.eigenvalues.any()
    assert pm.eigen_map.shape == (1, 24, 32) and not pm.eigen_map.any()
    assert math.isclose(float(tplane.COS_PI_8), math.cos(math.pi / 8), rel_tol=1e-8)
