"""PyTorch port: CCL normal merge and the KDE plane stage against the JAX
package (ops/ccl.py, ops/plane.py) on the CPU, both fed the JAX package's
own JBF points and NASP outputs (committed by tests/gen_torch_fixtures.py
stages; the JAX merge and plane stages run live).

Tolerances:
  * merged labels, component representatives `rep` and merged sizes: EXACT;
  * merged planes and variances: rtol 1e-5 (K-side f32 sums in another
    order);
  * plane stages (pseudo-depth, residual gate, variance optimisation, depth
    bilateral), through the cell-local and the global label index: residuals
    rtol 1e-4; points within 1e-3 mm on > 99% of pixels with the 99.9th
    percentile < 120 mm — the gate-flip allowance of
    tests/test_oracle_pipeline.py, for pixels whose size/variance/residual
    gate sits on an f32 boundary.
"""

import dataclasses
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, normalized_rays
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu.ops import ccl as jccl
from kinectdepthmapenhancement_tpu.ops import plane as jplane
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import ccl as tccl
from kinectdepthmapenhancement_tpu_torch.ops import plane as tplane
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
K = GRID.num_clusters
STAGES = os.path.join(os.path.dirname(__file__), "golden", "torch_stages_96x128_seed0.npz")


def _t(a):
    return torch.tensor(np.asarray(a))[None]


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX package's JBF points and NASP result at 96x128 (the fixture)
    and its CCL merge of them (jitted: eager dispatch compiles each op)."""
    intr = default_kinect_intrinsics(W, H)
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    with np.load(STAGES) as z:
        points = jnp.asarray(z["points"])
        nasp = SimpleNamespace(
            labels=jnp.asarray(z["nasp_labels"].astype(np.int32)),
            clusters=SimpleNamespace(normal=jnp.asarray(z["cluster_normal"]),
                                     center=jnp.asarray(z["cluster_center"])),
        )
    merged = jax.jit(lambda lab, n, c: jccl.merge_normals(lab, n, c, cfg.ccl))(
        nasp.labels, nasp.clusters.normal, nasp.clusters.center)
    return dict(
        intr=intr, cfg=cfg, points=points, rays=normalized_rays(intr, H, W),
        nasp=nasp, merged=merged,
    )


def _port_merge(st):
    nasp = st["nasp"]
    labels = _t(nasp.labels)
    idx = ts.cell_index(labels, GRID, neighborhood=8)
    merged = tccl.merge_normals(
        labels, _t(nasp.clusters.normal), _t(nasp.clusters.center),
        convert.config_from_jax(st["cfg"].ccl), index=idx,
    )
    return idx, merged


def test_merge_normals_exact(jax_stages):
    want = jax_stages["merged"]
    _, got = _port_merge(jax_stages)
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rep[0].numpy(), np.asarray(want.rep))
    np.testing.assert_array_equal(got.sizes[0].numpy(), np.asarray(want.sizes))
    np.testing.assert_allclose(got.variance[0].numpy(), np.asarray(want.variance), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.cluster_nd[0].numpy(), np.asarray(want.cluster_nd), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.nd_map[0].numpy(), np.asarray(want.nd_map), rtol=1e-5, atol=1e-4)
    assert len(np.unique(np.asarray(want.rep))) < K  # the scene does merge clusters


def test_merge_normals_exact_global_index(jax_stages):
    """The same merge through the global index over the same labels."""
    want = jax_stages["merged"]
    nasp = jax_stages["nasp"]
    labels = _t(nasp.labels)
    got = tccl.merge_normals(
        labels, _t(nasp.clusters.normal), _t(nasp.clusters.center),
        convert.config_from_jax(jax_stages["cfg"].ccl), index=ts._GlobalIndex(labels, K),
    )
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rep[0].numpy(), np.asarray(want.rep))
    np.testing.assert_array_equal(got.sizes[0].numpy(), np.asarray(want.sizes))
    np.testing.assert_allclose(got.variance[0].numpy(), np.asarray(want.variance), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.nd_map[0].numpy(), np.asarray(want.nd_map), rtol=1e-5, atol=1e-4)


def test_components_is_min_label_closure():
    """_components on a random sparse graph equals NumPy's min-label
    connected components by repeated propagation."""
    rng = np.random.default_rng(4)
    k = 40
    adj = rng.random((k, k)) < 0.04
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    got = tccl._components(torch.from_numpy(adj)[None])[0].numpy()
    rep = np.arange(k)
    for _ in range(k):
        nb = np.where(adj, rep[None, :], k).min(1)
        rep = np.minimum(rep, nb)
    np.testing.assert_array_equal(got, rep)


def _close(got, want):
    diff = np.abs(got - want)
    diff = diff.max(-1) if diff.ndim == 3 else diff
    assert (diff <= 1e-3).mean() > 0.99
    assert float(np.quantile(diff, 0.999)) < 120.0


def _jax_plane_stages(st, max_resid):
    """The JAX plane stage on the JAX merge, once per gate mode."""
    key = ("plane", max_resid)
    if key not in st:
        cfg = dataclasses.replace(st["cfg"], max_plane_residual=max_resid)
        m = st["merged"]
        points, rays = st["points"], st["rays"]
        pf = jplane.set_pseudo_depth_map(points, rays, m.nd_map, m.labels, m.variance)
        resid = None if math.isinf(max_resid) else jplane.plane_fit_residual(
            points, pf, m.labels, K)
        opt = jplane.variance_optimization(
            points, pf, m.labels, m.variance, m.sizes,
            min_cluster_size=cfg.min_cluster_size, agree_tight=cfg.agree_tight,
            agree_loose=cfg.agree_loose, fit_residual=resid, max_fit_residual=max_resid,
        )
        out = jplane.depth_bilateral(opt, rays, cfg.projection)
        st[key] = (cfg, pf, resid, opt, out)
    return st[key]


def _check_plane_stages(st, max_resid, idx):
    """The port's plane stage on the same (JAX) merge outputs, through the
    label index `idx` over the JAX NASP labels."""
    cfg, pf, resid, opt, out = _jax_plane_stages(st, max_resid)
    m = st["merged"]
    points, rays = st["points"], st["rays"]
    kw = dict(index=idx, rep=_t(m.rep))
    tpoints, trays, tlabels = _t(points), torch.tensor(np.asarray(rays)), _t(m.labels)
    tpf = tplane.set_pseudo_depth_map(tpoints, trays, _t(m.nd_map), tlabels, _t(m.variance), **kw)
    _close(tpf[0].numpy(), np.asarray(pf))
    tresid = None
    if resid is not None:
        tresid = tplane.plane_fit_residual(tpoints, tpf, **kw)
        np.testing.assert_allclose(tresid[0].numpy(), np.asarray(resid), rtol=1e-4, atol=1e-7)
    topt = tplane.variance_optimization(
        tpoints, tpf, tlabels, _t(m.variance), _t(m.sizes),
        min_cluster_size=cfg.min_cluster_size, agree_tight=cfg.agree_tight,
        agree_loose=cfg.agree_loose, fit_residual=tresid, max_fit_residual=max_resid, **kw,
    )
    _close(topt[0].numpy(), np.asarray(opt))
    tout = tplane.depth_bilateral(topt, trays, convert.config_from_jax(cfg.projection))
    _close(tout[0].numpy(), np.asarray(out))
    # the projection gate fires on this scene, and in reference mode so does
    # the variance blend (with the residual gate on, no 96x128 cluster passes)
    assert (np.asarray(pf) != np.asarray(points)).any()
    if resid is None:
        assert (np.asarray(opt)[..., 2] != np.asarray(points)[..., 2]).any()


@pytest.mark.parametrize("max_resid", [0.0025, math.inf], ids=["gate", "refexact"])
def test_plane_stages_match_jax(jax_stages, max_resid):
    idx = ts.cell_index(_t(jax_stages["nasp"].labels), GRID, neighborhood=8)
    _check_plane_stages(jax_stages, max_resid, idx)


@pytest.mark.parametrize("max_resid", [0.0025, math.inf], ids=["gate", "refexact"])
def test_plane_stages_global_index_match_jax(jax_stages, max_resid):
    """The same stages through the global index over the same labels (the
    route of later iterations off the cap and of grids that do not divide
    the frame)."""
    idx = ts._GlobalIndex(_t(jax_stages["nasp"].labels), K)
    _check_plane_stages(jax_stages, max_resid, idx)
