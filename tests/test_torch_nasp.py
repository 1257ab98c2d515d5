"""PyTorch port: the NASP cell kernels' plain versions (ops/cuda_nasp.py)
against the JAX package's ops/pallas_nasp.py in interpret mode, as
tests/test_pallas.py runs it, and the port's stats_impl routes.

Inputs come from numpy seeds: make_noisy_scene(96, 128, seed=5) and the
adversarial cell-local labels of test_pallas.py::_nasp_state (invalid
labels, window misses, every candidate offset), grid 3x4, r=4 and r=2; the
NASP sums also with stray ids outside the candidates (ids >= K, far cells),
as the card tests' label maps have them.

Tolerances, and why:
  * assignment labels EXACT; distance rtol 1e-6, atol 1e-2 (XLA on the CPU
    contracts the distance's a*b+c into FMAs, the port rounds every
    operation; near-equal normals leave 65025 * w_nor * (1 - n.n') on a few
    ulps of 1, so small distances move by up to ~3e-3 absolute; the bar of
    test_pallas.py:303-305);
  * sums: integer-valued features (colours, u, v, counts, acc) EXACT, the
    others rtol 2e-5 / atol 2e-3 (f32 sums in another order; the bar of
    test_pallas.py:246-252); label-cell sums rtol 2e-5; gathers EXACT;
  * segment() on the kernel route against JAX segment(stats_impl="pallas"):
    labels exact, cluster tables at test_pallas.py:306-313's tolerances;
  * the port's "xla" and "auto" routes: bitwise equal on the CPU (both
    take the plain versions there).
The subnormal case: XLA flushes subnormal weights to 0, so a cluster whose
window weights are all subnormal keeps its old row; the port must too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig, NormalParams, SLICParams
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import normals as jn
from kinectdepthmapenhancement_tpu.ops import pallas_nasp
from kinectdepthmapenhancement_tpu.ops import slic as js
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.models import pipelines as tpipe
from kinectdepthmapenhancement_tpu_torch.ops import cuda_nasp
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
K = GRID.num_clusters
R = 4
PARAMS = SLICParams(10.0, 50.0, 50.0, 150.0, 1)
CELL = dict(rows=GRID.rows, cols=GRID.cols, r=R)


def _t(a):
    return torch.tensor(np.asarray(a))[None]


def _nasp_state(seed=9, r=R):
    """test_pallas.py::_nasp_state: labels from each pixel's (2r)x(2r) cell
    neighbourhood or -1, random colour / points / normals with invalids."""
    rng = np.random.default_rng(seed)
    cy = np.arange(H)[:, None] // (H // GRID.rows)
    cx = np.arange(W)[None, :] // (W // GRID.cols)
    ny = np.clip(cy + rng.integers(-r, r, (H, W)), 0, GRID.rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (H, W)), 0, GRID.cols - 1)
    labels = (ny * GRID.cols + nx).astype(np.int32)
    labels[rng.random((H, W)) < 0.07] = -1
    color_f = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    points = rng.uniform(100.0, 4000.0, (H, W, 3)).astype(np.float32)
    points[rng.random((H, W)) < 0.1] = 0.0
    normals = rng.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    normals[rng.random((H, W)) < 0.15] = -1.0
    return labels, color_f, points, normals


def _random_clusters(seed=1):
    """A random cluster table (numpy) as test_pallas.py builds it."""
    rng = np.random.default_rng(seed)
    return dict(
        rgb=rng.integers(0, 255, (K, 3)).astype(np.float32),
        xy=np.stack([rng.integers(0, W, K), rng.integers(0, H, K)], -1).astype(np.int32),
        size=np.zeros((K,), np.int32),
        center=rng.uniform(100, 4000, (K, 3)).astype(np.float32),
        normal=rng.normal(size=(K, 3)).astype(np.float32),
        variance=np.zeros((K,), np.float32),
    )


def _assert_sums(got, want, integer_cols, what):
    """Integer-valued features exact, the rest at test_pallas.py's bar."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    ints = list(integer_cols)
    np.testing.assert_array_equal(got[:, ints], want[:, ints], err_msg=what)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3, err_msg=what)


@pytest.fixture(scope="module")
def scene():
    """make_noisy_scene(96, 128, seed=5) through the JAX package's points
    and normals, as test_pallas.py::test_nasp_fused_assign_analyze_matches_xla."""
    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=5)
    pts = projective_to_real(jnp.asarray(noisy), intr)
    nmap = jn.generate_normal_map(pts, NormalParams(cov_impl="xla", dt_impl="xla"))
    rng = np.random.default_rng(2)
    seeds = np.stack([rng.integers(0, W, K), rng.integers(0, H, K)], axis=-1).astype(np.int32)
    return dict(color=color, points=np.asarray(pts), normals=np.asarray(nmap), seeds=seeds)


@pytest.mark.parametrize("r", [4, 2])
def test_assign_and_analyze_matches_pallas(scene, r):
    color_f = scene["color"].astype(np.float32)
    pts, nmap = scene["points"], scene["normals"]
    cl = js.init_clusters(jnp.asarray(scene["seeds"]), jnp.asarray(scene["color"]),
                          jnp.asarray(pts), jnp.asarray(nmap))
    cand = np.concatenate(
        [np.asarray(cl.rgb), np.asarray(cl.xy).astype(np.float32),
         np.asarray(cl.center)[:, 2:3], np.asarray(cl.normal)], axis=-1,
    ).reshape(GRID.rows, GRID.cols, 9)
    total = PARAMS.spatial_sigma + PARAMS.color_sigma + PARAMS.depth_sigma + PARAMS.normal_sigma
    kw = dict(
        CELL, r=r, lo=-40, hi=39, s_scale=32.0, apply_invalid=True,
        w_col=(PARAMS.color_sigma / total) ** 2, w_spa=(PARAMS.spatial_sigma / total) ** 2,
        w_dep=(PARAMS.depth_sigma / total) ** 2, w_nor=(PARAMS.normal_sigma / total) ** 2,
    )
    wl, wd, wp = pallas_nasp.nasp_assign_and_analyze(
        jnp.asarray(color_f), jnp.asarray(pts), jnp.asarray(nmap), jnp.asarray(cand),
        interpret=True, **kw,
    )
    before = dict(cuda_nasp.launches)
    gl, gd, gp = cuda_nasp.nasp_assign_and_analyze(
        _t(color_f), _t(pts), _t(nmap), _t(cand), **kw
    )
    assert cuda_nasp.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(gl[0].numpy(), np.asarray(wl))
    np.testing.assert_allclose(gd[0].numpy(), np.asarray(wd), rtol=1e-6, atol=1e-2)
    _assert_sums(gp[0], wp, cuda_nasp.INTEGER_FEATURES["analyze"], "assign+analyze")
    assert (np.asarray(wl) == -1).any() and (np.asarray(wp)[:, 5] > 0).sum() > K


@pytest.mark.parametrize("label_map", ["clipped", "stray"])
@pytest.mark.parametrize("r", [4, 2])
@pytest.mark.parametrize("mode", ["analyze", "weighted"])
def test_nasp_cell_sums_match_pallas(mode, r, label_map):
    """"stray": 3% of the labels any id in [-1, K + 5), as the card tests'
    adversarial maps have them: ids >= K, and at r = 2 cells outside the
    candidates, which both sides must leave out."""
    labels, color_f, points, normals = _nasp_state(r=r)
    if label_map == "stray":
        rng = np.random.default_rng(13)
        stray = rng.random(labels.shape) < 0.03
        labels[stray] = rng.integers(-1, K + 5, int(stray.sum()))
    cl = _random_clusters()
    xy = cl["xy"].astype(np.float32)
    fields = xy if mode == "analyze" else np.concatenate([xy, cl["rgb"], cl["normal"]], -1)
    fields = fields.reshape(GRID.rows, GRID.cols, -1)
    kw = dict(CELL, r=r, lo=-24, hi=23, mode=mode, color_sigma=PARAMS.color_sigma,
              spatial_sigma=PARAMS.spatial_sigma)
    want = pallas_nasp.nasp_cell_sums(
        *(jnp.asarray(a) for a in (labels, color_f, points, normals, fields)),
        interpret=True, **kw,
    )
    got = cuda_nasp.nasp_cell_sums(*(_t(a) for a in (labels, color_f, points, normals, fields)), **kw)
    _assert_sums(got[0], want, cuda_nasp.INTEGER_FEATURES[mode], mode)


@pytest.mark.parametrize("f, r", [(2, 4), (2, 2), (7, 4)])
def test_label_cell_sums_match_pallas(f, r):
    labels, *_ = _nasp_state(seed=11, r=r)
    rng = np.random.default_rng(3)
    # multiples of 2^-8 below 8 in magnitude: every sum of <= 1024 of them
    # is exact in f32, so the two summation orders cannot differ by round-off
    feats = np.round(rng.normal(size=(H, W, f)) * 256.0).astype(np.float32) / 256.0
    feats *= (rng.random((H, W)) < 0.8)[..., None]
    cell = dict(CELL, r=r)
    want = pallas_nasp.label_cell_sums(jnp.asarray(labels), jnp.asarray(feats), interpret=True, **cell)
    got = cuda_nasp.label_cell_sums(_t(labels), _t(feats), **cell)
    assert got.shape == (1, K * (2 * r) ** 2, f)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("f, r", [(1, 4), (3, 4), (6, 4), (6, 2)])
def test_label_cell_gather_matches_pallas(f, r):
    labels, *_ = _nasp_state(seed=12, r=r)
    table = np.random.default_rng(4).normal(size=(K, f)).astype(np.float32) * 1000.0
    cell = dict(CELL, r=r)
    want = pallas_nasp.label_cell_gather(jnp.asarray(labels), jnp.asarray(table), interpret=True, **cell)
    got = cuda_nasp.label_cell_gather(_t(labels), _t(table), **cell)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert (got[0].numpy()[labels < 0] == 0.0).all()


def test_segment_kernel_route_matches_pallas_segment(scene):
    """The port's segment() on the default "auto" route (fused assignment +
    analyze, weighted sums: the plain versions on the CPU) against the JAX
    package's fully fused Pallas route, with the same injected seeds."""
    color, pts, nmap = scene["color"], scene["points"], scene["normals"]
    js.force_cell(True)
    js.tables.force_mode("mxu")
    try:
        want = js.segment(
            jnp.asarray(color), jnp.asarray(pts), jnp.asarray(nmap), grid=GRID,
            params=dataclasses.replace(PARAMS, stats_impl="pallas"), variant="nasp",
            seeds=jnp.asarray(scene["seeds"]),
        )
    finally:
        js.force_cell(None)
        js.tables.force_mode(None)
    got = ts.segment(
        _t(color), _t(pts), _t(nmap), grid=convert.config_from_jax(GRID),
        params=convert.config_from_jax(PARAMS), seeds=torch.tensor(scene["seeds"]),
    )
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(
        got.distance[0].numpy(), np.asarray(want.distance), rtol=1e-6, atol=1e-2
    )
    for name in ("rgb", "xy", "size", "center", "normal", "variance"):
        np.testing.assert_allclose(
            getattr(got.clusters, name)[0].numpy(), np.asarray(getattr(want.clusters, name)),
            rtol=2e-5, atol=2e-3, err_msg=name,
        )


def test_stats_routes_agree_and_bogus_raises(scene):
    """stats_impl="xla" and "auto" give bitwise-equal segmentations and KDE
    outputs on the CPU; any other value raises."""
    c, p, n = (_t(scene[k]) for k in ("color", "points", "normals"))
    tparams = convert.config_from_jax(KDEConfig().nasp)
    routes = {
        impl: ts.segment(c, p, n, grid=GRID, params=dataclasses.replace(tparams, stats_impl=impl))
        for impl in ("xla", "auto")
    }
    assert torch.equal(routes["xla"].labels, routes["auto"].labels)
    assert torch.equal(routes["xla"].distance, routes["auto"].distance)
    for a, b in zip(routes["xla"].clusters, routes["auto"].clusters):
        assert torch.equal(a, b)

    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=5)
    cfg = convert.config_from_jax(dataclasses.replace(KDEConfig(), grid=GRID))
    ti = convert.intrinsics_from_jax(intr)
    out = {
        impl: tpipe.kde_pipeline(
            torch.from_numpy(noisy), torch.from_numpy(color), ti,
            dataclasses.replace(cfg, nasp=dataclasses.replace(cfg.nasp, stats_impl=impl)),
        )
        for impl in ("xla", "auto")
    }
    for a, b in zip(out["xla"], out["auto"]):
        assert torch.equal(a, b)

    bogus = dataclasses.replace(tparams, stats_impl="bogus")
    with pytest.raises(ValueError):
        ts.segment(c, p, n, grid=GRID, params=bogus)
    with pytest.raises(ValueError):
        ts.cell_index(routes["auto"].labels, GRID, 8, stats_impl="bogus")


def test_subnormal_window_weights_keep_the_old_row():
    """One cluster whose pixels all sit |drgb| = 140 from its colour: every
    window weight is exp(-98) ~ 3e-43, subnormal.  XLA flushes them, the
    weight sum is 0 and the JAX package keeps the old row; so must the port
    (without flush-denormal mode), on both stats routes."""
    labels, color_f, points, normals = _nasp_state()
    cl = _random_clusters()
    k0 = 5  # cell (1, 1)
    cl["rgb"][k0] = (60.0, 60.0, 60.0)
    cl["xy"][k0] = (48, 48)
    color_f[labels == k0] = (200.0, 60.0, 60.0)
    cdiff = 140.0**2
    assert 0.0 < np.exp(np.float32(-cdiff / (2 * PARAMS.color_sigma**2))) < np.finfo(np.float32).tiny
    window = (-24, 23)
    idx = js._CellIndex(jnp.asarray(labels), GRID, R, H, W, kernel_sums=False)
    want = js._update_nasp_weighted(
        idx, jnp.asarray(labels), js.Clusters(**{k: jnp.asarray(v) for k, v in cl.items()}),
        jnp.asarray(color_f), jnp.asarray(points), jnp.asarray(normals), GRID,
        dataclasses.replace(PARAMS, stats_impl="xla"), window, H, W,
    )
    for name, old in cl.items():  # the premise: the JAX package keeps the row
        np.testing.assert_array_equal(np.asarray(getattr(want, name))[k0], old[k0])
    tcl = ts.Clusters(**{k: _t(v) for k, v in cl.items()})
    for impl in ("xla", "auto"):
        tidx = ts.cell_index(_t(labels), GRID, 2 * R, stats_impl=impl)
        got = ts._update_nasp_weighted(
            tidx, tcl, _t(color_f), _t(points), _t(normals),
            dataclasses.replace(convert.config_from_jax(PARAMS), stats_impl=impl), window, H, W,
        )
        for name in cl:
            np.testing.assert_array_equal(
                getattr(got, name)[0, k0].numpy(), np.asarray(getattr(want, name))[k0],
                err_msg=f"{impl}.{name}",
            )
