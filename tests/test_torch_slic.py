"""PyTorch port: NASP seeds, assignment and cluster tables against the JAX
package (ops/slic.py) on the CPU, plus the cell-local index primitives.

Tolerances:
  * seed gradient: |d| <= 1e-6 relative (XLA contracts the window sums into
    FMAs; measured 3.9e-7), +inf at the same pixels; the seeds are EQUAL;
  * with the JAX seeds injected, NASP labels are EXACT; cluster tables meet
    rtol 1e-5 (integer-valued ones — rgb, xy, size — exactly);
  * cell-index gathers are exact; segment sums match a float64 NumPy sum to
    rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig, NormalParams
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import bilateral as jbil
from kinectdepthmapenhancement_tpu.ops import normals as jn
from kinectdepthmapenhancement_tpu.ops import slic as js
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import cuda_gradient
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)


def _t(a):
    return torch.tensor(np.asarray(a))[None]


@pytest.fixture(scope="module")
def nasp_inputs():
    """JAX-side JBF points and CM normals of the 96x128 scene (seed 0)."""
    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=0)
    jbf = jbil.joint_bilateral_filter(jnp.asarray(noisy), jnp.asarray(color))
    points = np.asarray(projective_to_real(jbf, intr))
    nmap = np.asarray(
        jn.generate_normal_map(jnp.asarray(points), NormalParams(cov_impl="xla", dt_impl="xla"))
    )
    return dict(color=color, points=points, normals=nmap)


@pytest.mark.parametrize("nasp", [True, False], ids=["nasp", "color_only"])
def test_seed_gradient_matches_jax(nasp_inputs, nasp):
    cf = nasp_inputs["color"].astype(np.float32)
    csub = np.asarray(js._subgrid_extract(jnp.asarray(cf), GRID, H, W, 8))
    if nasp:
        nsub = np.asarray(js._subgrid_extract(jnp.asarray(nasp_inputs["normals"]), GRID, H, W, 8))
        want = np.asarray(js._nasp_gradient(jnp.asarray(csub), jnp.asarray(nsub)))
        got = cuda_gradient.seed_gradient(_t(csub), _t(nsub))[0].numpy()
    else:
        want = np.asarray(js._color_gradient(jnp.asarray(csub)))
        got = cuda_gradient.seed_gradient(_t(csub))[0].numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isinf(got), ~fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_seeds_equal_jax(nasp_inputs):
    cf = nasp_inputs["color"].astype(np.float32)
    want = np.asarray(
        js._compute_seeds(
            jnp.asarray(cf), jnp.asarray(nasp_inputs["normals"]), GRID, H, W, 8, "nasp",
            grad_impl="xla",
        )
    )
    got = ts._compute_seeds(_t(cf), _t(nasp_inputs["normals"]), GRID, H, W, 8)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_full_image_seed_path_equals_subgrid(nasp_inputs):
    """sample_seeds over the full-image gradient picks the same seeds as the
    sub-grid fast path (the gradient support never leaves a cell)."""
    cf = _t(nasp_inputs["color"].astype(np.float32))
    nm = _t(nasp_inputs["normals"])
    full = ts.sample_seeds(ts._nasp_gradient(cf, nm), GRID, H, W, 8)
    assert torch.equal(full, ts._compute_seeds(cf, nm, GRID, H, W, 8))


def test_nasp_labels_exact_with_jax_seeds(nasp_inputs):
    params = KDEConfig().nasp
    color, points, nmap = (nasp_inputs[k] for k in ("color", "points", "normals"))
    seeds = np.asarray(
        js._compute_seeds(
            jnp.asarray(color.astype(np.float32)), jnp.asarray(nmap), GRID, H, W, 8, "nasp",
            grad_impl="xla",
        )
    )
    want = js.segment(
        jnp.asarray(color), jnp.asarray(points), jnp.asarray(nmap),
        grid=GRID, params=params, variant="nasp", seeds=jnp.asarray(seeds),
    )
    got = ts.segment(
        _t(color), _t(points), _t(nmap), grid=convert.config_from_jax(GRID),
        params=convert.config_from_jax(params), seeds=torch.tensor(seeds),
    )
    np.testing.assert_array_equal(got.labels[0].numpy(), np.asarray(want.labels))
    for field in ("rgb", "xy", "size"):
        np.testing.assert_array_equal(
            getattr(got.clusters, field)[0].numpy(), np.asarray(getattr(want.clusters, field))
        )
    for field in ("center", "normal", "variance"):
        np.testing.assert_allclose(
            getattr(got.clusters, field)[0].numpy(), np.asarray(getattr(want.clusters, field)),
            rtol=1e-5, atol=1e-6,
        )
    lab = np.asarray(want.labels)
    np.testing.assert_allclose(
        got.distance[0].numpy()[lab >= 0], np.asarray(want.distance)[lab >= 0], rtol=1e-5
    )


def test_segment_batched_equals_per_frame(nasp_inputs):
    """Two frames in one batch give exactly the per-frame segmentations."""
    params = KDEConfig().nasp
    c, p, n = (_t(nasp_inputs[k]) for k in ("color", "points", "normals"))
    c2 = torch.cat([c, torch.flip(c, dims=[2])])
    p2 = torch.cat([p, torch.flip(p, dims=[2])])
    n2 = torch.cat([n, torch.flip(n, dims=[2])])
    both = ts.segment(c2, p2, n2, grid=GRID, params=params)
    for i in range(2):
        one = ts.segment(c2[i : i + 1], p2[i : i + 1], n2[i : i + 1], grid=GRID, params=params)
        assert torch.equal(both.labels[i : i + 1], one.labels)
        for a, b in zip(both.clusters, one.clusters):
            assert torch.equal(a[i : i + 1], b)


def test_cell_index_gather_and_segment_sum():
    """_CellIndex on adversarial cell-local labels (invalids, every
    candidate offset): gathers exact, sums vs float64 NumPy, counts exact,
    pair_counts > 0 exactly where a 4-neighbour pair exists."""
    rng = np.random.default_rng(9)
    h, w, rows, cols, r = 48, 64, 3, 4, 4
    cy = np.arange(h)[:, None] // (h // rows)
    cx = np.arange(w)[None, :] // (w // cols)
    ny = np.clip(cy + rng.integers(-r, r, (h, w)), 0, rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (h, w)), 0, cols - 1)
    labels = (ny * cols + nx).astype(np.int32)
    labels[rng.random((h, w)) < 0.07] = -1
    k = rows * cols
    idx = ts._CellIndex(torch.from_numpy(labels)[None], GridParams(rows, cols), r, h, w)

    table = rng.normal(size=(k, 5)).astype(np.float32) * 1000.0
    got = idx.gather(torch.from_numpy(table)[None])[0].numpy()
    want = np.where((labels >= 0)[..., None], table[np.maximum(labels, 0)], 0.0)
    np.testing.assert_array_equal(got, want)

    feats = rng.normal(size=(h, w, 3)).astype(np.float32)
    mask = rng.random((h, w)) < 0.8
    sums = idx.segment_sum(torch.from_numpy(feats)[None], torch.from_numpy(mask)[None])[0]
    ref = np.zeros((k, 3))
    sel = mask & (labels >= 0)
    np.add.at(ref, labels[sel], feats[sel].astype(np.float64))
    np.testing.assert_allclose(sums.numpy(), ref, rtol=1e-6, atol=1e-4)

    counts = idx.counts()[0].numpy()
    np.testing.assert_array_equal(counts, np.bincount(labels[labels >= 0], minlength=k))

    right = np.concatenate([labels[:, 1:], np.full((h, 1), -1, np.int32)], axis=1)
    pc = idx.pair_counts(torch.from_numpy(right)[None])[0].numpy() > 0
    ref_pc = np.zeros((k, k), bool)
    ok = (labels >= 0) & (right >= 0)
    ref_pc[labels[ok], right[ok]] = True
    np.testing.assert_array_equal(pc, ref_pc)


def test_unported_routes_raise(nasp_inputs):
    c, p, n = (_t(nasp_inputs[k]) for k in ("color", "points", "normals"))
    with pytest.raises(NotImplementedError):
        ts.segment(c, p, n, grid=GRID, params=dataclasses.replace(KDEConfig().nasp, iterations=2))
    with pytest.raises(NotImplementedError):
        ts.segment(c, p, n, grid=GridParams(rows=5, cols=4), params=KDEConfig().nasp)
    with pytest.raises(NotImplementedError):
        ts.segment(c, p, n, grid=GRID, params=KDEConfig().nasp, variant="dasp")
