"""PyTorch port: kde_pipeline under the configs beyond the default —
plane_merge, fill_holes=4, a 5x6 grid that does not divide 96x128, and
nasp.iterations=3 — against the JAX package's outputs at 96x128
(tests/golden/kde_jax_96x128_ext_seed0.npz, written by
tests/gen_torch_fixtures.py ext), plus jbf_pipeline and the NumPy copies
(far-range scenes, Kinect v1 sensor model, metrics).

Tolerances:
  * the pipeline with the JAX seeds injected: every golden.kde_gates gate
    (JBF rtol 2e-4 / atol 0.25 mm, normal flags and directions > 99.5%,
    NASP labels > 99.5%, merged partition > 99.5%, optimized points within
    1 mm on > 99% and q99.9 < 120 mm) and NASP labels on > 99.9% of the
    pixels, as tests/test_torch_kde.py holds the default config (the
    port's own normals differ from the JAX package's by ulps, which moves
    a distance near-tie now and then);
  * fed the JAX package's own points, normals and seeds, under each of the
    four configs: NASP labels (the global route of the 5x6 grid and the
    capped route of 3 iterations among them), merged labels and merged
    sizes EXACT;
  * the port's seeds from the JAX normals EQUAL the JAX seeds (from its
    own normals a seed can land on the other side of a gradient near-tie:
    ROADMAP Queue C);
  * the NumPy copies byte-identical; the metrics rtol 1e-6.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gen_torch_fixtures
from kinectdepthmapenhancement_tpu.core import testdata as jtestdata
from kinectdepthmapenhancement_tpu.utils import metrics as jmetrics
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.core import testdata
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.ops import ccl, slic
from kinectdepthmapenhancement_tpu_torch.utils import golden, metrics

torch.set_num_threads(2)

H, W = 96, 128


def _config(name):
    """The fixture's config `name` (gen_torch_fixtures.ext_configs), in
    the port's KDEConfig."""
    return convert.config_from_jax(gen_torch_fixtures.ext_configs()[name])


@pytest.mark.parametrize("name", golden.EXT_CONFIGS)
def test_kde_config_matches_jax(name, monkeypatch):
    want = golden.load_jax_ext(name)
    seeds = torch.from_numpy(want["seeds"])
    monkeypatch.setattr(slic, "_compute_seeds", lambda c, *a: seeds.expand(c.shape[0], -1, -1))
    intr, color, noisy = golden.scene_96x128()
    res = pipelines.kde_pipeline(torch.from_numpy(noisy), torch.from_numpy(color), intr,
                                 _config(name))
    got = {f: getattr(res, f).numpy() for f in res._fields}
    gates = golden.kde_gates(got, want)
    assert not golden.failures(gates), gates
    assert (got["nasp_labels"] == want["nasp_labels"]).mean() > 0.999
    if name == "fill_holes":
        # the fill fires here: hole pixels with depth in the output
        assert ((got["optimized_points"][..., 2] > 50.0) & (noisy <= 50.0)).sum() > 100


@pytest.mark.parametrize("name", ["iter3", "grid5x6", "plane_merge", "fill_holes"])
def test_nasp_labels_exact_on_jax_inputs(name):
    """slic.segment fed the JAX package's JBF depth (as points), normals and
    seeds gives its NASP labels exactly (the capped route over 3
    iterations, the global route of a grid that does not divide the
    frame), and the config's merge (merge_planes with plane_merge, else
    merge_normals) on the label index kde_pipeline takes gives its merged
    labels and sizes exactly."""
    want = golden.load_jax_ext(name)
    intr, color, _ = golden.scene_96x128()
    cfg = _config(name)
    points = projective_to_real(torch.from_numpy(want["jbf_depth"])[None], intr)
    seg = slic.segment(torch.from_numpy(color)[None], points,
                       torch.from_numpy(want["normals"])[None], grid=cfg.grid,
                       params=cfg.nasp, seeds=torch.from_numpy(want["seeds"]))
    np.testing.assert_array_equal(seg.labels[0].numpy(), want["nasp_labels"])
    index = slic.label_index(seg.labels, cfg.grid, cfg.nasp)
    if cfg.plane_merge:
        merged = ccl.merge_planes(points, seg.labels, cfg.grid.num_clusters, index=index,
                                  tau=cfg.pm_tau)
    else:
        merged = ccl.merge_normals(seg.labels, seg.clusters.normal, seg.clusters.center,
                                   cfg.ccl, index=index)
    np.testing.assert_array_equal(merged.labels[0].numpy(), want["merged_labels"])
    np.testing.assert_array_equal(merged.sizes[0].numpy(), want["merged_sizes"])


@pytest.mark.parametrize("name", ["iter3", "grid5x6"])
def test_seeds_from_jax_normals_equal_jax(name):
    """The sub-grid seed path (3x4) and the full-frame one (5x6)."""
    want = golden.load_jax_ext(name)
    _, color, _ = golden.scene_96x128()
    got = slic._compute_seeds(torch.from_numpy(color)[None].float(),
                              torch.from_numpy(want["normals"])[None], _config(name).grid,
                              H, W, 8)
    np.testing.assert_array_equal(got[0].numpy(), want["seeds"])


def test_jbf_pipeline_matches_jax():
    intr, color, noisy = golden.scene_96x128()
    want = golden.load_jax_ext("iter3")["jbf_depth"]
    got = pipelines.jbf_pipeline(torch.from_numpy(noisy), torch.from_numpy(color))
    assert got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=0.25)
    both = pipelines.jbf_pipeline(torch.from_numpy(noisy)[None], torch.from_numpy(color)[None])
    assert torch.equal(both[0], got)


def test_numpy_copies_byte_identical():
    intr = default_kinect_intrinsics(W, H)
    for a, b in zip(testdata.make_banded_scene(H, W, intr, seed=1, hole_fraction=0.05),
                    jtestdata.make_banded_scene(H, W, intr, seed=1, hole_fraction=0.05)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(testdata.make_far_scene(H, W, intr, seed=2),
                    jtestdata.make_far_scene(H, W, intr, seed=2)):
        assert a.tobytes() == b.tobytes()


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    p = rng.normal(2000.0, 500.0, (H, W, 3)).astype(np.float32)
    q = (p + rng.normal(0.0, 3.0, p.shape)).astype(np.float32)
    p[rng.random((H, W)) < 0.1, 2] = 0.0
    e, n = metrics.mean_3d_error(torch.from_numpy(p), torch.from_numpy(q))
    je, jn = jmetrics.mean_3d_error(jnp.asarray(p), jnp.asarray(q))
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-6)
    r = metrics.depth_rmse(torch.from_numpy(p[..., 2]), torch.from_numpy(q[..., 2]))
    np.testing.assert_allclose(float(r), float(jmetrics.depth_rmse(
        jnp.asarray(p[..., 2]), jnp.asarray(q[..., 2]))), rtol=1e-6)
