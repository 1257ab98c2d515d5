"""PyTorch port: the SDC and bilateral normal methods (ops/normals.py) and
kde_pipeline under them, against the JAX package and the NumPy oracle.

The JAX outputs are committed (tests/golden/kde_jax_96x128_normals_seed0.npz,
written by tests/gen_torch_fixtures.py normals): kde_pipeline at 96x128,
grid 3x4, under each method, so no JAX pipeline is compiled here.

Tolerances, and why:
  * bilateral normals against the JAX package (its bilateral_normals on a
    40x48 crop, and its normals in the fixture) and against the oracle:
    the bar of tests/test_normals.py:78-81, rtol 1e-3 / atol 1e-4
    (measured: 1.2e-7 and 5.8e-6, FMA contraction in XLA);
  * SDC normals against the oracle: the bars of tests/test_normals.py:
    102-113 (validity masks agree on > 99.5%, the 5% quantile of |n.n'|
    above cos 1.5 degrees);
  * SDC normals against the JAX package's: agreement fractions, not ulps.
    The summed-area tables of both packages are f32 sums in different
    orders (the port's in float64, rounded once: ops/integral.py), and
    the SDC normal is ill-conditioned in them.  At 96x128 the validity
    masks agree on > 99.9% of the pixels (measured 1.0) and the normals
    lie within 1e-2 (any component) on > 99.9% of the pixels valid in
    both (measured 0.99950) and within 1e-3 on > 95% (measured 0.97196).
    At 640x480 they agree less (chip_smoke.py, golden.normal_method_gates);
  * kde_pipeline under either method, with the JAX seeds injected as
    tests/test_torch_kde_ext.py does: every golden.kde_gates gate and NASP
    labels on > 99.9% of the pixels (measured 0.99992 sdc, 1.0
    bilateral); fed the JAX package's points, normals and seeds, the NASP
    labels, merged labels and merged sizes are EXACT;
  * the bilateral method runs neither the DT nor the covariance sweep;
    SDC runs the DT and not the covariance sweep;
  * a batch of two frames equals each frame alone, bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import projective_to_real as jreal
from kinectdepthmapenhancement_tpu.ops import normals as jn
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    normalized_rays,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig, NormalParams
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.ops import ccl, cuda_cov, cuda_dt, plane, slic
from kinectdepthmapenhancement_tpu_torch.ops import normals as tn
from kinectdepthmapenhancement_tpu_torch.utils import golden

import oracle_normals

torch.set_num_threads(2)

H, W = 96, 128


def _config(method):
    base = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    return dataclasses.replace(base, normals=dataclasses.replace(base.normals, method=method))


def _vertices(small_scene, h, w):
    """tests/test_normals.py::_vertices: the crop's points in metres (f64)."""
    depth = small_scene["depth"][:h, :w]
    return np.asarray(jreal(jnp.asarray(depth), small_scene["intr"]), np.float64) / 1000.0


def _valid(n):
    return (n != -1.0).any(-1)


def test_bilateral_normals_match_jax_and_oracle(small_scene):
    vm = _vertices(small_scene, 40, 48)
    got = tn.bilateral_normals(torch.from_numpy(vm.astype(np.float32))[None])[0].numpy()
    want_j = np.asarray(jn.bilateral_normals(jnp.asarray(vm, jnp.float32)))
    np.testing.assert_allclose(got, want_j, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, oracle_normals.bilateral_normals(vm), rtol=1e-3, atol=1e-4)


def _jax_points(method):
    want = golden.load_jax_normals("96x128", method)
    intr, _, _ = golden.scene_96x128()
    return want, projective_to_real(torch.from_numpy(want["jbf_depth"])[None], intr)


def test_bilateral_method_matches_jax_fixture():
    """The method returns bilateral_normals as they are (no fill, no flip:
    JAX normals.py:539-540)."""
    want, pts = _jax_points("bilateral")
    got = tn.generate_normal_map(pts, NormalParams(method="bilateral"))
    assert torch.equal(got, tn.bilateral_normals(pts * (1.0 / 1000.0)))
    np.testing.assert_allclose(got[0].numpy(), want["normals"], rtol=1e-3, atol=1e-4)


def test_sdc_normals_match_oracle(small_scene):
    vm = _vertices(small_scene, 64, 96)
    got = tn.generate_normal_map(torch.from_numpy((vm * 1000.0).astype(np.float32))[None],
                                 NormalParams(method="sdc"))[0].numpy()
    want = oracle_normals.generate(vm * 1000.0, method="sdc")
    valid_o, valid_t = _valid(want), _valid(got)
    assert (valid_o == valid_t).mean() > 0.995
    both = valid_o & valid_t
    dots = np.abs(np.sum(got[both] * want[both], axis=-1))
    assert np.quantile(dots, 0.05) > np.cos(np.deg2rad(1.5))


def test_sdc_normals_match_jax_fixture():
    want, pts = _jax_points("sdc")
    got = tn.generate_normal_map(pts, NormalParams(method="sdc"))[0].numpy()
    gv, wv = _valid(got), _valid(want["normals"])
    assert (gv == wv).mean() > 0.999
    diff = np.abs(got - want["normals"]).max(-1)[gv & wv]
    assert (diff <= 1e-2).mean() > 0.999
    assert (diff <= 1e-3).mean() > 0.95


@pytest.mark.parametrize("method", golden.NORMAL_METHODS)
def test_normal_methods_batch_equals_single_frames(method):
    _, pts = _jax_points(method)
    both = torch.cat([pts, pts.flip(1)])
    p = NormalParams(method=method)
    out = tn.generate_normal_map(both, p)
    for i in range(2):
        assert torch.equal(out[i], tn.generate_normal_map(both[i:i + 1], p)[0])


@pytest.mark.parametrize("method", golden.NORMAL_METHODS)
def test_kde_normal_methods_match_jax(method, monkeypatch):
    want = golden.load_jax_normals("96x128", method)
    seeds = torch.from_numpy(want["seeds"])
    monkeypatch.setattr(slic, "_compute_seeds", lambda c, *a: seeds.expand(c.shape[0], -1, -1))
    intr, color, noisy = golden.scene_96x128()
    res = pipelines.kde_pipeline(torch.from_numpy(noisy), torch.from_numpy(color), intr,
                                 _config(method))
    got = {f: getattr(res, f).numpy() for f in res._fields}
    gates = golden.kde_gates(got, want)
    assert not golden.failures(gates), gates
    assert (got["nasp_labels"] == want["nasp_labels"]).mean() > 0.999


@pytest.mark.parametrize("method", golden.NORMAL_METHODS)
def test_nasp_labels_exact_on_jax_inputs(method):
    want, pts = _jax_points(method)
    _, color, _ = golden.scene_96x128()
    cfg = _config(method)
    seg = slic.segment(torch.from_numpy(color)[None], pts,
                       torch.from_numpy(want["normals"])[None], grid=cfg.grid,
                       params=cfg.nasp, seeds=torch.from_numpy(want["seeds"]))
    np.testing.assert_array_equal(seg.labels[0].numpy(), want["nasp_labels"])
    merged = ccl.merge_normals(seg.labels, seg.clusters.normal, seg.clusters.center, cfg.ccl,
                               index=slic.label_index(seg.labels, cfg.grid, cfg.nasp))
    np.testing.assert_array_equal(merged.labels[0].numpy(), want["merged_labels"])
    np.testing.assert_array_equal(merged.sizes[0].numpy(), want["merged_sizes"])


@pytest.mark.parametrize("method", golden.NORMAL_METHODS)
def test_methods_skip_the_unused_kernels(method, monkeypatch):
    """bilateral skips the smoothing map (no DT, no covariance sweep); SDC
    reads its window sizes from the DT and runs no covariance sweep."""
    calls = []

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran under normals.method={method!r}")
        return fn

    monkeypatch.setattr(cuda_cov, "cm_covariances", refuse("cm_covariances"))
    if method == "bilateral":
        monkeypatch.setattr(cuda_dt, "distance_transform", refuse("distance_transform"))
    else:
        dt = cuda_dt.distance_transform
        monkeypatch.setattr(cuda_dt, "distance_transform",
                            lambda *a, **k: calls.append(1) or dt(*a, **k))
    _, pts = _jax_points(method)
    out = tn.generate_normal_map(pts, NormalParams(method=method))
    assert out.shape == pts.shape and calls == ([1] if method == "sdc" else [])


def _jax_cm_640x480():
    """The JAX package's cm outputs on the 640x480 frame, keyed as
    golden.kde_gates reads the port's."""
    cm = golden.load_jax_640x480()
    got = {k: cm[k] for k in ("normals", "nasp_labels", "merged_labels", "optimized_points")}
    return cm, dict(got, jbf_depth=cm["jbf"])


@pytest.mark.parametrize("method", golden.NORMAL_METHODS)
def test_640x480_bars_reject_the_cm_outputs(method):
    """golden.normal_method_gates tells the methods apart at 640x480: the
    JAX package's cm outputs of the same frame, put in the method's place,
    fail its normal-direction and NASP-label bars (measured 0.6959 and
    0.8801 against SDC's 0.97 / 0.95; 0.3053 and 0.8220 against
    bilateral's 0.995 / 0.995).  The end-point gates cannot: see
    test_640x480_end_point_ignores_the_normal_method."""
    _, got = _jax_cm_640x480()
    gates = golden.normal_method_gates(method, got, golden.load_jax_normals("640x480", method))
    assert not gates["normal_direction_agreement"][2], gates
    assert not gates["nasp_label_agreement"][2], gates


def test_640x480_end_point_ignores_the_normal_method():
    """On the 640x480 frame the JAX package's plane stage moves no pixel
    under any method: its optimized z is the final depth bilateral
    (plane.depth_bilateral) of the JBF points alone, within 2e-3 mm
    (measured 1.2e-3: f32 rounding between the packages).  So
    optimized_within_1mm and optimized_q999_mm hold the JBF there, not the
    normals; the normal and NASP-label gates hold the method.  Which of
    variance_optimization's gates closes each merged cluster, chip_smoke.py
    reads on the card."""
    cm, _ = _jax_cm_640x480()
    intr = default_kinect_intrinsics(640, 480)
    pts = projective_to_real(torch.from_numpy(cm["jbf"])[None], intr)
    z = plane.depth_bilateral(pts, normalized_rays(intr, 480, 640),
                              KDEConfig().projection)[0, ..., 2].numpy()
    for method in ("cm",) + golden.NORMAL_METHODS:
        want = cm if method == "cm" else golden.load_jax_normals("640x480", method)
        np.testing.assert_allclose(want["optimized_points"][..., 2], z, rtol=0, atol=2e-3)
