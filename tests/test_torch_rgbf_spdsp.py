"""PyTorch port: rgbf_pipeline, spdsp_pipeline and tof_pipeline
(models/pipelines.py) against the JAX package's runs at 96x128, grid 3x4
(tests/golden/dasp_jax_96x128_seed0.npz, written by
tests/gen_torch_fixtures.py dasp) and against the NumPy oracle's RGBF
(tests/golden/rgbf_oracle_96x128_seed0.npz), on the CPU.

Bars against the JAX runs, with the JAX seeds injected and without (the
colour seeds are equal here): every label map EXACT (the colour and depth
SLICs, the refined labels, TOF's merged labels); the refined depth within
rtol 2e-6 (measured 7.3e-7); the PCA planes' normals within 1e-5 (7.2e-7)
and d within rtol 1e-5 (9.2e-7); SPDSP's plane-fitted and optimized z
and TOF's plane-fitted z within rtol 5e-6 (measured 2.0e-6 after the 20
MRF sweeps); TOF's merged eigenvalues within rtol 1e-4 / 1e-3 (9.2e-4 at
~500).  The float differences are ulps: XLA on the CPU contracts FMAs, the
port does not, and the port sums cell-local where the JAX package sums
by one-hot products.  Against the oracle: test_oracle_pipeline.py:195-228's
gates (golden.rgbf_oracle_gates).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu.core import config as jconfig
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.core.camera import normalized_rays, projective_to_real
from kinectdepthmapenhancement_tpu_torch.core.config import (
    GridParams, RGBFConfig, SPDSPConfig, TOFConfig,
)
from kinectdepthmapenhancement_tpu_torch.models import pipelines as tp
from kinectdepthmapenhancement_tpu_torch.ops import plane as tplane
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts
from kinectdepthmapenhancement_tpu_torch.utils import golden

torch.set_num_threads(2)

GRID = GridParams(rows=3, cols=4)
CFGS = {
    "rgbf": dataclasses.replace(RGBFConfig(), grid=GRID),
    "spdsp": dataclasses.replace(SPDSPConfig(), grid=GRID),
    "tof": dataclasses.replace(TOFConfig(), grid=GRID),
}


@pytest.fixture(scope="module")
def scene():
    intr, color, noisy = golden.scene_96x128()
    d, c = torch.from_numpy(noisy), torch.from_numpy(color)
    return intr, d, c, projective_to_real(d, intr), golden.load_dasp("96x128")


def _run(name, scene, cfg=None):
    intr, d, c, pts, _ = scene
    cfg = cfg or CFGS[name]
    if name == "rgbf":
        return tp.rgbf_pipeline(d, pts, c, cfg)
    return getattr(tp, f"{name}_pipeline")(d, pts, c, intr, cfg)


@pytest.fixture(params=[False, True], ids=["sampled_seeds", "jax_seeds"])
def seeds(request, scene, monkeypatch):
    """With "jax_seeds", both DASP segmentations take the JAX run's seeds."""
    if request.param:
        jax_seeds = torch.from_numpy(scene[4]["seeds"])[None]
        monkeypatch.setattr(ts, "_compute_seeds", lambda *a, **k: jax_seeds)
    return request.param


def _rel(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("name", ["rgbf", "spdsp", "tof"])
def test_pipeline_matches_jax_96x128(scene, seeds, name):
    want = scene[4]
    res = _run(name, scene)
    pre = name + "__"
    if name == "tof":  # TOF's front end is SPDSP's
        for f in ("refined_labels", "refined_depth"):
            want = dict(want, **{pre + f: want["spdsp__" + f]})
    for f in ("color_labels", "depth_labels", "refined_labels", "merged_labels"):
        if hasattr(res, f):
            np.testing.assert_array_equal(getattr(res, f).numpy(), want[pre + f])
    _rel(res.refined_depth.numpy(), want[pre + "refined_depth"], 2e-6)
    if name == "spdsp":
        nd, wnd = res.planes_nd.numpy(), want[pre + "planes_nd"]
        np.testing.assert_allclose(nd[:, :3], wnd[:, :3], atol=1e-5)
        _rel(nd[:, 3], wnd[:, 3], 1e-5)
        _rel(res.optimized_points.numpy()[..., 2], want[pre + "optimized_z"], 5e-6)
    if name != "rgbf":
        _rel(res.plane_fitted.numpy()[..., 2], want[pre + "plane_fitted_z"], 5e-6)
    if name == "tof":
        np.testing.assert_allclose(res.merged_eigenvalues.numpy(),
                                   want[pre + "merged_eigenvalues"], rtol=1e-4, atol=1e-3)
        assert torch.equal(res.optimized_points, projective_to_real(res.refined_depth, scene[0]))


def test_rgbf_matches_oracle(scene):
    """test_oracle_pipeline.py:195-228's gates against the NumPy oracle."""
    res = _run("rgbf", scene)
    got = {f: getattr(res, f).numpy() for f in res._fields}
    gates = golden.rgbf_oracle_gates(got, golden.load_rgbf_oracle())
    assert not golden.failures(gates), gates


def test_spdsp_inf_mode_equals_all_true_gate(scene):
    """max_plane_residual=inf is the reference's ungated composition
    (test_oracle_pipeline.py:159-192): from the same refined stages, the
    port's pipeline equals set_pseudo_depth_cluster + mrf_optimization with
    no gate and with an all-true gate, bitwise (one program, no fusion
    drift)."""
    intr, d, _, _, _ = scene
    cfg = dataclasses.replace(CFGS["spdsp"], max_plane_residual=math.inf)
    res = _run("spdsp", scene, cfg)
    rays = normalized_rays(intr, *d.shape)
    rpoints = projective_to_real(res.refined_depth, intr)[None]
    labels = res.refined_labels[None]
    idx = tp._local_index(labels, cfg)
    fitted = tplane.set_pseudo_depth_cluster(rpoints, rays, res.planes_nd[None], labels,
                                            strict=False, index=idx)
    for gate in (None, torch.ones_like(labels, dtype=torch.bool)):
        want = tplane.mrf_optimization(rpoints, fitted, rays, cfg.projection, gate_mask=gate)
        assert torch.equal(res.optimized_points, want[0])
    gated = _run("spdsp", scene)
    assert not torch.equal(gated.optimized_points, res.optimized_points)


@pytest.mark.parametrize("name", ["rgbf", "spdsp", "tof"])
def test_batched_equals_per_frame(scene, name):
    """[B, H, W] frames (the scene and its left-right mirror) give each
    frame's result alone: labels exact, floats within rtol 1e-6 (batched
    products may block their sums differently)."""
    intr, d, c, pts, _ = scene
    d2 = torch.stack([d, d.flip(-1)])
    c2 = torch.stack([c, c.flip(-2)])
    p2 = projective_to_real(d2, intr)
    if name == "rgbf":
        both = tp.rgbf_pipeline(d2, p2, c2, CFGS[name])
    else:
        both = getattr(tp, f"{name}_pipeline")(d2, p2, c2, intr, CFGS[name])
    for i in range(2):
        one = (tp.rgbf_pipeline(d2[i], p2[i], c2[i], CFGS[name]) if name == "rgbf" else
               getattr(tp, f"{name}_pipeline")(d2[i], p2[i], c2[i], intr, CFGS[name]))
        for f in one._fields:
            a, b = getattr(both, f)[i], getattr(one, f)
            if a.dtype == torch.int32:
                assert torch.equal(a, b), f
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("locality", ["cell", "global"])
def test_local_index_routes_agree(scene, locality):
    """The ERS labels' index: "auto" takes the cell index at r = 4 here (the
    labels lie within the cap of 4); "cell" (unchecked) and "global" give
    the same labels, the floats to the module's bars; a label outside the
    cap sends "auto" to the global index."""
    auto = _run("tof", scene)
    cfg = dataclasses.replace(CFGS["tof"], depth_slic=dataclasses.replace(
        CFGS["tof"].depth_slic, locality=locality))
    other = _run("tof", scene, cfg)
    for f in ("refined_labels", "merged_labels"):
        assert torch.equal(getattr(auto, f), getattr(other, f))
    _rel(other.plane_fitted.numpy(), auto.plane_fitted.numpy(), 5e-6)
    labels = auto.refined_labels[None]
    assert isinstance(tp._local_index(labels, CFGS["tof"]), ts._CellIndex)
    assert tp._local_index(labels, CFGS["tof"]).r == 4
    assert isinstance(tp._local_index(labels, cfg), ts._CellIndex if locality == "cell"
                      else ts._GlobalIndex)
    wide = dataclasses.replace(CFGS["tof"], grid=GridParams(rows=3, cols=8))
    far8 = torch.zeros_like(labels)
    far8[0, :, :16] = 7  # the first column of cells claims cluster (0, 7): dx = 7 > 3
    assert isinstance(tp._local_index(far8, wide), ts._GlobalIndex)


def test_configs_carry_across_from_jax():
    """convert.config_from_jax carries RGBF / SPDSP / TOF configs with
    non-default fields, nested SLIC, ERS, projection and PCA-merge
    parameters included."""
    j = dataclasses.replace(
        jconfig.TOFConfig(), grid=jconfig.GridParams(rows=3, cols=4),
        depth_slic=jconfig.SLICParams(0.0, 11.0, 190.0, 0.0, 4, locality="cell"),
        ers=jconfig.ERSParams(window=5), ccl_pca=jconfig.CCLPCAParams(plane_offset_max=650.0),
        projection=jconfig.ProjectionParams(mrf_iterations=7), max_plane_residual=math.inf)
    t = convert.config_from_jax(j)
    assert type(t) is TOFConfig and dataclasses.asdict(t) == dataclasses.asdict(j)
    for cls in (jconfig.RGBFConfig, jconfig.SPDSPConfig):
        assert type(convert.config_from_jax(cls())).__name__ == cls.__name__
