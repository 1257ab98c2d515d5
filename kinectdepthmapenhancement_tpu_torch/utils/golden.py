"""The composed-oracle gates for a KDE result, the gates of the DASP / ERS
pipelines (RGBF, SPDSP, TOF), and the JAX fixtures.

The JAX package's tests/test_oracle_pipeline.py holds its kde_pipeline
against the NumPy oracle's outputs, committed as tests/golden/
kde_oracle_96x128_seed0{,_refexact}.npz.  These functions apply the same
thresholds (test_oracle_pipeline.py:68-116 and :150-155) to the port's
result, so the CPU tests and chip_smoke.py hold the port to the same bar.
The same gates hold the port against the JAX package's own kde_pipeline
outputs, written by tests/gen_torch_fixtures.py: at 640x480 with
KDEConfig() (kde_jax_640x480_seed0.npz) and at 96x128 under four more
configs (kde_jax_96x128_ext_seed0.npz); and the JAX package's
rgbf_pipeline, spdsp_pipeline and tof_pipeline at 96x128 and 640x480
(dasp_jax_{96x128,640x480}_seed0.npz).  The fixtures are only read
(np.load): tests/golden.py rewrites a fixture whose key differs, so nothing
here goes through it.

Each gate returns {name: (value, limit, passed)}.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    normalized_rays,
)
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene

FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden",
)
Gate = Dict[str, Tuple[float, float, bool]]


def scene_96x128():
    """(intr, color, noisy) exactly as test_oracle_pipeline.py:38-41 builds
    them; the grid is GridParams(rows=3, cols=4)."""
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    return intr, color, noisy


def load_fixture(refexact: bool) -> Dict[str, np.ndarray]:
    name = "kde_oracle_96x128_seed0" + ("_refexact" if refexact else "")
    with np.load(os.path.join(FIXTURES, name + ".npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__key__"}


def _jax_outputs(z, prefix: str, intr: Intrinsics) -> Dict[str, np.ndarray]:
    """A JAX fixture's arrays keyed as kde_gates reads them: labels as i32,
    normals as f32, optimized_points rebuilt from the stored depth along
    the unit-z rays (the pipeline's last step is rays * z)."""
    h, w = z["jbf_depth"].shape
    out = {k: z[k] for k in z.files if "__" not in k}
    out.update({k.split("__", 1)[1]: z[k] for k in z.files if k.startswith(prefix + "__")})
    for k in ("nasp_labels", "merged_labels", "seeds"):
        if k in out:
            out[k] = out[k].astype(np.int32)
    if "normals" in out:
        out["normals"] = out["normals"].astype(np.float32)
    out["jbf"] = out["jbf_depth"]
    rays = normalized_rays(intr, h, w).numpy()
    out["optimized_points"] = rays * out.pop("optimized_z")[..., None]
    return out


def load_jax_640x480() -> Dict[str, np.ndarray]:
    """The JAX kde_pipeline(KDEConfig()) outputs on make_noisy_scene(480,
    640, seed=0), with the JAX seeds of that run ("seeds", [K, 2] (x, y))
    and its normals (stored as f16)."""
    with np.load(os.path.join(FIXTURES, "kde_jax_640x480_seed0.npz")) as z:
        return _jax_outputs(z, "", default_kinect_intrinsics(640, 480))


EXT_CONFIGS = ("plane_merge", "fill_holes", "grid5x6", "iter3")  # gen_torch_fixtures.ext_configs


def load_jax_ext(name: str) -> Dict[str, np.ndarray]:
    """The JAX kde_pipeline outputs on scene_96x128() under one of
    EXT_CONFIGS (tests/gen_torch_fixtures.py::ext_configs), with its
    merged_sizes."""
    with np.load(os.path.join(FIXTURES, "kde_jax_96x128_ext_seed0.npz")) as z:
        return _jax_outputs(z, name, default_kinect_intrinsics(128, 96))


def _endpoint_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    gates: Gate = {}
    got_l = got["nasp_labels"]
    agree = float((got_l == want["nasp_labels"]).mean())
    gates["nasp_label_agreement"] = (agree, 0.995, agree > 0.995)
    diff = np.abs(got["optimized_points"] - want["optimized_points"]).max(-1)
    within = float((diff < 1.0).mean())
    gates["optimized_within_1mm"] = (within, 0.99, within > 0.99)
    q = float(np.quantile(diff, 0.999))
    gates["optimized_q999_mm"] = (q, 120.0, q < 120.0)
    return gates


def kde_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    """Default-gate fixture (test_oracle_pipeline.py:68-116)."""
    gates: Gate = {}
    jd = np.abs(got["jbf_depth"] - want["jbf"]) - 2e-4 * np.abs(want["jbf"])
    worst = float(jd.max())
    gates["jbf_allclose_excess_mm"] = (worst, 0.25, worst <= 0.25)

    got_n, wn = got["normals"], want["normals"]
    gv, wv = (got_n != -1.0).any(-1), (wn != -1.0).any(-1)
    flags = float((gv == wv).mean())
    gates["normal_flags_match"] = (flags, 0.995, flags > 0.995)
    both_zero = (np.linalg.norm(got_n, axis=-1) < 1e-6) & (np.linalg.norm(wn, axis=-1) < 1e-6)
    ok = both_zero | (np.abs(np.sum(got_n * wn, axis=-1)) > 0.999)
    frac = float(ok[gv & wv].mean())
    gates["normal_direction_agreement"] = (frac, 0.995, frac > 0.995)

    gates.update(_endpoint_gates(got, want))

    got_l, got_m, want_m = got["nasp_labels"], got["merged_labels"], want["merged_labels"]
    stable = got_l == want["nasp_labels"]
    inv = float(((got_m < 0) == (want_m < 0))[stable].mean())
    gates["merged_invalid_agreement"] = (inv, 0.995, inv > 0.995)
    part, total = partition_agreement(got_m[stable], want_m[stable])
    gates["merged_partition_agreement"] = (part, 0.995, total > 0 and part > 0.995)
    return gates


def partition_agreement(got_m: np.ndarray, want_m: np.ndarray) -> Tuple[float, int]:
    """Share of pixels labelled in both merged partitions whose got label
    maps to the want label its first pixel fixed, and that pixel count."""
    pairs: Dict[int, int] = {}
    ok_pairs = total = 0
    for g, w_ in zip(got_m.ravel(), want_m.ravel()):
        if g >= 0 and w_ >= 0:
            total += 1
            ok_pairs += pairs.setdefault(int(g), int(w_)) == w_
    return (ok_pairs / total if total else 0.0), total


def kde_refexact_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    """Reference-exact fixture, max_plane_residual=inf
    (test_oracle_pipeline.py:150-155)."""
    return _endpoint_gates(got, want)


def far_range_gates(
    z_jbf: np.ndarray, z_kde: np.ndarray, z_pm: np.ndarray, pm_labels: np.ndarray,
    gt: np.ndarray, k: int,
) -> Tuple[Gate, Dict[str, float]]:
    """The far-range gate of tests/test_oracle_pipeline.py:230-287 on
    make_banded_scene(480, 640, seed=0): depths [H, W] of jbf_pipeline,
    kde_pipeline(KDEConfig()) and kde_pipeline with plane_merge=True, the
    latter's merged labels, the true depth.  KDE RMSE < 0.9 x the JBF's;
    plane merge < 0.98 x the KDE's; the dominant merged component
    > 100000 px with an RMSE < 1.5 mm; > 99% valid pixels.  Returns the
    gates and the three depth RMSEs (mm)."""

    def rmse(z):
        v = z > 50.0
        return float(np.sqrt(np.mean((z[v] - gt[v]) ** 2))), float(v.mean())

    (rm_jbf, vj), (rm_kde, vk), (rm_pm, _) = rmse(z_jbf), rmse(z_kde), rmse(z_pm)
    sizes = np.bincount(pm_labels[pm_labels >= 0], minlength=k)
    big = int(np.argmax(sizes))
    wall = (pm_labels == big) & (z_pm > 50.0)
    rm_wall = float(np.sqrt(np.mean((z_pm[wall] - gt[wall]) ** 2)))
    gates = {
        "valid_share": (min(vj, vk), 0.99, vj > 0.99 and vk > 0.99),
        "kde_over_jbf_rmse": (rm_kde / rm_jbf, 0.9, rm_kde < rm_jbf * 0.9),
        "plane_merge_over_kde_rmse": (rm_pm / rm_kde, 0.98, rm_pm < rm_kde * 0.98),
        "wall_px": (float(sizes[big]), 100000.0, bool(sizes[big] > 100000)),
        "wall_rmse_mm": (rm_wall, 1.5, rm_wall < 1.5),
    }
    return gates, {"jbf": rm_jbf, "kde": rm_kde, "plane_merge": rm_pm}


def failures(gates: Gate) -> Dict[str, Tuple[float, float, bool]]:
    return {k: v for k, v in gates.items() if not v[2]}


# ------------------------------------------------ RGBF, SPDSP and TOF


def load_dasp(size: str) -> Dict[str, np.ndarray]:
    """tests/gen_torch_fixtures.py's dasp fixture, "96x128" or "640x480":
    {"seeds", "<pipeline>__<field>"} with labels as i32."""
    with np.load(os.path.join(FIXTURES, f"dasp_jax_{size}_seed0.npz")) as z:
        return {k: z[k].astype(np.int32) if z[k].dtype == np.int16 else z[k] for k in z.files}


def load_rgbf_oracle() -> Dict[str, np.ndarray]:
    """The NumPy oracle's RGBF outputs on scene_96x128(), grid 3x4."""
    with np.load(os.path.join(FIXTURES, "rgbf_oracle_96x128_seed0.npz")) as z:
        return {k: z[k] for k in z.files if k != "__key__"}


def rgbf_oracle_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    """test_oracle_pipeline.py:195-228: the colour SLIC exact (its inputs are
    bit-identical), the depth SLIC on > 99.5% and the refined labels on
    > 99% of pixels (f32 against f64 points), the refined depth within
    0.5 mm on > 99% of pixels and its 99.9% quantile below 400 mm
    (zeroing-command flips)."""
    gates: Gate = {}
    same = float((got["color_labels"] == want["color_labels"]).mean())
    gates["color_labels_equal"] = (same, 1.0, same == 1.0)
    for f, lim in (("depth_labels", 0.995), ("refined_labels", 0.99)):
        agree = float((got[f] == want[f]).mean())
        gates[f"{f}_agreement"] = (agree, lim, agree > lim)
    dd = np.abs(got["refined_depth"] - want["refined_depth"])
    within = float((dd < 0.5).mean())
    gates["refined_within_0.5mm"] = (within, 0.99, within > 0.99)
    q = float(np.quantile(dd, 0.999))
    gates["refined_q999_mm"] = (q, 400.0, q < 400.0)
    return gates


def dasp_jax_gates(name: str, got: Mapping[str, np.ndarray],
                   want: Mapping[str, np.ndarray]) -> Gate:
    """One pipeline's output (name "rgbf", "spdsp" or "tof"; got keyed by
    its result fields, [H, W] numpy) against the JAX package's run of the
    same frame in a dasp fixture: every stored label map on > 99.5% of
    pixels (colour seeds can fall the other way at gradient near-ties), and
    each stored depth map (SPDSP's optimized z, TOF's plane-fitted z, and
    RGBF's refined depth where stored) within 1 mm on > 99% of pixels with
    its 99.9% quantile below 120 mm, kde_gates' bars."""
    gates: Gate = {}
    pre = name + "__"
    for key in sorted(k for k in want if k.startswith(pre)):
        field = key[len(pre):]
        if field.endswith("labels") and field in got:
            agree = float((got[field] == want[key]).mean())
            gates[f"{field}_agreement"] = (agree, 0.995, agree > 0.995)
    maps = {"refined_depth": "refined_depth", "optimized_z": "optimized_points",
            "plane_fitted_z": "plane_fitted"}
    for field, src in maps.items():
        if pre + field not in want or src not in got:
            continue
        z = got[src] if got[src].ndim == 2 else got[src][..., 2]
        dd = np.abs(z - want[pre + field])
        within = float((dd < 1.0).mean())
        gates[f"{field}_within_1mm"] = (within, 0.99, within > 0.99)
        q = float(np.quantile(dd, 0.999))
        gates[f"{field}_q999_mm"] = (q, 120.0, q < 120.0)
    return gates


def rgbf_quality_gates(refined_depth: np.ndarray, gt: np.ndarray) -> Gate:
    """tests/test_pipelines.py:68-80: more than half the refined pixels
    valid, their median within 200 mm of the ground truth's."""
    valid = refined_depth > 50.0
    share = float(valid.mean())
    med = abs(float(np.median(refined_depth[valid])) - float(np.median(gt[gt > 0])))
    return {"valid_share": (share, 0.5, share > 0.5),
            "median_offset_mm": (med, 200.0, med < 200.0)}


def spdsp_quality_gates(err_in: float, err_ers: float, err_out: float, n: int) -> Gate:
    """tests/test_pipelines.py:108-134 at 640x480: mean 3-D errors (mm) of
    the input, the ERS-refined and the optimized points against ground
    truth, over n valid refined points."""
    return {
        "valid_points": (float(n), 200000.0, n > 200000),
        "ers_over_input": (err_ers / err_in, 1.0, err_ers < err_in),
        "ers_error_mm": (err_ers, 1.2, err_ers < 1.2),
        "output_error_mm": (err_out, 3.0, err_out < 3.0),
    }


def tof_quality_gates(plane_fitted_z: np.ndarray, gt: np.ndarray) -> Gate:
    """tests/test_pipelines.py:137-157 at 640x480: the plane-fitted depth
    on ground-truth-flat pixels (> 80000 of them) within a 12 mm RMSE."""
    gy, gx = np.gradient(gt)
    flat = (np.abs(gy) + np.abs(gx)) < 0.5
    m = flat & (plane_fitted_z > 50.0) & (plane_fitted_z < 15000.0) & (gt > 50.0)
    rmse = float(np.sqrt(np.mean((plane_fitted_z - gt)[m] ** 2))) if m.any() else float("inf")
    return {"flat_pixels": (float(m.sum()), 80000.0, int(m.sum()) > 80000),
            "plane_rmse_mm": (rmse, 12.0, rmse < 12.0)}
