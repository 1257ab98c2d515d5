"""The composed-oracle gates for a KDE result, and the JAX fixtures.

The JAX package's tests/test_oracle_pipeline.py holds its kde_pipeline
against the NumPy oracle's outputs, committed as tests/golden/
kde_oracle_96x128_seed0{,_refexact}.npz.  These functions apply the same
thresholds (test_oracle_pipeline.py:68-116 and :150-155) to the port's
result, so the CPU tests and chip_smoke.py hold the port to the same bar.
The same gates hold the port against the JAX package's own kde_pipeline
outputs, written by tests/gen_torch_fixtures.py: at 640x480 with
KDEConfig() (kde_jax_640x480_seed0.npz) and at 96x128 under four more
configs (kde_jax_96x128_ext_seed0.npz).  The fixtures are only read
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
