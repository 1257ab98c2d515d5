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
configs (kde_jax_96x128_ext_seed0.npz) and with the "sdc" and
"bilateral" normal methods at both sizes (kde_jax_{96x128,640x480}_
normals_seed0.npz, which also holds mrf_pipeline at 640x480); and the JAX
package's rgbf_pipeline, spdsp_pipeline and tof_pipeline at 96x128 and
640x480 (dasp_jax_{96x128,640x480}_seed0.npz); and the plane stage where
it moves pixels (kde_jax_planes_seed0.npz: plane merge
and hole fill under the cm and SDC normals on the far-range frame) and
depth-to-colour registration at 640x480
(registration_jax_640x480_seed0.npz); and the JAX package's parallel/:
the JBF on width tiles and the sharded KDE step at 96x128
(parallel_jax_seed0.npz).  The fixtures are only read (np.load):
tests/golden.py rewrites a fixture whose key differs, so nothing here goes
through it.

Each gate returns {name: (value, limit, passed)}.  plain_nasp swaps the
NASP kernel wrappers for their plain versions, the card's reference.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    normalized_rays,
)
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.ops import cuda_nasp

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
    """A JAX fixture's arrays (an npz or a dict) keyed as kde_gates reads
    them: labels as i32, normals as f32, optimized_points rebuilt from the
    stored depth along the unit-z rays (the pipeline's last step is
    rays * z)."""
    names = list(getattr(z, "files", z))
    out = {k: z[k] for k in names if "__" not in k}
    out.update({k.split("__", 1)[1]: z[k] for k in names if k.startswith(prefix + "__")})
    h, w = out["jbf_depth"].shape
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


NORMAL_METHODS = ("sdc", "bilateral")  # gen_torch_fixtures.NORMAL_METHODS


def load_jax_normals(size: str, method: str) -> Dict[str, np.ndarray]:
    """The JAX kde_pipeline outputs with normals.method `method`, keyed as
    kde_gates reads them: at "96x128" on scene_96x128() (grid 3x4, with
    merged_sizes and the full normals); at "640x480" on the frame of
    load_jax_640x480() (KDEConfig()'s grid), whose JBF depth is that
    fixture's, with the normals' validity ("normal_valid", [H, W]) and the
    normals on every 4th row and column ("normals_sub4") in place of the
    normals."""
    if size == "96x128":
        with np.load(os.path.join(FIXTURES, "kde_jax_96x128_normals_seed0.npz")) as z:
            return _jax_outputs(z, method, default_kinect_intrinsics(128, 96))
    with np.load(os.path.join(FIXTURES, "kde_jax_640x480_normals_seed0.npz")) as z, \
            np.load(os.path.join(FIXTURES, "kde_jax_640x480_seed0.npz")) as cm:
        arrays = {f"{method}__{k}": cm[k] for k in ("jbf_depth", "optimized_z")}
        arrays.update({k: z[k] for k in z.files if k.startswith(method + "__")})
    arrays[f"{method}__optimized_z"] = (arrays[f"{method}__optimized_z"]
                                        + arrays.pop(f"{method}__optimized_z_minus_cm"))
    out = _jax_outputs(arrays, method, default_kinect_intrinsics(640, 480))
    out["normal_valid"] = np.unpackbits(out["normal_valid"])[: 480 * 640].reshape(480, 640) > 0
    out["normals_sub4"] = out["normals_sub4"].astype(np.float32)
    return out


def load_jax_mrf_640x480() -> np.ndarray:
    """The JAX mrf_pipeline output on the frame of load_jax_640x480()."""
    with np.load(os.path.join(FIXTURES, "kde_jax_640x480_normals_seed0.npz")) as z:
        return z["mrf__depth"]


def load_jax_parallel() -> Dict[str, object]:
    """The JAX package's parallel/ outputs (tests/golden/parallel_jax_seed0.npz,
    gen_torch_fixtures.py parallel): "jbf_sharded" ([48, 64] f32, spatial
    8) and "kde", one dict a frame of the 96x128 batch (seeds 0..3, grid
    3x4), keyed as kde_gates reads it: the sharded step's optimized points,
    the unsharded run's JBF depth, normals and label maps."""
    with np.load(os.path.join(FIXTURES, "parallel_jax_seed0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    intr = default_kinect_intrinsics(128, 96)
    frames = [_jax_outputs({k: v[i] for k, v in arrays.items() if k.startswith("kde__")},
                           "kde", intr)
              for i in range(arrays["kde__optimized_z"].shape[0])]
    return {"jbf_sharded": arrays["jbf_sharded"], "kde": frames}


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

    got_n = got["normals"]
    gv = (got_n != -1.0).any(-1)
    if "normals" in want:
        wn = want["normals"]
        wv = (wn != -1.0).any(-1)
        flags = float((gv == wv).mean())
    else:  # the validity at every pixel, the normals on every 4th row and column
        flags = float((gv == want["normal_valid"]).mean())
        got_n, wn = got_n[::4, ::4], want["normals_sub4"]
        gv, wv = gv[::4, ::4], want["normal_valid"][::4, ::4]
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


# SDC's bars at 640x480 against the JAX package: the SDC normal is
# ill-conditioned in the f32 summed-area tables, which the two packages sum
# in different orders (ops/integral.py).  On make_noisy_scene(480, 640,
# seed=0), the port on the CPU: normal directions agree on 0.9820 of the
# pixels and NASP labels on 0.9716 (52 of 300 seeds move; 0.9887 with the
# JAX seeds), while the merged partition and the optimized points pass
# kde_gates' bars (1.0 and 1.0).
SDC_640X480_BARS = {"normal_direction_agreement": 0.97, "nasp_label_agreement": 0.95}


def normal_method_gates(method: str, got: Mapping[str, np.ndarray],
                        want: Mapping[str, np.ndarray]) -> Gate:
    """kde_gates for KDE under normals.method `method` at 640x480 against
    load_jax_normals("640x480", method), with SDC_640X480_BARS for "sdc"."""
    gates = kde_gates(got, want)
    if method == "sdc":
        for name, lim in SDC_640X480_BARS.items():
            val = gates[name][0]
            gates[name] = (val, lim, val > lim)
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


# ------------------------------------------------ the plane stage where it acts

PLANE_RUNS = ("cm_pm", "cm_pm_fill", "sdc_pm", "sdc_pm_fill")  # gen_torch_fixtures.plane_configs
MOVED_MM = 0.01  # gen_torch_fixtures.MOVED_MM


def plane_configs(grid=None) -> Dict[str, "KDEConfig"]:
    """The port's KDEConfig of each of PLANE_RUNS (tests/gen_torch_fixtures.py::
    plane_configs): plane_merge=True, and with fill_holes=4, under the
    "cm" and "sdc" normals, on `grid` (default 15x20)."""
    import dataclasses

    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig

    base = KDEConfig() if grid is None else dataclasses.replace(KDEConfig(), grid=grid)
    out = {}
    for name in PLANE_RUNS:
        method = name.split("_", 1)[0]
        cfg = dataclasses.replace(base, plane_merge=True, normals=dataclasses.replace(
            base.normals, method=method))
        out[name] = dataclasses.replace(cfg, fill_holes=4) if name.endswith("fill") else cfg
    return out


def plane_stage_maps(res, sensor, intr: Intrinsics, cfg) -> Dict[str, np.ndarray]:
    """A KDEResult of one frame as the planes fixture keys it: the optimized
    depth, the merged labels, the pixels the plane stage moved (whose output
    point lies more than MOVED_MM from the final depth bilateral of the JBF
    points alone) and the input holes (sensor <= 50 mm) with depth in the
    output."""
    from kinectdepthmapenhancement_tpu_torch.core.camera import projective_to_real
    from kinectdepthmapenhancement_tpu_torch.ops import plane

    h, w = res.jbf_depth.shape
    rays = normalized_rays(intr, h, w, res.jbf_depth.device)
    base = plane.depth_bilateral(projective_to_real(res.jbf_depth[None], intr), rays,
                                 cfg.projection)[0]
    opt = res.optimized_points
    out = {"optimized_z": opt[..., 2], "merged_labels": res.merged_labels,
           "moved": (base - opt).abs().amax(-1) > MOVED_MM}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["filled"] = (out["optimized_z"] > 50.0) & (np.asarray(sensor) <= 50.0)
    return out


def load_jax_planes(size: str, name: str) -> Dict[str, np.ndarray]:
    """The planes fixture's maps of run `name` (one of PLANE_RUNS) at size
    "640x480" or "96x128", keyed as plane_stage_maps returns them."""
    h, w = (480, 640) if size == "640x480" else (96, 128)
    pre = f"{h}x{w}__{name}__"
    with np.load(os.path.join(FIXTURES, "kde_jax_planes_seed0.npz")) as z:
        out = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
        if "optimized_z_minus_first" in out:
            out["optimized_z"] = (z[f"{h}x{w}__{PLANE_RUNS[0]}__optimized_z"]
                                  + out.pop("optimized_z_minus_first"))
    for k in ("moved", "filled"):
        out[k] = np.unpackbits(out[k])[: h * w].reshape(h, w) > 0
    out["merged_labels"] = out["merged_labels"].astype(np.int32)
    return out


# lower bars on agreements, upper bars on differences and the quantile
PLANE_STAGE_BARS = {"moved_px_relative_difference": 0.01, "moved_mask_agreement": 0.99,
                    "filled_mask_agreement": 0.995, "merged_partition_agreement": 0.995,
                    "optimized_within_1mm": 0.99, "optimized_q999_mm": 120.0,
                    "rmse_relative_difference": 0.01}
# SDC's plane stage at 640x480 on the far-range frame is chaotic: its
# normals on the quantized bands turn on ulps of the summed-area tables.
# The JAX package against itself with only those tables summed in float64
# (as the port sums them), plane_merge (with fill_holes=4): 4.4% (4.3%)
# more pixels moved, moved masks equal on 0.950 (0.948), filled masks on
# 1.0 (0.9969), merged partitions agree on 0.759 (0.759), optimized depth
# within 1 mm on 0.956 (0.949) of pixels, its 99.9% quantile of the
# difference 7.5 mm (3600 mm: filled or not), RMSE to ground truth within
# 0.14% (0.22%) (tests/gen_torch_fixtures.py's runs beside the same runs
# with ops/integral.py's tables summed in float64).  The port is held at
# twice that spread; the partition and the quantile are reported, not held.
SDC_PLANES_640X480_BARS = dict(PLANE_STAGE_BARS, moved_px_relative_difference=0.1,
                               moved_mask_agreement=0.89, filled_mask_agreement=0.994,
                               merged_partition_agreement=None, optimized_within_1mm=0.89,
                               optimized_q999_mm=None)


def plane_stage_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray],
                      gt: np.ndarray, bars: Mapping[str, float] = PLANE_STAGE_BARS) -> Gate:
    """The port's plane_stage_maps against load_jax_planes of the same run
    and the true depth gt: the moved-pixel counts (relative difference),
    the moved and filled masks and the merged partitions (agreement), the
    optimized depth (share within 1 mm, the 99.9% quantile of the
    difference) and its RMSE to ground truth (relative difference), each
    to `bars` (a None bar is reported, not held)."""
    def rmse(z):
        v = (z > 50.0) & (gt > 50.0)
        return float(np.sqrt(np.mean((z[v] - gt[v]) ** 2)))

    n_got, n_want = int(got["moved"].sum()), int(want["moved"].sum())
    dz = np.abs(got["optimized_z"] - want["optimized_z"])
    vals = {
        "moved_px_relative_difference": abs(n_got - n_want) / max(n_want, 1),
        "moved_mask_agreement": float((got["moved"] == want["moved"]).mean()),
        "filled_mask_agreement": float((got["filled"] == want["filled"]).mean()),
        "merged_partition_agreement": partition_agreement(got["merged_labels"],
                                                          want["merged_labels"])[0],
        "optimized_within_1mm": float((dz < 1.0).mean()),
        "optimized_q999_mm": float(np.quantile(dz, 0.999)),
        "rmse_relative_difference": abs(rmse(got["optimized_z"]) / rmse(want["optimized_z"]) - 1),
    }
    gates: Gate = {}
    for name, val in vals.items():
        lim = bars[name]
        if lim is None:
            gates[name] = (val, float("nan"), True)
        elif name.endswith(("difference", "_mm")):
            gates[name] = (val, lim, val < lim and n_want > 0)
        else:
            gates[name] = (val, lim, val > lim)
    return gates


# ------------------------------------------------ depth-to-colour registration

def rotation_y(deg: float) -> np.ndarray:
    """f32 [3, 3] rotation by `deg` degrees about the y axis."""
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                     [-np.sin(a), 0.0, np.cos(a)]], np.float32)


def registration_extrinsics() -> Tuple[np.ndarray, np.ndarray]:
    """The registration fixture's depth -> colour transform (rotation [3, 3],
    t [3], f32): a 2 degree rotation about y and a 25 mm baseline."""
    return rotation_y(2.0), np.array([25.0, 0.0, 0.0], np.float32)


# a projected coordinate this close to .5 may round the other way in the
# other package (its operands differ by an ulp; an ulp of a coordinate
# below 1000 px is < 1.3e-4 px)
TIE_PX = 1e-3


def tie_pixels(uc: np.ndarray, vc: np.ndarray, h: int, w: int) -> np.ndarray:
    """[h, w] bool: the colour pixels that the points projected to (uc, vc)
    can land on, either way each coordinate rounds, for the points with a
    coordinate within TIE_PX of .5."""
    du, dv = np.abs(np.abs(uc % 1.0) - 0.5), np.abs(np.abs(vc % 1.0) - 0.5)
    near = (du < TIE_PX) | (dv < TIE_PX)
    touched = np.zeros((h, w), bool)
    for u, v in zip(uc[near], vc[near]):
        for ui in {int(np.floor(u)), int(np.ceil(u))}:
            for vi in {int(np.floor(v)), int(np.ceil(v))}:
                if 0 <= ui < w and 0 <= vi < h:
                    touched[vi, ui] = True
    return touched


def load_jax_registration() -> Dict[str, np.ndarray]:
    """The JAX register_depth_to_color of make_noisy_scene(480, 640, seed=0)'s
    noisy depth through registration_extrinsics(): "filled" [H, W] bool,
    "z_sub4" (every 4th row and column) and "touched", the tie_pixels of
    the fixture's near-tie points."""
    h, w = 480, 640
    with np.load(os.path.join(FIXTURES, "registration_jax_640x480_seed0.npz")) as z:
        out = {k: z[k] for k in z.files}
    out["filled"] = np.unpackbits(out["filled"])[: h * w].reshape(h, w) > 0
    out["touched"] = tie_pixels(out.pop("near_uc"), out.pop("near_vc"), h, w)
    return out


def registration_gates(got: np.ndarray, want: Mapping[str, np.ndarray]) -> Gate:
    """The port's registered depth [480, 640] against load_jax_registration():
    the filled pixels equal and the z map within 1 ulp (XLA's CPU dot forms
    the z component with fused multiply-adds) except at the touched pixels,
    whose differences are counted, not bounded."""
    keep = ~want["touched"]
    filled = (got > 0) != want["filled"]
    g4, w4 = got[::4, ::4], want["z_sub4"]
    ulp = np.abs(g4.view(np.int32).astype(np.int64) - w4.view(np.int32).astype(np.int64))
    gates: Gate = {
        "filled_differ_off_ties": (float((filled & keep).sum()), 0.0,
                                   not (filled & keep).any()),
        "z_sub4_max_ulp_off_ties": (float(ulp[keep[::4, ::4]].max()), 1.0,
                                    ulp[keep[::4, ::4]].max() <= 1),
        "filled_differ_at_ties": (float(filled.sum()), float("nan"), True),
        "touched_px": (float(want["touched"].sum()), float("nan"), True),
    }
    return gates


def failures(gates: Gate) -> Dict[str, Tuple[float, float, bool]]:
    return {k: v for k, v in gates.items() if not v[2]}


# ------------------------------------------- the NASP kernels' plain twins

# the ops/cuda_nasp.py wrappers that ops/slic.py calls, each with a
# <name>_plain twin of the same signature
PLAIN_NASP = ("label_cell_gather", "label_cell_sums", "label_counts", "label_pair_counts",
              "label_sums", "nasp_cell_sums", "nasp_assign_and_analyze", "assign_global")


@contextlib.contextmanager
def plain_nasp() -> Iterator[None]:
    """Inside the block each wrapper of PLAIN_NASP is its plain twin on
    every device: the one-hot products (and the chunked PyTorch sweep) on
    CUDA tensors, the reference that
    the card's tests and chip_smoke.py hold the kernels against.  A
    compiled call (core/jit.py) keys its graph by shapes and config, not by
    this swap, so run the plain side eagerly or through a jit.jit made
    inside the block."""
    saved = {name: getattr(cuda_nasp, name) for name in PLAIN_NASP}
    try:
        for name in PLAIN_NASP:
            setattr(cuda_nasp, name, getattr(cuda_nasp, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_nasp, name, fn)


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
