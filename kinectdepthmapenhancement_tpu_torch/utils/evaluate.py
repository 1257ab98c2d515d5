"""Single-frame evaluation harness, the reference's main() (main.cpp:158-309),
on tensors.

PyTorch counterpart of the JAX package's utils/evaluate.py: runs INPUT /
JBF / MRF / RGBF / KDE (and SPDSP / TOF on request) on one frame, times
each method and computes its mean 3-D error against a ground-truth depth,
and writes an `evaluation.txt` in the JAX package's layout.  Everything
runs on `device`, the card unless the caller asks for another (without a
card "cuda" raises); each time is that device's, so the caller names the
device beside it.

Usage:
    python -m kinectdepthmapenhancement_tpu_torch.utils.evaluate [out.txt]
    python -m kinectdepthmapenhancement_tpu_torch evaluate out.txt [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core import buffer2d, jit
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import (
    GridParams,
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu_torch.core.datasets import TUMSequence
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.utils import metrics, visualize
from kinectdepthmapenhancement_tpu_torch.utils.timing import time_pipeline


def method_runs(
    intr: Intrinsics,
    grid: Optional[GridParams] = None,
    *,
    include_sp_methods: bool = True,
    fill_steps: int = 0,
    plane_merge: bool = False,
) -> Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]]:
    """evaluate()'s rows, in order: name -> fn(depth, color) returning the
    method's point map [H, W, 3] (mm) on the inputs' device.  Every row is
    a compiled call (core/jit.py), as the JAX package jits each row; the
    RGBF, SPDSP and TOF rows take the raw points inside the call."""
    kde_cfg = KDEConfig() if grid is None else dataclasses.replace(KDEConfig(), grid=grid)
    rgbf_cfg = RGBFConfig() if grid is None else dataclasses.replace(RGBFConfig(), grid=grid)
    spdsp_cfg = SPDSPConfig() if grid is None else dataclasses.replace(SPDSPConfig(), grid=grid)
    tof_cfg = TOFConfig() if grid is None else dataclasses.replace(TOFConfig(), grid=grid)

    def kde(cfg):
        return jit.jit(lambda dd, cc: pipelines.kde_pipeline(dd, cc, intr, cfg).optimized_points)

    # each run takes (depth, color), so time_pipeline can feed fresh inputs
    runs = {
        "input": jit.jit(lambda dd, cc: projective_to_real(dd, intr)),
        "jbf": jit.jit(lambda dd, cc: projective_to_real(pipelines.jbf_pipeline(dd, cc), intr)),
        "mrf": jit.jit(lambda dd, cc: projective_to_real(pipelines.mrf_pipeline(dd, cc), intr)),
        "rgbf": jit.jit(lambda dd, cc: projective_to_real(pipelines.rgbf_pipeline(
            dd, projective_to_real(dd, intr), cc, rgbf_cfg).refined_depth, intr)),
        "kde": kde(kde_cfg),
    }
    if fill_steps > 0:
        runs["kde_fill"] = kde(dataclasses.replace(kde_cfg, fill_holes=fill_steps))
    if plane_merge:
        runs["kde_pm"] = kde(dataclasses.replace(kde_cfg, plane_merge=True))
        if fill_steps > 0:
            runs["kde_pm_fill"] = kde(dataclasses.replace(
                kde_cfg, plane_merge=True, fill_holes=fill_steps))
    if include_sp_methods:
        runs["spdsp"] = jit.jit(lambda dd, cc: pipelines.spdsp_pipeline(
            dd, projective_to_real(dd, intr), cc, intr, spdsp_cfg).optimized_points)
        runs["tof"] = jit.jit(lambda dd, cc: pipelines.tof_pipeline(
            dd, projective_to_real(dd, intr), cc, intr, tof_cfg).plane_fitted)
    return runs


def evaluate(
    depth: np.ndarray,
    color: np.ndarray,
    gt_depth: np.ndarray,
    *,
    include_sp_methods: bool = True,
    intr: Optional[Intrinsics] = None,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
    fill_steps: int = 0,
    plane_merge: bool = False,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Every method's {"time_ms", "mean_3d_error_mm", "rmse_mm",
    "valid_px"} on one frame (depth f32 [H, W] mm, color u8 [H, W, 3],
    gt_depth f32 [H, W] mm, NumPy arrays).

    fill_steps > 0 adds a "kde_fill" row: KDE with the label-consistent
    plane hole fill (KDEConfig.fill_holes).  plane_merge adds a "kde_pm"
    row (the plane-consistency merge, ops/ccl.py::merge_planes), and with
    fill_steps also "kde_pm_fill" (the fill fires only where cluster planes
    pass the confidence gates, which on far-range banded depth needs the
    plane merge).  Each method is timed by time_pipeline on inputs jittered
    by 1e-3 mm (fresh for every call) and scored on one more call on the
    frame itself, each a compiled call; figure_path writes the montage of
    the depth renders."""
    dev = resolve_device(device)
    h, w = depth.shape
    if intr is None:
        intr = default_kinect_intrinsics(w, h)
    d = torch.from_numpy(np.array(depth, dtype=np.float32)).to(dev)
    c = torch.from_numpy(np.array(color, dtype=np.uint8)).to(dev)
    gt = torch.from_numpy(np.array(gt_depth, dtype=np.float32)).to(dev)
    gt_pts = projective_to_real(gt, intr)
    runs = method_runs(intr, grid, include_sp_methods=include_sp_methods,
                       fill_steps=fill_steps, plane_merge=plane_merge)
    if methods is not None:
        unknown = set(methods) - set(runs)
        if unknown:
            raise ValueError(f"unknown methods {sorted(unknown)} (have {list(runs)})")
        runs = {k: v for k, v in runs.items() if k in methods}

    rng = np.random.default_rng(12345)

    def make_args(_i):
        jitter = rng.normal(0.0, 1e-3, depth.shape).astype(np.float32)
        return (torch.from_numpy(depth + jitter).to(dev), c)

    out: Dict[str, Dict[str, float]] = {}
    depth_renders = {}
    with torch.inference_mode():
        for name, fn in runs.items():
            stats = time_pipeline(fn, make_args, iters=timing_iters)
            pts = fn(d, c)
            err, n = metrics.mean_3d_error(pts, gt_pts)
            rmse = metrics.depth_rmse(pts[..., 2], gt)
            out[name] = {
                "time_ms": stats["median_s"] * 1e3,
                "mean_3d_error_mm": float(err),
                "rmse_mm": float(rmse),
                "valid_px": int(n),
            }
            if figure_path:
                depth_renders[name] = visualize.depth_rgb(pts[..., 2])

        if figure_path:
            # the PCL 6-viewport comparison (main.cpp:362-413): input, ground
            # truth and every evaluated method, one captioned montage
            panels = {"input": depth_renders.get("input"),
                      "ground truth": visualize.depth_rgb(gt)}
            panels.update((k, v) for k, v in depth_renders.items() if k != "input")
            panels = {k: v for k, v in panels.items() if v is not None}
            visualize.save_png(figure_path, visualize.comparison_figure(panels))
    return out


def evaluate_tum(
    root: str,
    *,
    frames: int = 30,
    eval_index: Optional[int] = None,
    include_sp_methods: bool = False,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Evaluate on a real RGB-D sequence (TUM layout) by the reference's own
    capture protocol (main.cpp:86-116): fold the sequence's first `frames`
    depth frames through the Buffer2D gated weighted average into a
    temporally averaged pseudo-ground truth, then run every method on one
    frame (eval_index, the middle one by default) against it.  The fold
    steps through jit(buffer2d.update), one graph for the sequence's frame
    shape, as the JAX package's step is jitted."""
    dev = resolve_device(device)
    seq = TUMSequence(root)
    if len(seq) == 0:
        raise ValueError(f"{root}: no associated rgb/depth pairs")
    n = min(frames, len(seq))
    h, w = seq[0].depth.shape
    buf = buffer2d.init(h, w, device=dev)
    step = jit.jit(buffer2d.update)
    for i in range(n):
        buf = step(buf, torch.from_numpy(seq[i].depth).to(dev))
    gt = buf.depth.cpu().numpy()
    fr = seq[eval_index if eval_index is not None else n // 2]
    return evaluate(
        fr.depth,
        fr.color,
        gt,
        include_sp_methods=include_sp_methods,
        intr=seq.intrinsics,
        grid=grid,
        timing_iters=timing_iters,
        methods=methods,
        figure_path=figure_path,
        device=dev,
    )


def write_report(path: str, results: Dict[str, Dict[str, float]]) -> str:
    """Write the evaluation.txt text (the JAX package's layout) and return it."""
    lines = ["runtime"]
    for name, r in results.items():
        lines.append(f"{name}: {r['time_ms']:.3f} ms")
    lines.append("error")
    for name, r in results.items():
        lines.append(
            f"{name} {r['mean_3d_error_mm']:.6f}  (rmse {r['rmse_mm']:.3f} mm, "
            f"n={r['valid_px']})"
        )
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text


def main(
    path: str | None = None,
    include_sp_methods: bool = False,
    *,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
    device="cuda",
) -> None:
    """evaluate() on make_noisy_scene(480, 640, seed=0); prints the report."""
    if path is None:
        path = sys.argv[1] if len(sys.argv) > 1 else "evaluation.txt"
    color, noisy, gt = make_noisy_scene(480, 640, default_kinect_intrinsics(), seed=0)
    results = evaluate(
        noisy,
        color,
        gt,
        include_sp_methods=include_sp_methods,
        grid=grid,
        timing_iters=timing_iters,
        methods=methods,
        figure_path=figure_path,
        device=device,
    )
    print(write_report(path, results))


if __name__ == "__main__":
    main()
