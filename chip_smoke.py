#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. refuse to run without CUDA; print the card's name and power limit
     (nvidia-smi), torch and CUDA versions;
  2. build the kernels from kinectdepthmapenhancement_tpu_torch/csrc
     (one nvcc per source, in parallel) and print the build time and
     ptxas register / shared-memory use (of the JBF, its R = 2
     instantiations, the path's radius), and the issued instructions a tap
     of the JBF and seed-gradient kernels (cuobjdump -sass of the build);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the 640x480 KDE path, B=1 and B=4, to its bar (JBF, chamfer
     DT, covariance sweep and seed gradient bitwise, the seeds identical;
     NASP assignment labels and distance and the
     label-cell gather bitwise, the NASP sums with integer-valued features
     exact and the rest within 1e-5 of the sum of their terms' magnitudes;
     the gather at each width the path uses, F = 6, 1 and 3; the DT also on
     a lattice depth-change map, zeros 48 px apart; the JBF and the DT in
     one device activity per call; the weighted NASP sums also on labels
     whose slot changes nearly every pixel), and at the shapes phase 6's
     paths add: the NASP sums at r = 5 on three-iteration labels, the label
     sums at F = 4 and 6 (merge_planes) and at r = 5, the gather at F = 2
     (the trust table) and at r = 5; and at the shapes phase 7's DASP / ERS
     paths add: the colour seed gradient on DASP's window-4 sub-grid, the
     label sums at F = 10 (the DASP update) at r = 2 and 3, the gather at
     F = 2 (the DASP window's centres) at r = 2 and 3 and at F = 4 and 7
     (the PCA planes, the PCA merge's table) at r = 4; time kernel,
     plain version and, where one PyTorch call computes (nearly) the same
     function, that call: "call ms" with CUDA events around one Python
     call (host dispatch included), and for kernel and library call
     "device ms", the profiler's summed kernel durations per call ("not
     measured" if three tries of utils/timing.device_ms all fail); print
     each kernel's bound (bytes at 3.35 TB/s or f32 operations at 67
     TFLOP/s), for the JBF, the seed gradient and the fused NASP
     assignment also their issue floor (issued instructions at one warp
     instruction a clock on every scheduler), and whether it is slower
     than the library call on device ms;
  4. drive kde_pipeline(KDEConfig()) at 640x480 (B=1, then B=4) from
     make_noisy_scene(480, 640); check finite outputs, that every kernel
     counter went up, and bitwise-identical outputs on a second run; hold
     the B=1 output against the JAX package's run of the same frame
     (tests/golden/kde_jax_640x480_seed0.npz, golden.kde_gates; the seed
     and partition agreements printed) and against ground truth (> 200000
     valid points, mean 3-D error below the input's, depth RMSE < 10 mm);
     hold the kernel route (stats_impl="auto") against the plain route
     ("xla") at B=4; print the median ms per frame of both routes and the
     profile of the kernel route by stage, with the device ms and
     launches of each of the port's own kernels in that call;
  5. run kde_pipeline at 96x128 (grid 3x4) and hold it against the golden
     oracle fixtures tests/golden/kde_oracle_96x128_seed0{,_refexact}.npz
     with the thresholds of tests/test_oracle_pipeline.py;
  6. drive the slice's paths at full width, each from launch counts at 0
     (every kernel and cuda_nasp form it runs must count), each timed and
     profiled by stage: (a) the far-range gate of
     tests/test_oracle_pipeline.py:230-287 on make_banded_scene (JBF,
     KDE, KDE with plane_merge); (b) plane_merge with fill_holes=4 at B=1
     and B=4 (labels of B=1 equal to frame 0 of B=4, bitwise on a second
     run); (c) three NASP iterations, the capped route ("auto") against
     locality="global" (one iteration from the same state: labels and
     distances bitwise equal, cluster tables to tolerance; end to end at
     most 8 labels a batch apart) with the assignment timed alone; (d) a
     424x512 Kinect v2 frame, whose grid does not divide it (the global
     route);
  7. drive rgbf_pipeline, spdsp_pipeline and tof_pipeline (default configs)
     at 640x480, B=1 and B=4, each from launch counts at 0 (the colour
     seed gradient, the label-cell sums and the gather must each launch,
     in the forms named there), with its host cap reads counted; hold the
     B=1 outputs against the JAX package's (tests/golden/
     dasp_jax_640x480_seed0.npz, golden.dasp_jax_gates) and ground truth
     (tests/test_pipelines.py:68-80, :108-157), B=4 bitwise on a second
     run; time each (CUDA events) and profile it by stage, and time the
     DASP sweep alone;
  8. print the kernels JSON line (one entry per TPU kernel of the repo,
     each with its forms and their launches by path), then
     {"ok": true, "device": ...} last.

Kernels are built under build/kernels/ (listed in .gitignore).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time


# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3
# bandwidth and f32 outside the tensor cores.  The f32 rate counts an FMA
# as two operations; the kernels are built with -fmad=false and issue
# separate adds and muls, at half that rate, but the same work could be
# done with FMAs, so the bound uses the published rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# one H100 SXM issues at most one warp instruction a clock on each of its
# 132 x 4 schedulers
SCHEDULERS = 528
# issued instructions of the fused assignment's candidate loop per pixel and
# in-grid candidate on its fast path (cuobjdump -sass of csrc/nasp.cu's
# assign_analyze_kernel: 124 for the loop's unrolled pair, the IEEE sqrt's
# slow-path call not taken); bitwise equality to the plain version fixes
# its operations and their order
ASSIGN_LOOP_INSTRUCTIONS = 62

# a trace's name of a kernel of csrc/*.cu (each lives in an anonymous namespace)
PORT_KERNEL = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+_kernel)\b")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: each input read and each output
    written once at the memory rate, or the operations at the f32 rate,
    whichever is longer.  Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from kinectdepthmapenhancement_tpu_torch import _build
    from kinectdepthmapenhancement_tpu_torch.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu_torch.core.config import (
        GridParams, KDEConfig, SPDSPConfig,
    )
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu_torch.ops import (
        bilateral, ccl, cuda_bilateral, cuda_cov, cuda_dt, cuda_gradient, cuda_nasp, ers,
        normals, plane, slic,
    )
    from kinectdepthmapenhancement_tpu_torch.utils import golden, kernel_variants, metrics
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms, device_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    print(f"max SM clock {sm_mhz:g} MHz")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    # ---- phase 2: build
    info = _build.load().build_info
    print(f"build: {info['seconds']:.2f} s, compiled {info['built']} ({info['path']})")
    for src, lines in info["ptxas"].items():
        entry = ""
        for ln in lines:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            entry = m.group(1) if m else entry
            if src == "jbf.cu" and entry and "jbf_kernelILi2E" not in entry:
                continue  # the radii the path does not run
            print(f"  {src}: {ln.strip()}")
    # issued instructions a tap of the JBF's and the gradient's path
    # instantiations on their fast path (the JBF's two passes together)
    tap_instr = {k: kernel_variants.tap_instructions(info["path"], k)
                 for k in kernel_variants.TAP_KERNELS}
    print("sass instructions a tap: " + "  ".join(
        f"{k} {n:.2f}" for k, n in tap_instr.items()))

    # ---- inputs at the 640x480 KDE path's shapes, B=1 and B=4
    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    cfg = KDEConfig()
    grid, nasp_p = cfg.grid, cfg.nasp
    cell = dict(rows=grid.rows, cols=grid.cols, r=4)
    cell5 = dict(cell, r=5)  # the capped iterations' cells
    ws_x, ws_y = w // grid.cols, h // grid.rows
    s_scale = (ws_x + ws_y) / 2.0
    rp = ws_x * 2 // 16 + 1
    lo, hi = -8 * rp, 8 * rp - 1  # the NASP update window (slic.segment)
    scenes = [make_noisy_scene(h, w, intr, seed=s) for s in range(4)]
    color4 = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    depth4 = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)

    def stage_inputs(depth, color):
        p = cfg.jbf
        guide = bilateral.guide_bilateral(color, p).to(torch.float32).contiguous()
        jbf_depth = cuda_bilateral.jbf_plain(
            depth, guide, window=p.window, spatial_sigma=p.spatial_sigma,
            color_sigma=p.color_sigma, depth_sigma=p.depth_sigma,
        )
        points = projective_to_real(jbf_depth, intr).contiguous()
        vm = (points / 1000.0).contiguous()
        dci = normals.dci_map(vm, cfg.normals.max_depth_change_factor).contiguous()
        rect = normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous()
        nmap = normals.generate_normal_map(points, cfg.normals).contiguous()
        color_f = color.to(torch.float32).contiguous()
        csub = slic._subgrid_extract(color_f, grid, h, w, 8).contiguous()
        nsub = slic._subgrid_extract(nmap, grid, h, w, 8).contiguous()
        x = dict(depth=depth.contiguous(), guide=guide, dci=dci, vm=vm, rect=rect,
                 csub=csub, nsub=nsub, color_f=color_f, points=points, nmap=nmap)
        # the first NASP iteration's inputs on the plain route: seeds,
        # candidate fields, labels, the analyze-updated cluster table
        b = depth.shape[0]
        seeds = slic._compute_seeds(color_f, nmap, grid, h, w, 8)
        cl = slic.init_clusters(seeds, color, points, nmap)
        cand, akw = slic._assign_args(cl, grid, nasp_p, s_scale)
        labels, _, part = cuda_nasp.nasp_assign_and_analyze_plain(
            color_f, points, nmap, cand, lo=lo, hi=hi, **akw)
        idx = slic._CellIndex(labels, grid, 4, h, w, kernel_sums=False)
        cl = slic._nasp_analyze_post(idx.fold(part), cl, points, h, w)
        xy = cl.xy.to(torch.float32)
        x.update(cand=cand, akw=akw, labels=labels,
                 f_analyze=xy.reshape(b, grid.rows, grid.cols, 2).contiguous(),
                 f_weighted=torch.cat([xy, cl.rgb, cl.normal], -1)
                 .reshape(b, grid.rows, grid.cols, 8).contiguous(),
                 table6=torch.cat([cl.center, cl.normal], -1).contiguous())
        x["table1"] = x["table6"][..., 2:3].contiguous()
        x["table3"] = x["table6"][..., :3].contiguous()
        z = points[..., 2]
        ok = ((z > 50.0) & (labels >= 0)).to(torch.float32)
        x["feats2"] = torch.stack([(z * 1e-3) ** 2 * ok, ok], -1).contiguous()
        # the sums' scales: each sum's terms summed by magnitude
        tri = (color_f, points, nmap)
        x["scale_assign"] = cuda_nasp.nasp_cell_sums_plain(
            labels, *tri, cand[..., 3:5], lo=lo, hi=hi, mode="analyze", abs_terms=True, **cell)
        for mode in ("analyze", "weighted"):
            x[f"scale_{mode}"] = cuda_nasp.nasp_cell_sums_plain(
                labels, *tri, x[f"f_{mode}"], lo=lo, hi=hi, mode=mode, abs_terms=True,
                color_sigma=nasp_p.color_sigma, spatial_sigma=nasp_p.spatial_sigma, **cell)
        x["scale_label"] = cuda_nasp.label_cell_sums_plain(labels, x["feats2"].abs(), **cell)
        # the capped iterations' state: three NASP iterations on the plain
        # route, every label within the cap of 5 (the r = 5 sums and gathers)
        three = slic.segment(color, points, nmap, grid=grid, params=dataclasses.replace(
            nasp_p, iterations=3, stats_impl="xla"))
        if not bool(slic.labels_within_cap(three.labels, grid, 5, h, w).all()):
            _fail("three-iteration labels left the cap of 5")
        labels5, cl5 = three.labels, three.clusters
        xy5 = cl5.xy.to(torch.float32)
        ok5 = ((z > 50.0) & (labels5 >= 0)).to(torch.float32)
        x.update(labels5=labels5,
                 f5_analyze=xy5.reshape(b, grid.rows, grid.cols, 2).contiguous(),
                 f5_weighted=torch.cat([xy5, cl5.rgb, cl5.normal], -1)
                 .reshape(b, grid.rows, grid.cols, 8).contiguous(),
                 feats2_r5=torch.stack([(z * 1e-3) ** 2 * ok5, ok5], -1).contiguous())
        for mode in ("analyze", "weighted"):
            x[f"scale5_{mode}"] = cuda_nasp.nasp_cell_sums_plain(
                labels5, *tri, x[f"f5_{mode}"], lo=lo, hi=hi, mode=mode, abs_terms=True,
                color_sigma=nasp_p.color_sigma, spatial_sigma=nasp_p.spatial_sigma, **cell5)
        # merge_planes' moments over the single-iteration labels: (points, 1)
        # and the centred scatter (ops/ccl.py); the trust table without the
        # residual (variance, size)
        valid = (labels >= 0) & (z > 50.0)
        x["feats4"] = (torch.cat([points, torch.ones_like(z)[..., None]], -1)
                       * valid[..., None]).contiguous()
        s4 = idx.segment_sum(x["feats4"], valid)
        mean = s4[..., :3] / s4[..., 3:4].clamp_min(1.0)
        x["feats6"] = ccl._outer6(
            torch.where(valid[..., None], points - idx.gather(mean), 0.0)).contiguous()
        x["table2"] = torch.stack([cl.variance, cl.size.to(torch.float32)], -1).contiguous()
        x["scale_feats4"] = cuda_nasp.label_cell_sums_plain(labels, x["feats4"].abs(), **cell)
        x["scale_feats6"] = cuda_nasp.label_cell_sums_plain(labels, x["feats6"].abs(), **cell)
        x["scale_feats2_r5"] = cuda_nasp.label_cell_sums_plain(
            labels5, x["feats2_r5"].abs(), **cell5)
        # the DASP / ERS paths' inputs (SPDSPConfig() on the plain route): the
        # raw frame's points, the depth SLIC's labels after one iteration
        # (r = 2) and after five (r = 3, within the cap of 3), the ERS labels
        # (r = 4, within the cap of 4); the DASP update's 10 features, the
        # centre tables (F = 2), the PCA planes (F = 4) and a merge-table
        # width (F = 7)
        sp_cfg = SPDSPConfig()
        raw = projective_to_real(depth, intr).contiguous()
        xla = dict(stats_impl="xla")
        d1 = slic.segment(color, raw, grid=grid, variant="dasp", params=dataclasses.replace(
            sp_cfg.depth_slic, iterations=1, **xla))
        d5 = slic.segment(color, raw, grid=grid, variant="dasp", params=dataclasses.replace(
            sp_cfg.depth_slic, **xla))
        c5 = slic.segment(color, raw, grid=grid, variant="dasp", params=dataclasses.replace(
            sp_cfg.color_slic, **xla))
        ers_labels = ers.edge_refine(c5.labels, d5.labels, depth, sp_cfg.ers).labels
        for lab, cap in ((d5.labels, 3), (ers_labels, 4)):
            if not bool(slic.labels_within_cap(lab, grid, cap, h, w).all()):
                _fail(f"DASP / ERS labels left the cap of {cap}")
        uv1 = slic._pixel_uv1(b, h, w, dev)
        validz = (raw[..., 2:3] > 50.0).to(torch.float32)
        for r_, seg in ((2, d1), (3, d5)):
            lab = seg.labels
            x[f"dlabels{r_}"] = lab
            x[f"dfeats{r_}"] = (torch.cat([color_f, uv1, raw, validz], -1)
                                * (lab >= 0)[..., None]).contiguous()
            x[f"dtable{r_}"] = seg.clusters.xy.to(torch.float32).contiguous()
            x[f"scale_dfeats{r_}"] = cuda_nasp.label_cell_sums_plain(
                lab, x[f"dfeats{r_}"].abs(), rows=grid.rows, cols=grid.cols, r=r_)
            x[f"flat_dlabel{r_}"] = (torch.arange(b, device=dev)[:, None, None]
                                     * grid.num_clusters + lab.clamp_min(0).long()).reshape(-1)
        x["elabels"] = ers_labels
        eidx = slic._CellIndex(ers_labels, grid, 4, h, w, kernel_sums=False)
        planes = plane.pca_planes(raw, ers_labels, grid.num_clusters, index=eidx)
        x["etable4"] = planes.nd.contiguous()
        x["etable7"] = torch.cat([planes.nd, planes.centers], -1).contiguous()
        x["csub4"] = slic._subgrid_extract(color_f, grid, h, w, 4).contiguous()
        # labels whose slot changes nearly every pixel: each pixel takes one
        # of the 3x3 cells around its own (the clusters whose update window
        # can reach it), -1 where that leaves the grid and on 3%
        rng = np.random.default_rng(11)
        cyy = np.arange(h)[None, :, None] // ws_y
        cxx = np.arange(w)[None, None, :] // ws_x
        ny = cyy + rng.integers(-1, 2, (b, h, w))
        nx = cxx + rng.integers(-1, 2, (b, h, w))
        inside = (ny >= 0) & (ny < grid.rows) & (nx >= 0) & (nx < grid.cols)
        scattered = np.where(inside, ny * grid.cols + nx, -1)
        scattered[rng.random(scattered.shape) < 0.03] = -1
        x["labels_scattered"] = torch.from_numpy(scattered.astype(np.int32)).to(dev)
        x["scale_weighted_scattered"] = cuda_nasp.nasp_cell_sums_plain(
            x["labels_scattered"], *tri, x["f_weighted"], lo=lo, hi=hi, mode="weighted",
            abs_terms=True, color_sigma=nasp_p.color_sigma,
            spatial_sigma=nasp_p.spatial_sigma, **cell)
        # the DT's worst case: a zero every 48 px puts one in every block's
        # region, and most pixels settle only after ~24 rounds
        yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        lattice = torch.where((yy % 48 == 24) & (xx % 48 == 24), 0, 255).to(torch.int32)
        x["dci_lattice"] = lattice.expand(b, h, w).contiguous()
        # the library calls' inputs: a flat label index, the batch index
        bi = torch.arange(b, device=dev)
        x["bi"] = bi[:, None, None]
        x["flat_label"] = (bi[:, None, None] * grid.num_clusters
                           + labels.clamp_min(0).long()).reshape(-1)
        x["flat_label5"] = (bi[:, None, None] * grid.num_clusters
                            + labels5.clamp_min(0).long()).reshape(-1)
        return x

    # ---- phase 3: each kernel against its plain version on the card
    p = cfg.jbf
    jbf_kw = dict(window=p.window, spatial_sigma=p.spatial_sigma,
                  color_sigma=p.color_sigma, depth_sigma=p.depth_sigma)
    its = cfg.normals.dt_iterations
    sums_kw = dict(lo=lo, hi=hi, color_sigma=nasp_p.color_sigma,
                   spatial_sigma=nasp_p.spatial_sigma, **cell)
    sums_kw5 = dict(sums_kw, r=5)

    def cell_sums_args(x, mode, labels="labels", fields="f"):
        return (x[labels], x["color_f"], x["points"], x["nmap"], x[f"{fields}_{mode}"])

    def sums_ok(mode, scale, ints=None):
        ints = cuda_nasp.INTEGER_FEATURES.get(mode, ()) if ints is None else ints
        return lambda got, want, x: cuda_nasp.sums_close(got[-1], want[-1], x[scale], ints)

    def npx(t):
        return t.shape[0] * t.shape[1] * t.shape[2]

    def dt_ops(dci):
        """The least a DT round needs per pixel, 10: as min(a + c, b + c) ==
        min(a, b) + c exactly, the min of the 4 edge and of the 4 corner
        neighbours (3 + 3), their costs added (2), and the min of those two
        and the pixel's own value (2).  Both dci here change somewhere in
        each of the `its` rounds, so every pixel counts all of them (the
        kernel stops a block sooner once its own region settles)."""
        return npx(dci) * its * 10

    def cov_taps(rect):  # taps the selected window needs: min(rect, 21)^2, none below 2
        r = rect.clamp(max=21).to(torch.float64)
        return float(torch.where(rect >= 2, r * r, torch.zeros_like(r)).sum())

    def labeled(x, labels="labels"):  # pixels whose features the NASP sums form
        return int((x[labels] >= 0).sum())

    # in-grid candidates of each cell; an out-of-grid one costs one compare
    n_in = (cuda_nasp.cand_grid(grid.rows, grid.cols, cuda_nasp.candidate_offsets(4), dev)
            >= 0).sum(-1).to(torch.float64)
    n_cand = 64

    def assign_ops(x):
        """Kernel 5: per pixel and in-grid candidate 33 (colour 8, pixel 7,
        depth 2, weighting 7, normal dot 5, normal term 3, the running
        argmin's compare 1), per out-of-grid one 1; per pixel 5 (its depth
        and normal validity, the invalid-depth override); per cell and
        in-grid candidate 4 (the candidate's depth and normal validity);
        per labeled pixel the analyze features 16 and their 13 sums."""
        b = x["color_f"].shape[0]
        per_cell = ws_x * ws_y * (33 * n_in + (n_cand - n_in)) + 4 * n_in
        return b * float(per_cell.sum()) + 5 * npx(x["color_f"]) + 29 * labeled(x)

    def tap_issue(kernel, key):
        """The issue floor of the JBF or the gradient: its issued
        instructions a tap (tap_instr) for every tap of every pixel, one
        warp instruction per 32 pixels, at one a clock on every scheduler
        at the card's top SM clock."""
        def issue(x):
            taps = kernel_variants.TAP_KERNELS[kernel][1]
            warp_instructions = npx(x[key]) * taps * tap_instr[kernel] / 32
            return warp_instructions / (SCHEDULERS * sm_mhz * 1e3), warp_instructions
        return issue

    def assign_issue_ms(x):
        """Kernel 5's issue floor: its candidate loop alone, one warp
        instruction per 32 pixels, in-grid candidate and loop instruction,
        at one a clock on every scheduler at the card's top SM clock."""
        warp_instructions = (x["color_f"].shape[0] * ws_x * ws_y * float(n_in.sum())
                             * ASSIGN_LOOP_INSTRUCTIONS / 32)
        return warp_instructions / (SCHEDULERS * sm_mhz * 1e3), warp_instructions

    # operations per call, one per f32 add / mul / sub / div / compare /
    # min / sqrt / exp, counted from each plain version's loop body
    kernels = {
        "jbf": dict(
            module=cuda_bilateral, bar="bitwise", activities=1,
            run=lambda x: cuda_bilateral.jbf(x["depth"], x["guide"], **jbf_kw),
            plain=lambda x: cuda_bilateral.jbf_plain(x["depth"], x["guide"], **jbf_kw),
            inputs=lambda x: [x["depth"], x["guide"]],
            # an expf or a division counted as one operation (it issues
            # ~10 instructions): the issue floor beside it counts them
            ops=lambda x: npx(x["depth"]) * 25 * (17 + 25),
            issue=tap_issue("jbf", "depth"),
            shape=lambda x: tuple(x["depth"].shape)),
        "chamfer_dt": dict(
            module=cuda_dt, bar="bitwise", activities=1,
            run=lambda x: cuda_dt.distance_transform(x["dci"], its),
            plain=lambda x: cuda_dt.distance_transform_plain(x["dci"], its),
            inputs=lambda x: [x["dci"]],
            ops=lambda x: dt_ops(x["dci"]),
            shape=lambda x: tuple(x["dci"].shape)),
        "chamfer_dt_lattice": dict(
            module=cuda_dt, bar="bitwise", row="chamfer_dt", secondary=True, activities=1,
            run=lambda x: cuda_dt.distance_transform(x["dci_lattice"], its),
            plain=lambda x: cuda_dt.distance_transform_plain(x["dci_lattice"], its),
            inputs=lambda x: [x["dci_lattice"]],
            ops=lambda x: dt_ops(x["dci_lattice"]),
            shape=lambda x: tuple(x["dci_lattice"].shape)),
        "cm_covariance": dict(
            module=cuda_cov, bar="count exact, entries bitwise",
            run=lambda x: cuda_cov.cm_covariances(x["vm"], x["rect"]),
            plain=lambda x: cuda_cov.cm_covariances_plain(x["vm"], x["rect"]),
            inputs=lambda x: [x["vm"], x["rect"]],
            # per tap 22: 3 residuals (3 subs, 3 muls by the validity
            # factor), the count, 3 first and 6 second moments (6 products)
            ops=lambda x: 22 * cov_taps(x["rect"]),
            shape=lambda x: tuple(x["vm"].shape)),
        "seed_gradient_nasp": dict(
            module=cuda_gradient, bar="bitwise, seeds identical", row="seed_gradient",
            run=lambda x: cuda_gradient.seed_gradient(x["csub"], x["nsub"]),
            plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub"], x["nsub"]),
            ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(
                slic._sample_seeds_subgrid(got[0], grid, h, w, 8),
                slic._sample_seeds_subgrid(want[0], grid, h, w, 8)),
            inputs=lambda x: [x["csub"], x["nsub"]],
            ops=lambda x: npx(x["csub"]) * 121 * 20,  # a sqrt counted as one
            issue=tap_issue("seed_gradient_nasp", "csub"),
            shape=lambda x: tuple(x["csub"].shape)),
        "seed_gradient_color": dict(
            module=cuda_gradient, bar="bitwise", row="seed_gradient", secondary=True,
            run=lambda x: cuda_gradient.seed_gradient(x["csub"]),
            plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub"]),
            inputs=lambda x: [x["csub"]],
            ops=lambda x: npx(x["csub"]) * 121 * 12,
            issue=tap_issue("seed_gradient_color", "csub"),
            shape=lambda x: tuple(x["csub"].shape)),
        "nasp_assign_analyze": dict(
            module=cuda_nasp, bar="labels, distance bitwise; sums: integer exact, "
            "rest <= 1e-5 sum|terms|",
            run=lambda x: cuda_nasp.nasp_assign_and_analyze(
                x["color_f"], x["points"], x["nmap"], x["cand"], lo=lo, hi=hi, **x["akw"]),
            plain=lambda x: cuda_nasp.nasp_assign_and_analyze_plain(
                x["color_f"], x["points"], x["nmap"], x["cand"], lo=lo, hi=hi, **x["akw"]),
            ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and sums_ok("analyze", "scale_assign")(got, want, x),
            inputs=lambda x: [x["color_f"], x["points"], x["nmap"], x["cand"]],
            ops=assign_ops, issue=assign_issue_ms,
            shape=lambda x: tuple(x["color_f"].shape)),
        "nasp_cell_sums_weighted": dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="nasp_cell_sums",
            run=lambda x: cuda_nasp.nasp_cell_sums(
                *cell_sums_args(x, "weighted"), mode="weighted", **sums_kw),
            plain=lambda x: cuda_nasp.nasp_cell_sums_plain(
                *cell_sums_args(x, "weighted"), mode="weighted", **sums_kw),
            ok=sums_ok("weighted", "scale_weighted"),
            inputs=lambda x: list(cell_sums_args(x, "weighted")),
            # per labeled pixel: window 6, normal validity 3, colour
            # weight 12, pixel weight 7, product 2, normal dot 6, accept 3,
            # features 12, and the 14 sums
            ops=lambda x: labeled(x) * (51 + 14),
            shape=lambda x: tuple(x["color_f"].shape)),
        "nasp_cell_sums_analyze": dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="nasp_cell_sums", secondary=True,
            run=lambda x: cuda_nasp.nasp_cell_sums(
                *cell_sums_args(x, "analyze"), mode="analyze", **sums_kw),
            plain=lambda x: cuda_nasp.nasp_cell_sums_plain(
                *cell_sums_args(x, "analyze"), mode="analyze", **sums_kw),
            ok=sums_ok("analyze", "scale_analyze"),
            inputs=lambda x: list(cell_sums_args(x, "analyze")),
            # per labeled pixel: window 6, validity 4, features 6, 13 sums
            ops=lambda x: labeled(x) * (16 + 13),
            shape=lambda x: tuple(x["color_f"].shape)),
        "nasp_cell_sums_weighted_scattered": dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="nasp_cell_sums", secondary=True,
            run=lambda x: cuda_nasp.nasp_cell_sums(
                *cell_sums_args(x, "weighted", "labels_scattered"), mode="weighted", **sums_kw),
            plain=lambda x: cuda_nasp.nasp_cell_sums_plain(
                *cell_sums_args(x, "weighted", "labels_scattered"), mode="weighted", **sums_kw),
            ok=sums_ok("weighted", "scale_weighted_scattered"),
            inputs=lambda x: list(cell_sums_args(x, "weighted", "labels_scattered")),
            ops=lambda x: labeled(x, "labels_scattered") * (51 + 14),
            shape=lambda x: tuple(x["color_f"].shape)),
        "label_cell_sums": dict(
            module=cuda_nasp, bar="<= 1e-5 sum|terms|",
            run=lambda x: cuda_nasp.label_cell_sums(x["labels"], x["feats2"], **cell),
            plain=lambda x: cuda_nasp.label_cell_sums_plain(x["labels"], x["feats2"], **cell),
            ok=sums_ok("label", "scale_label"),
            # per-cluster sums in one call (the candidate fold included)
            library=lambda x: torch.zeros(
                (x["bi"].shape[0] * grid.num_clusters, 2), device=dev).index_add_(
                0, x["flat_label"], x["feats2"].reshape(-1, 2)),
            inputs=lambda x: [x["labels"], x["feats2"]],
            ops=lambda x: npx(x["labels"]) * 2,
            shape=lambda x: tuple(x["feats2"].shape)),
    }
    # the gather at the main path's three widths: F=6 (ccl.py, the row's
    # headline), F=1 and F=3 (plane.py)
    for nf in (6, 1, 3):
        tkey = f"table{nf}"
        kernels["label_cell_gather" if nf == 6 else f"label_cell_gather_f{nf}"] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=nf != 6,
            run=lambda x, t=tkey: cuda_nasp.label_cell_gather(x["labels"], x[t], **cell),
            plain=lambda x, t=tkey: cuda_nasp.label_cell_gather_plain(x["labels"], x[t], **cell),
            # table[label] by advanced indexing (no zero outside the candidates)
            library=lambda x, t=tkey: x[t][x["bi"], x["labels"].clamp_min(0)],
            inputs=lambda x, t=tkey: [x["labels"], x[t]],
            ops=lambda x: 0,
            shape=lambda x, nf=nf: tuple(x["labels"].shape) + (nf,))
    # the shapes the slice's paths add: the NASP sums at r = 5 (capped
    # iterations), the label sums at merge_planes' F = 4 and 6 and at r = 5
    # (the residual over capped labels), the gather of the trust table
    # (F = 2) and at r = 5 (CCL and the plane stage over capped labels)
    for mode, per_px in (("analyze", 16 + 13), ("weighted", 51 + 14)):
        kernels[f"nasp_cell_sums_{mode}_r5"] = dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="nasp_cell_sums", secondary=True, form=f"r5:{mode}",
            run=lambda x, m=mode: cuda_nasp.nasp_cell_sums(
                *cell_sums_args(x, m, "labels5", "f5"), mode=m, **sums_kw5),
            plain=lambda x, m=mode: cuda_nasp.nasp_cell_sums_plain(
                *cell_sums_args(x, m, "labels5", "f5"), mode=m, **sums_kw5),
            ok=sums_ok(mode, f"scale5_{mode}"),
            inputs=lambda x, m=mode: list(cell_sums_args(x, m, "labels5", "f5")),
            ops=lambda x, n=per_px: labeled(x, "labels5") * n,
            shape=lambda x: tuple(x["color_f"].shape))
    for key, nf, r, feats in (("label_cell_sums_f4", 4, 4, "feats4"),
                              ("label_cell_sums_f6", 6, 4, "feats6"),
                              ("label_cell_sums_r5", 2, 5, "feats2_r5")):
        lab, flat, kw = ("labels", "flat_label", cell) if r == 4 else (
            "labels5", "flat_label5", cell5)
        kernels[key] = dict(
            module=cuda_nasp, bar="<= 1e-5 sum|terms|", row="label_cell_sums",
            secondary=True, form=f"r{r}:F{nf}",
            run=lambda x, l=lab, f=feats, kw=kw: cuda_nasp.label_cell_sums(x[l], x[f], **kw),
            plain=lambda x, l=lab, f=feats, kw=kw: cuda_nasp.label_cell_sums_plain(
                x[l], x[f], **kw),
            ok=sums_ok("label", f"scale_{feats}"),
            library=lambda x, f=feats, fl=flat, nf=nf: torch.zeros(
                (x["bi"].shape[0] * grid.num_clusters, nf), device=dev).index_add_(
                0, x[fl], x[f].reshape(-1, nf)),
            inputs=lambda x, l=lab, f=feats: [x[l], x[f]],
            ops=lambda x, f=feats: npx(x[f]) * x[f].shape[-1],
            shape=lambda x, f=feats: tuple(x[f].shape))
    for key, nf, r in (("label_cell_gather_f2", 2, 4), ("label_cell_gather_r5", 6, 5),
                       ("label_cell_gather_r5_f3", 3, 5)):
        lab, kw, tkey = ("labels", cell, f"table{nf}") if r == 4 else (
            "labels5", cell5, f"table{nf}")
        kernels[key] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=True,
            form=f"r{r}:F{nf}",
            run=lambda x, l=lab, t=tkey, kw=kw: cuda_nasp.label_cell_gather(x[l], x[t], **kw),
            plain=lambda x, l=lab, t=tkey, kw=kw: cuda_nasp.label_cell_gather_plain(
                x[l], x[t], **kw),
            library=lambda x, l=lab, t=tkey: x[t][x["bi"], x[l].clamp_min(0)],
            inputs=lambda x, l=lab, t=tkey: [x[l], x[t]],
            ops=lambda x: 0,
            shape=lambda x, l=lab, nf=nf: tuple(x[l].shape) + (nf,))
    # the forms phase 7's DASP / ERS paths add: the colour gradient on
    # DASP's window-4 sub-grid; the DASP update's sums (10 features: colour,
    # u, v, 1 and the valid-depth count integer-valued) and its centre
    # gather at r = 2 (first iteration) and r = 3 (capped later ones); the
    # PCA planes' gather (F = 4) and the PCA merge's (F = 7) at r = 4 over
    # ERS labels
    kernels["seed_gradient_color_w4"] = dict(
        module=cuda_gradient, bar="bitwise, seeds identical", row="seed_gradient",
        secondary=True, form="color",
        run=lambda x: cuda_gradient.seed_gradient(x["csub4"]),
        plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub4"]),
        ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(
            slic._sample_seeds_subgrid(got[0], grid, h, w, 4),
            slic._sample_seeds_subgrid(want[0], grid, h, w, 4)),
        inputs=lambda x: [x["csub4"]],
        ops=lambda x: npx(x["csub4"]) * 121 * 12,
        issue=tap_issue("seed_gradient_color", "csub4"),
        shape=lambda x: tuple(x["csub4"].shape))
    for r_ in (2, 3):
        kw_r = dict(rows=grid.rows, cols=grid.cols, r=r_)
        kernels[f"label_cell_sums_r{r_}_f10"] = dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="label_cell_sums", secondary=True, form=f"r{r_}:F10",
            run=lambda x, r_=r_, kw=kw_r: cuda_nasp.label_cell_sums(
                x[f"dlabels{r_}"], x[f"dfeats{r_}"], **kw),
            plain=lambda x, r_=r_, kw=kw_r: cuda_nasp.label_cell_sums_plain(
                x[f"dlabels{r_}"], x[f"dfeats{r_}"], **kw),
            ok=sums_ok("dasp", f"scale_dfeats{r_}", (0, 1, 2, 3, 4, 5, 9)),
            library=lambda x, r_=r_: torch.zeros(
                (x["bi"].shape[0] * grid.num_clusters, 10), device=dev).index_add_(
                0, x[f"flat_dlabel{r_}"], x[f"dfeats{r_}"].reshape(-1, 10)),
            inputs=lambda x, r_=r_: [x[f"dlabels{r_}"], x[f"dfeats{r_}"]],
            ops=lambda x, r_=r_: npx(x[f"dfeats{r_}"]) * 10,
            shape=lambda x, r_=r_: tuple(x[f"dfeats{r_}"].shape))
    for key, lab, tkey, r_ in (("label_cell_gather_r2_f2", "dlabels2", "dtable2", 2),
                               ("label_cell_gather_r3_f2", "dlabels3", "dtable3", 3),
                               ("label_cell_gather_r4_f4", "elabels", "etable4", 4),
                               ("label_cell_gather_r4_f7", "elabels", "etable7", 4)):
        kw_r = dict(rows=grid.rows, cols=grid.cols, r=r_)
        kernels[key] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=True,
            form=f"r{r_}:F{key[-1]}",
            run=lambda x, l=lab, t=tkey, kw=kw_r: cuda_nasp.label_cell_gather(x[l], x[t], **kw),
            plain=lambda x, l=lab, t=tkey, kw=kw_r: cuda_nasp.label_cell_gather_plain(
                x[l], x[t], **kw),
            library=lambda x, l=lab, t=tkey: x[t][x["bi"], x[l].clamp_min(0)],
            inputs=lambda x, l=lab, t=tkey: [x[l], x[t]],
            ops=lambda x: 0,
            shape=lambda x, l=lab, t=tkey: tuple(x[l].shape) + (x[t].shape[-1],))
    kernels["seed_gradient_color"]["form"] = "color"
    # the main path's forms, as cuda_nasp.launch_forms names them
    for name, form in (("nasp_assign_analyze", "r4"), ("nasp_cell_sums_weighted", "r4:weighted"),
                       ("nasp_cell_sums_analyze", "r4:analyze"),
                       ("nasp_cell_sums_weighted_scattered", "r4:weighted"),
                       ("label_cell_sums", "r4:F2"), ("label_cell_gather", "r4:F6"),
                       ("label_cell_gather_f1", "r4:F1"), ("label_cell_gather_f3", "r4:F3")):
        kernels[name]["form"] = form
    def device_time(fn):
        """utils/timing.device_ms of fn: (device ms, activities) per call.
        The profiler's trace now and then comes back without its device
        records, every attempt of a call alike; the call is made again
        after a pause, three times in all, and reads (None, None) if none
        succeeded: "not measured" below, and a failed check where the
        kernel's activities are checked."""
        for _ in range(3):
            try:
                return device_ms(fn, warmup=3, iters=20)
            except RuntimeError as e:
                print(f"  {e}; measured again")
                time.sleep(2.0)
        return None, None

    def ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    def per_call(n):
        return "?" if n is None else f"{n:g}"

    report = {name: {"max_abs_err": 0.0} for name in kernels}
    for bsz in (1, 4):
        x = stage_inputs(depth4[:bsz], color4[:bsz])
        torch.cuda.synchronize()
        for key in ("labels", "labels_scattered"):  # what a sums lane sees a round on
            lab = x[key]
            both = (lab[:, 1:] >= 0) & (lab[:, :-1] >= 0)
            moved = float(((lab[:, 1:] != lab[:, :-1]) & both).sum() / both.sum())
            print(f"{key} B={bsz}: {moved:.4f} of labeled pixels differ from the one above")
        for name, k in kernels.items():
            got, want = k["run"](x), k["plain"](x)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(
                float(torch.where(a == b, torch.zeros_like(a), (a - b).abs()).max())
                for a, b in zip(got, want)
            )
            bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
            ok = k["ok"](got, want, x) if "ok" in k else bitwise
            if not ok:
                _fail(f"kernel {name} disagrees with its plain version at B={bsz}")
            # call ms: CUDA events around one Python call (host dispatch
            # included when the device finishes first); device ms: the
            # profiler's summed kernel durations per call
            t_k = cuda_ms(lambda: k["run"](x), warmup=3, iters=20)
            d_k, n_k = device_time(lambda: k["run"](x))
            if "activities" in k and n_k != k["activities"]:
                _fail(f"kernel {name} ran {per_call(n_k)} device activities per call, "
                      f"not {k['activities']}")
            t_p = cuda_ms(lambda: k["plain"](x), warmup=1, iters=5)
            t_l = d_l = None
            if "library" in k:
                t_l = cuda_ms(lambda: k["library"](x), warmup=3, iters=20)
                d_l, n_l = device_time(lambda: k["library"](x))
            nbytes = sum(t.numel() * t.element_size() for t in k["inputs"](x) + list(got))
            t_b, bound_by = bound_ms(nbytes, k["ops"](x))
            lib = "none" if t_l is None else (
                f"call {t_l:.4f} ms device {ms(d_l)} ({per_call(n_l)} kernels/call) -> kernel "
                + ("not compared" if None in (d_k, d_l) else
                   f"{'slower' if d_k > d_l else 'not slower'} on device ms"))
            print(f"kernel {name:24s} shape {str(k['shape'](x)):22s} B={bsz} "
                  f"max|d|={err:.3g} bitwise={bitwise} bar: {k['bar']} -> ok  "
                  f"call {t_k:.4f} ms  device {ms(d_k)} ({per_call(n_k)} kernels/call)  "
                  f"plain call {t_p:.4f} ms  library {lib}  "
                  f"bound {t_b:.4f} ms ({bound_by}, {nbytes / 1e6:.2f} MB, "
                  f"{k['ops'](x) / 1e9:.3f} Gop)")
            if "issue" in k:
                t_i, n_i = k["issue"](x)
                print(f"  issue floor {t_i:.4f} ms ({n_i / 1e6:.1f} M warp instructions at one a "
                      f"clock on {SCHEDULERS} schedulers, {sm_mhz:g} MHz)")
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r[f"ms_b{bsz}"], r[f"plain_ms_b{bsz}"], r[f"library_ms_b{bsz}"] = t_k, t_p, t_l
            r[f"device_ms_b{bsz}"], r[f"library_device_ms_b{bsz}"] = d_k, d_l
            r[f"bound_ms_b{bsz}"], r["bound_by"] = t_b, bound_by
        del x

    # ---- phase 4: the main path at 640x480, single-frame and batched
    def counts():
        c = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in (
            cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)}
        c.update(cuda_nasp.launches)
        return c

    def reset_counts():
        for m in (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient):
            m.launches = 0
        for name in cuda_nasp.launches:
            cuda_nasp.launches[name] = 0
        cuda_nasp.launch_forms.clear()
        cuda_gradient.launch_forms.clear()

    def forms_now():
        return {**cuda_nasp.launch_forms, **cuda_gradient.launch_forms}

    path_forms = {}  # path -> cuda_nasp.launch_forms of its driven run
    reset_counts()
    res1 = kde_pipeline(depth4[0], color4[0], intr, cfg)
    res4 = kde_pipeline(depth4, color4, intr, cfg)
    torch.cuda.synchronize()
    launches = counts()
    path_forms["main"] = forms_now()
    print(f"main path launches: {launches}")
    if any(n == 0 for n in launches.values()):
        _fail(f"a kernel of the main path was never launched: {launches}")
    k_count = grid.num_clusters
    for tag, res in (("B=1", res1), ("B=4", res4)):
        for field in ("optimized_points", "plane_fitted", "jbf_depth", "normals", "merged_variance"):
            if not bool(torch.isfinite(getattr(res, field)).all()):
                _fail(f"{tag}: non-finite values in {field}")
        for field in ("nasp_labels", "merged_labels"):
            lab = getattr(res, field)
            if int(lab.min()) < -1 or int(lab.max()) >= k_count:
                _fail(f"{tag}: {field} out of range")
        valid = float((res.optimized_points[..., 2] > 50.0).float().mean())
        print(f"{tag}: finite outputs, labels in range, valid-depth share {valid:.4f}")
    if not all(torch.equal(getattr(res1, f), getattr(res4, f)[0])
               for f in ("nasp_labels", "merged_labels")):
        _fail("frame 0 labels differ between the B=1 and B=4 runs")
    again = kde_pipeline(depth4, color4, intr, cfg)
    torch.cuda.synchronize()
    for f in res4._fields:
        if not torch.equal(getattr(again, f), getattr(res4, f)):
            _fail(f"second run gave different {f}")
    print("determinism: every output bitwise identical on a second run")

    # the B=1 output against the JAX package's run of the same frame
    # (tests/golden/kde_jax_640x480_seed0.npz); the seeds near gradient
    # ties can differ (XLA on the CPU contracts FMAs, the port does not)
    want = golden.load_jax_640x480()
    got1 = {f: getattr(res1, f).cpu().numpy() for f in res1._fields}
    jgates = golden.kde_gates(got1, want)
    for gname, (val, lim, ok) in jgates.items():
        print(f"jax 640x480 {gname:28s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
    seeds1 = slic._compute_seeds(color4[:1].to(torch.float32), res1.normals[None].contiguous(),
                                 grid, h, w, 8)[0].cpu().numpy()
    seed_same = (seeds1 == want["seeds"]).all(-1)
    part, total = golden.partition_agreement(got1["merged_labels"], want["merged_labels"])
    print(f"jax 640x480: seeds equal on {seed_same.mean():.4f} ({int((~seed_same).sum())} of "
          f"{len(seed_same)} differ); NASP labels equal on "
          f"{(got1['nasp_labels'] == want['nasp_labels']).mean():.6f} of pixels; merged "
          f"partition agreement {part:.6f} over {total} labelled pixels")
    if golden.failures(jgates):
        _fail(f"640x480 output against the JAX package: {golden.failures(jgates)}")
    # quality against ground truth (tests/test_pipelines.py:31-51)
    gt0 = torch.from_numpy(scenes[0][2]).to(dev)
    gt_pts = projective_to_real(gt0, intr)
    err_in, _ = metrics.mean_3d_error(projective_to_real(depth4[0], intr), gt_pts)
    err_out, n_valid = metrics.mean_3d_error(res1.optimized_points, gt_pts)
    rmse = float(metrics.depth_rmse(res1.optimized_points[..., 2], gt0))
    print(f"quality 640x480: {int(n_valid)} valid points (bar > 200000), mean 3-D error "
          f"{float(err_out):.4f} mm against the input's {float(err_in):.4f}, depth RMSE "
          f"{rmse:.4f} mm (bar < 10)")
    if not (int(n_valid) > 200000 and float(err_out) < float(err_in) and rmse < 10.0):
        _fail("the 640x480 quality gate")

    # the stats routes: the kernels ("auto") against the plain route ("xla")
    cfg_xla = dataclasses.replace(cfg, nasp=dataclasses.replace(nasp_p, stats_impl="xla"))
    res_x = kde_pipeline(depth4, color4, intr, cfg_xla)
    pts4 = projective_to_real(res4.jbf_depth, intr)
    seg = {impl: slic.segment(color4, pts4, res4.normals, grid=grid,
                              params=dataclasses.replace(nasp_p, stats_impl=impl))
           for impl in ("auto", "xla")}
    torch.cuda.synchronize()
    if not torch.equal(res4.nasp_labels, res_x.nasp_labels):
        _fail("nasp_labels differ between the kernel and the xla route")
    if not torch.equal(seg["auto"].labels, seg["xla"].labels):
        _fail("segment labels differ between the kernel and the xla route")
    for f in ("size", "xy", "rgb"):
        d = (getattr(seg["auto"].clusters, f).double()
             - getattr(seg["xla"].clusters, f).double()).abs()
        d = d.reshape(d.shape[0], d.shape[1], -1).amax(-1)
        same = float((d == 0).double().mean())
        print(f"routes: cluster {f} equal on {same:.4f} of clusters, max |d| {float(d.max()):.3g}")
        if same < 0.99 or float(d.max()) > 1.0:
            _fail(f"cluster {f} differs between the routes beyond the bar")
    part, _ = golden.partition_agreement(res4.merged_labels.cpu().numpy(),
                                         res_x.merged_labels.cpu().numpy())
    dmm = (res4.optimized_points - res_x.optimized_points).abs().amax(-1)
    within = float((dmm < 1.0).double().mean())
    print(f"routes: merged-partition agreement {part:.6f} (bar > 0.995); optimized points "
          f"within 1 mm on {within:.6f} of pixels (bar > 0.99)")
    if not part > 0.995 or not within > 0.99:
        _fail("the kernel route's outputs differ from the xla route's beyond the bar")

    frame_ms = {}
    for label, c_run in (("auto", cfg), ("xla", cfg_xla)):
        for bsz in (1, 4):
            d, c = depth4[:bsz], color4[:bsz]
            t = cuda_ms(lambda: kde_pipeline(d, c, intr, c_run), warmup=1, iters=5)
            frame_ms[(label, bsz)] = t / bsz
            print(f"kde_pipeline 640x480 stats_impl={label} B={bsz}: {t:.3f} ms per call, "
                  f"{t / bsz:.3f} ms per frame (median of 5)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory: {peak:.2f} GiB")

    # where the time goes: one profiled call per batch size, device time per
    # kde.* stage and per kernel name; busy share against the unprofiled
    # median call time above.  Every device activity of the trace counts,
    # the kernels launched through ctypes too, which the profiler attaches to
    # no CPU op; an activity counts under the stage whose device-side span
    # holds it, and one outside every span under the stage of the activity
    # before it (one stream, stages in order).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kde_scopes = ("kde.jbf", "kde.normals", "kde.nasp", "kde.ccl_merge", "kde.projection")

    def stage_profile(tag, fn, call_ms, port_kernels=True, scopes=kde_scopes):
        """One profiled call of fn: device ms and activities by kde.* stage,
        the top kernels, the port's own kernels; the busy share against
        call_ms (an unprofiled median)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        on_device = [ev for ev in events if ev.device_type == DeviceType.CUDA]
        spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                       for ev in on_device if ev.name in scopes)
        work = sorted((ev for ev in on_device if ev.name not in scopes
                       and not getattr(ev, "is_user_annotation", False)),
                      key=lambda ev: ev.time_range.start)
        attached = sum(len(ev.kernels) for ev in events if ev.device_type == DeviceType.CPU)
        per = {name: [0.0, 0] for name in scopes + ("unscoped",)}  # device ms, activities
        by_kernel: dict = {}
        port: dict = {}  # the port's own kernels (csrc/*.cu): device ms, launches
        scope = "unscoped"
        for ev in work:
            t = ev.time_range.start
            scope = next((name for t0, t1, name in spans if t0 <= t < t1), scope)
            ms = ev.time_range.elapsed_us() / 1e3
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
            per[scope][0] += ms
            per[scope][1] += 1
            own = PORT_KERNEL.match(ev.name)
            if own:
                acc = port.setdefault(own.group(1), [0.0, 0])
                acc[0] += ms
                acc[1] += 1
        busy = sum(by_kernel.values())
        print(f"profile {tag}: {len(work)} device activities ({attached} attached to a CPU "
              f"op), device busy {busy:.3f} ms of a {call_ms:.3f} ms call "
              f"({100.0 * busy / call_ms:.1f}% busy); {len(spans)} stage spans on the device")
        for name, (ms, count) in per.items():
            print(f"  {name:16s} device {ms:.3f} ms in {count} activities")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  kernel {ms:8.3f} ms  {name[:90]}")
        print("  port kernels: " + "  ".join(
            f"{name} {ms:.4f} ms x{count}" for name, (ms, count) in sorted(port.items())))
        if port_kernels and not port:
            _fail(f"{tag}: the profile shows none of the port's kernels")

    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        stage_profile(f"B={bsz}", lambda: kde_pipeline(d, c, intr, cfg),
                      frame_ms[("auto", bsz)] * bsz)

    # ---- phase 5: the golden oracle fixtures at 96x128
    intr_s, color_s, noisy_s = golden.scene_96x128()
    for refexact in (False, True):
        cfg_s = dataclasses.replace(
            KDEConfig(), grid=GridParams(rows=3, cols=4),
            max_plane_residual=float("inf") if refexact else 0.0025,
        )
        res = kde_pipeline(torch.from_numpy(noisy_s).to(dev), torch.from_numpy(color_s).to(dev),
                           intr_s, cfg_s)
        got = {f: getattr(res, f).cpu().numpy() for f in res._fields}
        want = golden.load_fixture(refexact)
        gates = (golden.kde_refexact_gates if refexact else golden.kde_gates)(got, want)
        tag = "refexact" if refexact else "default"
        for gname, (val, lim, ok) in gates.items():
            print(f"golden {tag:8s} {gname:28s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
        if golden.failures(gates):
            _fail(f"golden gates failed ({tag}): {golden.failures(gates)}")

    # ---- phase 6: the slice's paths at full width: each driven once with
    # the counts at 0 (every kernel it runs must count), checked, timed
    # (CUDA events, median of 5) and profiled by stage
    stencil_kernels = ("cuda_bilateral", "cuda_dt", "cuda_cov", "cuda_gradient")

    def drive(path, fn, expect, expect_forms=()):
        """Run fn once from counts at 0; fail unless every kernel in
        `expect` and every cuda_nasp form in `expect_forms` launched."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got, forms = counts(), forms_now()
        path_forms[path] = forms
        print(f"{path} launches: {got}; forms {forms}")
        missing = [k for k in expect if got[k] == 0] + [f for f in expect_forms if f not in forms]
        if missing:
            _fail(f"{path}: a kernel of the path was never launched: {missing}")
        return out

    def time_path(path, fn, bsz, scopes=kde_scopes):
        t = cuda_ms(fn, warmup=1, iters=5)
        print(f"{path}: {t:.3f} ms per call, {t / bsz:.3f} ms per frame (median of 5)")
        stage_profile(path, fn, t, scopes=scopes)
        return t

    def check_outputs(tag, res, k_count):
        for field in ("optimized_points", "plane_fitted", "jbf_depth", "normals",
                      "merged_variance"):
            if not bool(torch.isfinite(getattr(res, field)).all()):
                _fail(f"{tag}: non-finite values in {field}")
        for field in ("nasp_labels", "merged_labels"):
            lab = getattr(res, field)
            if int(lab.min()) < -1 or int(lab.max()) >= k_count:
                _fail(f"{tag}: {field} out of range")

    def check_again(tag, fn, first):
        again = fn()
        torch.cuda.synchronize()
        for f in first._fields:
            if not torch.equal(getattr(again, f), getattr(first, f)):
                _fail(f"{tag}: second run gave different {f}")
        print(f"{tag}: every output bitwise identical on a second run")

    all_kernels = tuple(launches)
    path_ms = {}

    # (a) the far-range gate (tests/test_oracle_pipeline.py:230-287)
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_banded_scene
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import jbf_pipeline

    fcolor, fsensor, fgt = make_banded_scene(h, w, intr, seed=0)
    fd, fc = torch.from_numpy(fsensor).to(dev), torch.from_numpy(fcolor).to(dev)
    cfg_pm = dataclasses.replace(cfg, plane_merge=True)
    z_jbf = drive("far.jbf", lambda: jbf_pipeline(fd, fc), ("cuda_bilateral",))
    res_fk = drive("far.kde", lambda: kde_pipeline(fd, fc, intr, cfg), all_kernels)
    res_fp = drive("far.plane_merge", lambda: kde_pipeline(fd, fc, intr, cfg_pm), all_kernels,
                   ("label_cell_sums:r4:F4", "label_cell_sums:r4:F6"))
    fgates, frmse = golden.far_range_gates(
        z_jbf.cpu().numpy(), res_fk.optimized_points[..., 2].cpu().numpy(),
        res_fp.optimized_points[..., 2].cpu().numpy(), res_fp.merged_labels.cpu().numpy(),
        fgt, k_count)
    for gname, (val, lim, ok) in fgates.items():
        print(f"far-range {gname:28s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
    print("far-range depth RMSE: " + "  ".join(f"{k} {v:.4f} mm" for k, v in frmse.items()))
    if golden.failures(fgates):
        _fail(f"far-range gate: {golden.failures(fgates)}")
    path_ms["far.jbf B=1"] = cuda_ms(lambda: jbf_pipeline(fd, fc), warmup=1, iters=5)
    print(f"far.jbf: {path_ms['far.jbf B=1']:.3f} ms per call (median of 5)")
    path_ms["far.plane_merge B=1"] = time_path(
        "far.plane_merge B=1", lambda: kde_pipeline(fd, fc, intr, cfg_pm), 1)

    # (b) plane_merge with the hole fill, B=1 and B=4
    cfg_b = dataclasses.replace(cfg, plane_merge=True, fill_holes=4)
    res_b1 = drive("pm_fill B=1", lambda: kde_pipeline(depth4[0], color4[0], intr, cfg_b),
                   all_kernels, ("label_cell_sums:r4:F4", "label_cell_sums:r4:F6"))
    res_b4 = drive("pm_fill B=4", lambda: kde_pipeline(depth4, color4, intr, cfg_b),
                   all_kernels)
    for tag, res in (("pm_fill B=1", res_b1), ("pm_fill B=4", res_b4)):
        check_outputs(tag, res, k_count)
    for f in ("nasp_labels", "merged_labels", "merged_sizes"):
        if not torch.equal(getattr(res_b1, f), getattr(res_b4, f)[0]):
            _fail(f"pm_fill: {f} of B=1 differs from frame 0 of B=4")
    dmm = (res_b1.optimized_points - res_b4.optimized_points[0]).abs().amax(-1)
    print(f"pm_fill: B=1 labels and sizes equal to frame 0 of B=4; optimized points max "
          f"|d| {float(dmm.max()):.3g} mm, within 1e-3 mm on "
          f"{float((dmm <= 1e-3).double().mean()):.6f} of pixels")
    filled = int(((res_b4.optimized_points[..., 2] > 50.0) & (depth4 <= 50.0)).sum())
    print(f"pm_fill B=4: {filled} input holes with depth in the output")
    check_again("pm_fill B=4", lambda: kde_pipeline(depth4, color4, intr, cfg_b), res_b4)
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        path_ms[f"pm_fill B={bsz}"] = time_path(
            f"pm_fill B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_b), bsz)

    # (c) three NASP iterations: the "auto" locality (the capped route's
    # r = 5 cell-local updates) against "global" (one-hot updates); both
    # assign by the global sweep
    r5_forms = ("nasp_cell_sums:r5:analyze", "nasp_cell_sums:r5:weighted",
                "label_cell_sums:r5:F2", "label_cell_gather:r5:F6")
    cfg_c = {loc: dataclasses.replace(cfg, nasp=dataclasses.replace(
        nasp_p, iterations=3, locality=loc)) for loc in ("auto", "global")}
    res_c = {}
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        res_c[bsz] = drive(f"iter3 B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_c["auto"]),
                           all_kernels, r5_forms)
        res_g = drive(f"iter3.global B={bsz}",
                      lambda: kde_pipeline(d, c, intr, cfg_c["global"]),
                      stencil_kernels + ("nasp_assign_analyze", "nasp_cell_sums"))
        check_outputs(f"iter3 B={bsz}", res_c[bsz], k_count)
        if any(f.split(":")[1] == "r5" for f in path_forms[f"iter3.global B={bsz}"]):
            _fail("the global route launched an r = 5 cell kernel")
        # one later iteration on each route from the same state (two
        # iterations on the capped route): one sweep, so labels and
        # distances bitwise equal; the updates sum in different orders, so
        # the cluster tables are held to the stats routes' bar
        pts = projective_to_real(res_c[bsz].jbf_depth, intr)
        two = slic.segment(c, pts, res_c[bsz].normals, grid=grid,
                           params=dataclasses.replace(cfg_c["auto"].nasp, iterations=2))
        state = (two.labels, two.distance, two.clusters, c.to(torch.float32), pts,
                 res_c[bsz].normals)
        step = {loc: slic.later_iteration(*state, grid=grid, params=cfg_c[loc].nasp)
                for loc in ("auto", "global")}
        same_step = (torch.equal(step["auto"][0], step["global"][0])
                     and torch.equal(step["auto"][1], step["global"][1]))
        print(f"iter3 B={bsz} step: labels and distances of the routes bitwise equal: "
              f"{same_step}")
        if not same_step:
            _fail(f"iter3 B={bsz}: one iteration from the same state gave other labels")
        a, g = step["auto"][2], step["global"][2]
        for f in ("size", "xy", "rgb"):
            dc = (getattr(a, f).double() - getattr(g, f).double()).abs()
            dc = dc.reshape(dc.shape[0], dc.shape[1], -1).amax(-1)
            eq = float((dc == 0).double().mean())
            print(f"iter3 B={bsz} step: cluster {f} equal on {eq:.4f} of clusters, "
                  f"max |d| {float(dc.max()):.3g}")
            if eq < 0.99 or float(dc.max()) > 1.0:
                _fail(f"iter3 B={bsz}: cluster {f} differs between the routes beyond the bar")
        close = (torch.allclose(a.center, g.center, rtol=1e-5, atol=1e-3)
                 and torch.allclose(a.normal, g.normal, rtol=1e-5, atol=1e-5))
        print(f"iter3 B={bsz} step: centres and normals within tests/test_slic.py:179's "
              f"tolerances: {close}")
        if not close:
            _fail(f"iter3 B={bsz}: cluster tables differ between the routes beyond the bar")
        # end to end, an ulp of a cluster table can move a pixel at a
        # distance near-tie in the third sweep: at most 8 pixels a batch
        # (1 of 1228800 seen at B=4, ROADMAP Queue C)
        ndiff = int((res_c[bsz].nasp_labels != res_g.nasp_labels).sum())
        part = min(golden.partition_agreement(a_, g_)[0] for a_, g_ in zip(
            res_c[bsz].merged_labels.cpu().numpy(), res_g.merged_labels.cpu().numpy()))
        dmm = (res_c[bsz].optimized_points - res_g.optimized_points).abs().amax(-1)
        within = float((dmm < 1.0).double().mean())
        print(f"iter3 B={bsz}: NASP labels differ on {ndiff} pixels (bar <= 8), "
              f"merged-partition agreement {part:.6f} (bar > 0.9999); optimized points "
              f"within 1 mm on {within:.6f} of pixels (bar > 0.9999), max |d| "
              f"{float(dmm.max()):.3g} mm")
        if not (ndiff <= 8 and part > 0.9999 and within > 0.9999):
            _fail(f"iter3 B={bsz}: the capped and the global route differ beyond the bar")
        moved = float((res_c[bsz].nasp_labels != res1.nasp_labels if bsz == 1 else
                       res_c[bsz].nasp_labels != res4.nasp_labels).double().mean())
        print(f"iter3 B={bsz}: iterations 2-3 moved {moved:.4f} of the labels")
        # the later iterations' assignment alone (plain PyTorch, 64 offsets)
        args = state + (grid, nasp_p, (w // grid.cols + h // grid.rows) / 2.0)
        t_glob = cuda_ms(lambda: slic._assign_global(*args), warmup=1, iters=5)
        path_ms[f"assign_global B={bsz}"] = t_glob
        print(f"iter3 B={bsz}: later iterations' assignment {t_glob:.3f} ms per call "
              f"(median of 5)")
        check_again(f"iter3 B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_c["auto"]),
                    res_c[bsz])
        path_ms[f"iter3 B={bsz}"] = time_path(
            f"iter3 B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_c["auto"]), bsz)
        path_ms[f"iter3.global B={bsz}"] = time_path(
            f"iter3.global B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_c["global"]), bsz)

    # (d) a Kinect v2 frame, 424x512: the default 15x20 grid does not divide
    # it, so the NASP and downstream stages take the global route
    intr_v2 = default_kinect_intrinsics(512, 424)
    vcolor, vnoisy, _ = make_noisy_scene(424, 512, intr_v2, seed=0)
    vd, vc = torch.from_numpy(vnoisy).to(dev), torch.from_numpy(vcolor).to(dev)
    res_d = drive("kinect_v2 424x512", lambda: kde_pipeline(vd, vc, intr_v2, cfg),
                  stencil_kernels)
    check_outputs("kinect_v2 424x512", res_d, k_count)
    check_again("kinect_v2 424x512", lambda: kde_pipeline(vd, vc, intr_v2, cfg), res_d)
    path_ms["kinect_v2 B=1"] = time_path(
        "kinect_v2 424x512 B=1", lambda: kde_pipeline(vd, vc, intr_v2, cfg), 1)
    # ---- phase 7: the DASP / ERS pipelines at 640x480, B=1 and B=4, each
    # driven from counts at 0 (the colour gradient, the label sums and the
    # gather must launch, in the forms named), with its host cap reads
    # counted (labels_within_cap read on the host: one a later SLIC
    # iteration, one for the ERS labels' index); checked, timed, profiled
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import (
        rgbf_pipeline, spdsp_pipeline, tof_pipeline,
    )

    dasp_want = golden.load_dasp("640x480")
    raw4 = projective_to_real(depth4, intr)
    front = ("rgbf.color_slic", "rgbf.depth_slic", "rgbf.ers")
    r2 = ("seed_gradient:color", "label_cell_sums:r2:F10", "label_cell_gather:r2:F2")
    capped = ("label_cell_sums:r3:F10", "label_cell_gather:r3:F2")
    pca = ("label_cell_sums:r4:F4", "label_cell_sums:r4:F6", "label_cell_gather:r4:F3",
           "label_cell_gather:r4:F4")
    dasp_paths = {
        "rgbf": (lambda d, p, c: rgbf_pipeline(d, p, c), front, r2),
        "spdsp": (lambda d, p, c: spdsp_pipeline(d, p, c, intr), front
                  + ("spdsp.planes", "spdsp.mrf"), r2 + capped + pca + ("label_cell_gather:r4:F1",)),
        "tof": (lambda d, p, c: tof_pipeline(d, p, c, intr), front + ("tof.planes",),
                r2 + capped + pca + ("label_cell_gather:r4:F7",)),
    }
    cap_reads = []
    within_cap = slic._within_cap

    def counted_within_cap(*args):
        cap_reads.append(args[2])
        return within_cap(*args)

    slic._within_cap = counted_within_cap
    gt0_np = scenes[0][2]
    gt0_pts = projective_to_real(torch.from_numpy(gt0_np).to(dev), intr)
    for name, (run, stage_scopes, forms) in dasp_paths.items():
        res = {}
        for bsz in (1, 4):
            d, p_, c = depth4[:bsz], raw4[:bsz], color4[:bsz]
            if bsz == 1:
                d, p_, c = d[0], p_[0], c[0]
            cap_reads.clear()
            res[bsz] = drive(f"{name} B={bsz}", lambda: run(d, p_, c),
                             ("cuda_gradient", "label_cell_sums", "label_cell_gather"), forms)
            print(f"{name} B={bsz}: {len(cap_reads)} host cap reads a call (caps {cap_reads})")
            for f in res[bsz]._fields:
                t = getattr(res[bsz], f)
                if t.dtype == torch.int32:
                    if int(t.min()) < -1 or int(t.max()) >= k_count:
                        _fail(f"{name} B={bsz}: {f} out of range")
                elif not bool(torch.isfinite(t).all()):
                    _fail(f"{name} B={bsz}: non-finite values in {f}")
        got1 = {f: getattr(res[1], f).cpu().numpy() for f in res[1]._fields}
        for f in got1:
            if got1[f].dtype == np.int32:
                same = float((got1[f] == getattr(res[4], f)[0].cpu().numpy()).mean())
                print(f"{name}: {f} of B=1 equal to frame 0 of B=4 on {same:.6f} of pixels "
                      "(bar > 0.9999)")
                if not same > 0.9999:
                    _fail(f"{name}: {f} of B=1 differs from frame 0 of B=4")
        if name == "spdsp":  # its SLIC labels, as the fixture stores them
            sp_cfg = SPDSPConfig()
            for f, prm in (("color_labels", sp_cfg.color_slic), ("depth_labels", sp_cfg.depth_slic)):
                got1[f] = slic.segment(color4[:1], raw4[:1], grid=grid, params=prm,
                                       variant="dasp").labels[0].cpu().numpy()
        gates = golden.dasp_jax_gates(name, got1, dasp_want)
        if name == "rgbf":
            gates.update(golden.rgbf_quality_gates(got1["refined_depth"], gt0_np))
        elif name == "spdsp":
            err_in, _ = metrics.mean_3d_error(raw4[0], gt0_pts)
            err_ers, n = metrics.mean_3d_error(projective_to_real(res[1].refined_depth, intr),
                                               gt0_pts)
            err_out, _ = metrics.mean_3d_error(res[1].optimized_points, gt0_pts)
            gates.update(golden.spdsp_quality_gates(float(err_in), float(err_ers),
                                                    float(err_out), int(n)))
        else:
            gates.update(golden.tof_quality_gates(got1["plane_fitted"][..., 2], gt0_np))
        for gname, (val, lim, ok) in gates.items():
            print(f"{name} 640x480 {gname:28s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
        if golden.failures(gates):
            _fail(f"{name} 640x480 against the JAX package and ground truth: "
                  f"{golden.failures(gates)}")
        check_again(f"{name} B=4", lambda: run(depth4, raw4, color4), res[4])
        for bsz in (1, 4):
            d, p_, c = depth4[:bsz], raw4[:bsz], color4[:bsz]
            path_ms[f"{name} B={bsz}"] = time_path(
                f"{name} B={bsz}", lambda: run(d, p_, c), bsz, scopes=stage_scopes)
    slic._within_cap = within_cap
    # the DASP sweep alone (plain PyTorch, 16 candidates), from the depth
    # SLIC's state after one iteration: SPDSP and TOF run ten a call
    sp_cfg = SPDSPConfig()
    s_scale_d, _ = slic._update_geometry(grid, h, w, "dasp")
    for bsz in (1, 4):
        one = slic.segment(color4[:bsz], raw4[:bsz], grid=grid, variant="dasp",
                           params=dataclasses.replace(sp_cfg.depth_slic, iterations=1))
        args = (one.labels, one.distance, one.clusters, color4[:bsz].to(torch.float32),
                raw4[:bsz], None, grid, sp_cfg.depth_slic, s_scale_d, "dasp")
        t_sw = cuda_ms(lambda: slic._assign_global(*args), warmup=1, iters=5)
        path_ms[f"dasp_sweep B={bsz}"] = t_sw
        print(f"dasp sweep B={bsz}: {t_sw:.3f} ms per call (median of 5)")
    print("slice paths ms per call: " + "  ".join(f"{k} {v:.3f}" for k, v in path_ms.items()))

    # ---- phase 8: summary lines, one JSON entry per TPU kernel; a second
    # form of a kernel (colour-only gradient, analyze-mode sums, the shapes
    # of phase 6's paths) is checked and timed beside its main-path form
    # above, and listed under the row's "forms" with its launches by path
    def form_entry(name, k):
        """A kernel's form: its shape, B=1 / B=4 numbers, and its launches
        per driven path (cuda_nasp.launch_forms)."""
        r = report[name]
        key = f"{k.get('row', name)}:{k['form']}"
        return {"form": name, "launch_form": key, "max_abs_err": r["max_abs_err"],
                "ms": r["ms_b1"], "device_ms": r["device_ms_b1"], "plain_ms": r["plain_ms_b1"],
                "bound_ms": r["bound_ms_b1"], "library_ms": r["library_ms_b1"],
                "ms_b4": r["ms_b4"], "device_ms_b4": r["device_ms_b4"],
                "bound_ms_b4": r["bound_ms_b4"],
                "launches_by_path": {p: f[key] for p, f in path_forms.items() if key in f}}

    out = []
    for name, k in kernels.items():
        if k.get("secondary"):
            continue
        row = k.get("row", name)
        r = report[name]
        err = max(report[n]["max_abs_err"] for n, kk in kernels.items()
                  if kk.get("row", n) == row)
        mod = k["module"]
        is_nasp = mod is cuda_nasp
        out.append({
            "name": row, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES[row] if is_nasp else mod.REPLACES,
            "launches": launches[row if is_nasp else mod.__name__.rsplit(".", 1)[-1]],
            "max_abs_err": err, "ms": r["ms_b1"], "plain_ms": r["plain_ms_b1"],
            "bound_ms": r["bound_ms_b1"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms_b1"],
            "ms_b4": r["ms_b4"], "plain_ms_b4": r["plain_ms_b4"],
            "bound_ms_b4": r["bound_ms_b4"], "library_ms_b4": r["library_ms_b4"],
            "device_ms": r["device_ms_b1"], "device_ms_b4": r["device_ms_b4"],
            "library_device_ms": r["library_device_ms_b1"],
            "library_device_ms_b4": r["library_device_ms_b4"],
            "forms": [form_entry(n, kk) for n, kk in kernels.items()
                      if "form" in kk and kk.get("row", n) == row],
        })
    print("kde ms per frame: " + "  ".join(
        f"{label} B={bsz} {ms:.3f}" for (label, bsz), ms in frame_ms.items()))
    print(json.dumps({"kernels": out}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
