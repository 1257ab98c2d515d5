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
     (the PCA planes, the PCA merge's table) at r = 4; and the JBF on the
     haloed width tiles phase 11's paths give it ([B, 480, 324], [B, 480,
     164], [B, 480, 161]: x = 2 and 4 at 640 columns, x = 4 at 628); and
     the forms the tiled route gives rows 2-8 (rows 2t-8t): the DT and
     the covariance on the haloed tiles the tiled normals hand them
     ([B, 480, 347] at x = 2, [B, 480, 214] at x = 4), the seed gradient
     on x = 2's tile sub-grid, the four cell kernels at x = 2's tile
     (cell columns 10-19); and at that tile the forms the other configs'
     tiled steps add (rows 6bt-8bt): the NASP sums at r = 5, the label
     sums at F = 4 and 6 (r = 4) and F = 2 at r = 5, the gathers at F =
     6, 3 and 1 at r = 5; and the forms of the tiled route on frames the
     grid does not divide and on tiles that split a cell (rows 1v, 2v, 3v,
     4h, 5u-8u): the JBF on the 424x512 Kinect v2 frame's tiles ([B, 424,
     260], [B, 424, 132]), the DT and the covariance on its haloed tiles
     ([B, 424, 283], [B, 424, 182]), the seed gradient on its 5-column
     haloed tile ([B, 424, 261]), the four cell kernels on x = 8's
     cell-aligned tile at 640 (cell columns 3-4); and the global label
     index's label counts on NASP's labels of the 424x512 frame (pairs with
     the right and the down neighbours, and the single form; bitwise), and
     a CCL merge's three of them at B=8 against the index_add_ scatter
     that could replace them (bitwise, device ms a frame); the global
     route's assignment sweep (assign_global_kernel) of a later NASP
     iteration on the 424x512 frames and of a DASP one at 640x480, B=1,
     B=4 and B=8, bitwise its plain version; time kernel,
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
     hold the NASP kernels against their plain twins (golden.plain_nasp)
     at B=4; print the median ms per frame and the profile by stage, with
     the device ms and launches of each of the port's own kernels in that
     call;
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
  8. drive this slice's paths at 640x480, each from launch counts at 0:
     kde_pipeline with normals.method "sdc" and "bilateral" at B=1 and B=4
     (bilateral launches neither the DT nor the covariance kernel, SDC no
     covariance kernel), held against the JAX package's output
     (tests/golden/kde_jax_640x480_normals_seed0.npz,
     golden.normal_method_gates), the normals against the port's CPU run of
     the same points, B=4 bitwise on a second run; mrf_pipeline against the
     JAX package's and the CPU's output (rtol 1e-6); run_stream over 32
     frames at batch 1, 4 and 8, capture and kde_only, each chunk's points
     bitwise equal to kde_pipeline on the same batch, frames per second and
     the device busy share, and a run stopped at 16 frames and resumed from
     its checkpoint equal to the uninterrupted one; the enhance command for
     the six pipelines through files, each refined depth equal to the
     pipeline's output, kde with --ply, --png and --debug-dir; each timed (CUDA
     events, or the host clock around a whole stream) and profiled;
  10. (before phase 9's summary) drive the evaluation and data-ingest
     slice at 640x480, each path from launch counts at 0 with each
     evaluate row's launches (every row must launch the kernels its method
     runs and no other): (a) evaluate(make_noisy_scene(480, 640, seed=0),
     include_sp_methods=True, timing_iters=3) with its report and figure,
     each row's error held against the port's CPU run of the row and,
     where committed, the JAX package's output of the frame; (b) the
     far-range rows (scripts/eval_far_range.py --holes 0.15: plane merge,
     hole fill) the same way, and the plane stage under the cm and SDC
     normals against the JAX package's where it moves pixels
     (tests/golden/kde_jax_planes_seed0.npz, golden.plane_stage_gates);
     (c) `evaluate --tum` through the command line (runpy, as python -m
     runs it) on a 30-frame Kinect v1 sensor-model sequence; (d)
     register_depth_to_color, the card's output equal to the CPU's and held
     against the JAX function's (golden.registration_gates), timed; (e) 32
     XML frames through the native frame source into run_stream (batch 8),
     every chunk bitwise equal to the stream over core/io.py reads, frames
     per second; and the cm normals read against the JAX package's alone,
     in SDC's place and rounded to f16 (ROADMAP C1);
  11. (before phase 9's summary) drive the multi-process layer
     (parallel/) at 640x480: (a) world size 1 over NCCL in this process
     (initialize from MASTER_ADDR / MASTER_PORT / RANK, global_mesh,
     local_batch_to_global of the four frames): the data-parallel step
     bitwise equal to phase 4's kde_pipeline at B=4, every kernel launched,
     frame 0 through golden.kde_gates against the JAX package, global_mean
     equal to the local mean, jbf_sharded bitwise equal to the unsharded
     JBF; (b) gloo ranks sharing the card (multihost.spawn, world 2 and
     4): jbf_sharded on 320-, 160- and 157-px tiles, the spatial step
     (data 1 x x 2) and the data-parallel step (data 2 x x 1), each
     gathered and bitwise equal to the unsharded run, one JBF launch a
     rank a step; and the tiled route (sharding.spatial_kde), default
     config, on four frames and on frame 0, each from counts at 0: the
     640x480 frames at x = 2 and 4 (data tiles of whole cells) and x = 8
     (eight ranks: 80-px data tiles split the 32-px cells, so the stages
     run on cell-aligned tiles of 96 and 64 px), the 424x512 Kinect v2
     frames at x = 2 and 4 and the 628 crop at x = 4 (the grid does not
     divide them: NASP's global route, no cell kernel, the seed gradient
     on haloed tiles): spatial_route "tiled", every KDEResult field
     gathered and bitwise equal to kde_pipeline on the card, every kernel
     of the path launched on its tile forms by every rank and none it
     does not run, the collectives a step, and per rank the peak device
     memory and step ms of the tiled route beside the replicated route's
     (and rank 0's unsharded call's) at B=4, and on the 640x480 frames at
     x = 2 and 4 also at B=1 with device ms by kde.* stage; then
     the other configs on the tiled route at x = 2 and 4, B=4 (and B=1
     once): the bilateral and SDC normals, plane merge with fill_holes=4
     on phase 10's banded frame with 15% holes (and three more seeds),
     three NASP iterations capped and with locality="global", and all of
     them at once: spatial_route "tiled", every field bitwise
     kde_pipeline's, holes filled within the fill's reach of an inner
     tile edge, each kernel of the path launched in its tile forms (and
     none it does not run), the collectives a step, and per rank the
     peak device memory and step ms beside the replicated route's;
     (c) dryrun(1) over NCCL and dryrun(4) under gloo; CUDA
     event times (median of 5) of the step at world 1 against a bare
     kde_pipeline call, one exchange_width under NCCL and under gloo, and
     jbf_sharded a tile against the unsharded JBF, printed beside the
     card's name and power limit (one card: not a scaling number);
  12. (before phase 9's summary) drive the compiled call (core/jit.py,
     phase12): each of the slice's kde_pipeline configs (default, plane
     merge + fill_holes=4, three NASP iterations "auto" and "global", SDC
     and bilateral normals, the 424x512 Kinect v2 frames) and the JBF and
     MRF baselines at B=1 and B=4 through jit, the replay bitwise the
     eager call, every kernel of the eager call in the capture's launches
     and in a profiled replay (as often as eagerly), eager against replay
     ms, capture ms, pool and busy share; rgbf_pipeline, spdsp_pipeline
     and tof_pipeline likewise at B=1 and B=4 (0, 9 and 9 conds) and TOF
     on the 424x512 frame (0); the conditional node taken both ways, on
     NASP labels and on the ERS labels' index; the SPDSP and TOF replays
     against the JAX package's outputs; run_stream at batch 1, 4 and 8 and
     a resumed run; the compiled Buffer2D fold and evaluate_tum's jitted
     step bitwise the eager fold; a host read under jit raising.
     Phase 12 runs in a process of its own (`python3 chip_smoke.py
     --phase12`, which alone runs phases 1, 2 without the SASS counts,
     and 12);
  9. print the kernels JSON line (one entry per TPU kernel of the repo and
     one each for the label counts, the label sums and the global sweep,
     which replace none, each with its forms and
     their launches by path, and its launches on
     phase 10's and phase 11's paths), then {"ok": true, "device": ...}
     last.

Kernels are built under build/kernels/, the native frame source under
build/native/, and phases 8 and 10 write their files under
build/chip_smoke/ (build/ is listed in .gitignore).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import shutil
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
# the global sweep (csrc/nasp.cu's assign_global_kernel): f32 operations
# per pixel and in-grid candidate, by variant (NASP: colour 8, pixel 7,
# depth 2, weighting 7, normal dot 5, normal term 3, the compare 1, as the
# fused assignment counts them; DASP and SP stop after their terms), and
# issued instructions of its staged candidate loop per pixel and in-grid
# candidate (cuobjdump -sass of the build)
SWEEP_OPS = {"nasp": 33, "dasp": 23, "sp": 19}
SWEEP_LOOP_INSTRUCTIONS = {"nasp": 62, "dasp": 47, "sp": 39}

# the JBF's width tiles on phase 11's paths, named as cuda_bilateral's
# launch_forms name them, by the haloed tile's width (w<ws + 2 * rj>): x = 2 and 4 at 640 columns, x = 4 at 628 (157-px
# tiles, a width that is not a multiple of 4)
JBF_TILES = {"w324": (2, 640), "w164": (4, 640), "w161": (4, 628)}  # form: (x, W)

# the tiled route's kernel forms (phase 11), each on width tile s = 1: the DT
# and the covariance on the haloed tile that normals_sharded hands them (27
# columns of points each side, none past the frame), named by its width as
# cuda_dt's and cuda_cov's launch_forms name it: x = 2 ([B, 480, 347], its right edge the frame's) and x = 4 ([B, 480, 214]);
# the seed gradient and the four cell kernels on x = 2's tile, cell columns
# [CELL_TILE[0], CELL_TILE[0] + CELL_TILE[1])
HALO_TILES = {"w347": 2, "w214": 4}  # form: x
CELL_TILE = (10, 10)  # (c0, tile cols) of x = 2's tile 1 on the 20-column grid
# the tiled route on the frames the grid does not divide and on tiles that
# split a cell (phase 11 (b)), each on tile s = 1: the 424x512 Kinect v2
# frame's JBF tiles at x = 2 and 4 (named as JBF_TILES), the DT and
# covariance on its 27-column haloed tiles of points (x = 2: [B, 424, 283],
# its right edge the frame's; x = 4: [B, 424, 182]) and the seed gradient on
# x = 2's 5-column haloed tile ([B, 424, 261]); the four cell kernels on
# x = 8's cell-aligned tile at 640 (2 of the 32-px cells, beside tile 0's 3)
V2_SHAPE = (424, 512)
V2_JBF_TILES = {"w260": 2, "w132": 4}  # form: x
V2_HALO_TILES = {"w283": 2, "w182": 4}  # form: x
V2_GRADIENT_TILE = "halo261"  # x = 2
UNEVEN_TILE = (3, 2)  # (c0, tile cols) of x = 8's tile 1 on the 20-column grid

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


def label_sums_f64(labels, feats, mask, k: int):
    """[B, K, F] float64 sums of feats [B, H, W, F] per label of labels
    [B, H, W] in [0, K) over mask (None: every pixel): the label-sums
    kernel's exact value, to float64 rounding."""
    import torch

    b, f = labels.shape[0], feats.shape[-1]
    flat = labels.reshape(b, -1).long()
    ok = (flat >= 0) & (flat < k)
    if mask is not None:
        ok &= mask.reshape(b, -1)
    key = (torch.arange(b, device=labels.device)[:, None] * k + flat)[ok]
    out = torch.zeros((b * k, f), dtype=torch.float64, device=labels.device)
    return out.index_add_(0, key, feats.reshape(b, -1, f)[ok].double()).reshape(b, k, f)


def label_sums_within_bound(got, labels, feats, mask, k: int):
    """(ok, most ulps) of the label-sums kernel's output `got` [B, K, F]
    against float64 sums E under csrc/nasp.cu's bound, |got - E| <= ulp(E)
    / 2 + n * 2^-53 * sum|terms| over a label's n terms, its second term
    doubled for the float64 sum's own error; and the largest gap in f32
    ulps at E (1 at most unless the terms cancel)."""
    import torch

    want = label_sums_f64(labels, feats, mask, k)
    n = label_sums_f64(labels, torch.ones_like(feats[..., :1]), mask, k)
    absum = label_sums_f64(labels, feats.abs(), mask, k)
    gap = (got.double() - want).abs()
    ok = bool((gap <= want.abs() * 2.0**-24 + n * 2.0**-52 * absum).all())
    w = want.float().abs()
    ulp = (torch.nextafter(w, torch.full_like(w, float("inf"))) - w).double()
    return ok, float((gap / ulp).max())


KDE_SCOPES = ("kde.jbf", "kde.normals", "kde.nasp", "kde.ccl_merge", "kde.projection")


def _stage_breakdown(fn, scopes=KDE_SCOPES) -> dict:
    """One profiled call of fn (torch.profiler): its device activities by
    kde.* stage, by kernel name and for the port's own kernels.  Every
    device activity of the trace counts, the kernels launched through
    ctypes too, which the profiler attaches to no CPU op; an activity counts
    under the stage whose device-side span holds it, and one outside every
    span under the stage of the activity before it (one stream, stages in
    order).  Returns per: {stage: [device ms, activities]}, by_kernel,
    port: {kernel: [device ms, launches]}, work (activities), attached,
    spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_device = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in on_device if ev.name in scopes)
    starts = [t0 for t0, _, _ in spans]  # the spans follow one another
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
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            scope = spans[i][2]
        ms = ev.time_range.elapsed_us() / 1e3
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        per[scope][0] += ms
        per[scope][1] += 1
        own = PORT_KERNEL.match(ev.name)
        if own:
            acc = port.setdefault(own.group(1), [0.0, 0])
            acc[0] += ms
            acc[1] += 1
    return {"per": per, "by_kernel": by_kernel, "port": port, "work": len(work),
            "attached": attached, "spans": len(spans)}


def _phase11_rank(depth_np, color_np, crop_w: int, banded_np, v2_np) -> dict:
    """One gloo rank of phase 11 (b), on the shared card.  At world 2 and 4:
    the JBF on width tiles of the four 640x480 frames at x = world size
    (and, at world 4, of their 628-column crop), at world 2 the spatial step
    (data 1 x x 2) and the data-parallel step (data 2 x x 1, B=2 a rank),
    each from launch counts at 0; the outputs gathered (rank 0 returns
    them), and the times of one exchange_width and one jbf_sharded call
    (CUDA events, median of 5; every rank times the same calls, as each is
    a collective); then the tiled route under the default config on the
    640x480 frames, the Kinect v2 frames (v2_np: 424x512 depth and colour)
    and, at world 4, the 628 crop (_phase11_tiled), and the other configs
    (_phase11_configs; banded_np: the banded frames' depth and colour).  At
    world 8: the tiled route on the 640x480 frames alone, whose 80-px data
    tiles split the 32-px cells."""
    import torch
    import torch.distributed as dist

    from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu_torch.ops import (
        cuda_bilateral, cuda_cov, cuda_dt, cuda_gradient, cuda_nasp,
    )
    from kinectdepthmapenhancement_tpu_torch.parallel import halo, sharding
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh
    from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import jbf_sharded
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

    mods = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)

    def zero():
        """Launch counts and forms at 0."""
        for m in mods + (cuda_nasp,):
            m.launch_forms.clear()
        for m in mods:
            m.launches = 0
        for k in cuda_nasp.launches:
            cuda_nasp.launches[k] = 0

    def counted(fn):
        """fn() from launch counts and forms at 0 -> (its output, the
        launches by kernel, the launches by form as the wrappers record
        them)."""
        zero()
        out = fn()
        torch.cuda.synchronize()
        c = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in mods}
        c.update(cuda_nasp.launches)
        forms = {}
        for m in mods + (cuda_nasp,):
            forms.update(m.launch_forms)
        return out, c, forms

    n = dist.get_world_size()
    mesh = make_mesh(n, spatial=n, device="cuda")  # one data row, n width tiles
    depth = torch.from_numpy(depth_np).to(mesh.device)
    color = torch.from_numpy(color_np).to(mesh.device)
    h, w = depth.shape[1:]
    intr, cfg = default_kinect_intrinsics(w, h), KDEConfig()
    p = cfg.jbf
    res = {"rank": dist.get_rank(), "device": str(mesh.device), "counts": {}, "forms": {},
           "expect": {}, "out": {}, "ms": {}}
    if n == 8:
        _phase11_tiled(res, mesh, {"split": (depth, color, intr)}, cfg, counted)
        _phase11_compiled(res, {"split default B=4": (mesh, cfg, intr, depth, color)}, zero,
                          counted)
        return res

    def path(tag, m, fn, form=None):
        """Drive fn from counts at 0; `form` the JBF's launch form the path
        must launch on (it reads the wrapper's record)."""
        out, res["counts"][tag], res["forms"][tag] = counted(fn)
        res["expect"][tag] = form
        res["out"][tag] = (tuple(out.shape), (halo.gather_width(out, m) if out.dim() == 3
                                              else sharding.gather_global(out, m)).cpu())

    frames = [(w, depth, color)] + ([(crop_w, depth[:, :, :crop_w], color[:, :, :crop_w])]
                                    if n == 4 else [])
    for width, d, c in frames:
        wid = f"w{width // n + 4}"
        form = f"jbf:{wid}"
        path(f"jbf x{n} {wid}", mesh,
             lambda d=d, c=c: jbf_sharded(mesh.width_tile(d), mesh.width_tile(c), mesh, p), form)
        d1, c1 = mesh.width_tile(d[:1]), mesh.width_tile(c[:1])
        res["ms"][f"exchange_width gloo x{n} (colour halo 4, {wid}, B=1)"] = cuda_ms(
            lambda c1=c1: halo.exchange_width(c1, 4, mesh), warmup=2, iters=5)
        res["ms"][f"jbf_sharded gloo x{n} {wid} B=1"] = cuda_ms(
            lambda d1=d1, c1=c1: jbf_sharded(d1, c1, mesh, p), warmup=2, iters=5)
    vd, vc = (torch.from_numpy(a).to(mesh.device) for a in v2_np)
    cases = {"640": (depth, color, intr),
             "v2": (vd, vc, default_kinect_intrinsics(vd.shape[2], vd.shape[1]))}
    if n == 4:
        cases["crop628"] = (depth[:, :, :crop_w].contiguous(), color[:, :, :crop_w].contiguous(),
                            default_kinect_intrinsics(crop_w, h))
    _phase11_tiled(res, mesh, cases, cfg, counted)
    banded = tuple(torch.from_numpy(a).to(mesh.device) for a in banded_np)
    _phase11_configs(res, mesh, {"noisy": (depth, color), "banded": banded}, intr, counted)
    if n == 2:
        # the eager steps (the compiled call's function, step.fn); part (d)
        # below runs them compiled
        step = sharding.sharded_kde_step(mesh, intr, cfg).fn
        path("spatial step data1 x2", mesh,
             lambda: step(mesh.width_tile(depth), mesh.width_tile(color)), f"jbf:w{w // n + 4}")
        res["ms"]["spatial step gloo data1 x2 B=4"] = cuda_ms(
            lambda: step(mesh.width_tile(depth), mesh.width_tile(color)), warmup=1, iters=5)
        mesh_d = make_mesh(n, spatial=1, device="cuda")
        b = depth.shape[0] // mesh_d.data
        rows = slice(mesh_d.d * b, (mesh_d.d + 1) * b)
        step_d = sharding.sharded_kde_step(mesh_d, intr, cfg).fn
        path("data step data2 x1", mesh_d, lambda: step_d(depth[rows], color[rows]))
        cases = {"640 default B=4": (mesh, cfg, intr, depth, color),
                 "640 default B=1": (mesh, cfg, intr, depth[:1], color[:1]),
                 "data2 x1 default B=4": (mesh_d, cfg, intr, depth, color)}
    else:
        iter3 = phase11_configs()["iter3"][0]
        cases = {"640 default B=4": (mesh, cfg, intr, depth, color),
                 "640 iter3 B=4": (mesh, iter3, intr, depth, color),
                 "v2 default B=4": (mesh, cfg, default_kinect_intrinsics(vd.shape[2], vd.shape[1]),
                                    vd, vc)}
    _phase11_compiled(res, cases, zero, counted)
    if res["rank"] != 0:
        res["out"] = {}
    return res


# each compiled case of phase 11 (d): the host steps of a replay (the eager
# step's collectives, TILED_CASE_PATHS and tests/test_torch_tiled_configs.py)
# and its host branches (the capped route's two later updates and the label
# index; no conditional node on any of these paths)
COMPILED_CASE_STEPS = {
    "640 default B=4": (14, 0), "640 default B=1": (14, 0), "data2 x1 default B=4": (0, 0),
    "640 iter3 B=4": (25, 3), "v2 default B=4": (18, 0), "split default B=4": (16, 0),
}
# what a capture with host branches launches beyond the eager step, by
# form: it records both branches of each; the untaken global branch of the
# label index (one CCL merge and the plane residual on the global index)
# runs the label counts and the F = 2 label sums, the capped route's two
# untaken global updates the analyze (F = 13) and weighted (F = 14) sums
UNTAKEN_GLOBAL_INDEX_FORMS = {"label_counts:pairs": 2, "label_counts:single": 1,
                              "label_sums:F=2": 1, "label_sums:F=13": 2, "label_sums:F=14": 2}


def _phase11_compiled(res, cases, zero, counted) -> None:
    """Phase 11 (d), the compiled step, on one gloo rank: each case (tag:
    mesh, config, intrinsics, the global batch's depth and colour) through
    sharding.sharded_kde_step.  The eager step (step.fn) from launch counts
    at 0 with its collectives; the first compiled call (warm-up and
    capture) with the counts zeroed as its capture begins (jit.capture_hooks),
    so they count the capture alone; two replays, each bitwise the eager
    step's block, no output shared, their host steps (jit.stats) and the
    launches they make from Python (none); replay 1 gathered over the world
    and, on rank 0, held bitwise against kde_pipeline on the same frames;
    eager and replay ms (CUDA events, median of 5; every rank times the
    same calls, each a collective), warm-up and capture ms, the pool, the
    pieces, host steps and host branches with their branches taken; rank 0
    profiles one replay (the others replay beside it).  jit.clear() and
    torch.cuda.empty_cache() after each case.  Results go in
    res["compiled"]."""
    import torch

    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu_torch.parallel import mesh as mesh_mod
    from kinectdepthmapenhancement_tpu_torch.parallel import sharding
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

    out = res["compiled"] = {}
    torch.cuda.empty_cache()  # (b)'s cached blocks: each case's pool and warm-up need room
    for tag, (m, cfg, intr, depth, color) in cases.items():
        b = depth.shape[0] // m.data
        rows = slice(m.d * b, (m.d + 1) * b)
        blocks = (m.width_tile(depth[rows]), m.width_tile(color[rows]))
        step = sharding.sharded_kde_step(m, intr, cfg)
        mesh_mod.collectives = 0
        eager, eager_counts, eager_forms = counted(lambda: step.fn(*blocks))
        run = {"collectives": mesh_mod.collectives, "eager_counts": eager_counts,
               "eager_forms": eager_forms, "block": tuple(eager.shape)}
        jit.capture_hooks.append(zero)
        try:
            first, run["capture_counts"], run["capture_forms"] = counted(lambda: step(*blocks))
        finally:
            jit.capture_hooks.remove(zero)
        zero()
        replays, host_steps = [], []
        for _ in range(2):
            before = jit.stats["host_steps"]
            replays.append(step(*blocks))
            torch.cuda.synchronize()
            host_steps.append(jit.stats["host_steps"] - before)
        _, run["replay_counts"], _ = counted(lambda: None)
        run["host_steps"] = host_steps
        run["bitwise"] = all(torch.equal(x, eager) for x in [first] + replays)
        run["aliased"] = replays[0].data_ptr() == replays[1].data_ptr()
        run["route"] = getattr(step, "route", "data")
        full = sharding.gather_global(replays[0], m)
        if m.rank == 0:
            want = kde_pipeline(depth[:m.data * b].contiguous(), color[:m.data * b].contiguous(),
                                intr, cfg).optimized_points
            run["gathered_bitwise"] = torch.equal(full, want)
        run["eager_ms"] = cuda_ms(lambda: step.fn(*blocks), warmup=1, iters=5)
        run["replay_ms"] = cuda_ms(lambda: step(*blocks), warmup=1, iters=5)
        if m.rank == 0:
            run["profile"] = _replay_profile(lambda: step(*blocks))
        else:
            step(*blocks)
            torch.cuda.synchronize()
        (info,) = step.info()
        run.update({k: info[k] for k in ("warmup_ms", "capture_ms", "pieces", "conds",
                                         "host_branches", "host_taken")})
        run["pool_mib"] = info["pool_bytes"] / 2**20
        out[tag] = run
        del step, eager, first, replays, full
        jit.clear()
        torch.cuda.empty_cache()


# the cell kernels' launch forms on the tiled route (cuda_nasp.launch_forms):
# the first iteration, the weighted update, the plane residual and the
# gathers of CCL (F = 6) and the plane stage (F = 1, 3), each on a width tile
TILED_NASP_FORMS = ("nasp_assign_analyze:r4:tile", "nasp_cell_sums:r4:weighted:tile",
                    "label_cell_sums:r4:F2:tile", "label_cell_gather:r4:F6:tile",
                    "label_cell_gather:r4:F1:tile", "label_cell_gather:r4:F3:tile")
_CELL_KERNELS = ("nasp_assign_analyze", "nasp_cell_sums", "label_cell_sums",
                 "label_cell_gather")
# the label index's kernels keyed by the whole [K] id space: the counts and
# pair counts of both indices (CCL's merges), and the global index's float
# segment sums
INDEX_KERNELS = ("label_counts", "label_sums")
# the global label index's own kernel: launched only where an index has no
# locality (a grid that does not divide the frame, labels off the cap,
# locality="global")
GLOBAL_INDEX_KERNELS = ("label_sums",)
# the global route's assignment sweep (slic._assign_global): every SP / DASP
# iteration, every later NASP iteration and NASP on a frame the grid does
# not divide; so idle, with the global index's kernels, where one NASP
# iteration runs on the cell route
CELL_ROUTE_IDLE = GLOBAL_INDEX_KERNELS + ("assign_global",)
# each tiled case of the default config: the kernels it must not launch (by
# counter; every other must launch), the cell and gradient forms it must
# launch and its collectives a step (B=4 and B=1 alike).  "640": data tiles
# of whole cells; "split": x = 8's cell-aligned tiles (the data tiles split
# cells: two retiles more); "v2", "crop628": frames the grid does not divide
# (NASP's global route: no cell kernel, the seed gradient on haloed tiles,
# four gathers more for the global first iteration and the seed windows)
TILED_CASE_PATHS = {
    "640": (CELL_ROUTE_IDLE, TILED_NASP_FORMS + ("seed_gradient:nasp:tile",), 14),
    "split": (CELL_ROUTE_IDLE, TILED_NASP_FORMS + ("seed_gradient:nasp:tile",), 16),
    "v2": (_CELL_KERNELS, ("seed_gradient:nasp:halo", "assign_global:nasp:r4"), 18),
    "crop628": (_CELL_KERNELS, ("seed_gradient:nasp:halo", "assign_global:nasp:r4"), 18),
}


def _phase11_tiled(res, mesh, cases, cfg, counted) -> None:
    """Phase 11 (b)'s tiled route on one gloo rank (data 1 x x n), the
    default config on each of `cases` (name: depth, colour, intrinsics of
    four frames): the spatial step's stages after the JBF on the rank's own
    width tile (sharding.spatial_kde) on the four frames (B=4) and on frame
    0 (B=1), each from launch counts at 0 and with the collectives it made
    and the launch forms the wrappers recorded, beside the widths the JBF,
    DT and covariance must launch on (the haloed data tile; the haloed tile
    of sharding.tile_spans); every KDEResult field gathered and, on rank 0,
    held bitwise against kde_pipeline on the card.  Then, on the same
    frames at B=4 (and B=1 on the "640" frames), each route's (tiled,
    replicated) peak device memory of this rank and its ms (CUDA events,
    median of 5), the replicated route's fields at B=4 gathered and held
    bitwise as the tiled route's, and on the "640" frames its device ms by
    kde.* stage (torch.profiler); and on rank 0 the unsharded
    kde_pipeline's.  Results go in res["tiled"]."""
    import torch

    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu_torch.parallel import halo, sharding, stencil_shard
    from kinectdepthmapenhancement_tpu_torch.parallel import mesh as mesh_mod
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

    out = res["tiled"] = {"routes": {}, "spans": {}, "runs": {}, "replicated": {},
                          "memory_mib": {}, "stage_ms": {}, "ms": {}}
    rj = cfg.jbf.window // 2
    halo_r = stencil_shard.normals_halo(cfg.normals)

    def gathered(result):
        """Every field of the tile's KDEResult over the group: the per-pixel
        maps along the width, the [B, K] tables checked equal on every
        rank."""
        g, same = {}, True
        for f in result._fields:
            v = getattr(result, f).contiguous()
            if f in sharding.PER_PIXEL_FIELDS:
                g[f] = halo.gather_width(v, mesh)
            else:
                every = mesh_mod.all_gather_x(v[None], mesh, dim=0)
                same = same and all(torch.equal(e, every[0]) for e in every)
                g[f] = v
        return g, same

    def measure(key, call, stages):
        """call()'s peak memory, device ms by stage and ms; returns its
        first output."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
        first = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(mesh.device)
        out["memory_mib"][key] = {"peak": peak / 2**20, "above_inputs": (peak - base) / 2**20}
        if stages:
            sb = _stage_breakdown(call)
            out["stage_ms"][key] = {s: v[0] for s, v in sb["per"].items()}
            out["stage_ms"][key]["memcpy"] = sum(
                ms for name, ms in sb["by_kernel"].items() if "Memcpy" in name)
        out["ms"][key] = cuda_ms(call, warmup=1, iters=5)
        return first

    for name, (depth, color, intr) in cases.items():
        h, w = depth.shape[1:]
        out["routes"][name] = sharding.spatial_route(mesh, cfg, h, w)
        # the tiles the stages after the JBF run on, and the widths the JBF
        # (the haloed data tile) and the DT and covariance (the tile with
        # the normals' halo, none past the frame) must launch on
        spans, _ = sharding.tile_spans(mesh, cfg.grid, h, w)
        out["spans"][name] = spans
        x0, width = spans[mesh.s]
        haloed = min(w, x0 + width + halo_r) - max(0, x0 - halo_r)
        expect = {f"jbf:w{w // mesh.x + 2 * rj}", f"chamfer_dt:w{haloed}",
                  f"cm_covariance:w{haloed}"}
        wants = {}
        for tag, d, c in (("B=4", depth, color), ("B=1", depth[:1], color[:1])):
            mesh_mod.collectives = 0
            (route, result), cnt, forms = counted(
                lambda d=d, c=c, intr=intr: sharding.spatial_kde(
                    mesh.width_tile(d), mesh.width_tile(c), mesh, intr, cfg))
            run = {"route": route, "counts": cnt, "collectives": mesh_mod.collectives,
                   "forms": forms, "expect_widths": sorted(expect),
                   "block": tuple(result.optimized_points.shape)}
            g, run["tables_equal_on_ranks"] = gathered(result)
            if res["rank"] == 0:
                want = kde_pipeline(d.contiguous(), c.contiguous(), intr, cfg)
                run["differs"] = [f for f in want._fields
                                  if not torch.equal(g[f], getattr(want, f))]
                wants[tag] = want  # B=4's is held against the replicated route below
            out["runs"][f"{name} {tag}"] = run
        wants.pop("B=1", None)

        d4, c4 = mesh.width_tile(depth), mesh.width_tile(color)
        stages = name == "640"
        for bsz in ((4, 1) if stages else (4,)):
            d, c = d4[:bsz], c4[:bsz]
            for route in ("tiled", "replicated"):
                got_route, result = measure(
                    f"{name} {route} B={bsz}",
                    lambda d=d, c=c, route=route, intr=intr: sharding.spatial_kde(
                        d, c, mesh, intr, cfg, route=route), stages)
                if route == "replicated" and bsz == 4:
                    g, same = gathered(result)
                    rep = {"route": got_route, "tables_equal_on_ranks": same}
                    if res["rank"] == 0:
                        rep["differs"] = [f for f in wants["B=4"]._fields
                                          if not torch.equal(g[f], getattr(wants["B=4"], f))]
                    out["replicated"][f"{name} B=4"] = rep
            if res["rank"] == 0:
                measure(f"{name} unsharded B={bsz}",
                        lambda bsz=bsz, intr=intr: kde_pipeline(depth[:bsz], color[:bsz], intr,
                                                                cfg), stages)


def phase11_configs():
    """name: (KDEConfig, frames) of the configs beyond the default that
    phase 11 (b) runs on the tiled route: the bilateral and SDC normals,
    plane merge with fill_holes=4 on the banded frames with 15% holes (phase
    10's far-range frame and three more seeds), three NASP iterations on
    the capped route and with locality="global" (the global index), and
    SDC, plane merge, the fill and three global-index iterations at once on
    the banded frames."""
    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig

    base = KDEConfig()

    def normals(method):
        return dataclasses.replace(base.normals, method=method)

    iter3 = dataclasses.replace(base, nasp=dataclasses.replace(base.nasp, iterations=3))
    glob = dataclasses.replace(iter3, nasp=dataclasses.replace(iter3.nasp, locality="global"))
    return {
        "bilateral": (dataclasses.replace(base, normals=normals("bilateral")), "noisy"),
        "sdc": (dataclasses.replace(base, normals=normals("sdc")), "noisy"),
        "plane_merge_fill": (dataclasses.replace(base, plane_merge=True, fill_holes=4),
                             "banded"),
        "iter3": (iter3, "noisy"),
        "iter3_global": (glob, "noisy"),
        "all": (dataclasses.replace(glob, normals=normals("sdc"), plane_merge=True,
                                    fill_holes=4), "banded"),
    }


# each config's tiled step: the kernels it must launch and must not (by
# counter), and the cuda_nasp forms it must launch on the tile
_FIRST = ("nasp_assign_analyze:r4:tile", "nasp_cell_sums:r4:weighted:tile")
_CELL_R4 = ("label_cell_sums:r4:F2:tile", "label_cell_gather:r4:F6:tile",
            "label_cell_gather:r4:F1:tile", "label_cell_gather:r4:F3:tile")
CONFIG_PATHS = {
    "bilateral": (("cuda_dt", "cuda_cov") + CELL_ROUTE_IDLE, _FIRST + _CELL_R4),
    "sdc": (("cuda_cov",) + CELL_ROUTE_IDLE, _FIRST + _CELL_R4),
    "plane_merge_fill": (CELL_ROUTE_IDLE, _FIRST + _CELL_R4 + (
        "label_cell_sums:r4:F4:tile", "label_cell_sums:r4:F6:tile")),
    "iter3": (GLOBAL_INDEX_KERNELS, _FIRST + ("assign_global:nasp:r4",
        "nasp_cell_sums:r5:analyze:tile", "nasp_cell_sums:r5:weighted:tile",
        "label_cell_sums:r5:F2:tile", "label_cell_gather:r5:F6:tile",
        "label_cell_gather:r5:F1:tile", "label_cell_gather:r5:F3:tile")),
    "iter3_global": (("label_cell_sums", "label_cell_gather"), _FIRST + ("assign_global:nasp:r4",)),
    "all": (("cuda_cov", "label_cell_sums", "label_cell_gather"),
            _FIRST + ("assign_global:nasp:r4",)),
}


def _phase11_configs(res, mesh, frames, intr, counted) -> None:
    """Phase 11 (b)'s other configs on one gloo rank (data 1 x x n): each of
    phase11_configs() on the tiled route (sharding.spatial_kde) at B=4, and
    "all" also at B=1, from launch counts at 0 with the collectives it
    made; every KDEResult field gathered and, on rank 0, held bitwise
    against kde_pipeline on the card, with the pixels the hole fill filled
    (plane.plane_hole_fill's output against its input, recorded in that
    call).  Then at B=4 each config's peak device memory of this rank and
    its ms (CUDA events, median of 5) on the tiled and the replicated
    route, and on rank 0 the unsharded kde_pipeline call's.  Results go in
    res["configs"]."""
    import torch

    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu_torch.ops import plane
    from kinectdepthmapenhancement_tpu_torch.parallel import halo, sharding
    from kinectdepthmapenhancement_tpu_torch.parallel import mesh as mesh_mod
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

    out = res["configs"] = {"routes": {}, "runs": {}, "memory_mib": {}, "ms": {}}

    def measure(key, call):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(mesh.device)
        out["memory_mib"][key] = {"peak": peak / 2**20, "above_inputs": (peak - base) / 2**20}
        out["ms"][key] = cuda_ms(call, warmup=1, iters=5)

    for name, (cfg, scene) in phase11_configs().items():
        depth, color = frames[scene]
        h, w = depth.shape[1:]
        out["routes"][name] = sharding.spatial_route(mesh, cfg, h, w)
        for bsz in ((4, 1) if name == "all" else (4,)):
            d, c = depth[:bsz], color[:bsz]
            mesh_mod.collectives = 0
            (route, result), cnt, forms = counted(
                lambda d=d, c=c, cfg=cfg: sharding.spatial_kde(
                    mesh.width_tile(d), mesh.width_tile(c), mesh, intr, cfg))
            run = {"route": route, "counts": cnt, "collectives": mesh_mod.collectives,
                   "forms": forms,
                   "block": tuple(result.optimized_points.shape), "tables_equal_on_ranks": True}
            got = {}
            for f in result._fields:
                v = getattr(result, f).contiguous()
                if f in sharding.PER_PIXEL_FIELDS:
                    got[f] = halo.gather_width(v, mesh)
                else:
                    every = mesh_mod.all_gather_x(v[None], mesh, dim=0)
                    run["tables_equal_on_ranks"] &= all(torch.equal(e, every[0]) for e in every)
                    got[f] = v
            if res["rank"] == 0:
                fill, seen = plane.plane_hole_fill, {}

                def record(optimized, *args, fill=fill, seen=seen):
                    filled = fill(optimized, *args)
                    seen["filled"] = (filled != optimized).any(-1)
                    return filled

                plane.plane_hole_fill = record
                try:
                    want = kde_pipeline(d.contiguous(), c.contiguous(), intr, cfg)
                finally:
                    plane.plane_hole_fill = fill
                run["differs"] = [f for f in want._fields
                                  if not torch.equal(got[f], getattr(want, f))]
                if cfg.fill_holes:
                    ws = w // mesh.x
                    near = torch.zeros(w, dtype=torch.bool, device=d.device)
                    for edge in range(ws, w, ws):
                        near[edge - cfg.fill_holes:edge + cfg.fill_holes] = True
                    run["filled"] = int(seen["filled"].sum())
                    run["filled_near_tile_edges"] = int(seen["filled"][:, :, near].sum())
            out["runs"][f"{name} B={bsz}"] = run

        d, c = mesh.width_tile(depth), mesh.width_tile(color)
        for route in ("tiled", "replicated"):
            measure(f"{name} {route} B=4", lambda route=route, cfg=cfg: sharding.spatial_kde(
                d, c, mesh, intr, cfg, route=route))
        if res["rank"] == 0:
            measure(f"{name} unsharded B=4",
                    lambda cfg=cfg: kde_pipeline(depth, color, intr, cfg))



# csrc kernel names (PORT_KERNEL's group) -> the launch counters' names
KERNEL_COUNTER = {
    "jbf_kernel": "cuda_bilateral", "dt_kernel": "cuda_dt", "cov_kernel": "cuda_cov",
    "grad_kernel": "cuda_gradient", "assign_analyze_kernel": "nasp_assign_analyze",
    "nasp_sums_kernel": "nasp_cell_sums", "label_sums_kernel": "label_cell_sums",
    "label_gather_kernel": "label_cell_gather", "label_counts_kernel": "label_counts",
    "label_index_sums_kernel": "label_sums", "assign_global_kernel": "assign_global",
}


def _replay_profile(fn):
    """One profiled call of fn (a replay): the port's kernels in its
    device trace by counter name and how often each ran, its device
    activities and busy share (the union of their intervals over their
    span); None when the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [ev for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()]
    if not acts:
        return None
    launched = {}
    for ev in acts:
        m = PORT_KERNEL.match(ev.name())
        if m and m.group(1) in KERNEL_COUNTER:
            name = KERNEL_COUNTER[m.group(1)]
            launched[name] = launched.get(name, 0) + 1
    busy_ns, end = 0, None
    spans = sorted((ev.start_ns(), ev.end_ns()) for ev in acts)
    for a, b in spans:
        if end is None or a >= end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    span_ms = (end - spans[0][0]) / 1e6
    return {"kernels": sorted(launched), "launches": launched, "activities": len(acts),
            "busy_ms": busy_ns / 1e6, "wall_ms": wall_ms, "span_ms": span_ms,
            "busy_share": busy_ns / 1e6 / span_ms}


def phase12(dev, smi: str) -> dict:
    """Phase 12: the compiled call (core/jit.py) on the card.  (a) each of
    the slice's kde_pipeline configs at 640x480 (and the 424x512 Kinect v2
    frames), B=1 and B=4, through jit: the capture from launch counts at 0
    launches every kernel the eager call launches, the replay is bitwise
    the eager call's and a second replay's outputs are other tensors with
    the same bits, every kernel the eager call runs is in a profiled
    replay by name and as often as the eager call launched it, with the
    replay's device busy share; eager against replay ms (CUDA events,
    median of 5), capture ms and the graph's pool; JBF and MRF likewise;
    (e) RGBF, SPDSP and TOF likewise at 640x480, B=1 and B=4, and TOF at
    424x512 B=1, holding 0, 9, 9 and 0 conds; (b) the conditional taken
    both ways: a jitted with_capped_index on labels that hold the cap and
    on labels that break it, bitwise the eager host branch each way, each
    branch counted on the device; (f) the same for SPDSP's ERS labels'
    index (pipelines._with_local_index), and the SPDSP and TOF replays at
    B=1 through golden.dasp_jax_gates; (c) run_stream at batch 1, 4 and 8,
    every chunk bitwise kde_pipeline's, frames/s, and a run stopped at 16
    frames and resumed from its checkpoint equal to the uninterrupted one;
    (g) buffer2d.accumulate over 32 frames and evaluate_tum's jitted
    update step folded over them, bitwise the eager fold; (d) a function
    that reads a tensor on the host raises under jit, and a replay still
    runs after it.  Returns the numbers it prints."""
    import numpy as np
    import torch

    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu_torch.core import buffer2d
    from kinectdepthmapenhancement_tpu_torch.core.config import (
        KDEConfig, RGBFConfig, SPDSPConfig, TOFConfig,
    )
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.models import pipelines, streaming
    from kinectdepthmapenhancement_tpu_torch.ops import (
        cuda_bilateral, cuda_cov, cuda_dt, cuda_gradient, cuda_nasp, plane, slic,
    )
    from kinectdepthmapenhancement_tpu_torch.utils import golden
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

    t_phase = time.perf_counter()
    wrappers = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)

    def reset_counts():
        for m in wrappers:
            m.launches = 0
            m.launch_forms.clear()
        for name in cuda_nasp.launches:
            cuda_nasp.launches[name] = 0
        cuda_nasp.launch_forms.clear()

    def counts():
        c = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in wrappers}
        c.update(cuda_nasp.launches)
        return c

    def frames(h, w, seeds=range(4)):
        intr_f = default_kinect_intrinsics(w, h)
        sc = [make_noisy_scene(h, w, intr_f, seed=s) for s in seeds]
        return (intr_f, torch.from_numpy(np.stack([s[1] for s in sc])).to(dev),
                torch.from_numpy(np.stack([s[0] for s in sc])).to(dev), sc)

    intr, depth4, color4, scenes = frames(480, 640)
    intr_v2, vdepth4, vcolor4, _ = frames(424, 512)

    def fields(out):
        return out._asdict() if hasattr(out, "_asdict") else {"out": out}

    def same(a, b) -> list:
        """The fields of a and b that differ (bitwise)."""
        fa, fb = fields(a), fields(b)
        return [k for k in fa if not torch.equal(fa[k], fb[k])]

    kept = []  # every jitted call of (a) and (e), alive until (e) ends
    outs = {}  # each held call's first replay, by tag

    def hold(tag, fn, args):
        """fn through jit against the eager fn(*args): launches, bits,
        aliasing, kernels in a profiled replay (each as often as the eager
        call launched it), times.  Returns the row.  The graph stays alive
        until the caller clears it: on an H100 under torch 2.11 the
        profiler has named a replay's kernels wrongly after an earlier
        graph was destroyed."""
        reset_counts()
        eager = fn(*args)
        torch.cuda.synchronize()
        eager_launches = {k: n for k, n in counts().items() if n}
        ran = set(eager_launches)
        reset_counts()
        f = jit.jit(fn)
        kept.append(f)
        got = outs[tag] = f(*args)
        torch.cuda.synchronize()
        captured = counts()
        missing = [k for k in ran if not captured[k]]
        if missing:
            _fail(f"phase 12 {tag}: the capture never launched {missing}")
        reset_counts()
        again = f(*args)
        torch.cuda.synchronize()
        if any(counts().values()):
            _fail(f"phase 12 {tag}: a replay launched from Python: {counts()}")
        diff, diff2 = same(got, eager), same(again, eager)
        if diff or diff2:
            _fail(f"phase 12 {tag}: the replay differs from the eager call in {diff or diff2}")
        alias = [k for k, v in fields(got).items() if v.data_ptr() == fields(again)[k].data_ptr()]
        if alias:
            _fail(f"phase 12 {tag}: two replays return the same tensors for {alias}")
        for _ in range(3):  # a trace may come back short of device records
            prof = _replay_profile(lambda: f(*args))
            absent = sorted(ran - set(prof["kernels"] if prof else ()))
            if prof and not absent and prof["launches"] == eager_launches:
                break
            print(f"phase 12 {tag}: a profiled replay without {absent or 'device activity'} "
                  f"or with other launches ({prof and prof['launches']} against the eager "
                  f"{eager_launches}); branches taken {f.info()[0]['taken']}")
        if not prof:
            _fail(f"phase 12 {tag}: three profiled replays held no device activity")
        if absent:
            _fail(f"phase 12 {tag}: kernels of the eager call absent from a profiled replay: "
                  f"{absent} (trace: {prof['kernels']})")
        if prof["launches"] != eager_launches:
            _fail(f"phase 12 {tag}: a replay launched {prof['launches']}, the eager call "
                  f"{eager_launches}")
        eager_ms = cuda_ms(lambda: fn(*args), warmup=1, iters=5)
        replay_ms = cuda_ms(lambda: f(*args), warmup=1, iters=5)
        (key,) = f.info()
        if key["pieces"] != 1 or key["host_steps"] or key["host_branches"]:
            _fail(f"phase 12 {tag}: {key['pieces']} pieces, {key['host_steps']} host steps, "
                  f"{key['host_branches']} host branches: a call with no collective is one "
                  "graph, its conds conditional nodes")
        row = {"eager_ms": eager_ms, "replay_ms": replay_ms, "capture_ms": key["capture_ms"],
               "warmup_ms": key["warmup_ms"], "pool_mb": key["pool_bytes"] / 2**20,
               "segments": key["segments"], "conds": key["conds"], "taken": key["taken"],
               "kernels": prof["kernels"], "launches": prof["launches"],
               "activities": prof["activities"],
               "busy_ms": prof["busy_ms"], "profiled_wall_ms": prof["wall_ms"],
               "span_ms": prof["span_ms"], "busy_share": prof["busy_share"]}
        print(f"phase 12 {tag}: replay bitwise the eager call (2 replays, no alias); "
              f"eager {eager_ms:.3f} ms, replay {replay_ms:.3f} ms (CUDA events, median of 5); "
              f"warm-up {key['warmup_ms']:.1f} ms, capture {key['capture_ms']:.1f} ms, pool "
              f"{row['pool_mb']:.1f} MiB, {key['segments']} segments, {key['conds']} conds "
              f"taken {key['taken']}; profiled replay: {prof['activities']} device activities, "
              f"busy {prof['busy_ms']:.3f} ms of their {prof['span_ms']:.3f} ms span "
              f"({100 * prof['busy_share']:.1f}%; the profiled call's wall "
              f"{prof['wall_ms']:.3f} ms), kernel launches {prof['launches']} (as eager) "
              f"[{smi}]")
        return row

    base = KDEConfig()

    def normals_cfg(method):
        return dataclasses.replace(base, normals=dataclasses.replace(base.normals, method=method))

    def iter3(locality):
        return dataclasses.replace(base, nasp=dataclasses.replace(
            base.nasp, iterations=3, locality=locality))

    configs = {
        "default": (base, intr, depth4, color4),
        "plane_merge+fill4": (dataclasses.replace(base, plane_merge=True, fill_holes=4),
                              intr, depth4, color4),
        "iter3 auto": (iter3("auto"), intr, depth4, color4),
        "iter3 global": (iter3("global"), intr, depth4, color4),
        "sdc": (normals_cfg("sdc"), intr, depth4, color4),
        "bilateral": (normals_cfg("bilateral"), intr, depth4, color4),
        "v2 424x512": (base, intr_v2, vdepth4, vcolor4),
    }
    rows = {}
    for name, (cfg, intr_c, d4, c4) in configs.items():
        for bsz in (1, 4):
            d, c = (d4[0], c4[0]) if bsz == 1 else (d4, c4)
            rows[f"kde {name} B={bsz}"] = hold(
                f"kde {name} B={bsz}", pipelines.kde_pipeline, (d, c, intr_c, cfg))
    auto = rows["kde iter3 auto B=1"]
    if auto["conds"] != 3 or rows["kde iter3 global B=1"]["conds"] != 0:
        _fail(f"phase 12: three auto iterations hold {auto['conds']} conds (want 3: two "
              "updates and the label index), the global ones "
              f"{rows['kde iter3 global B=1']['conds']}")
    for name, fn in (("jbf", pipelines.jbf_pipeline), ("mrf", pipelines.mrf_pipeline)):
        for bsz in (1, 4):
            d, c = (depth4[0], color4[0]) if bsz == 1 else (depth4, color4)
            rows[f"{name} B={bsz}"] = hold(f"{name} B={bsz}", fn, (d, c))

    # (e) RGBF, SPDSP and TOF (default configs) through jit at 640x480, B=1
    # and B=4, and TOF on the 424x512 frame at B=1, the raw points passed
    # in as the JAX CLI passes them: 0 conds for RGBF (one SLIC iteration
    # each), 9 for SPDSP and TOF (four later iterations a SLIC and the ERS
    # labels' index), 0 for TOF where the grid does not divide the frame
    raw4, vraw4 = projective_to_real(depth4, intr), projective_to_real(vdepth4, intr_v2)
    dasp_cases = {
        "rgbf": (pipelines.rgbf_pipeline, (RGBFConfig(),), 0),
        "spdsp": (pipelines.spdsp_pipeline, (intr, SPDSPConfig()), 9),
        "tof": (pipelines.tof_pipeline, (intr, TOFConfig()), 9),
    }
    want = {"tof v2 424x512 B=1": 0}
    for name, (fn, rest, want_conds) in dasp_cases.items():
        for bsz in (1, 4):
            d, p_, c = (depth4[0], raw4[0], color4[0]) if bsz == 1 else (depth4, raw4, color4)
            rows[f"{name} B={bsz}"] = hold(f"{name} B={bsz}", fn, (d, p_, c) + rest)
            want[f"{name} B={bsz}"] = want_conds
    rows["tof v2 424x512 B=1"] = hold("tof v2 424x512 B=1", pipelines.tof_pipeline, (
        vdepth4[0], vraw4[0], vcolor4[0], intr_v2, TOFConfig()))
    conds = {tag: rows[tag]["conds"] for tag in want}
    if conds != want:
        _fail(f"phase 12 (e): conds {conds}, not {want}")
    print(f"phase 12 (e): conds {conds}; pools " + ", ".join(
        f"{tag} {rows[tag]['pool_mb']:.1f} MiB" for tag in conds)
        + f"; device memory reserved {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB [{smi}]")
    kept.clear()
    jit.clear()

    # (f) the ERS labels' index both ways: _with_local_index on one SPDSP
    # call's refined labels (they hold cap 4) and on the same labels with
    # the top half of every frame moved by half the frame (far outside
    # it); and the replays of SPDSP and TOF at B=1 against the JAX
    # package's committed outputs of the frame
    sp_cfg = SPDSPConfig()
    ref = pipelines.spdsp_pipeline(depth4, raw4, color4, intr, sp_cfg)
    ers_lab = ref.refined_labels
    ers_broken = ers_lab.clone()
    ers_broken[:, :240] = torch.roll(ers_lab[:, :240], shifts=320, dims=-1)
    ers_pts = projective_to_real(ref.refined_depth, intr)
    del ref

    def local_planes(labels, pts):
        return pipelines._with_local_index(
            lambda idx: plane.pca_planes(pts, labels, sp_cfg.grid.num_clusters, index=idx),
            labels, sp_cfg)

    verdicts = [slic._within_cap(lab_, sp_cfg.grid, pipelines._LOCAL_CAP, 480, 640)
                for lab_ in (ers_lab, ers_broken)]
    if verdicts != [True, False]:
        _fail(f"phase 12 (f): the ERS labels' verdicts read {verdicts}, not [True, False]")
    f_local = jit.jit(local_planes)
    local_ms = {}
    for tag, labels in (("holds the cap", ers_lab), ("breaks the cap", ers_broken)):
        got, eager = f_local(labels, ers_pts), local_planes(labels, ers_pts)
        diff = [k for k in got._fields if not torch.equal(getattr(got, k), getattr(eager, k))]
        if diff:
            _fail(f"phase 12 (f): ERS labels that {tag}: {diff} differ from the host branch")
        local_ms[tag] = cuda_ms(lambda: f_local(labels, ers_pts), warmup=1, iters=5)
    (key,) = f_local.info()
    if key["conds"] != 1 or key["taken"] != [[1 + 6, 1 + 6]]:
        _fail(f"phase 12 (f): {key['conds']} conds, branches taken {key['taken']}, not one "
              "cond taken IF and ELSE 7 times each")
    print(f"phase 12 (f): the ERS labels' index took IF on labels that hold cap 4 and ELSE on "
          f"labels that break it ({key['taken']} [IF, ELSE] on the device), each bitwise the "
          f"host branch; replay {local_ms['holds the cap']:.3f} / "
          f"{local_ms['breaks the cap']:.3f} ms, pool {key['pool_bytes'] / 2**20:.1f} MiB "
          f"[{smi}]")
    del f_local
    dasp_want = golden.load_dasp("640x480")
    jax_gates = {}
    for name in ("spdsp", "tof"):
        got1 = {k: v.cpu().numpy() for k, v in outs[f"{name} B=1"]._asdict().items()}
        gates = golden.dasp_jax_gates(name, got1, dasp_want)
        for gname, (val, lim, ok) in gates.items():
            print(f"phase 12 (f) {name} replay B=1 {gname:28s} {val:.6g} (limit {lim}) "
                  f"{'ok' if ok else 'FAIL'}")
        if not gates or golden.failures(gates):
            _fail(f"phase 12 (f): the {name} replay against the JAX package: "
                  f"{golden.failures(gates) or 'no gate'}")
        jax_gates[name] = {g: v[0] for g, v in gates.items()}
    outs.clear()
    jit.clear()

    # (b) the conditional both ways: with_capped_index on three-iteration
    # labels (they hold the cap) and on the same labels with the top half
    # of every frame moved by half the frame (far outside the cap)
    grid = base.grid
    lab = pipelines.kde_pipeline(depth4, color4, intr, iter3("auto")).nasp_labels
    broken = lab.clone()
    broken[:, :240] = torch.roll(lab[:, :240], shifts=320, dims=-1)
    feats = projective_to_real(depth4, intr)
    table = torch.arange(grid.num_clusters * 4 * 2, dtype=torch.float32, device=dev)
    table = table.reshape(4, grid.num_clusters, 2)

    def capped(labels, x):
        return slic.with_capped_index(
            lambda idx: (idx.segment_sum(x, labels >= 0), idx.gather(table), idx.counts()),
            labels, grid, 5)

    verdicts = [slic._within_cap(lab, grid, 5, 480, 640),
                slic._within_cap(broken, grid, 5, 480, 640)]
    if verdicts != [True, False]:
        _fail(f"phase 12 cond: the labels' verdicts read {verdicts}, not [True, False]")
    jit.clear()
    f = jit.jit(capped)
    cond_rows = {}
    for tag, labels in (("holds the cap", lab), ("breaks the cap", broken)):
        got, eager = f(labels, feats), capped(labels, feats)
        diff = [i for i, (a, b) in enumerate(zip(got, eager)) if not torch.equal(a, b)]
        if diff:
            _fail(f"phase 12 cond: labels that {tag}: outputs {diff} differ from the eager route")
        cond_rows[tag] = cuda_ms(lambda: f(labels, feats), warmup=1, iters=5)
    (key,) = jit.keys()
    if key["taken"] != [[1 + 6, 1 + 6]]:  # one call each, then 6 timed each
        _fail(f"phase 12 cond: branches taken {key['taken']}, not IF and ELSE 7 times each")
    print(f"phase 12 cond: the replay took IF on labels that hold the cap and ELSE on labels "
          f"that break it ({key['taken']} [IF, ELSE] on the device), each bitwise the eager "
          f"route's; replay {cond_rows['holds the cap']:.3f} / "
          f"{cond_rows['breaks the cap']:.3f} ms, pool {key['pool_bytes'] / 2**20:.1f} MiB "
          f"(both branches) [{smi}]")
    jit.clear()

    # (c) run_stream at batch 1, 4 and 8: 32 noisy frames of scene 0
    gt0, color0 = scenes[0][2], scenes[0][0]
    rng = np.random.default_rng(0)
    var = 0.45 * 2.85 * np.square(gt0 / 10.0) / 1.0e4
    frames32 = [(gt0 + rng.uniform(-1, 1, gt0.shape) * var).astype(np.float32)
                for _ in range(32)]
    frames_dev = torch.from_numpy(np.stack(frames32)).to(dev)
    stream_rows = {}
    whole = None
    for bsz in (1, 4, 8):
        seen = []
        streaming.run_stream(iter(frames32), color0, intr, batch=bsz,
                             on_outputs=lambda s0, p: seen.append((s0, p)))
        for s0, pts in seen:
            k = pts.shape[0]
            want = pipelines.kde_pipeline(frames_dev[s0:s0 + k], color4[0].expand(
                k, -1, -1, -1).contiguous(), intr, base).optimized_points
            if not torch.equal(pts, want):
                _fail(f"phase 12 stream batch={bsz}: the chunk at frame {s0} differs from "
                      "kde_pipeline")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = streaming.run_stream(iter(frames32), color0, intr, batch=bsz)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stream_rows[f"batch={bsz}"] = 32 / wall
        print(f"phase 12 stream batch={bsz}: {len(seen)} chunks bitwise kde_pipeline's; "
              f"32 frames in {wall * 1e3:.1f} ms, {32 / wall:.2f} frames/s [{smi}]")
        whole = st
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
                        "phase12_stream.npz")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    part = streaming.run_stream(iter(frames32), color0, intr, batch=8, checkpoint_path=ckpt,
                                checkpoint_every=8, max_frames=16)
    resumed = streaming.run_stream(iter(frames32), color0, intr, batch=8,
                                   checkpoint_path=ckpt, checkpoint_every=8)
    if not (part.frame_index == 16 and resumed.frame_index == whole.frame_index == 32
            and resumed.metric_sums == whole.metric_sums
            and resumed.metric_counts == whole.metric_counts
            and torch.equal(resumed.buffer.depth, whole.buffer.depth)
            and torch.equal(resumed.buffer.weight, whole.buffer.weight)):
        _fail("phase 12 stream: the resumed run differs from the uninterrupted one")
    print("phase 12 stream resume: stopped at 16 frames, resumed to 32, equal to the "
          "uninterrupted run")
    streams = jit.keys()
    jit.clear()

    # (g) the Buffer2D fold: the compiled accumulate over the 32 frames (one
    # graph for N = 32) and evaluate_tum's jitted update step folded over
    # them, each bitwise the eager fold of buffer2d.update
    buf0 = buffer2d.init(480, 640, dev)
    eager_fold = buf0
    for fr in frames_dev:
        eager_fold = buffer2d.update(eager_fold, fr)
    got, again = buffer2d.accumulate(buf0, frames_dev), buffer2d.accumulate(buf0, frames_dev)
    step = jit.jit(buffer2d.update)

    def step_fold():
        b = buf0
        for fr in frames_dev:
            b = step(b, fr)
        return b

    folded = step_fold()
    for tag, out_ in (("accumulate", got), ("accumulate, a second replay", again),
                      ("the jitted step's fold", folded)):
        if same(out_, eager_fold):
            _fail(f"phase 12 (g): {tag} differs from the eager fold in {same(out_, eager_fold)}")
    if got.depth.data_ptr() == again.depth.data_ptr() or len(step.info()) != 1:
        _fail("phase 12 (g): two replays of accumulate share a tensor, or the step holds "
              f"{len(step.info())} graphs, not one")
    fold = {"accumulate": buffer2d.accumulate.info(), "step": step.info()}
    fold_ms = {"eager_fold": cuda_ms(lambda: buffer2d.accumulate.fn(buf0, frames_dev),
                                     warmup=1, iters=5),
               "accumulate_replay": cuda_ms(lambda: buffer2d.accumulate(buf0, frames_dev),
                                            warmup=1, iters=5),
               "step_fold": cuda_ms(step_fold, warmup=1, iters=5)}
    prof = _replay_profile(lambda: buffer2d.accumulate(buf0, frames_dev))
    if not prof:
        _fail("phase 12 (g): a profiled replay of accumulate held no device activity")
    fold.update(ms=fold_ms, busy_share=prof["busy_share"], activities=prof["activities"])
    (acc,) = fold["accumulate"]
    print(f"phase 12 (g): accumulate over 32 frames (two replays) and the jitted step's fold "
          f"bitwise the eager fold; eager {fold_ms['eager_fold']:.3f} ms, replay "
          f"{fold_ms['accumulate_replay']:.3f} ms, the step's fold "
          f"{fold_ms['step_fold']:.3f} ms (32 replays) (CUDA events, median of 5); warm-up "
          f"{acc['warmup_ms']:.1f} ms, capture {acc['capture_ms']:.1f} ms, pool "
          f"{acc['pool_bytes'] / 2**20:.1f} MiB; profiled replay: {prof['activities']} "
          f"device activities, busy {100 * prof['busy_share']:.1f}% of their span [{smi}]")
    del step
    jit.clear()

    # (d) a host read inside a jit call raises; the card runs on
    def host_read(x):
        return x * x.sum().item()

    try:
        jit.jit(host_read)(torch.ones(8, device=dev))
    except Exception as e:  # the capture's own error
        raised = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    else:
        _fail("phase 12: a jit call that reads a tensor on the host did not raise")
    after = hold("default B=1 after the failed capture", pipelines.kde_pipeline,
                 (depth4[0], color4[0], intr, base))
    kept.clear()
    print(f"phase 12: a host read under jit raised ({raised}); the default config replays "
          f"bitwise after it")
    out = {"rows": rows, "cond_ms": cond_rows, "ers_cond_ms": local_ms,
           "dasp_jax_gates": jax_gates, "fold": fold, "stream_fps": stream_rows,
           "stream_keys": streams, "raised": raised,
           "after_failed_capture_replay_ms": after["replay_ms"], "jit_stats": dict(jit.stats),
           "seconds": time.perf_counter() - t_phase}
    print(f"phase 12: {out['seconds']:.1f} s")
    print("phase 12 json: " + json.dumps(out))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from kinectdepthmapenhancement_tpu_torch import _build
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.core.camera import (
        default_kinect_intrinsics, normalized_rays, projective_to_real,
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
    from kinectdepthmapenhancement_tpu_torch.parallel import stencil_shard
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
    if sys.argv[1:] == ["--phase12"]:  # phase 12 alone, or main's phase 12 process
        phase12(dev, smi)
        print(f"phase 12 alone: ok, {time.perf_counter() - t_start:.1f} s [{smi}]")
        return 0
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
    tile_kw = dict(c0=CELL_TILE[0], tile_cols=CELL_TILE[1])  # the tiled route's cells
    ws_x, ws_y = w // grid.cols, h // grid.rows
    s_scale = (ws_x + ws_y) / 2.0
    rp = ws_x * 2 // 16 + 1
    lo, hi = -8 * rp, 8 * rp - 1  # the NASP update window (slic.segment)
    scenes = [make_noisy_scene(h, w, intr, seed=s) for s in range(4)]
    color4 = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    depth4 = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    # the Kinect v2 frames of phase 3's and phase 11's tiled forms
    intr_v2 = default_kinect_intrinsics(V2_SHAPE[1], V2_SHAPE[0])
    v2_scenes = [make_noisy_scene(*V2_SHAPE, intr_v2, seed=s) for s in range(4)]
    vcolor4 = torch.from_numpy(np.stack([s[0] for s in v2_scenes])).to(dev)
    vdepth4 = torch.from_numpy(np.stack([s[1] for s in v2_scenes])).to(dev)

    def jbf_tile(depth, color, nx, width):
        """(guide, depth) of the JBF's haloed width tile s = 1 of x = nx
        tiles of the frames' first `width` columns, as
        parallel/stencil_shard.py hands them to the kernel: the depth with rj
        columns of its neighbours (zeros past the frame), the guide smoothed
        on the colour tile with rg + rj columns of halo (reflect-101 past the
        frame) and cut to the tile's columns [-rj, ws + rj)."""
        rg, rj = cfg.jbf.guide_diameter // 2, cfg.jbf.window // 2
        ws = width // nx
        cpad = torch.nn.functional.pad(color[:, :, :width].permute(0, 3, 1, 2).float(),
                                       (rg + rj, rg + rj, 0, 0), mode="reflect")
        cpad = cpad.permute(0, 2, 3, 1).to(torch.uint8)[:, :, ws:2 * ws + 2 * (rg + rj)]
        tile_guide = bilateral.guide_bilateral(cpad.contiguous(), cfg.jbf).float()
        return (tile_guide[:, :, rg:rg + ws + 2 * rj].contiguous(),
                torch.nn.functional.pad(depth[:, :, :width], (rj, rj))[
                    :, :, ws:2 * ws + 2 * rj].contiguous())

    def halo_tile(t, nx, radius):
        """Tile s = 1 of x = nx tiles of t [B, H, W, ...] with `radius`
        columns of its neighbours each side and none past the frame."""
        ws = t.shape[2] // nx
        return t[:, :, max(0, ws - radius):min(t.shape[2], 2 * ws + radius)].contiguous()

    def v2_inputs(depth, color):
        """Phase 11 (b)'s tile forms on the 424x512 Kinect v2 frames (the
        grid does not divide them), tile s = 1: the JBF's haloed tiles at
        x = 2 and 4, the depth-change map, window sizes and vertices of the
        DT and the covariance on the 27-column haloed tiles of points, and
        x = 2's colour and normals with the seed gradient's 5-column halo."""
        hv, wv = depth.shape[1:]
        p = cfg.jbf
        x = {}
        for tag, nx in V2_JBF_TILES.items():
            x[f"guide_{tag}"], x[f"depth_{tag}"] = jbf_tile(depth, color, nx, wv)
        guide = bilateral.guide_bilateral(color, p).to(torch.float32).contiguous()
        jbf_depth = cuda_bilateral.jbf_plain(
            depth, guide, window=p.window, spatial_sigma=p.spatial_sigma,
            color_sigma=p.color_sigma, depth_sigma=p.depth_sigma)
        points = projective_to_real(jbf_depth, default_kinect_intrinsics(wv, hv)).contiguous()
        halo_r = stencil_shard.normals_halo(cfg.normals)
        for tag, nx in V2_HALO_TILES.items():
            vm_t = halo_tile(points / 1000.0, nx, halo_r)
            if vm_t.shape[2] != int(tag[1:]):
                _fail(f"the {tag} form is {vm_t.shape[2]} columns wide")
            x[f"vm_{tag}"] = vm_t
            x[f"dci_{tag}"] = normals.dci_map(
                vm_t, cfg.normals.max_depth_change_factor).contiguous()
            x[f"rect_{tag}"] = normals.smoothing_map(
                vm_t, cfg.normals).to(torch.int32).contiguous()
        nmap = normals.generate_normal_map(points, cfg.normals)
        x["cf_h"] = halo_tile(color.to(torch.float32), 2, slic.GRAD_MARGIN)
        x["nm_h"] = halo_tile(nmap, 2, slic.GRAD_MARGIN)
        if x["cf_h"].shape[2] != int(V2_GRADIENT_TILE[4:]):
            _fail(f"the {V2_GRADIENT_TILE} form is {x['cf_h'].shape[2]} columns wide")
        # the global index's label counts as CCL's adjacency runs them on
        # this frame: NASP's labels (the grid does not divide the frame, so
        # the global index) and their right and down
        # neighbours, -1 past the frame; the library's keys (a * K + c, or a,
        # offset by frame, a dropped pixel at a spare slot past the tables)
        seg = slic.segment(color, points, nmap, grid=grid, params=nasp_p)
        lab = seg.labels.contiguous()
        # the global sweep of a later NASP iteration from that state (r = 4)
        x["sweep_v2"] = (lab, seg.distance.contiguous(),
                         slic._cluster_fields(seg.clusters, "nasp").contiguous(),
                         color.to(torch.float32).contiguous(), points, nmap.contiguous())
        b, k = lab.shape[0], grid.num_clusters
        # the global index's float sums as NASP's updates run them on these
        # labels (analyze F = 13, weighted F = 14): each pixel's features
        # against its cluster's fields, summed over the labelled pixels; and
        # each sum's terms by magnitude (sums_close's scale)
        _, (vlo, vhi) = slic._update_geometry(grid, hv, wv, "nasp")
        xy, cl = seg.clusters.xy.to(torch.float32), seg.clusters
        bi = torch.arange(b, device=dev)[:, None, None]
        x["mask_v2"] = lab >= 0
        for mode, fields in (("analyze", xy),
                             ("weighted", torch.cat([xy, cl.rgb, cl.normal], -1))):
            fe = cuda_nasp.nasp_features(
                mode, lab, fields[bi, lab.clamp_min(0).long()], color.to(torch.float32),
                points, nmap, vlo, vhi, nasp_p.color_sigma, nasp_p.spatial_sigma).contiguous()
            x[f"sums_{mode}_v2"] = fe
            x[f"sums_scale_{mode}_v2"] = cuda_nasp.label_sums_plain(lab, fe.abs(), x["mask_v2"], k)
        right = torch.cat([lab[:, :, 1:], lab.new_full((b, hv, 1), -1)], dim=2).contiguous()
        down = torch.cat([lab[:, 1:], lab.new_full((b, 1, wv), -1)], dim=1).contiguous()
        x.update(labels_v2=lab, right_v2=right, down_v2=down,
                 ones_v2=torch.ones(lab.numel(), dtype=torch.float32, device=dev))
        frame = torch.arange(b, device=dev)[:, None, None]
        ina = (lab >= 0) & (lab < k)
        for tag, nb in (("right", right), ("down", down), ("single", None)):
            size = k if nb is None else k * k
            key, ok = (lab, ina) if nb is None else (lab * k + nb, ina & (nb >= 0) & (nb < k))
            x[f"keys_{tag}_v2"] = torch.where(ok, key + frame * size, b * size).reshape(-1).long()
        return x

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
        # the JBF's haloed width tiles as parallel/stencil_shard.py hands
        # them to the kernel (phase 11), tile s = 1 of each: the depth with
        # rj columns of its neighbours (zeros past the frame), the guide
        # smoothed on the colour tile with rg + rj columns of halo (reflect-101
        # past the frame) and cut to the tile's columns [-rj, ws + rj)
        for tag, (nx, width) in JBF_TILES.items():
            x[f"guide_{tag}"], x[f"depth_{tag}"] = jbf_tile(depth, color, nx, width)
        # the first NASP iteration's inputs: seeds, candidate fields,
        # labels, the analyze-updated cluster table
        b = depth.shape[0]
        seeds = slic._compute_seeds(color_f, nmap, grid, h, w, 8)
        cl = slic.init_clusters(seeds, color, points, nmap)
        cand, akw = slic._assign_args(cl, grid, nasp_p, s_scale)
        labels, _, part = cuda_nasp.nasp_assign_and_analyze_plain(
            color_f, points, nmap, cand, lo=lo, hi=hi, **akw)
        idx = slic._CellIndex(labels, grid, 4, h, w)
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
        # the capped iterations' state: three NASP iterations, every label
        # within the cap of 5 (the r = 5 sums and gathers)
        three = slic.segment(color, points, nmap, grid=grid, params=dataclasses.replace(
            nasp_p, iterations=3))
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
        # the DASP / ERS paths' inputs (SPDSPConfig()): the
        # raw frame's points, the depth SLIC's labels after one iteration
        # (r = 2) and after five (r = 3, within the cap of 3), the ERS labels
        # (r = 4, within the cap of 4); the DASP update's 10 features, the
        # centre tables (F = 2), the PCA planes (F = 4) and a merge-table
        # width (F = 7)
        sp_cfg = SPDSPConfig()
        raw = projective_to_real(depth, intr).contiguous()
        d1 = slic.segment(color, raw, grid=grid, variant="dasp", params=dataclasses.replace(
            sp_cfg.depth_slic, iterations=1))
        # the DASP sweep of a later iteration from that state (r = 2)
        x["sweep_dasp"] = (d1.labels, d1.distance,
                           slic._cluster_fields(d1.clusters, "dasp").contiguous(), color_f, raw,
                           None)
        d5 = slic.segment(color, raw, grid=grid, variant="dasp", params=sp_cfg.depth_slic)
        c5 = slic.segment(color, raw, grid=grid, variant="dasp", params=sp_cfg.color_slic)
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
        eidx = slic._CellIndex(ers_labels, grid, 4, h, w)
        planes = plane.pca_planes(raw, ers_labels, grid.num_clusters, index=eidx)
        x["etable4"] = planes.nd.contiguous()
        x["etable7"] = torch.cat([planes.nd, planes.centers], -1).contiguous()
        x["csub4"] = slic._subgrid_extract(color_f, grid, h, w, 4).contiguous()
        # the tiled route's inputs (phase 11's tile s = 1): the haloed points'
        # depth-change map, window sizes and vertices of the DT and the
        # covariance at x = 2 and 4; x = 2's tile of the cell kernels'
        # planes, labels (the tile's assignment gives these columns, bitwise)
        # and features, and its seed sub-grid
        halo_r = stencil_shard.normals_halo(cfg.normals)
        for tag, nx in HALO_TILES.items():
            ws = w // nx
            vm_t = vm[:, :, max(0, ws - halo_r):min(w, 2 * ws + halo_r)].contiguous()
            if vm_t.shape[2] != int(tag[1:]):
                _fail(f"the {tag} form is {vm_t.shape[2]} columns wide")
            x[f"vm_{tag}"] = vm_t
            x[f"dci_{tag}"] = normals.dci_map(
                vm_t, cfg.normals.max_depth_change_factor).contiguous()
            x[f"rect_{tag}"] = normals.smoothing_map(
                vm_t, cfg.normals).to(torch.int32).contiguous()
        c0, tc = CELL_TILE
        cols_t = slice(c0 * ws_x, (c0 + tc) * ws_x)
        for key in ("color_f", "points", "nmap", "labels", "feats2"):
            x[f"{key}_t"] = x[key][:, :, cols_t].contiguous()
        grid_t = GridParams(rows=grid.rows, cols=tc)
        x["csub_t"] = slic._subgrid_extract(x["color_f_t"], grid_t, h, tc * ws_x, 8).contiguous()
        x["nsub_t"] = slic._subgrid_extract(x["nmap_t"], grid_t, h, tc * ws_x, 8).contiguous()
        tri_t = (x["color_f_t"], x["points_t"], x["nmap_t"])
        x["scale_assign_t"] = cuda_nasp.nasp_cell_sums_plain(
            x["labels_t"], *tri_t, cand[..., 3:5], lo=lo, hi=hi, mode="analyze",
            abs_terms=True, **cell, **tile_kw)
        x["scale_weighted_t"] = cuda_nasp.nasp_cell_sums_plain(
            x["labels_t"], *tri_t, x["f_weighted"], lo=lo, hi=hi, mode="weighted",
            abs_terms=True, color_sigma=nasp_p.color_sigma, spatial_sigma=nasp_p.spatial_sigma,
            **cell, **tile_kw)
        x["scale_label_t"] = cuda_nasp.label_cell_sums_plain(
            x["labels_t"], x["feats2_t"].abs(), **cell, **tile_kw)
        # x = 8's cell-aligned tile (UNEVEN_TILE) of the same planes, labels
        # and features
        uc0, utc = UNEVEN_TILE
        cols_u = slice(uc0 * ws_x, (uc0 + utc) * ws_x)
        for key in ("color_f", "points", "nmap", "labels", "feats2"):
            x[f"{key}_u"] = x[key][:, :, cols_u].contiguous()
        tri_u = (x["color_f_u"], x["points_u"], x["nmap_u"])
        uneven_kw = dict(c0=uc0, tile_cols=utc)
        x["scale_assign_u"] = cuda_nasp.nasp_cell_sums_plain(
            x["labels_u"], *tri_u, cand[..., 3:5], lo=lo, hi=hi, mode="analyze",
            abs_terms=True, **cell, **uneven_kw)
        x["scale_weighted_u"] = cuda_nasp.nasp_cell_sums_plain(
            x["labels_u"], *tri_u, x["f_weighted"], lo=lo, hi=hi, mode="weighted",
            abs_terms=True, color_sigma=nasp_p.color_sigma, spatial_sigma=nasp_p.spatial_sigma,
            **cell, **uneven_kw)
        x["scale_label_u"] = cuda_nasp.label_cell_sums_plain(
            x["labels_u"], x["feats2_u"].abs(), **cell, **uneven_kw)
        # the forms the other configs' tiled steps add (rows 6bt-8bt), at the
        # same tile: three-iteration labels (r = 5) and merge_planes' moments
        for key in ("labels5", "feats4", "feats6", "feats2_r5"):
            x[f"{key}_t"] = x[key][:, :, cols_t].contiguous()
        for mode in ("analyze", "weighted"):
            x[f"scale5_{mode}_t"] = cuda_nasp.nasp_cell_sums_plain(
                x["labels5_t"], *tri_t, x[f"f5_{mode}"], lo=lo, hi=hi, mode=mode,
                abs_terms=True, color_sigma=nasp_p.color_sigma,
                spatial_sigma=nasp_p.spatial_sigma, **cell5, **tile_kw)
        for key, lab, kw in (("feats4", "labels_t", cell), ("feats6", "labels_t", cell),
                             ("feats2_r5", "labels5_t", cell5)):
            x[f"scale_{key}_t"] = cuda_nasp.label_cell_sums_plain(
                x[lab], x[f"{key}_t"].abs(), **kw, **tile_kw)
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
        x["flat_label_t"] = (bi[:, None, None] * grid.num_clusters
                             + x["labels_t"].clamp_min(0).long()).reshape(-1)
        x["flat_label5_t"] = (bi[:, None, None] * grid.num_clusters
                              + x["labels5_t"].clamp_min(0).long()).reshape(-1)
        x["flat_label_u"] = (bi[:, None, None] * grid.num_clusters
                             + x["labels_u"].clamp_min(0).long()).reshape(-1)
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

    def assign_ops(x, t="", tile=CELL_TILE):
        """Kernel 5: per pixel and in-grid candidate 33 (colour 8, pixel 7,
        depth 2, weighting 7, normal dot 5, normal term 3, the running
        argmin's compare 1), per out-of-grid one 1; per pixel 5 (its depth
        and normal validity, the invalid-depth override); per cell and
        in-grid candidate 4 (the candidate's depth and normal validity);
        per labeled pixel the analyze features 16 and their 13 sums.  t =
        "_t" or "_u": the tile's cells (CELL_TILE, UNEVEN_TILE) and pixels."""
        b = x["color_f" + t].shape[0]
        n_c = n_in[:, tile[0]:tile[0] + tile[1]] if t else n_in
        per_cell = ws_x * ws_y * (33 * n_c + (n_cand - n_c)) + 4 * n_c
        return (b * float(per_cell.sum()) + 5 * npx(x["color_f" + t])
                + 29 * labeled(x, "labels" + t))

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
        **{f"jbf_{tag}": dict(
            module=cuda_bilateral, bar="bitwise", activities=1, row="jbf", secondary=True,
            form=tag,
            run=lambda x, t=tag: cuda_bilateral.jbf(x[f"depth_{t}"], x[f"guide_{t}"], **jbf_kw),
            plain=lambda x, t=tag: cuda_bilateral.jbf_plain(
                x[f"depth_{t}"], x[f"guide_{t}"], **jbf_kw),
            inputs=lambda x, t=tag: [x[f"depth_{t}"], x[f"guide_{t}"]],
            # the tile's own taps: every pixel of the haloed tile is filtered
            ops=lambda x, t=tag: npx(x[f"depth_{t}"]) * 25 * (17 + 25),
            issue=tap_issue("jbf", f"depth_{tag}"),
            shape=lambda x, t=tag: tuple(x[f"depth_{t}"].shape)) for tag in JBF_TILES},
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
    # the tiled route's forms (phase 11, rows 2t-8t): the DT and covariance
    # on haloed tiles, the seed gradient on the tile's sub-grid, the four
    # cell kernels at the tile's cells (the global grid's candidates and
    # tables, global u), each against its plain version on the same tile
    for tag in HALO_TILES:
        kernels[f"chamfer_dt_{tag}"] = dict(
            module=cuda_dt, bar="bitwise", row="chamfer_dt", secondary=True, activities=1,
            form=tag,
            run=lambda x, t=tag: cuda_dt.distance_transform(x[f"dci_{t}"], its),
            plain=lambda x, t=tag: cuda_dt.distance_transform_plain(x[f"dci_{t}"], its),
            inputs=lambda x, t=tag: [x[f"dci_{t}"]],
            ops=lambda x, t=tag: dt_ops(x[f"dci_{t}"]),
            shape=lambda x, t=tag: tuple(x[f"dci_{t}"].shape))
        kernels[f"cm_covariance_{tag}"] = dict(
            module=cuda_cov, bar="count exact, entries bitwise", row="cm_covariance",
            secondary=True, form=tag,
            run=lambda x, t=tag: cuda_cov.cm_covariances(x[f"vm_{t}"], x[f"rect_{t}"]),
            plain=lambda x, t=tag: cuda_cov.cm_covariances_plain(x[f"vm_{t}"], x[f"rect_{t}"]),
            inputs=lambda x, t=tag: [x[f"vm_{t}"], x[f"rect_{t}"]],
            ops=lambda x, t=tag: 22 * cov_taps(x[f"rect_{t}"]),
            shape=lambda x, t=tag: tuple(x[f"vm_{t}"].shape))
    grid_t = GridParams(rows=grid.rows, cols=CELL_TILE[1])
    ws_t = CELL_TILE[1] * ws_x
    kernels["seed_gradient_nasp_tile"] = dict(
        module=cuda_gradient, bar="bitwise, seeds identical", row="seed_gradient",
        secondary=True, form="nasp:tile",
        run=lambda x: cuda_gradient.seed_gradient(x["csub_t"], x["nsub_t"], "tile"),
        plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub_t"], x["nsub_t"]),
        ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(
            slic._sample_seeds_subgrid(got[0], grid_t, h, ws_t, 8),
            slic._sample_seeds_subgrid(want[0], grid_t, h, ws_t, 8)),
        inputs=lambda x: [x["csub_t"], x["nsub_t"]],
        ops=lambda x: npx(x["csub_t"]) * 121 * 20,
        shape=lambda x: tuple(x["csub_t"].shape))
    tri_t = ("color_f_t", "points_t", "nmap_t")
    kernels["nasp_assign_analyze_tile"] = dict(
        module=cuda_nasp, bar="labels, distance bitwise; sums: integer exact, "
        "rest <= 1e-5 sum|terms|", row="nasp_assign_analyze", secondary=True, form="r4:tile",
        run=lambda x: cuda_nasp.nasp_assign_and_analyze(
            *(x[k] for k in tri_t), x["cand"], lo=lo, hi=hi, **x["akw"], **tile_kw),
        plain=lambda x: cuda_nasp.nasp_assign_and_analyze_plain(
            *(x[k] for k in tri_t), x["cand"], lo=lo, hi=hi, **x["akw"], **tile_kw),
        ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        and sums_ok("analyze", "scale_assign_t")(got, want, x),
        inputs=lambda x: [*(x[k] for k in tri_t), x["cand"]],
        ops=lambda x: assign_ops(x, "_t"),
        shape=lambda x: tuple(x["color_f_t"].shape))
    kernels["nasp_cell_sums_weighted_tile"] = dict(
        module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|", row="nasp_cell_sums",
        secondary=True, form="r4:weighted:tile",
        run=lambda x: cuda_nasp.nasp_cell_sums(
            x["labels_t"], *(x[k] for k in tri_t), x["f_weighted"], mode="weighted",
            **sums_kw, **tile_kw),
        plain=lambda x: cuda_nasp.nasp_cell_sums_plain(
            x["labels_t"], *(x[k] for k in tri_t), x["f_weighted"], mode="weighted",
            **sums_kw, **tile_kw),
        ok=sums_ok("weighted", "scale_weighted_t"),
        inputs=lambda x: [x["labels_t"], *(x[k] for k in tri_t), x["f_weighted"]],
        ops=lambda x: labeled(x, "labels_t") * (51 + 14),
        shape=lambda x: tuple(x["color_f_t"].shape))
    kernels["label_cell_sums_tile"] = dict(
        module=cuda_nasp, bar="<= 1e-5 sum|terms|", row="label_cell_sums", secondary=True,
        form="r4:F2:tile",
        run=lambda x: cuda_nasp.label_cell_sums(x["labels_t"], x["feats2_t"], **cell, **tile_kw),
        plain=lambda x: cuda_nasp.label_cell_sums_plain(
            x["labels_t"], x["feats2_t"], **cell, **tile_kw),
        ok=sums_ok("label", "scale_label_t"),
        library=lambda x: torch.zeros(
            (x["bi"].shape[0] * grid.num_clusters, 2), device=dev).index_add_(
            0, x["flat_label_t"], x["feats2_t"].reshape(-1, 2)),
        inputs=lambda x: [x["labels_t"], x["feats2_t"]],
        ops=lambda x: npx(x["labels_t"]) * 2,
        shape=lambda x: tuple(x["feats2_t"].shape))
    for nf in (6, 1, 3):
        tkey = f"table{nf}"
        kernels[f"label_cell_gather_f{nf}_tile"] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=True,
            form=f"r4:F{nf}:tile",
            run=lambda x, t=tkey: cuda_nasp.label_cell_gather(
                x["labels_t"], x[t], **cell, **tile_kw),
            plain=lambda x, t=tkey: cuda_nasp.label_cell_gather_plain(
                x["labels_t"], x[t], **cell, **tile_kw),
            library=lambda x, t=tkey: x[t][x["bi"], x["labels_t"].clamp_min(0)],
            inputs=lambda x, t=tkey: [x["labels_t"], x[t]],
            ops=lambda x: 0,
            shape=lambda x, nf=nf: tuple(x["labels_t"].shape) + (nf,))
    # the tile forms the other configs' tiled steps add (rows 6bt-8bt, phase
    # 11 (b)): the later iterations' capped update (r = 5, both modes),
    # merge_planes' sums (F = 4, 6 at r = 4), the residual over capped
    # labels (F = 2 at r = 5) and the gathers of CCL and the plane stage over
    # them (F = 6, 3, 1 at r = 5), each at x = 2's tile
    for mode, per_px in (("analyze", 16 + 13), ("weighted", 51 + 14)):
        kernels[f"nasp_cell_sums_{mode}_r5_tile"] = dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|",
            row="nasp_cell_sums", secondary=True, form=f"r5:{mode}:tile",
            run=lambda x, m=mode: cuda_nasp.nasp_cell_sums(
                x["labels5_t"], *(x[k] for k in tri_t), x[f"f5_{m}"], mode=m, **sums_kw5,
                **tile_kw),
            plain=lambda x, m=mode: cuda_nasp.nasp_cell_sums_plain(
                x["labels5_t"], *(x[k] for k in tri_t), x[f"f5_{m}"], mode=m, **sums_kw5,
                **tile_kw),
            ok=sums_ok(mode, f"scale5_{mode}_t"),
            inputs=lambda x, m=mode: [x["labels5_t"], *(x[k] for k in tri_t), x[f"f5_{m}"]],
            ops=lambda x, n=per_px: labeled(x, "labels5_t") * n,
            shape=lambda x: tuple(x["color_f_t"].shape))
    for key, nf, r, feats in (("label_cell_sums_f4_tile", 4, 4, "feats4"),
                              ("label_cell_sums_f6_tile", 6, 4, "feats6"),
                              ("label_cell_sums_r5_tile", 2, 5, "feats2_r5")):
        lab, flat, kw = ("labels_t", "flat_label_t", cell) if r == 4 else (
            "labels5_t", "flat_label5_t", cell5)
        ft = f"{feats}_t"
        kernels[key] = dict(
            module=cuda_nasp, bar="<= 1e-5 sum|terms|", row="label_cell_sums",
            secondary=True, form=f"r{r}:F{nf}:tile",
            run=lambda x, l=lab, f=ft, kw=kw: cuda_nasp.label_cell_sums(
                x[l], x[f], **kw, **tile_kw),
            plain=lambda x, l=lab, f=ft, kw=kw: cuda_nasp.label_cell_sums_plain(
                x[l], x[f], **kw, **tile_kw),
            ok=sums_ok("label", f"scale_{ft}"),
            library=lambda x, f=ft, fl=flat, nf=nf: torch.zeros(
                (x["bi"].shape[0] * grid.num_clusters, nf), device=dev).index_add_(
                0, x[fl], x[f].reshape(-1, nf)),
            inputs=lambda x, l=lab, f=ft: [x[l], x[f]],
            ops=lambda x, f=ft: npx(x[f]) * x[f].shape[-1],
            shape=lambda x, f=ft: tuple(x[f].shape))
    for nf in (6, 3, 1):
        tkey = f"table{nf}"
        kernels[f"label_cell_gather_r5_f{nf}_tile"] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=True,
            form=f"r5:F{nf}:tile",
            run=lambda x, t=tkey: cuda_nasp.label_cell_gather(
                x["labels5_t"], x[t], **cell5, **tile_kw),
            plain=lambda x, t=tkey: cuda_nasp.label_cell_gather_plain(
                x["labels5_t"], x[t], **cell5, **tile_kw),
            library=lambda x, t=tkey: x[t][x["bi"], x["labels5_t"].clamp_min(0)],
            inputs=lambda x, t=tkey: [x["labels5_t"], x[t]],
            ops=lambda x: 0,
            shape=lambda x, nf=nf: tuple(x["labels5_t"].shape) + (nf,))
    # the forms the tiled route adds on frames the grid does not divide and
    # on tiles that split a cell (phase 11 (b); rows 1c, 2t/3t, 4h, 5t-8t):
    # the JBF, the DT and the covariance on the Kinect v2 frame's haloed
    # tiles, the seed gradient on its 5-column haloed tile, and the four cell
    # kernels on x = 8's cell-aligned tile at 640 (UNEVEN_TILE)
    for tag in V2_JBF_TILES:
        kernels[f"jbf_v2_{tag}"] = dict(
            module=cuda_bilateral, bar="bitwise", activities=1, row="jbf", secondary=True,
            form=tag,
            run=lambda x, t=tag: cuda_bilateral.jbf(x[f"depth_{t}"], x[f"guide_{t}"], **jbf_kw),
            plain=lambda x, t=tag: cuda_bilateral.jbf_plain(
                x[f"depth_{t}"], x[f"guide_{t}"], **jbf_kw),
            inputs=lambda x, t=tag: [x[f"depth_{t}"], x[f"guide_{t}"]],
            ops=lambda x, t=tag: npx(x[f"depth_{t}"]) * 25 * (17 + 25),
            issue=tap_issue("jbf", f"depth_{tag}"),
            shape=lambda x, t=tag: tuple(x[f"depth_{t}"].shape))
    for tag in V2_HALO_TILES:
        kernels[f"chamfer_dt_v2_{tag}"] = dict(
            module=cuda_dt, bar="bitwise", row="chamfer_dt", secondary=True, activities=1,
            form=tag,
            run=lambda x, t=tag: cuda_dt.distance_transform(x[f"dci_{t}"], its),
            plain=lambda x, t=tag: cuda_dt.distance_transform_plain(x[f"dci_{t}"], its),
            inputs=lambda x, t=tag: [x[f"dci_{t}"]],
            ops=lambda x, t=tag: dt_ops(x[f"dci_{t}"]),
            shape=lambda x, t=tag: tuple(x[f"dci_{t}"].shape))
        kernels[f"cm_covariance_v2_{tag}"] = dict(
            module=cuda_cov, bar="count exact, entries bitwise", row="cm_covariance",
            secondary=True, form=tag,
            run=lambda x, t=tag: cuda_cov.cm_covariances(x[f"vm_{t}"], x[f"rect_{t}"]),
            plain=lambda x, t=tag: cuda_cov.cm_covariances_plain(x[f"vm_{t}"], x[f"rect_{t}"]),
            inputs=lambda x, t=tag: [x[f"vm_{t}"], x[f"rect_{t}"]],
            ops=lambda x, t=tag: 22 * cov_taps(x[f"rect_{t}"]),
            shape=lambda x, t=tag: tuple(x[f"vm_{t}"].shape))
    kernels["seed_gradient_nasp_halo"] = dict(
        module=cuda_gradient, bar="bitwise", row="seed_gradient", secondary=True,
        form="nasp:halo",
        run=lambda x: cuda_gradient.seed_gradient(x["cf_h"], x["nm_h"], "halo"),
        plain=lambda x: cuda_gradient.seed_gradient_plain(x["cf_h"], x["nm_h"]),
        inputs=lambda x: [x["cf_h"], x["nm_h"]],
        ops=lambda x: npx(x["cf_h"]) * 121 * 20,
        issue=tap_issue("seed_gradient_nasp", "cf_h"),
        shape=lambda x: tuple(x["cf_h"].shape))
    uneven_kw = dict(c0=UNEVEN_TILE[0], tile_cols=UNEVEN_TILE[1])
    tri_u = ("color_f_u", "points_u", "nmap_u")
    kernels["nasp_assign_analyze_uneven"] = dict(
        module=cuda_nasp, bar="labels, distance bitwise; sums: integer exact, "
        "rest <= 1e-5 sum|terms|", row="nasp_assign_analyze", secondary=True, form="r4:tile",
        run=lambda x: cuda_nasp.nasp_assign_and_analyze(
            *(x[k] for k in tri_u), x["cand"], lo=lo, hi=hi, **x["akw"], **uneven_kw),
        plain=lambda x: cuda_nasp.nasp_assign_and_analyze_plain(
            *(x[k] for k in tri_u), x["cand"], lo=lo, hi=hi, **x["akw"], **uneven_kw),
        ok=lambda got, want, x: torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        and sums_ok("analyze", "scale_assign_u")(got, want, x),
        inputs=lambda x: [*(x[k] for k in tri_u), x["cand"]],
        ops=lambda x: assign_ops(x, "_u", UNEVEN_TILE),
        shape=lambda x: tuple(x["color_f_u"].shape))
    kernels["nasp_cell_sums_weighted_uneven"] = dict(
        module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|", row="nasp_cell_sums",
        secondary=True, form="r4:weighted:tile",
        run=lambda x: cuda_nasp.nasp_cell_sums(
            x["labels_u"], *(x[k] for k in tri_u), x["f_weighted"], mode="weighted",
            **sums_kw, **uneven_kw),
        plain=lambda x: cuda_nasp.nasp_cell_sums_plain(
            x["labels_u"], *(x[k] for k in tri_u), x["f_weighted"], mode="weighted",
            **sums_kw, **uneven_kw),
        ok=sums_ok("weighted", "scale_weighted_u"),
        inputs=lambda x: [x["labels_u"], *(x[k] for k in tri_u), x["f_weighted"]],
        ops=lambda x: labeled(x, "labels_u") * (51 + 14),
        shape=lambda x: tuple(x["color_f_u"].shape))
    kernels["label_cell_sums_uneven"] = dict(
        module=cuda_nasp, bar="<= 1e-5 sum|terms|", row="label_cell_sums", secondary=True,
        form="r4:F2:tile",
        run=lambda x: cuda_nasp.label_cell_sums(x["labels_u"], x["feats2_u"], **cell,
                                                **uneven_kw),
        plain=lambda x: cuda_nasp.label_cell_sums_plain(
            x["labels_u"], x["feats2_u"], **cell, **uneven_kw),
        ok=sums_ok("label", "scale_label_u"),
        library=lambda x: torch.zeros(
            (x["bi"].shape[0] * grid.num_clusters, 2), device=dev).index_add_(
            0, x["flat_label_u"], x["feats2_u"].reshape(-1, 2)),
        inputs=lambda x: [x["labels_u"], x["feats2_u"]],
        ops=lambda x: npx(x["labels_u"]) * 2,
        shape=lambda x: tuple(x["feats2_u"].shape))
    for nf in (6, 1, 3):
        tkey = f"table{nf}"
        kernels[f"label_cell_gather_f{nf}_uneven"] = dict(
            module=cuda_nasp, bar="bitwise", row="label_cell_gather", secondary=True,
            form=f"r4:F{nf}:tile",
            run=lambda x, t=tkey: cuda_nasp.label_cell_gather(
                x["labels_u"], x[t], **cell, **uneven_kw),
            plain=lambda x, t=tkey: cuda_nasp.label_cell_gather_plain(
                x["labels_u"], x[t], **cell, **uneven_kw),
            library=lambda x, t=tkey: x[t][x["bi"], x["labels_u"].clamp_min(0)],
            inputs=lambda x, t=tkey: [x["labels_u"], x[t]],
            ops=lambda x: 0,
            shape=lambda x, nf=nf: tuple(x["labels_u"].shape) + (nf,))
    # the global index's label counts on the 424x512 frames' NASP labels,
    # as the path launches them (a CCL merge: pairs with the right and the
    # down neighbours, then the single form); it replaces no TPU kernel.
    # The library is one index_add_ of the precomputed keys into a zeroed
    # table: the scatter that could stand in for the kernel, its keys'
    # kernels left out (label_counts_b8 times it whole)
    def scatter_counts(x, tag):
        b, k = x["labels_v2"].shape[0], grid.num_clusters
        size = k if tag == "single" else k * k
        table = torch.zeros(b * size + 1, device=dev).index_add_(
            0, x[f"keys_{tag}_v2"], x["ones_v2"])
        return table[:-1].reshape((b, k) if tag == "single" else (b, k, k))

    for tag in ("right", "down", "single"):
        kernels["label_counts" if tag == "right" else f"label_counts_{tag}"] = dict(
            module=cuda_nasp, bar="bitwise", row="label_counts", secondary=tag != "right",
            form="single" if tag == "single" else "pairs", replaces=None,
            run=(lambda x: cuda_nasp.label_counts(x["labels_v2"], grid.num_clusters))
            if tag == "single" else (lambda x, t=tag: cuda_nasp.label_pair_counts(
                x["labels_v2"], x[f"{t}_v2"], grid.num_clusters)),
            plain=(lambda x: cuda_nasp.label_counts_plain(x["labels_v2"], grid.num_clusters))
            if tag == "single" else (lambda x, t=tag: cuda_nasp.label_pair_counts_plain(
                x["labels_v2"], x[f"{t}_v2"], grid.num_clusters)),
            library=lambda x, t=tag: scatter_counts(x, t),
            # the label planes read and the table written
            inputs=(lambda x: [x["labels_v2"]]) if tag == "single"
            else (lambda x, t=tag: [x["labels_v2"], x[f"{t}_v2"]]),
            ops=lambda x: npx(x["labels_v2"]),  # one count a pixel
            shape=lambda x: tuple(x["labels_v2"].shape))

    def label_counts_b8(x):
        """A CCL merge's three label counts on the global index at the
        replay's B=8 (the four 424x512 frames twice): the kernel's against
        the scatter's that could replace it (the keys built, one index_add_
        a table into a zeroed one), bitwise equal, their device ms a merge
        and a frame."""
        k = grid.num_clusters
        lab, right, down = (torch.cat([x[n]] * 2).contiguous()
                            for n in ("labels_v2", "right_v2", "down_v2"))
        b = lab.shape[0]
        ones = torch.ones(lab.numel(), dtype=torch.float32, device=dev)
        frame = torch.arange(b, device=dev, dtype=torch.int32)[:, None, None]

        def scatter(c):
            size = k if c is None else k * k
            ok = (lab >= 0) & (lab < k)
            key = lab
            if c is not None:
                ok = ok & (c >= 0) & (c < k)
                key = lab * k + c
            key = torch.where(ok, key + frame * size, b * size).reshape(-1)
            table = torch.zeros(b * size + 1, device=dev).index_add_(0, key, ones)
            return table[:-1].reshape((b, k) if c is None else (b, k, k))

        runs = {
            "kernel": lambda: (cuda_nasp.label_pair_counts(lab, right, k),
                               cuda_nasp.label_pair_counts(lab, down, k),
                               cuda_nasp.label_counts(lab, k)),
            "scatter": lambda: (scatter(right), scatter(down), scatter(None)),
        }
        got = {name: fn() for name, fn in runs.items()}
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got["kernel"], got["scatter"])):
            _fail("label counts B=8: the scatter's tables differ from the kernel's")
        out = {}
        for name, fn in runs.items():
            d, n = device_time(fn)
            out[name] = {"call_ms": cuda_ms(fn, warmup=3, iters=20), "device_ms": d,
                         "device_activities": n,
                         "device_ms_per_frame": None if d is None else d / b}
        print(f"label counts B=8 (a CCL merge's three calls, 424x512) on {smi}: "
              + json.dumps(out))
        return out

    # the global index's float label sums on the 424x512 frames' NASP
    # labels, as NASP's updates launch them there (weighted F = 14,
    # analyze F = 13, over the labelled pixels); they replace no TPU
    # kernel.  Held to the one-hot product (the plain version) by
    # sums_close, integer columns exact, and to float64 sums within the
    # kernel's bound; the library is that product, the route it replaces
    # (label_sums_b8 times both at the replay's B = 8)
    def sums_v2(x, mode, fn=cuda_nasp.label_sums):
        return fn(x["labels_v2"], x[f"sums_{mode}_v2"], x["mask_v2"], grid.num_clusters)

    for mode, nf in (("weighted", 14), ("analyze", 13)):
        kernels["label_sums" if mode == "weighted" else f"label_sums_{mode}"] = dict(
            module=cuda_nasp, bar="integer exact, rest <= 1e-5 sum|terms|; f64 sums: "
            "<= ulp/2 + n 2^-53 sum|terms|", row="label_sums", secondary=mode != "weighted",
            form=f"F={nf}", replaces=None, run=lambda x, m=mode: sums_v2(x, m),
            plain=lambda x, m=mode: sums_v2(x, m, cuda_nasp.label_sums_plain),
            library=lambda x, m=mode: sums_v2(x, m, cuda_nasp.label_sums_plain),
            ok=lambda got, want, x, m=mode: cuda_nasp.sums_close(
                got[0], want[0], x[f"sums_scale_{m}_v2"], cuda_nasp.INTEGER_FEATURES[m])
            and label_sums_within_bound(got[0], x["labels_v2"], x[f"sums_{m}_v2"],
                                        x["mask_v2"], grid.num_clusters)[0],
            # the labels, the mask and the features read, the sums written
            inputs=lambda x, m=mode: [x["labels_v2"], x["mask_v2"], x[f"sums_{m}_v2"]],
            ops=lambda x, nf=nf: npx(x["labels_v2"]) * nf,  # one add a feature and pixel
            shape=lambda x, m=mode: tuple(x[f"sums_{m}_v2"].shape))

    # the global route's assignment sweep (slic._assign_global), which
    # replaces no TPU kernel: a later NASP iteration's sweep on the 424x512
    # frames (r = 4, from the first iteration's state; the v2 path sweeps
    # once from the grid init, over the same 64 candidates a pixel) and
    # the DASP sweep on the 640x480 frames (r = 2, from the depth SLIC's
    # state after one iteration, as SPDSP's later iterations run it).
    # Bitwise the plain sweep, which is also the library (the chunked
    # PyTorch route it replaces); operations per in-grid candidate
    # (SWEEP_OPS) and per out-of-grid one (1), per pixel 5; the issue floor
    # from the loop's SASS (SWEEP_LOOP_INSTRUCTIONS)
    def sweep_kw(variant, params, hh, ww):
        wc, wsp, wd, wn = slic._weights(params, variant)
        return dict(rows=grid.rows, cols=grid.cols, r=slic._variant(variant)[1] // 2,
                    variant=variant, w_col=wc, w_spa=wsp, w_dep=wd, w_nor=wn,
                    s_scale=slic._update_geometry(grid, hh, ww, variant)[0],
                    apply_invalid=slic._overrides(params, variant))

    sweeps = {"nasp": ("sweep_v2", sweep_kw("nasp", nasp_p, *V2_SHAPE)),
              "dasp": ("sweep_dasp", sweep_kw("dasp", SPDSPConfig().depth_slic, h, w))}

    def sweep_in_grid(lab, r):
        """In-grid candidates of each pixel's label's cell (-1 as cell 0)."""
        n_in = (cuda_nasp.cand_grid(grid.rows, grid.cols, cuda_nasp.candidate_offsets(r), dev)
                >= 0).sum(-1).reshape(-1).to(torch.float64)
        return n_in[lab.clamp(0, grid.num_clusters - 1).long()]

    def sweep_ops(args, kw):
        n_in = sweep_in_grid(args[0], kw["r"])
        n = (2 * kw["r"]) ** 2
        return float((SWEEP_OPS[kw["variant"]] * n_in + (n - n_in)).sum()) + 5 * npx(args[0])

    def sweep_issue(args, kw):
        warp_instructions = (float(sweep_in_grid(args[0], kw["r"]).sum())
                             * SWEEP_LOOP_INSTRUCTIONS[kw["variant"]] / 32)
        return warp_instructions / (SCHEDULERS * sm_mhz * 1e3), warp_instructions

    def same_sweep(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))

    for variant, (key, skw) in sweeps.items():
        kernels["assign_global" if variant == "nasp" else f"assign_global_{variant}"] = dict(
            module=cuda_nasp, bar="labels, distance bitwise", row="assign_global",
            secondary=variant != "nasp", form=f"{variant}:r{skw['r']}", replaces=None,
            run=lambda x, k=key, kw=skw: cuda_nasp.assign_global(*x[k], **kw),
            plain=lambda x, k=key, kw=skw: cuda_nasp.assign_global_plain(*x[k], **kw),
            library=lambda x, k=key, kw=skw: cuda_nasp.assign_global_plain(*x[k], **kw),
            ok=lambda got, want, x: same_sweep(got, want),
            # labels, distance, fields and the pixel planes read, labels and
            # distance written
            inputs=lambda x, k=key: [t for t in x[k] if t is not None],
            ops=lambda x, k=key, kw=skw: sweep_ops(x[k], kw),
            issue=lambda x, k=key, kw=skw: sweep_issue(x[k], kw),
            shape=lambda x, k=key: tuple(x[k][0].shape))

    def assign_global_b8(x):
        """The global sweep at the replay's B=8 (the four frames twice):
        NASP r = 4 on the 424x512 frames, DASP r = 2 on the 640x480 ones,
        bitwise the plain sweep and on a second call; device ms a call and
        a frame of kernel and plain sweep, the bound of the bytes and the
        operations and the issue floor."""
        out = {}
        for variant, (key, skw) in sweeps.items():
            args = tuple(None if t is None else torch.cat([t] * 2).contiguous() for t in x[key])
            b = args[0].shape[0]
            runs = {"kernel": lambda: cuda_nasp.assign_global(*args, **skw),
                    "plain": lambda: cuda_nasp.assign_global_plain(*args, **skw)}
            got, again, want = runs["kernel"](), runs["kernel"](), runs["plain"]()
            torch.cuda.synchronize()
            if not (same_sweep(got, want) and same_sweep(again, got)):
                _fail(f"assign_global B=8 {variant}: the kernel differs from the plain sweep "
                      "or from its first call")
            nbytes = sum(t.numel() * t.element_size() for t in args + got if t is not None)
            t_b, by = bound_ms(nbytes, sweep_ops(args, skw))
            row = {"shape": list(args[0].shape), "bound_ms": t_b, "bound_by": by,
                   "mb": nbytes / 1e6, "issue_ms": sweep_issue(args, skw)[0]}
            for name, fn in runs.items():
                d, n = device_time(fn)
                row[name] = {"call_ms": cuda_ms(fn, warmup=3, iters=20 if name == "kernel" else 5),
                             "device_ms": d, "device_activities": n,
                             "device_ms_per_frame": None if d is None else d / b}
            out[f"{variant} r{skw['r']}"] = row
            del got, again, want, args
        print(f"assign_global B=8 (424x512 NASP r = 4, 640x480 DASP r = 2) on {smi}: "
              + json.dumps(out))
        return out

    def label_sums_b8(x):
        """The global index's float sums at the replay's B=8: NASP's analyze
        (F = 13) and weighted (F = 14) sums on the 424x512 frames' labels,
        and DASP's update (F = 10: colour, u, v, 1, points, z > 50) on the
        640x480 frames' NASP labels, each the four frames twice: the kernel
        against the one-hot product it replaces (sums_close, integer
        columns exact) and against float64 sums (its bound), the same on a
        second call; their device ms a call and a frame, and the bound of
        the bytes read and written."""
        k = grid.num_clusters

        def twice(t):
            return torch.cat([t] * 2).contiguous()

        lab_v2, lab_vga = twice(x["labels_v2"]), twice(x["labels"])
        b = lab_vga.shape[0]
        z = x["points"][..., 2]
        u = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :].expand_as(z)
        v = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None].expand_as(z)
        dasp = torch.cat([x["color_f"], torch.stack([u, v, torch.ones_like(z)], -1),
                          x["points"], (z > 50.0).to(torch.float32)[..., None]], -1)
        cases = {
            "424x512 F=13": (lab_v2, twice(x["sums_analyze_v2"]), cuda_nasp.INTEGER_FEATURES[
                "analyze"]),
            "424x512 F=14": (lab_v2, twice(x["sums_weighted_v2"]), cuda_nasp.INTEGER_FEATURES[
                "weighted"]),
            "640x480 F=10": (lab_vga, twice(dasp), (0, 1, 2, 3, 4, 5, 9)),
        }
        out = {}
        for case, (lab, fe, ints) in cases.items():
            mask = lab >= 0
            runs = {"kernel": lambda: cuda_nasp.label_sums(lab, fe, mask, k),
                    "product": lambda: cuda_nasp.label_sums_plain(lab, fe, mask, k)}
            got, again, want = runs["kernel"](), runs["kernel"](), runs["product"]()
            scale = cuda_nasp.label_sums_plain(lab, fe.abs(), mask, k)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                _fail(f"label sums B=8 {case}: a second call differs")
            if not cuda_nasp.sums_close(got, want, scale, ints):
                _fail(f"label sums B=8 {case}: the one-hot product differs past sums_close")
            within, ulps = label_sums_within_bound(got, lab, fe, mask, k)
            if not within:
                _fail(f"label sums B=8 {case}: off the float64 sums past the kernel's bound")
            nbytes = sum(t.numel() * t.element_size() for t in (lab, mask, fe, got))
            row = {"most_ulps_from_f64": ulps,
                   "bound_ms": bound_ms(nbytes, lab.numel() * fe.shape[-1])[0]}
            for name, fn in runs.items():
                d, n = device_time(fn)
                row[name] = {"call_ms": cuda_ms(fn, warmup=3, iters=20), "device_ms": d,
                             "device_activities": n,
                             "device_ms_per_frame": None if d is None else d / b}
            out[case] = row
            del got, again, want, scale
        print(f"label sums B=8 (424x512 NASP F = 13 / 14, 640x480 DASP F = 10) on {smi}: "
              + json.dumps(out))
        return out

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
        with golden.plain_nasp():  # the inputs on the NASP kernels' plain twins
            x = stage_inputs(depth4[:bsz], color4[:bsz])
            x.update(v2_inputs(vdepth4[:bsz], vcolor4[:bsz]))
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
        if bsz == 4:
            label_counts_at_b8 = label_counts_b8(x)
            label_sums_at_b8 = label_sums_b8(x)
            assign_global_at_b8 = assign_global_b8(x)
        del x

    # ---- phase 4: the main path at 640x480, single-frame and batched
    def counts():
        c = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in (
            cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)}
        c.update(cuda_nasp.launches)
        return c

    def reset_counts():
        # a compiled call (core/jit.py) launches from Python only when it
        # captures: drop every captured call, so a driven path captures anew
        jit.clear()
        for m in (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient):
            m.launches = 0
            m.launch_forms.clear()
        for name in cuda_nasp.launches:
            cuda_nasp.launches[name] = 0
        cuda_nasp.launch_forms.clear()

    def forms_now():
        forms = {}
        for m in (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient, cuda_nasp):
            forms.update(m.launch_forms)
        return forms

    path_forms = {}  # path -> the wrappers' launch_forms of its driven run
    path_counts = {}  # path -> launches of each kernel in its driven run
    reset_counts()
    res1 = kde_pipeline(depth4[0], color4[0], intr, cfg)
    res4 = kde_pipeline(depth4, color4, intr, cfg)
    torch.cuda.synchronize()
    launches = counts()
    path_forms["main"] = forms_now()
    print(f"main path launches: {launches}")
    if any(n == 0 for k, n in launches.items() if k not in CELL_ROUTE_IDLE):
        _fail(f"a kernel of the main path was never launched: {launches}")
    if any(launches[k] for k in CELL_ROUTE_IDLE):
        _fail(f"the main path's cell-local route launched a global-route kernel: {launches}")
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

    # the NASP kernels against their plain twins (golden.plain_nasp)
    pts4 = projective_to_real(res4.jbf_depth, intr)
    seg = {"auto": slic.segment(color4, pts4, res4.normals, grid=grid, params=nasp_p)}
    with golden.plain_nasp():
        res_x = kde_pipeline(depth4, color4, intr, cfg)
        seg["plain"] = slic.segment(color4, pts4, res4.normals, grid=grid, params=nasp_p)
    torch.cuda.synchronize()
    if not torch.equal(res4.nasp_labels, res_x.nasp_labels):
        _fail("nasp_labels differ between the kernels and their plain twins")
    if not torch.equal(seg["auto"].labels, seg["plain"].labels):
        _fail("segment labels differ between the kernels and their plain twins")
    for f in ("size", "xy", "rgb"):
        d = (getattr(seg["auto"].clusters, f).double()
             - getattr(seg["plain"].clusters, f).double()).abs()
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
        _fail("the kernels' outputs differ from their plain twins' beyond the bar")

    frame_ms = {}
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        t = cuda_ms(lambda: kde_pipeline(d, c, intr, cfg), warmup=1, iters=5)
        frame_ms[bsz] = t / bsz
        print(f"kde_pipeline 640x480 B={bsz}: {t:.3f} ms per call, "
              f"{t / bsz:.3f} ms per frame (median of 5)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory: {peak:.2f} GiB")

    # where the time goes: one profiled call per batch size, device time per
    # kde.* stage and per kernel name (_stage_breakdown); busy share against
    # the unprofiled median call time above
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kde_scopes = KDE_SCOPES

    def stage_profile(tag, fn, call_ms, port_kernels=True, scopes=kde_scopes):
        """One profiled call of fn: device ms and activities by kde.* stage,
        the top kernels, the port's own kernels; the busy share against
        call_ms (an unprofiled median)."""
        sb = _stage_breakdown(fn, scopes)
        per, by_kernel, port = sb["per"], sb["by_kernel"], sb["port"]
        busy = sum(by_kernel.values())
        print(f"profile {tag}: {sb['work']} device activities ({sb['attached']} attached to a "
              f"CPU op), device busy {busy:.3f} ms of a {call_ms:.3f} ms call "
              f"({100.0 * busy / call_ms:.1f}% busy); {sb['spans']} stage spans on the device")
        for name, (ms, count) in per.items():
            print(f"  {name:16s} device {ms:.3f} ms in {count} activities")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  kernel {ms:8.3f} ms  {name[:90]}")
        print("  port kernels: " + "  ".join(
            f"{name} {ms:.4f} ms x{count}" for name, (ms, count) in sorted(port.items())))
        if port_kernels and not port:
            _fail(f"{tag}: the profile shows none of the port's kernels")
        return {"activities": sb["work"], "busy_ms": busy,
                **{name: {"device_ms": ms, "activities": n} for name, (ms, n) in per.items()}}

    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        stage_profile(f"B={bsz}", lambda: kde_pipeline(d, c, intr, cfg),
                      frame_ms[bsz] * bsz)

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
        path_forms[path], path_counts[path] = forms, got
        print(f"{path} launches: {got}; forms {forms}")
        missing = [k for k in expect if got[k] == 0] + [f for f in expect_forms if f not in forms]
        if missing:
            _fail(f"{path}: a kernel of the path was never launched: {missing}")
        return out

    def time_path(path, fn, bsz, scopes=kde_scopes, profiles=None, port_kernels=True):
        """Median ms of 5 calls; the profile by stage goes to profiles[path]."""
        t = cuda_ms(fn, warmup=1, iters=5)
        print(f"{path}: {t:.3f} ms per call, {t / bsz:.3f} ms per frame (median of 5)")
        prof = stage_profile(path, fn, t, scopes=scopes, port_kernels=port_kernels)
        if profiles is not None:
            profiles[path] = prof
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

    # every kernel of the cell-local route (the global route's are driven
    # on the 424x512 frame and the later iterations)
    all_kernels = tuple(k for k in launches if k not in CELL_ROUTE_IDLE)
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
                "label_cell_sums:r5:F2", "label_cell_gather:r5:F6", "assign_global:nasp:r4")
    cfg_c = {loc: dataclasses.replace(cfg, nasp=dataclasses.replace(
        nasp_p, iterations=3, locality=loc)) for loc in ("auto", "global")}
    res_c = {}
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        res_c[bsz] = drive(f"iter3 B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_c["auto"]),
                           all_kernels + ("assign_global",), r5_forms)
        res_g = drive(f"iter3.global B={bsz}",
                      lambda: kde_pipeline(d, c, intr, cfg_c["global"]),
                      stencil_kernels + ("nasp_assign_analyze", "nasp_cell_sums", "assign_global")
                      + INDEX_KERNELS)
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
        # the later iterations' assignment alone (the sweep kernel, 64 candidates)
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
    vd, vc = vdepth4[0], vcolor4[0]
    res_d = drive("kinect_v2 424x512", lambda: kde_pipeline(vd, vc, intr_v2, cfg),
                  stencil_kernels + INDEX_KERNELS + ("assign_global",),
                  ("label_counts:pairs", "label_counts:single", "label_sums:F=2",
                   "label_sums:F=13", "label_sums:F=14", "assign_global:nasp:r4"))
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
    r2 = ("seed_gradient:color", "label_cell_sums:r2:F10", "label_cell_gather:r2:F2",
          "assign_global:dasp:r2")
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
                             ("cuda_gradient", "label_cell_sums", "label_cell_gather",
                              "assign_global"), forms)
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
    # the DASP sweep alone (the sweep kernel, 16 candidates), from the depth
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

    # ---- phase 8: this slice's paths at 640x480, each driven from counts at
    # 0: KDE with the SDC and the bilateral normals (P1, P2), the MRF
    # baseline (P3), run_stream (P4) and the enhance command over the six
    # pipelines (P5); checked against the JAX package, the port's CPU run
    # and direct calls, timed and profiled
    from kinectdepthmapenhancement_tpu_torch import cli
    from kinectdepthmapenhancement_tpu_torch.core import io as kio
    from kinectdepthmapenhancement_tpu_torch.models import streaming
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import mrf_pipeline

    t_phase8 = time.perf_counter()
    slice_ms, slice_prof, slice_out = {}, {}, {}

    # (a) P1, P2: the normal methods; bilateral skips the smoothing map (no
    # DT, no covariance sweep), SDC runs the DT but no covariance sweep.
    # What the 640x480 end point can tell apart: the pixels where the plane
    # stage moved the output (against the final depth bilateral of the JBF
    # points alone), with the merged clusters that pass each of
    # variance_optimization's gates in turn; and each method's bars read
    # against the main path's cm outputs in the method's place, which they
    # must reject
    rays0 = normalized_rays(intr, h, w, dev)
    got_cm = {f: getattr(res1, f).cpu().numpy() for f in res1._fields}

    def plane_stage(tag, res):
        base = plane.depth_bilateral(projective_to_real(res.jbf_depth[None], intr), rays0,
                                     cfg.projection)[0]
        z, lab = res.jbf_depth, res.merged_labels.long()
        ok = (lab >= 0) & (z > plane.VALID_DEPTH_MM)
        e2 = ((res.plane_fitted[..., 2] - z) / z.clamp_min(1.0)).double().square()
        k = res.merged_sizes.shape[-1]
        resid = torch.sqrt(torch.bincount(lab[ok], weights=e2[ok], minlength=k)
                           / torch.bincount(lab[ok], minlength=k).clamp_min(1))
        present = torch.bincount(lab[lab >= 0], minlength=k) > 0
        big = present & (res.merged_sizes > cfg.min_cluster_size)
        coherent = big & (res.merged_variance.clamp(max=1.0) > plane.COS_PI_8)
        fit = coherent & (resid < cfg.max_plane_residual)
        census = {"moved_px": int((base != res.optimized_points).any(-1).sum()),
                  "clusters": int(present.sum()), "big": int(big.sum()),
                  "big_coherent": int(coherent.sum()), "big_coherent_fit": int(fit.sum())}
        print(f"{tag} B=1: the plane stage moved {census['moved_px']} pixels; of "
              f"{census['clusters']} merged clusters {census['big']} have > "
              f"{cfg.min_cluster_size} px, {census['big_coherent']} of those a normal variance "
              f"> cos(pi/8), {census['big_coherent_fit']} of those a plane residual < "
              f"{cfg.max_plane_residual}")
        slice_out[f"{tag}_plane_stage"] = census

    plane_stage("cm", res1)
    for method in golden.NORMAL_METHODS:
        cfg_m = dataclasses.replace(cfg, normals=dataclasses.replace(cfg.normals, method=method))
        unused = ("cuda_cov",) + (("cuda_dt",) if method == "bilateral" else ())
        res_m = {}
        for bsz in (1, 4):
            d, c = (depth4[0], color4[0]) if bsz == 1 else (depth4, color4)
            res_m[bsz] = drive(f"{method} B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_m),
                               tuple(k for k in all_kernels if k not in unused))
            ran = [k for k in unused if path_counts[f"{method} B={bsz}"][k]]
            if ran:
                _fail(f"{method} B={bsz}: launched {ran}, which the method does not run")
            check_outputs(f"{method} B={bsz}", res_m[bsz], k_count)
        for f in ("nasp_labels", "merged_labels"):
            if not torch.equal(getattr(res_m[1], f), getattr(res_m[4], f)[0]):
                _fail(f"{method}: {f} of B=1 differs from frame 0 of B=4")
        got1 = {f: getattr(res_m[1], f).cpu().numpy() for f in res_m[1]._fields}
        want_m = golden.load_jax_normals("640x480", method)
        gates = golden.normal_method_gates(method, got1, want_m)
        for gname, (val, lim, ok) in gates.items():
            print(f"{method} 640x480 {gname:28s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
        if golden.failures(gates):
            _fail(f"{method} 640x480 against the JAX package: {golden.failures(gates)}")
        wrong = golden.normal_method_gates(method, got_cm, want_m)
        rejected = {g: wrong[g][0] for g in ("normal_direction_agreement", "nasp_label_agreement")}
        print(f"{method} 640x480 bars against the cm outputs in {method}'s place: " + ", ".join(
            f"{g} {v:.6g} (limit {wrong[g][1]})" for g, v in rejected.items()))
        if any(wrong[g][2] for g in rejected):
            _fail(f"{method} 640x480: the bars do not reject the cm outputs: {rejected}")
        slice_out[f"{method}_bars_on_cm_outputs"] = rejected
        plane_stage(method, res_m[1])
        # the card's normals against the port's CPU run on the same points
        pts_m = projective_to_real(res_m[4].jbf_depth, intr)
        n_card = normals.generate_normal_map(pts_m, cfg_m.normals).cpu()
        n_cpu = normals.generate_normal_map(pts_m.cpu(), cfg_m.normals)
        v_card, v_cpu = (n_card != -1.0).any(-1), (n_cpu != -1.0).any(-1)
        dn = (n_card - n_cpu).abs().amax(-1)[v_card & v_cpu]
        agree = float((v_card == v_cpu).double().mean())
        same, within = float((dn == 0).double().mean()), float((dn <= 1e-3).double().mean())
        print(f"{method} B=4 normals, card against CPU on the same points: validity agrees on "
              f"{agree:.6f} (bar > 0.999), equal on {same:.6f}, within 1e-3 on {within:.6f} "
              f"(bar > 0.99) of the pixels valid in both, max |d| {float(dn.max()):.3g}")
        if not (agree > 0.999 and within > 0.99):
            _fail(f"{method}: the card's normals differ from the CPU's beyond the bar")
        slice_out[f"{method}_normals_card_vs_cpu"] = {"valid_agree": agree, "equal": same,
                                                      "within_1e-3": within}
        check_again(f"{method} B=4", lambda: kde_pipeline(depth4, color4, intr, cfg_m), res_m[4])
        for bsz in (1, 4):
            d, c = depth4[:bsz], color4[:bsz]
            slice_ms[f"{method} B={bsz}"] = time_path(
                f"{method} B={bsz}", lambda: kde_pipeline(d, c, intr, cfg_m), bsz,
                profiles=slice_prof)

    print(f"phase 8 (a) P1, P2: {time.perf_counter() - t_phase8:.1f} s")
    # (b) P3: the MRF baseline (plain PyTorch; no kernel of the port)
    reset_counts()
    mrf1, mrf4 = mrf_pipeline(depth4[0], color4[0]), mrf_pipeline(depth4, color4)
    torch.cuda.synchronize()
    path_counts["mrf"] = counts()
    if not torch.equal(mrf1, mrf4[0]) or not bool(torch.isfinite(mrf4).all()):
        _fail("mrf: B=1 differs from frame 0 of B=4, or non-finite output")
    mrf_want = golden.load_jax_mrf_640x480()
    mrf_got = mrf1.cpu().numpy()
    rel_jax = float((np.abs(mrf_got - mrf_want) / np.maximum(np.abs(mrf_want), 1e-30)).max())
    mrf_cpu = mrf_pipeline(depth4.cpu(), color4.cpu())
    rel_cpu = float(((mrf4.cpu() - mrf_cpu).abs() / mrf_cpu.abs().clamp_min(1e-30)).max())
    same_cpu = float((mrf4.cpu() == mrf_cpu).double().mean())
    print(f"mrf 640x480: max relative difference {rel_jax:.3g} from the JAX package (bar 1e-6), "
          f"{rel_cpu:.3g} from the port's CPU run (bar 1e-6; equal on {same_cpu:.6f}); "
          f"launches {path_counts['mrf']}")
    if not (rel_jax <= 1e-6 and rel_cpu <= 1e-6):
        _fail("mrf: the output differs from the JAX package or the CPU beyond rtol 1e-6")
    slice_out["mrf"] = {"rel_jax": rel_jax, "rel_cpu": rel_cpu, "equal_cpu": same_cpu}
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        slice_ms[f"mrf B={bsz}"] = time_path(f"mrf B={bsz}", lambda: mrf_pipeline(d, c), bsz,
                                             scopes=(), profiles=slice_prof, port_kernels=False)

    print(f"phase 8 (b) P3: {time.perf_counter() - t_phase8:.1f} s")
    # (c) P4: run_stream over 32 frames (the noise of tests/test_streaming.py:
    # 13-17 on frame 0's true depth, seed 0), batch 1, 4 and 8, capture mode
    # and kde_only; each chunk's points bitwise against kde_pipeline on the
    # same batch, frames per second, the device busy share of a profiled run
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    gt0_s, color0 = scenes[0][2], scenes[0][0]
    rng = np.random.default_rng(0)
    var = 0.45 * 2.85 * np.square(gt0_s / 10.0) / 1.0e4
    frames32 = [(gt0_s + rng.uniform(-1, 1, gt0_s.shape) * var).astype(np.float32)
                for _ in range(32)]
    frames_dev = torch.from_numpy(np.stack(frames32)).to(dev)
    stream_states = {}

    def stream(bsz, kde_only, **kw):
        st = streaming.run_stream(iter(frames32), color0, intr, cfg=cfg, batch=bsz,
                                  kde_only=kde_only, **kw)
        torch.cuda.synchronize()
        return st

    def stream_busy(tag, fn):
        """Device busy share of one profiled fn(): the union of its device
        activities' intervals (a copy that overlaps a kernel counts once)
        over the profiled run's own wall time.  Traced on the device alone
        and read from the raw trace: for a whole stream the host-side
        events, or the profiler's event list, take seconds to tens of
        seconds to read."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [ev for ev in prof.profiler.kineto_results.events()
                if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()]
        if not acts:
            _fail(f"{tag}: the device trace holds no activity")
        busy_ns, end = 0, None
        for a, b in sorted((ev.start_ns(), ev.end_ns()) for ev in acts):
            if end is None or a >= end:
                busy_ns, end = busy_ns + b - a, b
            elif b > end:
                busy_ns, end = busy_ns + b - end, b
        busy = busy_ns / 1e6
        summed = sum(ev.duration_ns() for ev in acts) / 1e6
        print(f"profile {tag}: {len(acts)} device activities ({summed:.3f} ms summed), device "
              f"busy {busy:.3f} ms of the profiled run's {wall_ms:.3f} ms "
              f"({100.0 * busy / wall_ms:.1f}% busy)")
        return {"activities": len(acts), "busy_ms": busy, "summed_ms": summed,
                "wall_ms": wall_ms}

    for kde_only in (False, True):
        for bsz in (1, 4, 8):
            tag = f"stream {'kde_only' if kde_only else 'capture'} batch={bsz}"
            seen = []
            first = drive(tag, lambda: stream(bsz, kde_only, on_outputs=lambda s0, p: seen.append(
                (s0, p))), all_kernels)
            for s0, pts in seen:
                k = pts.shape[0]
                want = kde_pipeline(frames_dev[s0:s0 + k], color4[0].expand(k, -1, -1, -1)
                                    .contiguous(), intr, cfg).optimized_points
                if not torch.equal(pts, want):
                    _fail(f"{tag}: the points of the chunk at frame {s0} differ from kde_pipeline")
            t0 = time.perf_counter()
            st = stream(bsz, kde_only)
            wall = time.perf_counter() - t0
            for f in ("frame_index", "metric_sums", "metric_counts"):
                if getattr(st, f) != getattr(first, f):
                    _fail(f"{tag}: a second run gave another {f}")
            stream_states[tag] = st
            metric = "kde_checksum" if kde_only else "kde_error_mm"
            print(f"{tag}: {len(seen)} chunks bitwise equal to kde_pipeline; 32 frames in "
                  f"{wall * 1e3:.1f} ms, {32 / wall:.2f} frames/s; {metric} "
                  f"{streaming.mean_metric(st, metric):.6g}")
            slice_ms[tag] = wall * 1e3
            slice_prof[tag] = stream_busy(tag, lambda: stream(bsz, kde_only))
    cap = [stream_states[f"stream capture batch={b}"] for b in (1, 4, 8)]
    for st in cap[1:]:
        if st.metric_counts != cap[0].metric_counts or not torch.equal(
                st.buffer.weight, cap[0].buffer.weight):
            _fail("stream: the batch sizes give other counts or buffer weights")
        dz = float((st.buffer.depth - cap[0].buffer.depth).abs().max())
        ds = abs(st.metric_sums["kde_error_mm"] / cap[0].metric_sums["kde_error_mm"] - 1.0)
        print(f"stream batch invariance: buffer depth max |d| {dz:.3g} mm, error sum relative "
              f"difference {ds:.3g} (bar 1e-5)")
        if ds > 1e-5:
            _fail("stream: the error sums of the batch sizes differ beyond rtol 1e-5")
    # stopped after 16 frames and resumed from the checkpoint: equal to the
    # uninterrupted run
    ckpt = os.path.join(work, "stream.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    part = stream(8, False, checkpoint_path=ckpt, checkpoint_every=8, max_frames=16)
    resumed = stream(8, False, checkpoint_path=ckpt, checkpoint_every=8)
    whole = stream_states["stream capture batch=8"]
    same = (part.frame_index == 16 and resumed.frame_index == whole.frame_index == 32
            and resumed.metric_sums == whole.metric_sums
            and resumed.metric_counts == whole.metric_counts
            and torch.equal(resumed.buffer.depth, whole.buffer.depth)
            and torch.equal(resumed.buffer.weight, whole.buffer.weight))
    print(f"stream resume: stopped at frame {part.frame_index}, resumed to "
          f"{resumed.frame_index}; buffer and metric sums equal to the uninterrupted run: {same}")
    if not same:
        _fail("stream: the resumed run differs from the uninterrupted one")

    print(f"phase 8 (c) P4: {time.perf_counter() - t_phase8:.1f} s")
    # (d) P5: enhance for the six pipelines through files (the XML holds each
    # f32 as %.9g, which round-trips exactly): the refined depth equal to the
    # pipeline's output on the same arrays; kde with --ply, --png, --debug-dir
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import (
        rgbf_pipeline, spdsp_pipeline, tof_pipeline,
    )

    d0, c0 = depth4[0], color4[0]
    raw0 = projective_to_real(d0, intr)
    direct = {
        "jbf": lambda: jbf_pipeline(d0, c0),
        "mrf": lambda: mrf_pipeline(d0, c0),
        "rgbf": lambda: rgbf_pipeline(d0, raw0, c0).refined_depth,
        "kde": lambda: kde_pipeline(d0, c0, intr, cfg).optimized_points[..., 2],
        "spdsp": lambda: spdsp_pipeline(d0, raw0, c0, intr).optimized_points[..., 2],
        "tof": lambda: tof_pipeline(d0, raw0, c0, intr).plane_fitted[..., 2],
    }
    depth_xml = os.path.join(work, "depth.xml")
    kio.write_filestorage_xml(depth_xml, {"depth": scenes[0][1]})
    from PIL import Image

    color_png = os.path.join(work, "color.png")
    Image.fromarray(scenes[0][0]).save(color_png)
    ply, png, dbg = (os.path.join(work, f) for f in ("cloud.ply", "depth.png", "debug"))
    shutil.rmtree(dbg, ignore_errors=True)
    reset_counts()
    for name in cli.PIPELINES:
        out_xml = os.path.join(work, f"refined_{name}.xml")
        t0 = time.perf_counter()
        extra = ["--ply", ply, "--png", png, "--debug-dir", dbg] if name == "kde" else []
        rc = cli.main(["enhance", "--depth", depth_xml, "--color", color_png,
                       "--pipeline", name, "--out", out_xml] + extra)
        if rc != 0:
            _fail(f"enhance --pipeline {name} returned {rc}")
        torch.cuda.synchronize()
        slice_ms[f"enhance {name}"] = (time.perf_counter() - t0) * 1e3
        got = kio.read_filestorage_xml(out_xml)["depth"]
        want = direct[name]().cpu().numpy()
        if not np.array_equal(got, want):
            _fail(f"enhance --pipeline {name}: the refined depth differs from the pipeline's")
        print(f"enhance --pipeline {name}: refined depth equal to the pipeline's output "
              f"({slice_ms[f'enhance {name}']:.1f} ms through the files)")
    path_counts["enhance"] = counts()
    if any(path_counts["enhance"][k] == 0 for k in all_kernels):
        _fail(f"enhance: a kernel was never launched: {path_counts['enhance']}")
    renders = sorted(os.listdir(dbg))
    if len(renders) != 4:
        _fail(f"enhance --debug-dir wrote {renders}")
    with open(ply) as f:
        head = [f.readline() for _ in range(3)]
    with Image.open(png) as im:
        size = im.size
    print(f"enhance kde: {head[2].strip()} in {ply}, {png} {size}, renders {renders}")
    if head[0].strip() != "ply" or size != (w, h):
        _fail("enhance kde: the PLY or PNG output is malformed")
    print(f"phase 8: {time.perf_counter() - t_phase8:.1f} s")
    print("slice paths: " + json.dumps({"ms": slice_ms, "checks": slice_out, "profiles": {
        k: {"activities": v["activities"], "busy_ms": v["busy_ms"],
            "wall_ms": v.get("wall_ms"),
            "kde.normals_ms": v.get("kde.normals", {}).get("device_ms")}
        for k, v in slice_prof.items()}, "launches": {
        k: path_counts[k] for k in path_counts if k.split()[0] in (
            "sdc", "bilateral", "stream", "mrf", "enhance")}}))

    # ---- phase 10: the evaluation and data-ingest slice at 640x480 (runs
    # before phase 9's summary): (a) evaluate --full on the test scene, (b)
    # the far-range rows with the plane merge and hole fill, the plane stage
    # held against the JAX package where it moves pixels, (c) evaluate --tum
    # through the command line, (d) depth-to-colour registration, (e)
    # run_stream fed by the native frame source; the cm normals read against
    # the JAX package's (ROADMAP C1)
    import runpy

    from kinectdepthmapenhancement_tpu_torch import native
    from kinectdepthmapenhancement_tpu_torch.core import datasets
    from kinectdepthmapenhancement_tpu_torch.core.registration import (
        Extrinsics, register_depth_to_color,
    )
    from kinectdepthmapenhancement_tpu_torch.utils import evaluate as kev

    t_phase10 = time.perf_counter()
    eval_dir = os.path.join(work, "evaluate")
    shutil.rmtree(eval_dir, ignore_errors=True)
    os.makedirs(eval_dir)
    eval_out: dict = {}
    # kernels each evaluate row's method runs (every kde row runs all eight)
    dasp_kernels = ("cuda_gradient", "label_cell_sums", "label_cell_gather", "assign_global")
    row_kernels = {"input": (), "jbf": ("cuda_bilateral",), "mrf": (), "rgbf": dasp_kernels,
                   "spdsp": dasp_kernels, "tof": dasp_kernels + ("label_counts",)}

    def drive_rows(tag, fn):
        """fn() (an evaluate call, or the command that makes one) from counts
        at 0, with each row's launches: the counts are read whenever the
        harness starts timing a row (kev.time_pipeline) and at the end."""
        marks = []
        timer = kev.time_pipeline

        def marked(*args, **kw):
            marks.append(counts())
            return timer(*args, **kw)

        kev.time_pipeline = marked
        try:
            reset_counts()
            rows = fn()
            torch.cuda.synchronize()
        finally:
            kev.time_pipeline = timer
        marks.append(counts())
        path_counts[tag] = marks[-1]
        for i, name in enumerate(rows):
            got = {k: marks[i + 1][k] - marks[i][k] for k in marks[i]}
            path_counts[f"{tag}.{name}"] = got
            expect = all_kernels if name.startswith("kde") else row_kernels[name]
            missing = [k for k in expect if got[k] == 0]
            # a DASP pipeline's index may leave its cap: the global index's
            # kernels then run
            optional = GLOBAL_INDEX_KERNELS if name in ("rgbf", "spdsp", "tof") else ()
            extra = [k for k in got if got[k] and k not in expect + optional]
            if missing or extra:
                _fail(f"{tag} row {name}: kernels never launched {missing}, launched "
                      f"though the method does not run them {extra}")
        return rows

    def print_rows(tag, rows):
        for name, r in rows.items():
            print(f"{tag} {name:12s} {r['time_ms']:10.3f} ms  mean 3-D error "
                  f"{r['mean_3d_error_mm']:.6f} mm  rmse {r['rmse_mm']:.4f} mm  "
                  f"valid {r['valid_px']}  launches {sum(path_counts[f'{tag}.{name}'].values())}"
                  f"  [{smi}]")

    def row_stats(pts, gt_t):
        err, n = metrics.mean_3d_error(pts, projective_to_real(gt_t, intr))
        return float(err), float(metrics.depth_rmse(pts[..., 2], gt_t)), int(n)

    def hold_rows(tag, rows, d_np, c_np, gt_np, jax_z, bar, **kw):
        """Each row against the same row computed by the port on the CPU
        (one call of the row's method on the frame), and, where the JAX
        package's output of the frame is committed, against its error."""
        runs = kev.method_runs(intr, **kw)
        d_c, c_c, gt_c = (torch.from_numpy(np.array(a)) for a in (d_np, c_np, gt_np))
        gt_d = gt_c.to(dev)
        t0 = time.perf_counter()
        checks = {}
        for name, r in rows.items():
            with torch.inference_mode():
                err, rmse, n = row_stats(runs[name](d_c, c_c), gt_c)
            rel = max(abs(err / r["mean_3d_error_mm"] - 1), abs(rmse / r["rmse_mm"] - 1))
            line = (f"{tag} {name}: CPU error {err:.6f} rmse {rmse:.4f} valid {n}, "
                    f"relative difference {rel:.3g}")
            checks[name] = {"cpu_rel": rel, "cpu_valid_px": n}
            ok = rel <= bar and abs(n - r["valid_px"]) <= 1e-3 * n
            if name in jax_z:
                z = torch.from_numpy(jax_z[name]).to(dev)
                jerr, jrmse, jn = row_stats(projective_to_real(z, intr), gt_d)
                jrel = max(abs(jerr / r["mean_3d_error_mm"] - 1), abs(jrmse / r["rmse_mm"] - 1))
                line += (f"; JAX error {jerr:.6f} rmse {jrmse:.4f} valid {jn}, relative "
                         f"difference {jrel:.3g}")
                checks[name].update(jax_rel=jrel, jax_valid_px=jn)
                ok = ok and jrel <= bar and abs(jn - r["valid_px"]) <= 1e-3 * jn
            print(line + f" (bar {bar}; valid within 0.1%)")
            if not ok:
                _fail(f"{tag} {name}: the card's row differs from the CPU's or the JAX "
                      "package's beyond the bar")
        print(f"{tag}: CPU rows in {time.perf_counter() - t0:.1f} s")
        return checks

    # (a) evaluate --full: the JAX package's main() with SPDSP and TOF
    color_e, noisy_e, gt_e = scenes[0]  # make_noisy_scene(480, 640, seed=0)
    full = drive_rows("eval.full", lambda: kev.evaluate(
        noisy_e, color_e, gt_e, include_sp_methods=True, timing_iters=3,
        figure_path=os.path.join(eval_dir, "full.png"), device=dev))
    if list(full) != ["input", "jbf", "mrf", "rgbf", "kde", "spdsp", "tof"]:
        _fail(f"evaluate --full rows {list(full)}")
    text = kev.write_report(os.path.join(eval_dir, "evaluation_full.txt"), full)
    if not text.startswith("runtime\n") or "\nerror\n" not in text:
        _fail("evaluate --full: the report is malformed")
    print_rows("eval.full", full)
    # the RGBF, SPDSP and TOF rows time a replay: their eager calls timed
    # the same way beside them
    runs_full = kev.method_runs(intr, include_sp_methods=True)
    d_e, c_e = torch.from_numpy(noisy_e).to(dev), torch.from_numpy(color_e).to(dev)
    for name in ("rgbf", "spdsp", "tof"):
        with torch.inference_mode():
            st = kev.time_pipeline(runs_full[name].fn, lambda i: (d_e, c_e), iters=3,
                                   compiled=False)
        eval_out.setdefault("eager_ms", {})[name] = st["median_s"] * 1e3
        print(f"eval.full {name}: the row's replay {full[name]['time_ms']:.3f} ms, its eager "
              f"call {st['median_s'] * 1e3:.3f} ms (time_pipeline, median of 3) [{smi}]")
    jfull = golden.load_jax_640x480()
    jz = {"jbf": jfull["jbf"], "kde": jfull["optimized_points"][..., 2],
          "mrf": golden.load_jax_mrf_640x480(),
          "spdsp": dasp_want["spdsp__optimized_z"], "tof": dasp_want["tof__plane_fitted_z"]}
    eval_out["full"] = {"rows": full, "checks": hold_rows(
        "eval.full", full, noisy_e, color_e, gt_e, jz, 1e-3, include_sp_methods=True)}
    for name in ("jbf", "rgbf", "kde", "spdsp"):
        if not full[name]["mean_3d_error_mm"] < full["input"]["mean_3d_error_mm"]:
            _fail(f"evaluate --full: {name} does not beat the input's mean 3-D error")
    with Image.open(os.path.join(eval_dir, "full.png")) as im:
        if im.size != (3 * w, 3 * (h + 18)):  # 8 panels, three a row
            _fail(f"evaluate --figure: montage of size {im.size}")
    print(f"phase 10 (a): {time.perf_counter() - t_phase10:.1f} s")

    # (b) the far-range rows (scripts/eval_far_range.py --holes 0.15): the
    # plane stage moves pixels here, so kde_pm and kde_pm_fill differ from kde
    fcolor_h, fsensor_h, fgt_h = make_banded_scene(h, w, intr, seed=0, hole_fraction=0.15)
    far = drive_rows("eval.far", lambda: kev.evaluate(
        fsensor_h, fcolor_h, fgt_h, intr=intr, include_sp_methods=False, timing_iters=3,
        fill_steps=4, plane_merge=True, device=dev))
    if list(far) != ["input", "jbf", "mrf", "rgbf", "kde", "kde_fill", "kde_pm", "kde_pm_fill"]:
        _fail(f"far-range rows {list(far)}")
    kev.write_report(os.path.join(eval_dir, "evaluation_far.txt"), far)
    print_rows("eval.far", far)
    plane_runs = golden.plane_configs()
    fd_h, fc_h = torch.from_numpy(fsensor_h).to(dev), torch.from_numpy(fcolor_h).to(dev)
    planes_out, jz_far = {}, {}
    for name, cfg_p in plane_runs.items():
        res_p = kde_pipeline(fd_h, fc_h, intr, cfg_p)
        got_p = golden.plane_stage_maps(res_p, fsensor_h, intr, cfg_p)
        want_p = golden.load_jax_planes("640x480", name)
        gates = golden.plane_stage_gates(got_p, want_p, fgt_h, golden.SDC_PLANES_640X480_BARS
                                         if name.startswith("sdc") else golden.PLANE_STAGE_BARS)
        for gname, (val, lim, ok) in gates.items():
            print(f"planes {name:12s} {gname:30s} {val:.6g} (limit {lim}) {'ok' if ok else 'FAIL'}")
        dz = np.abs(got_p["optimized_z"] - want_p["optimized_z"])
        print(f"planes {name}: moved {int(got_p['moved'].sum())} px (JAX "
              f"{int(want_p['moved'].sum())}), filled {int(got_p['filled'].sum())} (JAX "
              f"{int(want_p['filled'].sum())}), merged labels equal on "
              f"{float((got_p['merged_labels'] == want_p['merged_labels']).mean()):.6f}, "
              f"optimized z max |d| {float(dz.max()):.4g} mm, within 0.01 mm on "
              f"{float((dz < 0.01).mean()):.6f}")
        if golden.failures(gates):
            _fail(f"planes {name} against the JAX package: {golden.failures(gates)}")
        planes_out[name] = {g: v[0] for g, v in gates.items()}
        if name.startswith("cm_"):
            jz_far["kde_" + name[3:]] = want_p["optimized_z"]
        else:  # SDC's own spread: the card against the port's CPU run (reported)
            res_c = kde_pipeline(fd_h.cpu(), fc_h.cpu(), intr, cfg_p)
            spread = golden.plane_stage_gates(
                got_p, golden.plane_stage_maps(res_c, fsensor_h, intr, cfg_p), fgt_h,
                dict.fromkeys(golden.PLANE_STAGE_BARS))
            print(f"planes {name}: the card against the port's CPU run: " + ", ".join(
                f"{g} {v[0]:.6g}" for g, v in spread.items()))
            planes_out[name + " card vs cpu"] = {g: v[0] for g, v in spread.items()}
    eval_out["far"] = {"rows": far, "planes": planes_out, "checks": hold_rows(
        "eval.far", far, fsensor_h, fcolor_h, fgt_h, jz_far, 1e-3, include_sp_methods=False,
        fill_steps=4, plane_merge=True)}
    if not (far["kde_pm"]["rmse_mm"] < far["kde"]["rmse_mm"] < far["jbf"]["rmse_mm"]):
        _fail("far range: the RMSE order jbf > kde > kde_pm does not hold")
    print(f"phase 10 (b): {time.perf_counter() - t_phase10:.1f} s")

    # (c) evaluate --tum through the command line, as `python -m
    # kinectdepthmapenhancement_tpu_torch evaluate ...` runs it: a 30-frame
    # Kinect v1 sensor-model sequence of the test scene
    tum_root = os.path.join(eval_dir, "tum_kinect_v1")
    rng = np.random.default_rng(0)
    datasets.write_tum_sequence(tum_root, [
        (100.0 + 0.033 * i, color_e, datasets.kinect_v1_sensor_model(gt_e, rng))
        for i in range(30)])
    tum_txt = os.path.join(eval_dir, "evaluation_tum.txt")
    argv = sys.argv

    def run_cli():
        sys.argv = ["kinectdepthmapenhancement_tpu_torch", "evaluate", tum_txt, "--tum",
                    tum_root, "--frames", "30", "--timing-iters", "3"]
        try:
            runpy.run_module("kinectdepthmapenhancement_tpu_torch", run_name="__main__")
        except SystemExit as e:
            if e.code not in (0, None):
                _fail(f"evaluate --tum exited with {e.code}")
        finally:
            sys.argv = argv
        tum_rows = {}
        with open(tum_txt) as f:
            lines = f.read().splitlines()
        if lines[0] != "runtime" or "error" not in lines:
            _fail("evaluate --tum: the report is malformed")
        for ln in lines[lines.index("error") + 1:]:
            name, err = ln.split()[:2]
            rmse = float(ln.split("rmse ")[1].split()[0])
            n = int(ln.rsplit("n=", 1)[1].rstrip(")"))
            ms = float(next(x for x in lines if x.startswith(name + ":")).split()[1])
            tum_rows[name] = {"time_ms": ms, "mean_3d_error_mm": float(err), "rmse_mm": rmse,
                              "valid_px": n}
        return tum_rows

    tum = drive_rows("eval.tum", run_cli)
    print_rows("eval.tum", tum)
    if list(tum) != ["input", "jbf", "mrf", "rgbf", "kde"] or not all(
            np.isfinite(r["rmse_mm"]) for r in tum.values()):
        _fail(f"evaluate --tum rows {tum}")
    if not (tum["kde"]["rmse_mm"] < tum["input"]["rmse_mm"]
            and tum["jbf"]["rmse_mm"] < tum["input"]["rmse_mm"]):
        _fail("evaluate --tum: kde or jbf does not beat the input's RMSE")
    eval_out["tum"] = {"rows": tum}
    print(f"phase 10 (c): {time.perf_counter() - t_phase10:.1f} s")

    # (d) registration: the card's output equal to the CPU's, and held
    # against the JAX function's on the same input (golden.registration_gates)
    rot_np, t_np = golden.registration_extrinsics()
    extr_d = Extrinsics(torch.from_numpy(rot_np).to(dev), torch.from_numpy(t_np).to(dev))
    reg_card = register_depth_to_color(depth4[0], intr, intr, extr_d)
    reg_cpu = register_depth_to_color(depth4[0].cpu(), intr, intr,
                                      Extrinsics(torch.from_numpy(rot_np), torch.from_numpy(t_np)))
    reg_same = torch.equal(reg_card.cpu(), reg_cpu)
    reg_gates = golden.registration_gates(reg_card.cpu().numpy(), golden.load_jax_registration())
    reg_ms = cuda_ms(lambda: register_depth_to_color(depth4[0], intr, intr, extr_d),
                     warmup=2, iters=20)
    print(f"registration 640x480: card output bitwise equal to the CPU's: {reg_same}; "
          + ", ".join(f"{g} {v[0]:g}" for g, v in reg_gates.items())
          + f"; {reg_ms:.4f} ms a call (CUDA events, median of 20) [{smi}]")
    if not reg_same or golden.failures(reg_gates):
        _fail(f"registration: card against CPU {reg_same}, against the JAX package "
              f"{golden.failures(reg_gates)}")
    eval_out["registration"] = {"card_equals_cpu": reg_same, "ms": reg_ms,
                                **{g: v[0] for g, v in reg_gates.items()}}
    print(f"phase 10 (d): {time.perf_counter() - t_phase10:.1f} s")

    # (e) 32 XML frames through the native frame source into run_stream
    # (batch 8), every chunk bitwise against run_stream over the same files
    # read by core/io.py
    if not native.available():
        _fail(f"the native frame source does not build: {native.build_error()}")
    xml_dir = os.path.join(eval_dir, "frames")
    os.makedirs(xml_dir)
    xml_paths = []
    for i, fr in enumerate(frames32):
        xml_paths.append(os.path.join(xml_dir, f"depth_{i:02d}.xml"))
        kio.write_filestorage_xml(xml_paths[-1], {"depth": fr})
    chunks = {"native": [], "io": []}

    def stream_from(src_name, keep):
        if src_name == "native":
            with native.FrameSource(xml_paths, width=w, height=h, capacity=8) as src:
                st = streaming.run_stream(native.iter_frames(src, len(xml_paths)), color0, intr,
                                          cfg=cfg, batch=8, on_outputs=keep)
                if src.io_errors():
                    _fail(f"the native frame source had {src.io_errors()} IO errors")
        else:
            st = streaming.run_stream(
                (kio.read_filestorage_xml(p)["depth"] for p in xml_paths), color0, intr,
                cfg=cfg, batch=8, on_outputs=keep)
        torch.cuda.synchronize()
        return st

    st_n = drive("stream.native", lambda: stream_from(
        "native", lambda s0, p: chunks["native"].append((s0, p))), all_kernels)
    st_io = stream_from("io", lambda s0, p: chunks["io"].append((s0, p)))
    same = (len(chunks["native"]) == len(chunks["io"]) == 4
            and all(a[0] == b[0] and torch.equal(a[1], b[1])
                    for a, b in zip(chunks["native"], chunks["io"]))
            and st_n.metric_sums == st_io.metric_sums
            and torch.equal(st_n.buffer.depth, st_io.buffer.depth))
    fps = {}
    for src_name in ("native", "io"):
        t0 = time.perf_counter()
        stream_from(src_name, None)
        fps[src_name] = 32 / (time.perf_counter() - t0)
    print(f"stream from the native frame source: {len(chunks['native'])} chunks of 8, each "
          f"bitwise equal to the core/io.py stream's: {same}; {fps['native']:.2f} frames/s "
          f"(core/io.py reads: {fps['io']:.2f} frames/s) [{smi}]")
    if not same:
        _fail("stream: the native frame source's chunks differ from core/io.py's")
    eval_out["stream_native"] = {"fps": fps["native"], "fps_io": fps["io"]}
    print(f"phase 10 (e): {time.perf_counter() - t_phase10:.1f} s")

    # ROADMAP C1: the cm normals of the main path's B=1 frame (card, and the
    # port's CPU run on the same JBF points) against the JAX package's
    # (kde_jax_640x480_seed0.npz stores them as f16), read alone and in
    # SDC's place against the JAX SDC normals (golden.normal_method_gates'
    # normal-direction bar, |dot| > 0.999 on every 4th row and column)
    want_sdc = golden.load_jax_normals("640x480", "sdc")
    n_card = res1.normals.cpu().numpy()
    n_cpu = normals.generate_normal_map(projective_to_real(res1.jbf_depth, intr).cpu()[None],
                                        cfg.normals)[0].numpy()

    def f16(n):
        return n.astype(np.float16).astype(np.float32)

    def in_sdc_place(n):
        return golden.normal_method_gates("sdc", dict(got_cm, normals=n), want_sdc)[
            "normal_direction_agreement"][0]

    def against_jax_cm(n):
        return golden.kde_gates(dict(got_cm, normals=n), jfull)["normal_direction_agreement"][0]

    c1 = {}
    for tag, n in (("card", n_card), ("cpu", n_cpu), ("card as f16", f16(n_card)),
                   ("cpu as f16", f16(n_cpu)), ("jax (f16)", jfull["normals"])):
        c1[tag] = {"in_sdc_place": in_sdc_place(n), "against_jax_cm": against_jax_cm(n)}
    jn, sn = jfull["normals"][::4, ::4], want_sdc["normals_sub4"]
    both = (jn != -1.0).any(-1) & want_sdc["normal_valid"][::4, ::4]
    jdot = np.abs((jn.astype(np.float64) * sn).sum(-1))[both]
    near = {eps: int((np.abs(jdot - 0.999) < eps).sum()) for eps in (1e-6, 1e-4, 1e-3)}
    equal16 = float((f16(n_card) == jfull["normals"]).all(-1).mean())
    print("C1 cm normals: " + "; ".join(
        f"{tag}: in SDC's place {v['in_sdc_place']:.6f}, against the JAX cm normals "
        f"{v['against_jax_cm']:.6f}" for tag, v in c1.items()))
    print(f"C1: card normals rounded to f16 equal the JAX f16 normals on {equal16:.6f} of "
          f"pixels; the JAX cm-SDC |dot| lies within 1e-6 / 1e-4 / 1e-3 of 0.999 on "
          f"{near[1e-6]} / {near[1e-4]} / {near[1e-3]} of {int(both.sum())} pixels; card "
          f"against CPU normals max |d| {float(np.abs(n_card - n_cpu).max()):.3g}")
    # the card's cm normals read 0.0155 higher in SDC's place than the JAX
    # package's: the fixture stores those as f16, and rounded as they were,
    # the card's normals read as the JAX package's do
    gap16 = abs(c1["card as f16"]["in_sdc_place"] - c1["jax (f16)"]["in_sdc_place"])
    if gap16 > 0.002 or c1["card"]["against_jax_cm"] <= 0.995:
        _fail(f"C1: the card's cm normals rounded to f16 read {gap16:.4g} from the JAX "
              "package's in SDC's place (bar 0.002), or miss the JAX cm normals")
    eval_out["c1"] = {"readings": c1, "near_threshold": near, "f16_equal": equal16}
    print(f"phase 10: {time.perf_counter() - t_phase10:.1f} s")
    print("evaluate paths: " + json.dumps({"out": eval_out, "launches": {
        k: v for k, v in path_counts.items() if k.startswith(("eval.", "stream.native"))}},
        default=float))

    # ---- phase 11: the multi-process layer (parallel/) at 640x480 (runs
    # before phase 9's summary): (a) world size 1 over NCCL in this process,
    # the step compiled; (b) gloo ranks sharing the one card, world 2, 4 and
    # 8; (c) the dryrun (the compiled step); (d) in (b)'s ranks, the
    # compiled step (sharding.sharded_kde_step) against the eager one.
    # One card measures no scaling: every time here is a path's cost
    import socket

    import torch.distributed as dist

    from kinectdepthmapenhancement_tpu_torch.parallel import halo, multihost, sharding
    from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import jbf_sharded

    t_phase11 = time.perf_counter()
    p11_ms: dict = {}
    p11_checks: dict = {}
    p = cfg.jbf
    jbf_ref4 = bilateral.joint_bilateral_filter(depth4, color4, p)
    crop_w = JBF_TILES["w161"][1]
    jbf_ref_crop = bilateral.joint_bilateral_filter(
        depth4[:, :, :crop_w].contiguous(), color4[:, :, :crop_w].contiguous(), p)

    # (a) world 1 over NCCL: initialize from torch's env names (the world
    # size passed: a world size of 1 read from the environment is the
    # single-process case), the data-parallel step on the four frames
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0")
    if not multihost.initialize(world_size=1):
        _fail("phase 11 (a): initialize took the single-process case")
    try:
        if dist.get_backend() != "nccl":
            _fail(f"phase 11 (a): backend {dist.get_backend()}, not nccl")
        mesh = multihost.global_mesh()
        gd = multihost.local_batch_to_global(mesh, list(depth4))
        gc = multihost.local_batch_to_global(mesh, list(color4), extra_dims=1)
        if (gd.size, gd.offset, gd.local.device) != (4, 0, mesh.device):
            _fail(f"phase 11 (a): global batch {gd.size} at {gd.offset} on {gd.local.device}")
        # the compiled step: its first call's capture (the counts zeroed as
        # the capture begins) launches what the eager step launches, and it
        # and a replay are bitwise phase 4's kde_pipeline at B=4
        step = sharding.sharded_kde_step(mesh, intr, cfg)
        drive("p11.world1 nccl eager step", lambda: step.fn(gd.local, gc.local), all_kernels)
        jit.capture_hooks.append(reset_counts)
        try:
            out1 = drive("p11.world1 nccl step", lambda: step(gd.local, gc.local), all_kernels)
        finally:
            jit.capture_hooks.remove(reset_counts)
        if path_counts["p11.world1 nccl step"] != path_counts["p11.world1 nccl eager step"]:
            _fail("phase 11 (a): the capture launched "
                  f"{path_counts['p11.world1 nccl step']}, the eager step "
                  f"{path_counts['p11.world1 nccl eager step']}")
        replay1 = step(gd.local, gc.local)
        (key1,) = step.info()
        if not (torch.equal(out1, res4.optimized_points)
                and torch.equal(replay1, res4.optimized_points)):
            _fail("phase 11 (a): the compiled data-parallel step differs from kde_pipeline at B=4")
        if (key1["host_steps"], key1["pieces"], jit.stats["host_steps"]) != (0, 1, 0):
            _fail(f"phase 11 (a): the world-1 step holds host steps or pieces: {key1}")
        got1 = {f: getattr(res4, f)[0].cpu().numpy() for f in res4._fields}
        got1["optimized_points"] = out1[0].cpu().numpy()
        gates = golden.kde_gates(got1, golden.load_jax_640x480())
        if golden.failures(gates):
            _fail(f"phase 11 (a): frame 0 against the JAX package: {golden.failures(gates)}")
        z = out1[..., 2].to(torch.float64)
        # the local sum over the local count (a division by a Python number
        # is a multiplication by its reciprocal on the card)
        gmean, lmean = gd.global_mean(z), z.sum() / torch.tensor(float(z.numel()), device=dev,
                                                                 dtype=torch.float64)
        if not torch.equal(gmean, lmean):
            _fail(f"phase 11 (a): global_mean {float(gmean)} against the local {float(lmean)}")
        jbf1 = drive("p11.world1 nccl jbf_sharded",
                     lambda: jbf_sharded(depth4, color4, mesh, p), ("cuda_bilateral",))
        if not torch.equal(jbf1, jbf_ref4) or path_counts["p11.world1 nccl jbf_sharded"][
                "cuda_bilateral"] != 1:
            _fail("phase 11 (a): jbf_sharded at world 1 differs from the unsharded JBF")
        p11_checks["world1 nccl"] = {
            "step bitwise": True, "jax gates": {k: v[0] for k, v in gates.items()},
            "global_mean": float(gmean), "jbf_sharded bitwise": True}
        p11_ms["world1 nccl step B=4"] = cuda_ms(lambda: step(gd.local, gc.local),
                                                 warmup=1, iters=5)
        p11_ms["world1 nccl eager step B=4"] = cuda_ms(lambda: step.fn(gd.local, gc.local),
                                                       warmup=1, iters=5)
        p11_checks["world1 nccl"]["compiled"] = {
            k: key1[k] for k in ("warmup_ms", "capture_ms", "pool_bytes", "pieces", "host_steps")}
        del step, out1, replay1
        jit.clear()
        p11_ms["bare kde_pipeline B=4"] = cuda_ms(lambda: kde_pipeline(depth4, color4, intr, cfg),
                                                  warmup=1, iters=5)
        p11_ms["exchange_width nccl x1 (colour halo 4, B=1)"] = cuda_ms(
            lambda: halo.exchange_width(color4[:1], 4, mesh), warmup=2, iters=5)
        p11_ms["jbf_sharded nccl x1 B=1"] = cuda_ms(
            lambda: jbf_sharded(depth4[:1], color4[:1], mesh, p), warmup=2, iters=5)
    finally:
        dist.destroy_process_group()
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
            os.environ.pop(var)
    p11_ms["unsharded joint_bilateral_filter B=1"] = cuda_ms(
        lambda: bilateral.joint_bilateral_filter(depth4[:1], color4[:1], p), warmup=2, iters=5)
    print(f"phase 11 (a): {time.perf_counter() - t_phase11:.1f} s")

    # (b) gloo ranks sharing the card (rank r on card r modulo the count):
    # the JBF on width tiles at x = 2 and 4 (and 157-px tiles of the 628-column
    # crop), the spatial step (data 1 x x 2) and the data-parallel step
    # (data 2 x x 1); each path's launches by rank, its output gathered on
    # rank 0 and held bitwise against the unsharded run on the card; the
    # tiled route on the 640x480, Kinect v2 and 628-column frames at x = 2
    # and 4 and at x = 8 (eight ranks: data tiles that split cells)
    depth_np, color_np = depth4.cpu().numpy(), color4.cpu().numpy()
    v2_np = (vdepth4.cpu().numpy(), vcolor4.cpu().numpy())
    # phase 10's far-range frame with 15% holes and three more seeds: the
    # frames of the plane merge and hole fill configs
    banded = [make_banded_scene(h, w, intr, seed=s, hole_fraction=0.15) for s in range(4)]
    banded_np = (np.stack([b_[1] for b_ in banded]), np.stack([b_[0] for b_ in banded]))
    p11_configs: dict = {}
    # the ranks share the card with this process: hand them its cached
    # memory (phase 10's graphs and batches left tens of GiB reserved)
    jit.clear()
    torch.cuda.empty_cache()
    print(f"phase 11 (b): this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
          "reserved on the card", flush=True)
    for n in (2, 4, 8):
        ranks = multihost.spawn(_phase11_rank, n,
                                args=(depth_np, color_np, crop_w, banded_np, v2_np),
                                device="cuda", backend="gloo", timeout_s=600)
        for r in ranks:
            for tag, cnt in r["counts"].items():
                key = f"p11.{tag} rank{r['rank']}"
                path_counts[key] = cnt
                path_forms[key] = r["forms"][tag]
                if cnt["cuda_bilateral"] != 1:
                    _fail(f"phase 11 (b): {key} launched the JBF {cnt['cuda_bilateral']} times")
                form = r["expect"][tag]
                jbf_forms = {f for f in r["forms"][tag] if f.startswith("jbf:")}
                if form and jbf_forms != {form}:
                    _fail(f"phase 11 (b): {key} launched the JBF on {jbf_forms}, not {form}")
                # the steps run 640x480 frames: the cell-local route
                if "step" in tag and any(v == 0 for k, v in cnt.items()
                                         if k not in CELL_ROUTE_IDLE):
                    _fail(f"phase 11 (b): {key}: a kernel of the path was never launched: {cnt}")
        for tag, (shape, got) in ranks[0]["out"].items():
            want = (res4.optimized_points if "step" in tag
                    else jbf_ref_crop if got.shape[2] == crop_w else jbf_ref4)
            if not torch.equal(got.to(dev), want):
                _fail(f"phase 11 (b): {tag} (blocks {shape}) differs from the unsharded run")
            p11_checks[f"gloo {tag}"] = {"block": shape, "bitwise": True}
        p11_ms.update({f"{k} (rank 0)": v for k, v in ranks[0]["ms"].items()})
        # the tiled route: routes, bitwise fields, launches and forms by rank
        for r in ranks:
            td = r["tiled"]
            off = {k: v for k, v in td["routes"].items() if v != "tiled"}
            if off:
                _fail(f"phase 11 (b): spatial_route at x = {n} reads {off}, not tiled")
            for tag, run in td["runs"].items():
                name = tag.split()[0]
                key = f"p11.tiled x{n} {tag} rank{r['rank']}"
                path_counts[key] = run["counts"]
                path_forms[key] = run["forms"]
                if run["route"] != "tiled" or not run["tables_equal_on_ranks"]:
                    _fail(f"phase 11 (b): {key}: route {run['route']}, cluster tables equal "
                          f"on the ranks: {run['tables_equal_on_ranks']}")
                if run.get("differs"):
                    _fail(f"phase 11 (b): {key}: {run['differs']} differ from kde_pipeline")
                idle, forms, collectives = TILED_CASE_PATHS[name]
                cnt = run["counts"]
                wrong = [k for k, v in cnt.items() if (v > 0) == (k in idle)]
                missing = [f for f in forms if not run["forms"].get(f)]
                if wrong or missing:
                    _fail(f"phase 11 (b): {key}: kernels launched against the path {wrong} "
                          f"({cnt}), tile forms missing {missing}")
                # the JBF, DT and covariance launched on the expected widths alone
                widths = sorted(f for f in run["forms"]
                                if f.startswith(("jbf:", "chamfer_dt:", "cm_covariance:")))
                if widths != run["expect_widths"]:
                    _fail(f"phase 11 (b): {key}: the stencil kernels launched on {widths}, "
                          f"not {run['expect_widths']}")
                if run["collectives"] != collectives:
                    _fail(f"phase 11 (b): {key}: {run['collectives']} collectives a step, "
                          f"not {collectives}")
                p11_checks[f"gloo {key}"] = {
                    "route": run["route"], "block": run["block"], "bitwise": True,
                    "collectives": run["collectives"], "launches": cnt}
            # the replicated route, asked for by name, on every case at B=4
            if sorted(td["replicated"]) != sorted(f"{c} B=4" for c in td["routes"]):
                _fail(f"phase 11 (b): x = {n}: the replicated route ran on "
                      f"{sorted(td['replicated'])}, not on every case")
            for tag, rep in td["replicated"].items():
                key = f"p11.replicated x{n} {tag} rank{r['rank']}"
                if rep["route"] != "replicated" or not rep["tables_equal_on_ranks"]:
                    _fail(f"phase 11 (b): {key}: route {rep['route']}, cluster tables equal "
                          f"on the ranks: {rep['tables_equal_on_ranks']}")
                if rep.get("differs"):
                    _fail(f"phase 11 (b): {key}: {rep['differs']} differ from kde_pipeline")
                p11_checks[f"gloo {key}"] = {"route": rep["route"], "bitwise": True}
        for r in ranks:
            td = r["tiled"]
            print(f"phase 11 (b) tiled x{n} rank {r['rank']} on {smi}: tiles (x0, width) "
                  + json.dumps(td["spans"]) + "; collectives a step "
                  + json.dumps({t: run["collectives"] for t, run in td["runs"].items()})
                  + "; peak device memory MiB (peak, above the inputs) "
                  + json.dumps(td["memory_mib"]) + "; device ms by stage (torch.profiler, "
                  "one call; ranks share the card) " + json.dumps(td["stage_ms"])
                  + "; ms (CUDA events, median of 5) " + json.dumps(td["ms"]))
            p11_ms.update({f"tiled x{n} rank{r['rank']} {k}": v for k, v in td["ms"].items()})
        # the other configs on the tiled route: route, bitwise fields, the
        # fill across tile edges, launches on the tile forms, collectives
        for r in ranks:
            if "configs" not in r:
                continue
            cd = r["configs"]
            off = {k: v for k, v in cd["routes"].items() if v != "tiled"}
            if off:
                _fail(f"phase 11 (b): spatial_route at x = {n} reads {off}, not tiled")
            for tag, run in cd["runs"].items():
                name = tag.split()[0]
                key = f"p11.cfg x{n} {tag} rank{r['rank']}"
                path_counts[key] = run["counts"]
                path_forms[key] = run["forms"]
                if run["route"] != "tiled" or not run["tables_equal_on_ranks"]:
                    _fail(f"phase 11 (b): {key}: route {run['route']}, cluster tables equal "
                          f"on the ranks: {run['tables_equal_on_ranks']}")
                if run.get("differs"):
                    _fail(f"phase 11 (b): {key}: {run['differs']} differ from kde_pipeline")
                if "filled" in run and not (run["filled"] > 0
                                            and run["filled_near_tile_edges"] > 0):
                    _fail(f"phase 11 (b): {key}: {run['filled']} pixels filled, "
                          f"{run['filled_near_tile_edges']} within the fill's reach of an "
                          "inner tile edge")
                idle, forms = CONFIG_PATHS[name]
                cnt = run["counts"]
                wrong = [k for k, v in cnt.items() if (v > 0) == (k in idle)]
                missing = [f for f in forms if not run["forms"].get(f)]
                if wrong or missing:
                    _fail(f"phase 11 (b): {key}: kernels launched against the path {wrong} "
                          f"({cnt}), tile forms missing {missing}")
                p11_checks[f"gloo {key}"] = {
                    "route": run["route"], "block": run["block"], "bitwise": True,
                    "collectives": run["collectives"], "launches": cnt,
                    **{k: run[k] for k in ("filled", "filled_near_tile_edges") if k in run}}
            p11_configs[f"x{n} rank{r['rank']}"] = {
                "collectives": {t: run["collectives"] for t, run in cd["runs"].items()},
                "memory_mib": cd["memory_mib"], "ms": cd["ms"]}
            p11_ms.update({f"cfg x{n} rank{r['rank']} {k}": v for k, v in cd["ms"].items()})
        for tag, v in p11_configs.items():
            if tag.startswith(f"x{n} "):
                print(f"phase 11 (b) configs {tag} on {smi}: collectives a step "
                      + json.dumps(v["collectives"]) + "; peak device memory MiB (peak, above "
                      "the inputs), tiled and replicated, B=4 " + json.dumps(v["memory_mib"])
                      + "; ms (CUDA events, median of 5) " + json.dumps(v["ms"]))
        print(f"phase 11 (b) world {n} on {[r['device'] for r in ranks]}: "
              f"{time.perf_counter() - t_phase11:.1f} s")
        # (d) the compiled step: bits, host steps and branches, launches,
        # times and pools by rank
        for r in ranks:
            for tag, run in r["compiled"].items():
                key = f"p11.compiled x{n} {tag} rank{r['rank']}"
                path_counts[key] = run["capture_counts"]
                want_steps, want_branches = COMPILED_CASE_STEPS[tag]
                wrong = []
                if not run["bitwise"] or run["aliased"] or run.get("gathered_bitwise") is False:
                    wrong.append(f"bits: bitwise {run['bitwise']}, aliased {run['aliased']}, "
                                 f"gathered {run.get('gathered_bitwise')}")
                if run["collectives"] != want_steps or run["host_steps"] != [want_steps] * 2:
                    wrong.append(f"{run['collectives']} collectives eager, host steps a replay "
                                 f"{run['host_steps']}, not {want_steps}")
                # a capture records both branches of each host branch: the
                # label index's untaken global branches add their label
                # counts and label sums, exactly those, and nothing else may
                # differ
                want_forms = UNTAKEN_GLOBAL_INDEX_FORMS if want_branches else {}
                extra = {k: v - run["eager_counts"][k]
                         for k, v in run["capture_counts"].items() if v != run["eager_counts"][k]}
                extra_forms = {
                    f: run["capture_forms"].get(f, 0) - run["eager_forms"].get(f, 0)
                    for f in set(run["capture_forms"]) | set(run["eager_forms"])
                    if f.startswith(INDEX_KERNELS)}
                extra_forms = {f: v for f, v in extra_forms.items() if v}
                want_extra = {k: sum(v for f, v in want_forms.items() if f.startswith(k + ":"))
                              for k in INDEX_KERNELS}
                if extra != {k: v for k, v in want_extra.items() if v} or extra_forms != want_forms:
                    wrong.append(f"the capture launched {run['capture_counts']} (label-count "
                                 f"forms beyond the eager step {extra_forms}, want {want_forms}), "
                                 f"the eager step {run['eager_counts']}")
                if any(run["replay_counts"].values()):
                    wrong.append(f"a replay launched from Python: {run['replay_counts']}")
                taken = run["host_taken"]
                if (run["host_branches"] != want_branches or run["conds"]
                        or any(t != [taken[0][0], 0] or not t[0] for t in taken)):
                    wrong.append(f"{run['host_branches']} host branches taken {taken}, "
                                 f"{run['conds']} conds; want {want_branches} taken IF alone")
                prof = run.get("profile")
                eager_nz = {k: v for k, v in run["eager_counts"].items() if v}
                if prof and prof["launches"] != eager_nz:
                    wrong.append(f"a profiled replay launched {prof['launches']}, the eager "
                                 f"step {eager_nz}")
                if wrong:
                    _fail(f"phase 11 (d): {key}: " + "; ".join(wrong))
                p11_checks[f"gloo {key}"] = {
                    "bitwise": True, "route": run["route"], "host_steps": run["host_steps"],
                    "host_branches": taken, "launches": run["capture_counts"]}
                p11_ms[f"compiled x{n} rank{r['rank']} {tag} eager"] = run["eager_ms"]
                p11_ms[f"compiled x{n} rank{r['rank']} {tag} replay"] = run["replay_ms"]
                if r["rank"] == 0:
                    print(f"phase 11 (d) x{n} {tag}: profiled replay on rank 0: " + (
                        "no device activity in the trace (CUPTI beside the other ranks)"
                        if not prof else
                        f"{prof['activities']} device activities, kernels {prof['launches']} "
                        f"(as the eager step), busy {prof['busy_ms']:.3f} ms of "
                        f"{prof['span_ms']:.3f} ms"))
            print(f"phase 11 (d) compiled step x{n} rank {r['rank']} on {smi}: " + "; ".join(
                f"{tag}: replays bitwise the eager step, eager {run['eager_ms']:.3f} ms, replay "
                f"{run['replay_ms']:.3f} ms (CUDA events, median of 5), warm-up "
                f"{run['warmup_ms']:.1f} ms, capture {run['capture_ms']:.1f} ms, pool "
                f"{run['pool_mib']:.1f} MiB, {run['pieces']} pieces, {run['host_steps'][0]} "
                f"host steps a replay ({run['collectives']} collectives eager), "
                f"{run['host_branches']} host branches taken {run['host_taken']}"
                for tag, run in r["compiled"].items()))
        print(f"phase 11 (d) world {n}: {time.perf_counter() - t_phase11:.1f} s")

    # (c) the dryrun: one rank over NCCL, four gloo ranks sharing the card
    for n, backend in ((1, None), (4, "gloo")):
        t0 = time.perf_counter()
        dry = sharding.dryrun(n, backend=backend)
        p11_ms[f"dryrun({n}) {backend or 'nccl'} wall"] = (time.perf_counter() - t0) * 1e3
        # the compiled step's two calls launch the JBF twice from Python on
        # each rank: in its warm-up and its capture (the replay, none)
        if "parity=ok" not in dry["line"] or dry["jbf_launches"] != [2] * n:
            _fail(f"phase 11 (c): dryrun({n}): {dry}")
        p11_checks[f"dryrun({n})"] = dry
    print(f"phase 11: {time.perf_counter() - t_phase11:.1f} s")
    print(f"phase 11 times on {smi} (ms; CUDA events, median of 5; dryrun wall clock; one "
          "card shared by every rank: not a scaling number): " + json.dumps(p11_ms))
    print("parallel paths: " + json.dumps({"checks": p11_checks, "launches": {
        k: v for k, v in path_counts.items() if k.startswith("p11.")}}, default=str))

    # ---- phase 12: the compiled call (core/jit.py), before phase 9's summary,
    # in a process of its own: once this process had built and destroyed
    # graphs with conditional nodes (phases 8 and 10), the profiler named
    # the kernels of a later replay wrongly (ones in a conditional body
    # under another kernel's name), though the replay was bitwise the eager
    # call
    jit.clear()
    torch.cuda.empty_cache()
    print(f"phase 12 in a process of its own; this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card", flush=True)
    p12 = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase12"],
                         timeout=900)
    if p12.returncode != 0:
        _fail(f"phase 12 exited {p12.returncode}")

    # ---- phase 9: summary lines, one JSON entry per TPU kernel; a second
    # form of a kernel (colour-only gradient, analyze-mode sums, the shapes
    # of phase 6's paths) is checked and timed beside its main-path form
    # above, and listed under the row's "forms" with its launches by path
    def form_entry(name, k):
        """A kernel's form: its shape, B=1 / B=4 numbers, and its launches
        per driven path (the wrappers' launch_forms)."""
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
        key = row if is_nasp else mod.__name__.rsplit(".", 1)[-1]
        out.append({
            "name": row, "route": "cuda", "source": mod.SOURCE,
            "replaces": k["replaces"] if "replaces" in k else (
                mod.REPLACES[row] if is_nasp else mod.REPLACES),
            "launches": launches[key],
            # phase 10's paths: each evaluate row (5 calls: one warm-up, 3
            # timed, one scored) and the native-fed stream
            "launches_by_path": {p: c[key] for p, c in path_counts.items()
                                 if p.startswith(("eval.", "stream.native", "p11."))},
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
            **({"b8_merge": label_counts_at_b8} if row == "label_counts" else {}),
            **({"b8": label_sums_at_b8} if row == "label_sums" else {}),
            **({"b8": assign_global_at_b8} if row == "assign_global" else {}),
        })
    print("kde ms per frame: " + "  ".join(
        f"B={bsz} {ms:.3f}" for bsz, ms in frame_ms.items()))
    print(json.dumps({"kernels": out}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
