#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. refuse to run without CUDA; print the card's name and power limit
     (nvidia-smi), torch and CUDA versions;
  2. build the kernels from kinectdepthmapenhancement_tpu_torch/csrc
     (one nvcc per source, in parallel) and print the build time and
     ptxas register / shared-memory use;
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of the 640x480 KDE path, B=1 and B=4, to its bar (JBF max |d|
     <= 1e-3 mm; chamfer DT, covariance sweep and seed gradient bitwise,
     the seeds identical); time both with CUDA events;
  4. drive kde_pipeline at 640x480 (B=1, then B=4) from
     make_noisy_scene(480, 640); check finite outputs, that every kernel
     counter went up, and identical labels on a second run; print the
     median ms per frame;
  5. run kde_pipeline at 96x128 (grid 3x4) and hold it against the golden
     oracle fixtures tests/golden/kde_oracle_96x128_seed0{,_refexact}.npz
     with the thresholds of tests/test_oracle_pipeline.py;
  6. print the kernels JSON line, then {"ok": true, "device": ...} last.

Kernels are built under build/kernels/ (listed in .gitignore).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu_torch.ops import (
        bilateral, cuda_bilateral, cuda_cov, cuda_dt, cuda_gradient, normals, slic,
    )
    from kinectdepthmapenhancement_tpu_torch.utils import golden
    from kinectdepthmapenhancement_tpu_torch.utils.timing import cuda_ms

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
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")

    # ---- phase 2: build
    info = _build.load().build_info
    print(f"build: {info['seconds']:.2f} s, compiled {info['built']} ({info['path']})")
    for src, lines in info["ptxas"].items():
        for ln in lines:
            print(f"  {src}: {ln.strip()}")

    # ---- inputs at the 640x480 KDE path's shapes, B=1 and B=4
    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    cfg = KDEConfig()
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
        points = projective_to_real(jbf_depth, intr)
        vm = (points / 1000.0).contiguous()
        dci = normals.dci_map(vm, cfg.normals.max_depth_change_factor).contiguous()
        rect = normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous()
        nmap = normals.generate_normal_map(points, cfg.normals)
        color_f = color.to(torch.float32)
        csub = slic._subgrid_extract(color_f, cfg.grid, h, w, 8).contiguous()
        nsub = slic._subgrid_extract(nmap, cfg.grid, h, w, 8).contiguous()
        return dict(depth=depth.contiguous(), guide=guide, dci=dci, vm=vm, rect=rect,
                    csub=csub, nsub=nsub)

    # ---- phase 3: each kernel against its plain version on the card
    p = cfg.jbf
    jbf_kw = dict(window=p.window, spatial_sigma=p.spatial_sigma,
                  color_sigma=p.color_sigma, depth_sigma=p.depth_sigma)
    its = cfg.normals.dt_iterations
    kernels = {
        "jbf": dict(
            module=cuda_bilateral, bar="max |d| <= 1e-3 mm",
            run=lambda x: cuda_bilateral.jbf(x["depth"], x["guide"], **jbf_kw),
            plain=lambda x: cuda_bilateral.jbf_plain(x["depth"], x["guide"], **jbf_kw),
            shape=lambda x: tuple(x["depth"].shape)),
        "chamfer_dt": dict(
            module=cuda_dt, bar="bitwise",
            run=lambda x: cuda_dt.distance_transform(x["dci"], its),
            plain=lambda x: cuda_dt.distance_transform_plain(x["dci"], its),
            shape=lambda x: tuple(x["dci"].shape)),
        "cm_covariance": dict(
            module=cuda_cov, bar="count exact, entries bitwise",
            run=lambda x: cuda_cov.cm_covariances(x["vm"], x["rect"]),
            plain=lambda x: cuda_cov.cm_covariances_plain(x["vm"], x["rect"]),
            shape=lambda x: tuple(x["vm"].shape)),
        "seed_gradient_nasp": dict(
            module=cuda_gradient, bar="bitwise, seeds identical",
            run=lambda x: cuda_gradient.seed_gradient(x["csub"], x["nsub"]),
            plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub"], x["nsub"]),
            shape=lambda x: tuple(x["csub"].shape)),
        "seed_gradient_color": dict(
            module=cuda_gradient, bar="bitwise",
            run=lambda x: cuda_gradient.seed_gradient(x["csub"]),
            plain=lambda x: cuda_gradient.seed_gradient_plain(x["csub"]),
            shape=lambda x: tuple(x["csub"].shape)),
    }
    report = {name: {"max_abs_err": 0.0} for name in kernels}
    # one JSON entry per kernel source: the colour-only seed-gradient form is
    # the same kernel as the NASP form, checked on the card beside it
    for bsz in (1, 4):
        x = stage_inputs(depth4[:bsz], color4[:bsz])
        torch.cuda.synchronize()
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
            if name == "jbf":
                ok = err <= 1e-3
            else:
                ok = bitwise
            if name == "seed_gradient_nasp":
                s_got = slic._sample_seeds_subgrid(got[0], cfg.grid, h, w, 8)
                s_want = slic._sample_seeds_subgrid(want[0], cfg.grid, h, w, 8)
                ok = ok and torch.equal(s_got, s_want)
            t_k = cuda_ms(lambda: k["run"](x), warmup=3, iters=20)
            t_p = cuda_ms(lambda: k["plain"](x), warmup=1, iters=5)
            print(f"kernel {name:20s} shape {str(k['shape'](x)):22s} B={bsz} "
                  f"max|d|={err:.3g} bitwise={bitwise} bar: {k['bar']} -> "
                  f"{'ok' if ok else 'FAIL'}  kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
            if not ok:
                _fail(f"kernel {name} disagrees with its plain version at B={bsz}")
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if bsz == 1:
                r["ms"], r["plain_ms"] = t_k, t_p
            r[f"ms_b{bsz}"], r[f"plain_ms_b{bsz}"] = t_k, t_p
        del x

    # ---- phase 4: the main path at 640x480, single-frame and batched
    counted = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)
    for m in counted:
        m.launches = 0
    res1 = kde_pipeline(depth4[0], color4[0], intr, cfg)
    res4 = kde_pipeline(depth4, color4, intr, cfg)
    torch.cuda.synchronize()
    launches = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in counted}
    print(f"main path launches: {launches}")
    if any(n == 0 for n in launches.values()):
        _fail(f"a kernel of the main path was never launched: {launches}")
    k_count = cfg.grid.num_clusters
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
    for f in ("nasp_labels", "merged_labels"):
        if not torch.equal(getattr(again, f), getattr(res4, f)):
            _fail(f"second run gave different {f}")
    same_pts = torch.equal(again.optimized_points, res4.optimized_points)
    print(f"determinism: labels identical on a second run; optimized points bitwise: {same_pts}")
    frame_ms = {}
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        t = cuda_ms(lambda: kde_pipeline(d, c, intr, cfg), warmup=1, iters=5)
        frame_ms[bsz] = t / bsz
        print(f"kde_pipeline 640x480 B={bsz}: {t:.3f} ms per call, "
              f"{frame_ms[bsz]:.3f} ms per frame (median of 5)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory: {peak:.2f} GiB")

    # where the time goes: one profiled call per batch size, device time per
    # kde.* stage scope and per kernel name; busy share against the
    # unprofiled median call time above
    from torch.profiler import ProfilerActivity, profile

    scopes = ("kde.jbf", "kde.normals", "kde.nasp", "kde.ccl_merge", "kde.projection")
    for bsz in (1, 4):
        d, c = depth4[:bsz], color4[:bsz]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kde_pipeline(d, c, intr, cfg)
            torch.cuda.synchronize()
        per = {name: [0.0, 0] for name in scopes + ("unscoped",)}  # device ms, kernels
        by_kernel: dict = {}
        n_kernels = 0
        for ev in prof.events():
            if not ev.kernels:
                continue
            scope = ev  # each kernel counts once, under the launching op's kde.* scope
            while scope is not None and scope.name not in scopes:
                scope = scope.cpu_parent
            for kinfo in ev.kernels:
                n_kernels += 1
                ms = kinfo.duration / 1e3
                by_kernel[kinfo.name] = by_kernel.get(kinfo.name, 0.0) + ms
                acc = per[scope.name if scope is not None else "unscoped"]
                acc[0] += ms
                acc[1] += 1
        busy = sum(by_kernel.values())
        call_ms = frame_ms[bsz] * bsz
        print(f"profile B={bsz}: {n_kernels} kernels, device busy {busy:.3f} ms of a "
              f"{call_ms:.3f} ms call ({100.0 * busy / call_ms:.1f}% busy)")
        for name, (ms, count) in per.items():
            print(f"  {name:16s} device {ms:.3f} ms in {count} kernels")
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  kernel {ms:8.3f} ms  {name[:90]}")

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

    # ---- phase 6: summary lines
    out = []
    for name, k in kernels.items():
        if name == "seed_gradient_color":
            continue
        r = report[name]
        if name == "seed_gradient_nasp":
            r["max_abs_err"] = max(r["max_abs_err"], report["seed_gradient_color"]["max_abs_err"])
        mod = k["module"]
        out.append({
            "name": "seed_gradient" if name == "seed_gradient_nasp" else name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": launches[mod.__name__.rsplit(".", 1)[-1]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "ms_b4": r["ms_b4"], "plain_ms_b4": r["plain_ms_b4"],
        })
    print(f"kde ms per frame: B=1 {frame_ms[1]:.3f}  B=4 {frame_ms[4]:.3f}")
    print(json.dumps({"kernels": out}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
