"""Tile and unroll variants of the covariance and chamfer-DT kernels, timed
on the card.

    python -m kinectdepthmapenhancement_tpu_torch.utils.kernel_variants

Rewrites the tile and unroll constants of csrc/cov.cu and csrc/dt.cu (their
`constexpr int NAME = N;` and `#pragma unroll N` lines) in copies under
build/variants/, builds each copy with the library's nvcc flags (one nvcc per
variant, all started together), holds its output bitwise against the plain
version at the 640x480 KDE path's shapes, B=1 and B=4 (the DT on the path's
dci and on the lattice dci of chip_smoke.py, 26 rounds), and prints one line
a variant: ptxas registers and device ms (utils/timing.device_ms).  The
first variant of each kernel is the committed source.  Exits non-zero
without a card or if a variant disagrees.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch import _build

VARIANT_DIR = _build.BUILD_DIR.parent / "variants"

# name -> (kernel, {constant: value}); "UNROLL" is the #pragma unroll count
COV_VARIANTS: Dict[str, Dict[str, int]] = {
    f"cov_ty{ty}_u{u}": {"TY": ty, "UNROLL": u}
    for ty in (8, 4, 16) for u in (4, 1, 2, 8)
}
DT_VARIANTS: Dict[str, Dict[str, int]] = {
    f"dt_{tw}x{th}_bx{bx}_by{by}_u{u}": {"TW": tw, "TH": th, "BX": bx, "BY": by, "UNROLL": u}
    for tw, th, bx, by, u in (
        (64, 32, 32, 16, 4),  # committed
        (64, 32, 32, 16, 1), (64, 32, 32, 16, 2),
        (64, 32, 32, 8, 4), (64, 32, 64, 8, 4), (64, 32, 32, 32, 4),
        (32, 32, 32, 16, 4), (32, 64, 32, 16, 4), (64, 64, 32, 16, 4),
        (64, 64, 32, 32, 4), (64, 64, 64, 16, 4), (128, 32, 32, 16, 4),
    )
}


def variant_source(text: str, values: Dict[str, int]) -> str:
    """`text` with each named constant (and UNROLL, the one #pragma unroll)
    set to its value; raises if a name does not occur exactly once."""
    for name, value in values.items():
        pat = r"#pragma unroll \d+" if name == "UNROLL" else rf"constexpr int {name} = \d+;"
        rep = f"#pragma unroll {value}" if name == "UNROLL" else f"constexpr int {name} = {value};"
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise ValueError(f"{name}: {n} matches in the source, expected 1")
    return text


def build(variants: Dict[str, Tuple[str, Dict[str, int]]]) -> Dict[str, str]:
    """Build each variant into its own library; returns its ptxas registers."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (kernel, values) in variants.items():
        src = VARIANT_DIR / f"{name}.cu"
        src.write_text(variant_source((_build.CSRC / f"{kernel}.cu").read_text(), values))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(VARIANT_DIR / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    regs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        regs[name] = "/".join(re.findall(r"Used (\d+) registers", out))
    return regs


def path_inputs(dev) -> Dict[str, torch.Tensor]:
    """The covariance's and DT's inputs on the 640x480 KDE path, B=4, as
    chip_smoke.py forms them, and the lattice dci."""
    from kinectdepthmapenhancement_tpu_torch.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.ops import bilateral, cuda_bilateral, normals

    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    cfg = KDEConfig()
    scenes = [make_noisy_scene(h, w, intr, seed=s) for s in range(4)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    p = cfg.jbf
    guide = bilateral.guide_bilateral(color, p).to(torch.float32).contiguous()
    jbf_depth = cuda_bilateral.jbf_plain(
        depth, guide, window=p.window, spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma, depth_sigma=p.depth_sigma,
    )
    vm = (projective_to_real(jbf_depth, intr) / 1000.0).contiguous()
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    lattice = torch.where((yy % 48 == 24) & (xx % 48 == 24), 0, 255).to(torch.int32)
    return dict(
        vm=vm,
        rect=normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous(),
        dci=normals.dci_map(vm, cfg.normals.max_depth_change_factor).contiguous(),
        lattice=lattice.expand(4, h, w).contiguous(),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from kinectdepthmapenhancement_tpu_torch.ops import cuda_cov, cuda_dt
    from kinectdepthmapenhancement_tpu_torch.utils.timing import device_ms

    variants = {n: ("cov", v) for n, v in COV_VARIANTS.items()}
    variants.update({n: ("dt", v) for n, v in DT_VARIANTS.items()})
    regs = build(variants)
    dev = torch.device("cuda", 0)
    x = path_inputs(dev)
    its = 26
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    h, w = x["dci"].shape[1:]
    want = {}
    for b in (1, 4):
        want["cov", b] = cuda_cov.cm_covariances_plain(x["vm"][:b], x["rect"][:b])
        for tag in ("dci", "lattice"):
            want[tag, b] = cuda_dt.distance_transform_plain(x[tag][:b], its)

    bad = []
    for name, (kernel, _) in variants.items():
        lib = ctypes.CDLL(str(VARIANT_DIR / f"{name}.so"))
        cols: List[str] = []
        for b in (1, 4):
            stream = torch.cuda.current_stream().cuda_stream
            if kernel == "cov":
                fn = lib.kde_cov
                fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
                cnt = torch.empty((b, h, w), device=dev)
                cov = torch.empty((b, h, w, 6), device=dev)
                args = (x["vm"].data_ptr(), x["rect"].data_ptr(), cnt.data_ptr(),
                        cov.data_ptr(), b, h, w, stream)
                cases = [("", lambda: fn(*args), lambda: (cnt, cov), want["cov", b])]
            else:
                fn = lib.kde_dt
                fn.argtypes = [ptr, i32, ptr] + [i32] * 4 + [ptr]
                cases = []
                for tag in ("dci", "lattice"):
                    out = torch.empty((b, h, w), device=dev)
                    args = (x[tag].data_ptr(), 1, out.data_ptr(), b, h, w, its, stream)
                    cases.append((f"{tag} ", lambda a=args: fn(*a), lambda o=out: (o,),
                                  (want[tag, b],)))
            for tag, run, got, ref in cases:
                if run() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                ok = all(torch.equal(g, r) for g, r in zip(got(), ref))
                if not ok:
                    bad.append(f"{name} {tag}B={b}")
                cols.append(f"{tag}B={b} {'bitwise' if ok else 'DIFFERS'} "
                            f"{device_ms(run)[0]:.4f} ms")
        print(f"{name:28s} regs {regs[name]:6s} " + "  ".join(cols), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    if bad:
        print(f"kernel_variants: FAILED: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
