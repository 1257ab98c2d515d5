"""Tile, block-shape and unroll variants of the covariance, chamfer-DT, JBF
and seed-gradient kernels, timed on the card.

    python -m kinectdepthmapenhancement_tpu_torch.utils.kernel_variants [KERNEL ...]

KERNEL is any of cov, dt, jbf, seed_gradient (all four when none is named).
Rewrites the tile and unroll constants of csrc/<KERNEL>.cu (their
`constexpr int NAME = N;` and `#pragma unroll N` lines) in copies under
build/variants/, builds each copy with the library's nvcc flags (one nvcc per
variant, all started together), holds its output bitwise against the plain
version at the 640x480 KDE path's shapes, B=1 and B=4 (the DT on the path's
dci and on the lattice dci of chip_smoke.py, 26 rounds; the JBF at the
default JBFParams; the gradient in both forms on the 270x360 seed
sub-grid), and prints one line a variant: ptxas registers and device ms
(utils/timing.device_ms), and for the JBF and the gradient the issued
instructions a tap (`tap_instructions`, from cuobjdump -sass).  The first
variant of each kernel is the committed source.  Exits non-zero without a
card or if a variant disagrees.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path
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
JBF_VARIANTS: Dict[str, Dict[str, int]] = {
    f"jbf_{tx}x{ty}_p{p}_mb{mb}_c{c}": {
        "TX": tx, "TY": ty, "P": p, "MIN_BLOCKS": mb, "CACHE_MAX_R": c}
    for tx, ty, p, mb, c in (
        (32, 8, 1, 6, 3),  # committed
        (32, 8, 1, 1, 3), (32, 8, 1, 7, 3),
        (32, 8, 1, 6, 1),  # R = 2 recomputes pass 1's weights
        (32, 16, 1, 3, 3), (16, 8, 1, 12, 3), (32, 4, 1, 12, 3), (32, 8, 2, 1, 3),
    )
}
GRAD_VARIANTS: Dict[str, Dict[str, int]] = {
    f"grad_{tx}x{ty}_p{p}": {"TX": tx, "TY": ty, "P": p}
    for tx, ty, p in (
        (24, 16, 1),  # committed
        (32, 8, 1), (32, 8, 2), (16, 16, 1), (24, 8, 1), (24, 32, 1), (40, 8, 1),
        (40, 16, 1), (24, 12, 1), (24, 8, 2),
    )
}
# source file (csrc/<name>.cu) -> its variants
VARIANTS: Dict[str, Dict[str, Dict[str, int]]] = {
    "cov": COV_VARIANTS, "dt": DT_VARIANTS, "jbf": JBF_VARIANTS,
    "seed_gradient": GRAD_VARIANTS,
}
# the instantiation on the path, by a part of its mangled name, and its taps
# a pixel: the JBF at R = 2 with both sigma gates on (2 passes of 25 taps
# counted as 25 two-pass taps), the gradient in each form (121 taps)
TAP_KERNELS = {
    "jbf": ("jbf_kernelILi2ELb1ELb1EEEv", 25),
    "seed_gradient_nasp": ("grad_kernelILb1EEEv", 121),
    "seed_gradient_color": ("grad_kernelILb0EEEv", 121),
}


def fast_path_instructions(sass: str, name: str) -> int:
    """Instructions of the first function in cuobjdump -sass text `sass`
    whose mangled name holds `name` that run on its fast path: from its
    block barrier (the tile staged) to the first unconditional EXIT after
    it, both counted, less each block that a predicated branch jumps over
    and that holds a CALL (the calls to the slow paths of IEEE division and
    sqrt)."""
    instrs, state = [], "seek"  # seek the function, then its barrier, then collect
    for line in sass.splitlines():
        if "Function :" in line:
            if state == "collect":
                break
            state = "barrier" if name in line else "seek"
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*)", line)
        if m is None or state == "seek":
            continue
        text = m.group(2).strip()
        if state == "barrier" and "BAR.SYNC" in text:
            state = "collect"
        if state == "collect":
            instrs.append((int(m.group(1), 16), text))
            if re.match(r"EXIT\b", text):
                break
    if not instrs or not re.match(r"EXIT\b", instrs[-1][1]):
        raise RuntimeError(f"fast_path_instructions: no barrier-to-EXIT path of {name}")
    skipped = set()
    for i, (_, text) in enumerate(instrs):
        m = re.match(r"@!?P\d+\s+BRA\s+0x([0-9a-f]+)", text)
        if m is None:
            continue
        target = int(m.group(1), 16)
        block = [k for k in range(i + 1, len(instrs)) if instrs[k][0] < target]
        if any(instrs[k][1].startswith("CALL") for k in block):
            skipped.update(block)
    return len(instrs) - len(skipped)


def tap_instructions(lib: str, kernel: str) -> float:
    """Issued instructions a tap of one of TAP_KERNELS in the library `lib`
    on its fast path (fast_path_instructions of its cuobjdump -sass) divided
    by its taps a pixel; the per-pixel epilogue is included, a few
    instructions a tap at most."""
    name, taps = TAP_KERNELS[kernel]
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    return fast_path_instructions(sass, name) / taps


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
    """Build each variant into its own library; returns its ptxas registers
    (for the JBF and the gradient, of the instantiations TAP_KERNELS names,
    with their spill stores)."""
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
        kernel = variants[name][0]
        if kernel in ("cov", "dt"):
            regs[name] = "/".join(re.findall(r"Used (\d+) registers", out))
        else:
            regs[name] = "/".join(
                entry_resources(out, entry)
                for tap, (entry, _) in TAP_KERNELS.items() if tap.startswith(kernel))
    return regs


def entry_resources(ptxas: str, entry: str) -> str:
    """"<registers>r <spill stores>s" of the first kernel whose mangled name
    holds `entry`, from nvcc's -Xptxas -v output."""
    regs = spill = "?"
    inside = False
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            if inside:
                break
            inside = entry in line
        elif inside:
            m = re.search(r"(\d+) bytes spill stores", line)
            spill = m.group(1) if m else spill
            m = re.search(r"Used (\d+) registers", line)
            regs = m.group(1) if m else regs
    return f"{regs}r{spill}s"


def path_inputs(dev) -> Dict[str, torch.Tensor]:
    """The covariance's, DT's, JBF's and gradient's inputs on the 640x480 KDE
    path, B=4, as chip_smoke.py forms them, and the lattice dci."""
    from kinectdepthmapenhancement_tpu_torch.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.ops import bilateral, cuda_bilateral, normals, slic

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
    points = projective_to_real(jbf_depth, intr)
    vm = (points / 1000.0).contiguous()
    nmap = normals.generate_normal_map(points, cfg.normals)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    lattice = torch.where((yy % 48 == 24) & (xx % 48 == 24), 0, 255).to(torch.int32)
    return dict(
        vm=vm,
        rect=normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous(),
        dci=normals.dci_map(vm, cfg.normals.max_depth_change_factor).contiguous(),
        lattice=lattice.expand(4, h, w).contiguous(),
        depth=depth.contiguous(), guide=guide,
        csub=slic._subgrid_extract(color.to(torch.float32), cfg.grid, h, w, 8).contiguous(),
        nsub=slic._subgrid_extract(nmap, cfg.grid, h, w, 8).contiguous(),
    )


def measure(name: str) -> Tuple[str, bool]:
    """One built variant held against the plain version and timed, at B=1
    and B=4: (its line, whether every output was bitwise equal)."""
    from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu_torch.ops import (
        cuda_bilateral, cuda_cov, cuda_dt, cuda_gradient,
    )
    from kinectdepthmapenhancement_tpu_torch.utils.timing import device_ms

    kernel = next(k for k, vs in VARIANTS.items() if name in vs)
    dev = torch.device("cuda", 0)
    x = path_inputs(dev)
    its = 26
    p = KDEConfig().jbf
    jbf_kw = dict(window=p.window, spatial_sigma=p.spatial_sigma, color_sigma=p.color_sigma,
                  depth_sigma=p.depth_sigma)
    table = cuda_bilateral.spatial_table(p.window, p.spatial_sigma, dev)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h, w = x["dci"].shape[1:]
    gh, gw = x["csub"].shape[1:3]
    want = {}
    for b in (1, 4):
        if kernel == "cov":
            want["cov", b] = cuda_cov.cm_covariances_plain(x["vm"][:b], x["rect"][:b])
        elif kernel == "dt":
            for tag in ("dci", "lattice"):
                want[tag, b] = cuda_dt.distance_transform_plain(x[tag][:b], its)
        elif kernel == "jbf":
            want["jbf", b] = cuda_bilateral.jbf_plain(x["depth"][:b], x["guide"][:b], **jbf_kw)
        else:
            want["nasp", b] = cuda_gradient.seed_gradient_plain(x["csub"][:b], x["nsub"][:b])
            want["color", b] = cuda_gradient.seed_gradient_plain(x["csub"][:b])
    OUT = object()  # the output pointer's place in a launch's arguments
    lib_path = str(VARIANT_DIR / f"{name}.so")
    lib = ctypes.CDLL(lib_path)

    def cases(b, stream):
        """[(tag, launch, outputs, wanted outputs)] of the variant at batch b."""
        if kernel == "cov":
            fn = lib.kde_cov
            fn.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
            cnt = torch.empty((b, h, w), device=dev)
            cov = torch.empty((b, h, w, 6), device=dev)
            args = (x["vm"].data_ptr(), x["rect"].data_ptr(), cnt.data_ptr(),
                    cov.data_ptr(), b, h, w, stream)
            return [("", lambda: fn(*args), lambda: (cnt, cov), want["cov", b])]
        if kernel == "dt":
            fn = lib.kde_dt
            fn.argtypes = [ptr, i32, ptr] + [i32] * 4 + [ptr]
            runs = {tag: (x[tag].data_ptr(), 1, OUT, b, h, w, its, stream)
                    for tag in ("dci", "lattice")}
            shape = (b, h, w)
        elif kernel == "jbf":
            fn = lib.kde_jbf
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [f32] * 2 + [i32] * 2 + [ptr]
            runs = {"jbf": (x["depth"].data_ptr(), x["guide"].data_ptr(), table, OUT, b, h, w,
                            p.window // 2, 2.0 * p.color_sigma**2, 2.0 * p.depth_sigma**2, 1, 1,
                            stream)}
            shape = (b, h, w)
        else:
            fn = lib.kde_seed_gradient
            fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            runs = {tag: (x["csub"].data_ptr(), x["nsub"].data_ptr() if tag == "nasp" else None,
                          OUT, b, gh, gw, int(tag == "nasp"), stream)
                    for tag in ("nasp", "color")}
            shape = (b, gh, gw)
        result = []
        for tag, args in runs.items():
            out = torch.empty(shape, device=dev)
            slot = next(i for i, a in enumerate(args) if a is OUT)
            args = args[:slot] + (out.data_ptr(),) + args[slot + 1:]
            result.append((f"{tag} ", lambda a=args: fn(*a), lambda o=out: (o,),
                           (want[tag, b],)))
        return result

    ok_all = True
    cols: List[str] = []
    for b in (1, 4):
        for tag, run, got, ref in cases(b, torch.cuda.current_stream().cuda_stream):
            if run() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            ok = all(torch.equal(g, r) for g, r in zip(got(), ref))
            ok_all &= ok
            cols.append(f"{tag}B={b} {'bitwise' if ok else 'DIFFERS'} "
                        f"{device_ms(run)[0]:.4f} ms")
    cols += [f"{t} {tap_instructions(lib_path, t):.1f}/tap"
             for t in TAP_KERNELS if t.startswith(kernel)]
    return "  ".join(cols), ok_all


def main(argv: List[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:  # one built variant, in a process of its own
        line, ok = measure(argv[1])
        print(line)
        return 0 if ok else 1
    kernels = argv or list(VARIANTS)
    unknown = [k for k in kernels if k not in VARIANTS]
    if unknown:
        print(f"kernel_variants: unknown kernels {unknown}; choose from {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    variants = {n: (k, v) for k in kernels for n, v in VARIANTS[k].items()}
    regs = build(variants)
    bad = []
    for name in variants:
        # each variant in a fresh process: with many variant libraries
        # loaded in one, the profiler drops device records from its traces
        res = subprocess.run(
            [sys.executable, "-m", "kinectdepthmapenhancement_tpu_torch.utils.kernel_variants",
             "--one", name], capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            bad.append(name)
        line = res.stdout.strip() or (res.stderr.strip().splitlines() or ["no output"])[-1]
        print(f"{name:28s} regs {regs[name]:12s} {line}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    if bad:
        print(f"kernel_variants: FAILED: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
