"""Build the port's CUDA kernels from csrc/ and load them with ctypes.

At first use every csrc/*.cu is compiled by its own nvcc process, all
started together, for sm_90a with -O3 and -fmad=false (no fast math: the
kernels are held bitwise against their plain PyTorch versions), then
linked into one shared library with a plain C interface.  The library is
cached under build/kernels/ at the repository root, keyed by a digest of
the sources and flags, so a rebuild happens only when a source changes.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + [
    "-O3", "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None  # the loaded library (built once per process)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: List[Path], out: Path) -> Dict[str, List[str]]:
    """Build `out`; returns each source's ptxas resource lines."""
    nvcc = _nvcc()
    # per-process scratch names: concurrent first uses build side by side
    # and the last os.replace wins with identical bytes
    work = BUILD_DIR / f"{out.stem}.work.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = work / (src.stem + ".o")
        log = (work / (src.stem + ".log")).open("w")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    ptxas = {}
    for src, _, log, proc in procs:
        rc = proc.wait()
        log.close()
        text = (work / (src.stem + ".log")).read_text()
        ptxas[src.name] = [ln for ln in text.splitlines() if "ptxas info" in ln]
        if rc != 0:
            failed.append(f"--- {src.name} (rc {rc})\n{text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = work / out.name
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return ptxas


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if nvcc fails).
    `load().build_info` records the path, whether this call compiled it, the
    seconds taken and the ptxas lines."""
    global _lib
    if _lib is not None:
        return _lib
    sources = _sources()
    out = BUILD_DIR / f"libkde_kernels_{_digest(sources)}.so"
    t0 = time.perf_counter()
    ptxas: Dict[str, List[str]] = {}
    built = not out.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ptxas = _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    lib.kde_error_string.argtypes = [ctypes.c_int]
    lib.kde_error_string.restype = ctypes.c_char_p
    lib.build_info = dict(
        path=str(out), built=built, seconds=time.perf_counter() - t0, ptxas=ptxas
    )
    _lib = lib
    return lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the kernel library with its signature declared."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_status(name: str, code: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        text = load().kde_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({text})")


def check_tensor(t, what: str, dtype, shape) -> None:
    """A kernel argument must be a contiguous CUDA tensor of this dtype and
    shape; raise otherwise (a kernel takes no other layout)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
