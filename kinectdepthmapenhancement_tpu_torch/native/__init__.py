"""ctypes binding of the C++ frame source (framesource.cpp, a copy of the JAX
package's): depth frames (cv::FileStorage XML "depth" nodes or raw f32
.bin files) read round robin by a background thread into a bounded ring,
so the device never waits on file IO.

Host code with a plain C interface (no pybind11).  At first use it is
built with g++ into build/native/ at the repository root (git-ignored),
under a temporary name and moved into place with os.replace, so two
processes building at once never load a half-written library.
`available()` is False when no compiler is present (`build_error()` says
why); the pure-Python readers of core/io.py do the same work.
`iter_frames(src, n)` feeds a FrameSource to models/streaming.py::
run_stream, whose frames are an iterator of NumPy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "framesource.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"
_LIB = BUILD_DIR / "libframesource.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{_LIB.name}.{os.getpid()}.tmp"
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
               str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            _build_error = getattr(e, "stderr", None) or str(e)
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, _LIB)
    lib = ctypes.CDLL(str(_LIB))
    lib.fs_open.restype = ctypes.c_longlong
    lib.fs_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fs_next.restype = ctypes.c_int
    lib.fs_next.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fs_close.restype = ctypes.c_int
    lib.fs_close.argtypes = [ctypes.c_longlong]
    lib.fs_io_errors.restype = ctypes.c_int
    lib.fs_io_errors.argtypes = [ctypes.c_longlong]
    lib.fs_depth_xml_read.restype = ctypes.c_int
    lib.fs_depth_xml_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and _build_error is None:
            _lib = _build()
        return _lib


def available() -> bool:
    return _get() is not None


def build_error() -> Optional[str]:
    _get()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    return lib


def _ptr(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_depth_xml(path: str, name: str, width: int, height: int) -> np.ndarray:
    """One-shot native FileStorage XML matrix read -> f32 [H, W]."""
    lib = _require()
    out = np.empty((height, width), np.float32)
    rc = lib.fs_depth_xml_read(path.encode(), name.encode(), _ptr(out), width, height)
    if rc != 0:
        raise IOError(f"fs_depth_xml_read({path!r}, {name!r}) failed: {rc}")
    return out


class FrameSource:
    """Background-threaded round-robin depth frame streamer."""

    def __init__(self, paths: List[str], width: int, height: int, capacity: int = 4):
        self._lib = _require()
        self.width, self.height = width, height
        self._handle = self._lib.fs_open("\n".join(paths).encode(), width, height, capacity)
        if self._handle < 0:
            raise IOError("fs_open failed (empty path list?)")

    def next(self, timeout_ms: int = 10000) -> np.ndarray:
        out = np.empty((self.height, self.width), np.float32)
        rc = self._lib.fs_next(self._handle, _ptr(out), timeout_ms)
        if rc != 0:
            raise TimeoutError(f"fs_next failed: {rc}")
        return out

    def io_errors(self) -> int:
        return int(self._lib.fs_io_errors(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.fs_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_frames(src: FrameSource, n: int) -> Iterator[np.ndarray]:
    """The next n frames of src, in its round-robin order."""
    for _ in range(n):
        yield src.next()
