"""The compiled call: jit(fn), the counterpart of jax.jit as the JAX package
uses it (cli.py:57-95, models/streaming.py:49, utils/timing.py:29,
utils/evaluate.py:134 and :188, core/buffer2d.py:58), and cond, the
counterpart of lax.cond (ops/slic.py:1451 and :1467, models/pipelines.py:255).

jit(fn) returns a callable.  On CUDA tensors a call is keyed on fn, its
static arguments (every argument leaf that is not a tensor: KDEConfig and
the other frozen dataclasses, Intrinsics' floats, Python scalars) and the
tensors' shapes, dtypes, strides and device.  The first call of a key
warms fn up on a side stream (every cond running both of its branches,
so every kernel form and library handle the graph holds exists before
the capture), then captures it on that stream into CUDA graphs that share
one memory pool, with static input buffers; every call, the first
included, copies its inputs into those buffers, replays, and returns
clones of the outputs, which no later replay overwrites.  A capture that
fails raises: fn never runs eagerly in the graph's place.  On CPU
tensors a call is fn's own: the CPU has no graphs, and the caller asked
for the CPU.

A cond(pred, true_fn, false_fn, *operands) outside a capture reads pred on
the host and runs one branch.  Inside one it ends the capture's current
segment, captures true_fn into one body and false_fn into another (which
copies its outputs into the first body's), and begins the next segment;
csrc/graph.cu joins the segments and bodies into one graph in which each
cond is a conditional node (IF with an ELSE body), set from pred on the
device by a one-thread kernel that also counts the branch taken.  A call
with no cond replays its one segment as a torch.cuda.CUDAGraph.

The kernel wrappers' launch counters count in Python, so they count the
warm-up and the capture, not the replays: a profiled replay shows the
kernels by name.  `stats` counts captures and replays; `keys()` gives
each key's capture ms, pool bytes, segments and conds.
"""

from __future__ import annotations

import ctypes
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from kinectdepthmapenhancement_tpu_torch import _build

# captures and replays since the last clear() (chip_smoke.py prints them)
stats = {"captures": 0, "replays": 0}

_mode: Optional[str] = None  # None (eager), "warmup" or "capture"
_active: Optional["_Capture"] = None  # the capture in progress
_jitted: "weakref.WeakSet[_Jitted]" = weakref.WeakSet()
_streams: Dict[int, torch.cuda.Stream] = {}  # the side stream, by device index


def tracing() -> bool:
    """True while a jit call warms up or captures (a cond then routes
    through the call: both branches, or a conditional node)."""
    return _mode is not None


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    """lax.cond: true_fn(*operands) where pred (a bool tensor of one
    element) holds, false_fn(*operands) otherwise.  Both return the same
    structure of tensors of the same shapes and dtypes (a pytree).  Eager:
    pred read on the host.  Warming up: both run, pred's branch is
    returned.  Capturing: a conditional node (see the module text)."""
    if _mode == "capture":
        return _active.cond(pred, true_fn, false_fn, operands)
    if _mode == "warmup":
        a, b = true_fn(*operands), false_fn(*operands)
        return a if bool(pred) else b
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def _tensor_key(t: torch.Tensor) -> tuple:
    return ("tensor", tuple(t.shape), t.dtype, t.stride(), t.device)


def key_of(fn: Callable, args: tuple, kwargs: dict) -> tuple:
    """The cache key of fn(*args, **kwargs): fn, the arguments' structure,
    each tensor leaf's shape, dtype, strides and device, every other leaf
    by value (it must be hashable), and the grad / inference modes."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    parts = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append(_tensor_key(leaf))
        else:
            try:
                hash(leaf)
            except TypeError:
                raise TypeError(f"jit: a static argument must be hashable, got {type(leaf)}")
            parts.append(("static", type(leaf), leaf))
    return (fn, str(spec), tuple(parts), torch.is_grad_enabled(),
            torch.is_inference_mode_enabled())


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _streams.get(dev.index)
    if s is None:
        s = _streams[dev.index] = torch.cuda.Stream(dev)
    return s


class _Capture:
    """One call's capture in progress: its segments and conds, in order, on
    one stream and one memory pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: List[torch.cuda.CUDAGraph] = []
        self.conds: List[tuple] = []  # (pred, IF body, ELSE body)
        self._open: Optional[torch.cuda.CUDAGraph] = None
        self._in_body = False

    def begin(self) -> torch.cuda.CUDAGraph:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = g
        return g

    def end(self) -> None:
        g, self._open = self._open, None
        with warnings.catch_warnings():
            # a segment that ends where a cond begins may hold no node
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            g.capture_end()

    def begin_segment(self) -> None:
        self.segments.append(self.begin())

    def abort(self) -> None:
        """End a capture left open by an exception (its error is the one
        that raises)."""
        if self._open is not None:
            try:
                self.end()
            except Exception:
                pass

    def cond(self, pred, true_fn, false_fn, operands):
        if pred.device.type != "cuda" or pred.numel() != 1:
            raise ValueError(f"jit.cond: pred must be one element on the card, got "
                             f"{tuple(pred.shape)} on {pred.device}")
        if self._in_body:
            raise NotImplementedError("jit.cond: a cond inside a cond's branch")
        pred = pred.reshape(()).to(torch.bool).contiguous()
        self.end()
        self._in_body = True
        g_if = self.begin()
        leaves_a, spec_a = pytree.tree_flatten(true_fn(*operands))
        if not all(isinstance(x, torch.Tensor) for x in leaves_a):
            raise TypeError("jit.cond: a branch must return tensors only")
        # the outputs live in the IF body's allocations, which the ELSE body
        # overwrites: no tensor from before the cond is written
        outs = [x.clone() for x in leaves_a]
        del leaves_a
        self.end()
        g_else = self.begin()
        leaves_b, spec_b = pytree.tree_flatten(false_fn(*operands))
        if spec_b != spec_a or any(
                not isinstance(b, torch.Tensor) or b.shape != a.shape or b.dtype != a.dtype
                for a, b in zip(outs, leaves_b)):
            raise TypeError("jit.cond: the branches return different structures, shapes "
                            "or dtypes")
        for a, b in zip(outs, leaves_b):
            a.copy_(b)
        del leaves_b
        self.end()
        self._in_body = False
        self.conds.append((pred, g_if, g_else))
        self.begin_segment()
        return pytree.tree_unflatten(outs, spec_a)


class _Graph:
    """One key's captured call: static inputs, static outputs, and the
    graph that replays it (a torch CUDAGraph, or the joined graph of
    csrc/graph.cu when the call holds conds)."""

    def __init__(self, fn, leaves, spec, dev):
        global _mode, _active
        self.dev = dev
        self.slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        self.inputs = [torch.empty_like(leaves[i]) for i in self.slots]
        static = list(leaves)
        for i, buf in zip(self.slots, self.inputs):
            buf.copy_(leaves[i])
            static[i] = buf
        args, kwargs = pytree.tree_unflatten(static, spec)
        stream = _side_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        cap = _Capture()
        with torch.cuda.stream(stream):
            _mode = "warmup"
            try:
                fn(*args, **kwargs)
                stream.synchronize()
                t1 = time.perf_counter()
                reserved = torch.cuda.memory_reserved(dev)
                _mode, _active = "capture", cap
                cap.begin_segment()
                out = fn(*args, **kwargs)
                cap.end()
            except BaseException:
                cap.abort()
                raise
            finally:
                _mode, _active = None, None
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.out_leaves, self.out_spec = pytree.tree_flatten(out)
        self.segments = cap.segments
        self.conds = cap.conds
        self.exec = None
        if not self.conds:
            self.segments[0].instantiate()
        else:
            self.taken = torch.zeros((len(self.conds), 2), dtype=torch.int32, device=dev)
            n = len(self.segments)
            arr = ctypes.c_void_p * n
            exec_out = ctypes.c_void_p()
            fn_c = _build.function("kde_graph_assemble", [_build.INT] + [_build.PTR] * 6)
            code = fn_c(
                n, arr(*(g.raw_cuda_graph() for g in self.segments)),
                arr(*(c[1].raw_cuda_graph() for c in self.conds), 0),
                arr(*(c[2].raw_cuda_graph() for c in self.conds), 0),
                arr(*(c[0].data_ptr() for c in self.conds), 0),
                arr(*(self.taken[i].data_ptr() for i in range(len(self.conds))), 0),
                ctypes.byref(exec_out))
            _build.check_status("kde_graph_assemble", code)
            self.exec = exec_out.value
            weakref.finalize(self, _destroy_exec, self.exec).atexit = False
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        stats["captures"] += 1

    def __call__(self, leaves):
        for i, buf in zip(self.slots, self.inputs):
            buf.copy_(leaves[i])
        if self.exec is None:
            self.segments[0].replay()
        else:
            code = _build.function("kde_graph_launch", [_build.PTR, _build.PTR])(
                self.exec, torch.cuda.current_stream(self.dev).cuda_stream)
            _build.check_status("kde_graph_launch", code)
        stats["replays"] += 1
        out = [x.clone() if isinstance(x, torch.Tensor) else x for x in self.out_leaves]
        return pytree.tree_unflatten(out, self.out_spec)

    def info(self) -> dict:
        """Warm-up ms, capture ms (host clock, the join and instantiation
        included), pool bytes (the device memory the capture reserved),
        segments, conds and each cond's branches taken [IF, ELSE] so far
        (read on the host)."""
        taken = self.taken.tolist() if self.conds else []
        return {"warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
                "pool_bytes": self.pool_bytes,
                "segments": len(self.segments), "conds": len(self.conds), "taken": taken}


def _destroy_exec(exec_handle) -> None:
    _build.check_status("kde_graph_destroy", _build.function(
        "kde_graph_destroy", [_build.PTR])(exec_handle))


class _Jitted:
    """jit(fn): its calls, by key (key_of)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.cache: Dict[tuple, _Graph] = {}
        self.__name__ = getattr(fn, "__name__", "jitted")

    def __call__(self, *args, **kwargs):
        if tracing():  # inside another jit's call: part of its graph
            return self.fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        if not devices or devices == {torch.device("cpu")}:
            return self.fn(*args, **kwargs)
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"jit: the tensors of a call lie on {sorted(map(str, devices))}; "
                             "one CUDA device or the CPU")
        key = key_of(self.fn, args, kwargs)
        graph = self.cache.get(key)
        if graph is None:
            graph = self.cache[key] = _Graph(self.fn, leaves, spec, next(iter(devices)))
        return graph(leaves)


    def info(self) -> List[dict]:
        """Every captured key's _Graph.info()."""
        return [g.info() for g in self.cache.values()]


def jit(fn: Callable) -> Callable:
    """fn as a compiled call (see the module text)."""
    j = _Jitted(fn)
    _jitted.add(j)
    return j


def keys() -> List[dict]:
    """Every live key's info() with its function's name."""
    return [dict(fn=j.__name__, **info) for j in list(_jitted) for info in j.info()]


def clear() -> None:
    """Drop every captured call (their graphs and memory pools) once the
    card has finished every replay, and zero the counters."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for j in list(_jitted):
        j.cache.clear()
    stats.update(captures=0, replays=0)
