"""The compiled call: jit(fn), the counterpart of jax.jit as the JAX package
uses it (cli.py:57-95, models/streaming.py:49, utils/timing.py:29,
utils/evaluate.py:134 and :188, core/buffer2d.py:58, parallel/sharding.py:
71-75 and :87-97), cond, the counterpart of lax.cond (ops/slic.py:1451 and
:1467, models/pipelines.py:255), and collective, the counterpart of a
collective inside an XLA program (the halo exchanges and gathers of the
sharded step, parallel/).

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

A collective(fn, *tensors) is a host step: fn moves tensors between
processes (a gloo transfer through host memory, or an NCCL call on the
stream), which no CUDA graph can hold under gloo.  Inside a capture it
ends the current piece of graph (its segments and conditional nodes),
records the step and begins the next piece; a replay runs piece 0, step
0, piece 1, ... on the caller's stream.  A cond whose branches make host
steps is a host branch: each branch's pieces and steps are recorded, and a
replay reads pred on the host (from the host step that made it, when one
did) and runs one branch.  A call with no host step replays as it did
without them.

The kernel wrappers' launch counters count in Python, so they count the
warm-up and the capture, not the replays: a profiled replay shows the
kernels by name.  `stats` counts captures, replays and host steps run;
`keys()` gives each key's capture ms, pool bytes, segments, conds, pieces,
host steps and host branches.
"""

from __future__ import annotations

import ctypes
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.utils._pytree as pytree
from torch.utils.weak import WeakIdKeyDictionary

from kinectdepthmapenhancement_tpu_torch import _build

# captures, replays and host steps run since the last clear() (chip_smoke.py
# prints them)
stats = {"captures": 0, "replays": 0, "host_steps": 0}

_mode: Optional[str] = None  # None (eager), "warmup" or "capture"
_active: Optional["_Capture"] = None  # the call warming up or capturing
_jitted: "weakref.WeakSet[_Jitted]" = weakref.WeakSet()
_streams: Dict[int, torch.cuda.Stream] = {}  # the side stream, by device index
# called as each capture begins, after its warm-up (chip_smoke.py zeroes the
# kernels' launch counters there, so that they count the capture alone)
capture_hooks: List[Callable[[], None]] = []
# a host step's one-element bool outputs that fn returned on the host, by
# output tensor: the value a cond on that output reads without the card
_host_values = WeakIdKeyDictionary()


def tracing() -> bool:
    """True while a jit call warms up or captures (a cond then routes
    through the call: both branches, or a conditional node)."""
    return _mode is not None


def _read(pred: torch.Tensor) -> bool:
    """pred on the host: the value its host step kept, else a read."""
    value = _host_values.get(pred)
    return bool(pred) if value is None else value


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    """lax.cond: true_fn(*operands) where pred (a bool tensor of one
    element) holds, false_fn(*operands) otherwise.  Both return the same
    structure of tensors of the same shapes and dtypes (a pytree).  Eager:
    pred read on the host.  Warming up: both run (with their host steps,
    the true branch's first, on every process alike), pred's branch is
    returned.  Capturing: a conditional node, or a host branch where a
    branch makes a host step (see the module text)."""
    if _mode == "capture":
        return _active.cond(pred, true_fn, false_fn, operands)
    if _mode == "warmup":
        a, b = true_fn(*operands), false_fn(*operands)
        return a if _read(pred) else b
    return true_fn(*operands) if _read(pred) else false_fn(*operands)


def _run_step(fn: Callable, tensors: Sequence[torch.Tensor]):
    """fn(*tensors) as a host step: (its outputs as fn returned them, the
    host value of each one-element bool output fn returned on the CPU,
    else None)."""
    res = list(fn(*tensors))
    if not all(isinstance(r, torch.Tensor) for r in res):
        raise TypeError("jit.collective: fn must return a list or tuple of tensors")
    host = [r.item() if r.device.type == "cpu" and r.numel() == 1 and r.dtype == torch.bool
            else None for r in res]
    stats["host_steps"] += 1
    return res, host


def _specs(tensors) -> list:
    return [(tuple(t.shape), t.dtype) for t in tensors]


def collective(fn: Callable, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """A host step: fn(*tensors) -> a list or tuple of tensors, on the card
    or on the host; returns them as a list on the device of tensors[0] (the
    step copies back what fn returned on the host).  fn may read its inputs
    on the host and talk to other processes; every process of its group
    makes the same host steps in the same order.  Outside a jit call, and
    warming up, it runs fn (the warm-up records its outputs' shapes and
    dtypes).  Capturing, it runs no collective: it ends the piece, returns
    static buffers of the warm-up's shapes, and a replay runs fn on the
    inputs the capture saw and copies its outputs into those buffers on
    the caller's stream.  A one-element bool output fn returned on the host
    keeps its host value: a cond on it reads that, not the card."""
    if not tensors:
        raise ValueError("jit.collective: a host step takes at least one tensor (its device)")
    if _mode == "capture":
        return _active.collective(fn, tensors)
    res, host = _run_step(fn, tensors)
    dev = tensors[0].device
    outs = [r if r.device == dev else r.to(dev) for r in res]
    for out, value in zip(outs, host):
        if value is not None:
            _host_values[out] = value
    if _mode == "warmup":
        _active.step_specs.append((_specs(tensors), _specs(outs)))
    return outs


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


class _Piece:
    """The graph between two host steps: its segments and the conds
    between them (conditional nodes), replayed as one torch CUDAGraph or,
    with conds, as csrc/graph.cu's joined graph."""

    def __init__(self):
        self.segments: List[torch.cuda.CUDAGraph] = []
        self.conds: List[tuple] = []  # (pred, IF body, ELSE body)
        self.exec = None
        self.taken = None  # [conds, 2] i32 on the device: [IF, ELSE] taken

    def instantiate(self, dev) -> None:
        if not self.conds:
            self.segments[0].instantiate()
            return
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

    def run(self, dev) -> None:
        if self.exec is None:
            self.segments[0].replay()
        else:
            code = _build.function("kde_graph_launch", [_build.PTR, _build.PTR])(
                self.exec, torch.cuda.current_stream(dev).cuda_stream)
            _build.check_status("kde_graph_launch", code)


class _HostStep:
    """A recorded collective: fn, the inputs the capture saw and the static
    outputs, all held for the graph's life (the pool hands none of their
    memory to a later segment)."""

    def __init__(self, fn, inputs, outs):
        self.fn, self.inputs, self.outs = fn, inputs, outs
        self.host: list = [None] * len(outs)

    def run(self, dev) -> None:
        res, self.host = _run_step(self.fn, self.inputs)
        if _specs(res) != _specs(self.outs):
            raise RuntimeError(f"jit: a host step returned {_specs(res)} at replay, "
                               f"{_specs(self.outs)} when captured")
        for buf, r in zip(self.outs, res):
            buf.copy_(r)


class _HostBranch:
    """A recorded cond whose branches make host steps: pred (held), the
    host step output it is (step, index) or None, and each branch's
    pieces and steps."""

    def __init__(self, pred, source, if_items, else_items):
        self.pred, self.source = pred, source
        self.items = (if_items, else_items)
        self.taken = [0, 0]  # [IF, ELSE] taken

    def run(self, dev) -> None:
        take = None
        if self.source is not None:
            step, i = self.source
            take = step.host[i]
        if take is None:
            take = bool(self.pred)
        self.taken[0 if take else 1] += 1
        for item in self.items[0 if take else 1]:
            item.run(dev)


def _walk(items) -> list:
    """Every item of a recorded program, the branches' included."""
    out = []
    for item in items:
        out.append(item)
        if isinstance(item, _HostBranch):
            out += _walk(item.items[0]) + _walk(item.items[1])
    return out


class _Capture:
    """One call's warm-up and capture in progress: the host steps' shapes
    the warm-up saw, and the recorded program (pieces, host steps, host
    branches, in order) on one stream and one memory pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.step_specs: List[tuple] = []  # (inputs, outputs) of each host step
        self.items: list = []  # the program being recorded (the call's or a branch's)
        self.piece = _Piece()  # the open piece
        self.steps: List[_HostStep] = []
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
            # a segment that ends where a cond or a host step begins may
            # hold no node
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            g.capture_end()

    def begin_segment(self) -> None:
        self.piece.segments.append(self.begin())

    def close_piece(self) -> None:
        """End the open segment and append the open piece to the program."""
        self.end()
        self.items.append(self.piece)
        self.piece = _Piece()

    def abort(self) -> None:
        """End a capture left open by an exception (its error is the one
        that raises)."""
        if self._open is not None:
            try:
                self.end()
            except Exception:
                pass

    def collective(self, fn, tensors):
        i = len(self.steps)
        if i >= len(self.step_specs) or self.step_specs[i][0] != _specs(tensors):
            raise RuntimeError(f"jit.collective: host step {i} of the capture with inputs "
                               f"{_specs(tensors)} is not the warm-up's")
        self.close_piece()
        dev = tensors[0].device
        outs = [torch.empty(shape, dtype=dtype, device=dev)
                for shape, dtype in self.step_specs[i][1]]
        step = _HostStep(fn, list(tensors), outs)
        self.steps.append(step)
        self.items.append(step)
        self.begin_segment()
        return list(outs)

    def _body(self, run, into):
        """Capture one branch into a program of its own: (the program, its
        outputs' leaves and structure).  The IF branch's outputs are clones
        (into=None); the ELSE branch copies its own into them."""
        self.items, self.piece = [], _Piece()
        self.begin_segment()
        leaves, spec = pytree.tree_flatten(run())
        if into is None:
            if not all(isinstance(x, torch.Tensor) for x in leaves):
                raise TypeError("jit.cond: a branch must return tensors only")
            # the outputs live in the IF body's allocations, which the ELSE
            # body overwrites: no tensor from before the cond is written
            outs = [x.clone() for x in leaves]
        else:
            outs, spec_a = into
            if spec != spec_a or any(
                    not isinstance(b, torch.Tensor) or b.shape != a.shape or b.dtype != a.dtype
                    for a, b in zip(outs, leaves)):
                raise TypeError("jit.cond: the branches return different structures, shapes "
                                "or dtypes")
            for a, b in zip(outs, leaves):
                a.copy_(b)
        del leaves
        self.close_piece()
        return self.items, outs, spec

    def cond(self, pred, true_fn, false_fn, operands):
        if pred.device.type != "cuda" or pred.numel() != 1:
            raise ValueError(f"jit.cond: pred must be one element on the card, got "
                             f"{tuple(pred.shape)} on {pred.device}")
        if self._in_body:
            raise NotImplementedError("jit.cond: a cond inside a cond's branch")
        source = next(((s, i) for s in self.steps for i, o in enumerate(s.outs) if o is pred),
                      None)
        pred = pred.reshape(()).to(torch.bool).contiguous()
        self.end()
        items, piece = self.items, self.piece
        self._in_body = True
        try:
            if_items, outs, spec = self._body(lambda: true_fn(*operands), None)
            else_items, _, _ = self._body(lambda: false_fn(*operands), (outs, spec))
        finally:
            self._in_body = False
            self.items, self.piece = items, piece
        bodies = (if_items, else_items)
        if all(len(b) == 1 and len(b[0].segments) == 1 for b in bodies):
            self.piece.conds.append((pred, if_items[0].segments[0], else_items[0].segments[0]))
        else:  # a branch made a host step
            self.items.append(self.piece)
            self.piece = _Piece()
            self.items.append(_HostBranch(pred, source, if_items, else_items))
        self.begin_segment()
        return pytree.tree_unflatten(outs, spec)


class _Graph:
    """One key's captured call: static inputs, static outputs, and the
    program that replays it: its pieces of graph (each a torch CUDAGraph,
    or the joined graph of csrc/graph.cu where it holds conds), with the
    host steps and host branches between them."""

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
            _mode, _active = "warmup", cap
            try:
                fn(*args, **kwargs)
                stream.synchronize()
                t1 = time.perf_counter()
                reserved = torch.cuda.memory_reserved(dev)
                for hook in capture_hooks:
                    hook()
                _mode = "capture"
                cap.begin_segment()
                out = fn(*args, **kwargs)
                cap.close_piece()
            except BaseException:
                cap.abort()
                raise
            finally:
                _mode, _active = None, None
        torch.cuda.current_stream(dev).wait_stream(stream)
        if len(cap.steps) != len(cap.step_specs):
            raise RuntimeError(f"jit: the warm-up made {len(cap.step_specs)} host steps, the "
                               f"capture {len(cap.steps)}")
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.out_leaves, self.out_spec = pytree.tree_flatten(out)
        self.items = cap.items
        walked = _walk(self.items)
        self.pieces = [x for x in walked if isinstance(x, _Piece)]
        self.steps = [x for x in walked if isinstance(x, _HostStep)]
        self.branches = [x for x in walked if isinstance(x, _HostBranch)]
        for piece in self.pieces:
            piece.instantiate(dev)
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        stats["captures"] += 1

    def __call__(self, leaves):
        for i, buf in zip(self.slots, self.inputs):
            buf.copy_(leaves[i])
        for item in self.items:
            item.run(self.dev)
        stats["replays"] += 1
        out = [x.clone() if isinstance(x, torch.Tensor) else x for x in self.out_leaves]
        return pytree.tree_unflatten(out, self.out_spec)

    def info(self) -> dict:
        """Warm-up ms, capture ms (host clock, the joins and instantiation
        included), pool bytes (the device memory the capture reserved),
        segments, conds (conditional nodes) and each one's branches taken
        [IF, ELSE] so far (read on the host), pieces of graph, host steps
        (both branches' of a host branch counted) and host branches with
        their branches taken [IF, ELSE]."""
        taken = [t for p in self.pieces if p.conds for t in p.taken.tolist()]
        return {"warmup_ms": self.warmup_ms, "capture_ms": self.capture_ms,
                "pool_bytes": self.pool_bytes,
                "segments": sum(len(p.segments) for p in self.pieces),
                "conds": sum(len(p.conds) for p in self.pieces), "taken": taken,
                "pieces": len(self.pieces), "host_steps": len(self.steps),
                "host_branches": len(self.branches),
                "host_taken": [list(b.taken) for b in self.branches]}


def _destroy_exec(exec_handle) -> None:
    _build.check_status("kde_graph_destroy", _build.function(
        "kde_graph_destroy", [_build.PTR])(exec_handle))


class _Jitted:
    """jit(fn): its calls, by key (key_of).  `prologue`, when given, runs
    on every call's arguments before it, eager or replayed: static checks
    and bookkeeping on the host that read no tensor's data."""

    def __init__(self, fn: Callable, prologue: Optional[Callable] = None):
        self.fn = fn
        self.prologue = prologue
        self.cache: Dict[tuple, _Graph] = {}
        self.__name__ = getattr(fn, "__name__", "jitted")

    def __call__(self, *args, **kwargs):
        if self.prologue is not None:
            self.prologue(*args, **kwargs)
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


def jit(fn: Callable, prologue: Optional[Callable] = None) -> Callable:
    """fn as a compiled call (see the module text); prologue as _Jitted's."""
    j = _Jitted(fn, prologue)
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
    stats.update(captures=0, replays=0, host_steps=0)
