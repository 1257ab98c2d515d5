"""Telemetry inside the port: host spans, device stage stamps and counters,
on one clock, with no profiler running.  Off by default: enable() turns it
on, disable() off, collect() returns what was recorded and clears it.

Host spans.  span(name, step=None) records its name, its start and end on
time.perf_counter_ns(), its parent span and the step's id (run_stream's
first frame index of the chunk; a span without one takes its parent's).
Spans live in a bounded store allocated once; a span past its capacity is
counted as dropped, never recorded half.  While telemetry is on a span is
also a torch.profiler record_function range, so a profiled stretch holds
the program's spans on the profiler's clock.  Off, span() returns one
shared null context and records nothing.

Device stage stamps.  stage(name, on) names a stage of a pipeline (kde.*,
rgbf.*, spdsp.*, tof.*, stream.fold, jit.graph): always a record_function
range, as in an eager profile; with telemetry on and `on` (a tensor or a
device) on the card, also a one-thread kernel (csrc/stamp.cu, kde_stamp)
at entry and at exit that writes (stage code, entry or exit, %globaltimer)
into a ring on the device at a cursor on the device.  Launched inside a
CUDA graph capture the stamps become kernel nodes of the graph (inside a
conditional body they fire only when its branch is taken); a capture made
with telemetry off holds none.  The ring is read only by collect(): a
stamp that the ring's wrap overwrote is counted as lost, never read as 0.

The clock.  %globaltimer is mapped onto perf_counter_ns by fits: each fit
launches stamps after a synchronize, each bracketed by two host reads, and
keeps the narrowest bracket (the stamp's time lies inside it); one fit is
made when a device's ring is made (or at enable() for a ring that
exists), one at collect(), and the offset is interpolated between them.
The bracket's half-width is reported as the clock's error.

Counters.  count(name, value) records a sample with the step of the
innermost open span (core/jit.py counts each replay's kernels as
"jit.kernels").  count_launch() is the kernel wrappers' launch bookkeeping
(ops/cuda_*.py: `launches`, `launch_forms`), counted in Python and so at a
warm-up and a capture, never at a replay.

One process, one thread: the open spans are a stack of the process.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

SPAN_CAPACITY = 1 << 16   # host spans a collect() can hold
COUNTER_CAPACITY = 1 << 16
RING_CAPACITY = 1 << 16   # stamps a device's ring holds before it wraps
FIT_BRACKETS = 64         # stamps a clock fit launches (the narrowest is kept)

_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int   # index of the parent span in Records.spans, -1 for none
    step: int     # the step's id, -1 for none


class Counter(NamedTuple):
    name: str
    step: int
    value: int
    t_ns: int


class Stamp(NamedTuple):
    stage: str
    exit: bool
    t_ns: int     # on perf_counter_ns, through the device's clock fits
    device: int


class Records(NamedTuple):
    """What collect() returns: spans in the order they opened, counter
    samples, stamps in the order the device ran them (by device), the
    stamps the ring's wrap overwrote, the spans and counter samples past
    their stores' capacity, and the clock's error (ns; nan without
    stamps)."""
    spans: List[Span]
    counters: List[Counter]
    stamps: List[Stamp]
    stamps_lost: int
    spans_dropped: int
    clock_error_ns: float


_on = False
_names: List[str] = []
_name_ids: Dict[str, int] = {}
_span_name = np.zeros(SPAN_CAPACITY, np.int32)
_span_start = np.zeros(SPAN_CAPACITY, np.int64)
_span_end = np.zeros(SPAN_CAPACITY, np.int64)
_span_parent = np.zeros(SPAN_CAPACITY, np.int32)
_span_step = np.zeros(SPAN_CAPACITY, np.int64)
_n_spans = 0
_dropped = 0
_stack: List[Tuple[int, int]] = []  # open spans: (index or -1 when dropped, step)
_counter_rows = np.zeros((COUNTER_CAPACITY, 4), np.int64)  # name, step, value, t
_n_counters = 0
_rings: Dict[int, "_Ring"] = {}
# stage stamps launched since the last collect(), eager or into a capture
stamps_launched = 0


def _name_id(name: str) -> int:
    i = _name_ids.get(name)
    if i is None:
        i = _name_ids[name] = len(_names)
        _names.append(name)
    return i


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn telemetry on (a device's ring is made, and its clock fitted, at
    its first stamp or by prepare()); a ring that exists is fitted again."""
    global _on
    _on = True
    for ring in _rings.values():
        ring.fits = [ring.fit()]


def disable() -> None:
    """Turn telemetry off; what was recorded stays for collect()."""
    global _on
    _on = False


class _Span:
    __slots__ = ("index", "rf")

    def __init__(self, name: str, step: Optional[int]):
        global _n_spans, _dropped
        parent, pstep = _stack[-1] if _stack else (-1, -1)
        step = pstep if step is None else step
        if _n_spans < SPAN_CAPACITY:
            i = self.index = _n_spans
            _n_spans += 1
            _span_name[i] = _name_id(name)
            _span_parent[i] = parent
            _span_step[i] = step
        else:
            self.index = -1
            _dropped += 1
        _stack.append((self.index, step))
        self.rf = record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        if self.index >= 0:
            _span_start[self.index] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            _span_end[self.index] = time.perf_counter_ns()
        _stack.pop()
        self.rf.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None):
    """A host span (see the module text); the shared null context when off."""
    if not _on:
        return _NULL
    return _Span(name, step)


def count(name: str, value: int) -> None:
    """A counter sample, with the innermost open span's step."""
    global _n_counters, _dropped
    if not _on:
        return
    if _n_counters >= COUNTER_CAPACITY:
        _dropped += 1
        return
    _counter_rows[_n_counters] = (_name_id(name), _stack[-1][1] if _stack else -1, value,
                                  time.perf_counter_ns())
    _n_counters += 1


def count_launch(counters: dict, form: str, kernel: Optional[str] = None) -> None:
    """One launch in a kernel wrapper's counters: `counters` is the
    wrapper's module namespace (globals()), whose `launches` is an int, or a
    dict by kernel when `kernel` is given, and whose `launch_forms` counts
    launches by form."""
    if kernel is None:
        counters["launches"] += 1
    else:
        counters["launches"][kernel] += 1
    forms = counters["launch_forms"]
    forms[form] = forms.get(form, 0) + 1


# ------------------------------------------------------------ device stamps


class Fit(NamedTuple):
    """One clock fit: the device time of the narrowest bracket's stamp, the
    offset (device ns - host ns at the bracket's middle) and the bracket's
    half-width (ns)."""
    device_ns: int
    offset_ns: float
    half_ns: float


def best_fit(brackets: Sequence[Tuple[int, int, int]]) -> Fit:
    """The fit of (host before, device, host after) brackets: the
    narrowest one's."""
    a, g, b = min(brackets, key=lambda x: x[2] - x[0])
    if not a <= b:
        raise ValueError("a bracket's host reads are out of order")
    return Fit(g, g - (a + b) / 2.0, (b - a) / 2.0)


def to_host(device_ns: np.ndarray, fits: Sequence[Fit]) -> np.ndarray:
    """Device times on perf_counter_ns: the offset interpolated linearly
    between the first and the last fit (constant with one)."""
    g = np.asarray(device_ns, dtype=np.float64)
    first, last = fits[0], fits[-1]
    if len(fits) == 1 or last.device_ns == first.device_ns:
        off = first.offset_ns
    else:
        frac = (g - first.device_ns) / (last.device_ns - first.device_ns)
        off = first.offset_ns + frac * (last.offset_ns - first.offset_ns)
    return np.rint(g - off).astype(np.int64)


def decode_ring(raw: np.ndarray, cursor: int) -> Tuple[np.ndarray, int]:
    """The stamps a ring holds, in the order they were written: raw is the
    ring [capacity, 3] (sequence, code, device ns) and cursor the stamps
    written.  Returns (rows [n, 3] in sequence order, stamps lost): a slot
    that the wrap overwrote, or whose sequence is not the one expected
    there, is lost."""
    cap = raw.shape[0]
    first = max(0, cursor - cap)
    seq = np.arange(first, cursor, dtype=np.int64)
    rows = raw[seq % cap] if cap else raw[:0]
    ok = rows[:, 0] == seq
    return rows[ok], first + int((~ok).sum())


class _Ring:
    """A device's stamp ring [capacity, 3] i64 and its cursor, its clock
    fits, and a small ring of its own for the fits' stamps."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.buf = torch.zeros((RING_CAPACITY, 3), dtype=torch.int64, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.clock = torch.zeros((FIT_BRACKETS, 3), dtype=torch.int64, device=dev)
        self.clock_cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.fits = [self.fit()]

    def fit(self) -> Fit:
        from kinectdepthmapenhancement_tpu_torch import _build

        fn = _build.function("kde_stamp_launch", [_build.PTR, _build.PTR, _build.INT,
                                                  _build.INT, _build.PTR])
        stream = torch.cuda.current_stream(self.dev)
        args = (self.clock.data_ptr(), self.clock_cursor.data_ptr(), FIT_BRACKETS, 0,
                stream.cuda_stream)
        self.clock_cursor.zero_()
        torch.cuda.synchronize(self.dev)
        hosts = []
        for _ in range(FIT_BRACKETS):
            a = time.perf_counter_ns()
            code = fn(*args)
            stream.synchronize()
            hosts.append((a, time.perf_counter_ns()))
            _build.check_status("kde_stamp_launch", code)
        dev_ns = self.clock[:, 2].tolist()
        return best_fit([(a, g, b) for (a, b), g in zip(hosts, dev_ns)])

    def stamp(self, code: int) -> None:
        from kinectdepthmapenhancement_tpu_torch import _build

        global stamps_launched
        _build.launch("kde_stamp_launch", [_build.PTR, _build.PTR, _build.INT, _build.INT],
                      self.dev, (self.buf.data_ptr(), self.cursor.data_ptr(), RING_CAPACITY,
                                 code))
        stamps_launched += 1


def prepare(dev: torch.device) -> None:
    """Make `dev`'s ring (and fit its clock) if telemetry is on and it has
    none: before a capture, which may not allocate or synchronise."""
    if _on and dev.type == "cuda":
        _ring(dev)


def _ring(dev: torch.device) -> "_Ring":
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ring = _rings.get(index)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("telemetry: a stamp inside a capture on a device without a "
                               "ring (telemetry.prepare(device) before capturing)")
        ring = _rings[index] = _Ring(torch.device("cuda", index))
    return ring


class _Stage:
    __slots__ = ("rf", "ring", "code")

    def __init__(self, name: str, ring: "_Ring"):
        self.rf = record_function(name)
        self.ring = ring
        self.code = 2 * _name_id(name)

    def __enter__(self):
        self.rf.__enter__()
        self.ring.stamp(self.code)
        return self

    def __exit__(self, *exc):
        self.ring.stamp(self.code + 1)
        self.rf.__exit__(*exc)
        return False


def stage(name: str, on=None):
    """A pipeline stage (see the module text): a record_function range, and
    with telemetry on and `on` (a tensor or a torch.device) on the card, a
    stamp at entry and at exit."""
    if _on and on is not None:
        dev = on.device if isinstance(on, torch.Tensor) else on
        if dev.type == "cuda":
            return _Stage(name, _ring(dev))
    return record_function(name)


# ------------------------------------------------------------------ collect


def collect() -> Records:
    """What was recorded since the last collect(), then cleared.  Not
    inside an open span."""
    global _n_spans, _dropped, _n_counters, stamps_launched
    if _stack:
        raise RuntimeError("telemetry.collect() inside an open span")
    n = _n_spans
    spans = [Span(_names[_span_name[i]], int(_span_start[i]), int(_span_end[i]),
                  int(_span_parent[i]), int(_span_step[i])) for i in range(n)]
    counters = [Counter(_names[r[0]], int(r[1]), int(r[2]), int(r[3]))
                for r in _counter_rows[:_n_counters].tolist()]
    stamps: List[Stamp] = []
    lost = 0
    errors = []
    for index, ring in sorted(_rings.items()):
        torch.cuda.synchronize(ring.dev)
        cursor = int(ring.cursor.item())
        rows, gone = decode_ring(ring.buf.cpu().numpy(), cursor)
        lost += gone
        fits = ring.fits + [ring.fit()]
        errors += [f.half_ns for f in fits]
        host = to_host(rows[:, 2], fits)
        stamps += [Stamp(_names[c // 2], bool(c % 2), int(t), index)
                   for c, t in zip(rows[:, 1].tolist(), host.tolist())]
        ring.cursor.zero_()
        ring.fits = fits[-1:]
    rec = Records(spans=spans, counters=counters, stamps=stamps, stamps_lost=lost,
                  spans_dropped=_dropped, clock_error_ns=max(errors) if errors else math.nan)
    _n_spans = 0
    _dropped = 0
    _n_counters = 0
    stamps_launched = 0
    return rec

