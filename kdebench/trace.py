"""The traced run's records: one profiled stretch of whole steps inside
the window, and what its device trace says.

A driver calls `boundary(step)` between steps (a step is a frame for the
sensor, a chunk for the replay), where every step before `step - 1` has
completed.  Once `start_share` of the window has passed, the tracer
synchronises the card, starts torch.profiler (host spans and device
activities) and, `steps` steps later, synchronises and stops it, so the
stretch holds the device work of exactly those steps.  The driver names
what the host does with `span(name)` (torch.profiler.record_function,
nothing when the run is not traced); the stretch itself is the span
"stretch", whose ends on the profiler's clock bound the idle gaps.

A stretch whose trace holds fewer device activities than MIN_SHARE of
the steps' due (the activities a step made in a profiled warm-up, times
the steps) is short of device records: the tracer drops it and profiles
the next stretch, TRIES times in all; a run left with no whole stretch
fails.  Nothing here is read as 0.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

STRETCH = "stretch"
TRIES = 2
MIN_SHARE = 0.9


class Stretch(NamedTuple):
    first_step: int
    steps: int
    window_s: float          # the stretch's length on the profiler's clock
    host_s: float            # the same on the host's clock, synchronised at both ends
    busy_s: float            # union of the device activities' intervals
    activities: int
    device_ops: List[Tuple[str, float]]   # seconds by name, most first
    idle_gaps: List[Tuple[str, float]]    # idle seconds by the host span, most first
    kernel_s: Dict[str, float]            # device seconds by name of each activity


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, merged intervals) of [start, end) intervals."""
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def reduce(events, first_step: int, steps: int, host_s: float, span_names) -> Stretch:
    """A stretch's records from the profiler's raw events
    (prof.profiler.kineto_results.events())."""
    from torch.autograd import DeviceType

    device, spans, stretch = [], [], None
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(), ev.name()))
        elif ev.name() == STRETCH:
            stretch = (ev.start_ns(), ev.end_ns())
        elif ev.name() in span_names:
            spans.append((ev.start_ns(), ev.end_ns(), ev.name()))
    if stretch is None:
        raise RuntimeError("the profiler kept no stretch span")
    lo, hi = stretch
    busy_ns, merged = _union([(max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi])
    by_name: Dict[str, float] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    gaps: Dict[str, float] = {}
    cursor = lo
    for a, b in merged + [(hi, hi)]:
        if a > cursor:
            mid = (a + cursor) / 2
            inside = [s for s in spans if s[0] <= mid < s[1]]
            # spans opened before the profiler started are not in its
            # records: the first span name is the one that holds the stretch
            name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else span_names[0]
            gaps[name] = gaps.get(name, 0.0) + (a - cursor) / 1e9
        cursor = max(cursor, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Stretch(first_step, steps, (hi - lo) / 1e9, host_s, busy_ns / 1e9, len(device),
                   top, sorted(gaps.items(), key=lambda kv: -kv[1])[:10], by_name)


class Tracer:
    def __init__(self, seconds: float, *, start_share: float, steps: int, span_names,
                 sync: Callable[[], None]):
        self.seconds = seconds
        self.start_share = start_share
        self.steps = steps
        self.tries = TRIES  # stretches left to profile
        self.span_names = tuple(span_names)
        self.sync = sync
        self.per_step: Optional[float] = None  # device activities a step, from the warm-up
        self.t_window: Optional[float] = None
        self.stretch: Optional[Stretch] = None
        self.short: List[Tuple[int, int]] = []  # (activities, due) of dropped stretches
        self._prof = None
        self._span = None
        self._first = 0
        self._t0 = 0.0

    def span(self, name: str):
        from torch.profiler import record_function

        return record_function(name)

    def calibrate(self, fn: Callable[[], None], steps: int) -> None:
        """Profile fn (a warm-up of `steps` steps, which also starts the
        profiler's machinery before the window): the device activities a
        step, the most of two tries."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        best = 0
        for _ in range(2):
            self.sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                self.sync()
            n = sum(1 for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation())
            best = max(best, n)
        if best == 0:
            raise RuntimeError("the profiled warm-up holds no device activity")
        self.per_step = best / steps

    def start_window(self) -> None:
        self.t_window = time.perf_counter()

    def boundary(self, step: int) -> None:
        if self._prof is not None:
            if step - self._first < self.steps:
                return
            self._stop(step)
        if self.stretch is None and self.tries > 0 and (
                time.perf_counter() - self.t_window >= self.start_share * self.seconds):
            self._start(step)

    def finish(self, step: int) -> None:
        """After the window: close an open stretch at `step` (the steps
        completed)."""
        if self._prof is None:
            return
        if step > self._first:
            self._stop(step)
        else:  # no step ran inside it: nothing to keep
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self._prof = self._span = None

    def _start(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._span = self.span(STRETCH)
        self._span.__enter__()
        self._first = step
        self._t0 = time.perf_counter()

    def _stop(self, step: int) -> None:
        self.sync()
        host_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.stop()
        prof, self._prof, self._span = self._prof, None, None
        steps = step - self._first
        st = reduce(prof.profiler.kineto_results.events(), self._first, steps, host_s,
                    self.span_names)
        self.tries -= 1
        due = MIN_SHARE * self.per_step * steps
        if st.activities == 0 or st.activities < due:
            self.short.append((st.activities, int(due)))
            return
        self.stretch = st


@contextlib.contextmanager
def no_span(name: str):
    yield
