"""Timing: a pipeline's wall time on fresh inputs (time_pipeline, on any
device, of the compiled call), call time on the card with CUDA events and
device time with the profiler.

PyTorch launches return before the device finishes, so a host clock without
a synchronise measures the enqueue.  cuda_ms brackets each call with CUDA
events on the current stream, warms up first, and reports the median: the
call's time as the stream sees it, which for a call shorter than its own
host-side dispatch is the dispatch.  device_ms sums the durations of the
device activities (kernels, memsets, copies) that the profiler's CUDA
tracing records over many calls: what the card spent, whatever the host
did around it.  Both refuse to run without a card: a CPU time is never a
device time.  time_pipeline is the evaluation harness's clock
(utils/evaluate.py): it runs on the CPU as well, so its caller prints the
device beside every time.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch.core import jit


def time_pipeline(
    fn: Callable,
    make_args: Callable[[int], Sequence],
    *,
    iters: int = 5,
    compiled: bool = True,
) -> Dict[str, float]:
    """{"median_s", "min_s", "fps"} of fn(*make_args(i)) over `iters` timed
    calls after one warm-up call (i == -1).

    As the JAX package's utils/timing.py:21-44 does, the call timed is
    jit(lambda *a: torch.sum(fn(*a))) (core/jit.py): on the card the
    warm-up call captures it and every timed call replays its graph;
    compiled=False times the eager call instead, host work and syncs
    included.  make_args(i) returns fresh inputs for call i, already on
    the device; they are built before the clock starts.  The clock stops
    when the sum has been read back to the host, so a call on the card is
    timed to its completion."""
    def summed(*args):
        return torch.sum(fn(*args))

    red = jit.jit(summed) if compiled else summed

    def run(args) -> float:
        return float(red(*args))

    run(make_args(-1))
    times = []
    for i in range(iters):
        args = make_args(i)
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"median_s": med, "min_s": min(times),
            "fps": 1.0 / med if med > 0 else float("inf")}


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")


def cuda_ms(fn: Callable[[], object], *, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds of fn() between CUDA events recorded before and
    after it, over `iters` timed calls after `warmup` untimed ones."""
    _require_cuda("cuda_ms")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


_SPAN = "device_ms.call"  # the record_function label around each timed call


def device_ms(
    fn: Callable[[], object], *, warmup: int = 3, iters: int = 20, attempts: int = 3
) -> Tuple[float, float]:
    """(device ms, device activities) per fn() call: every kernel, memset and
    copy that `iters` calls ran on the card, summed from torch.profiler's
    CUDA trace and divided by `iters`, after `warmup` untimed calls.

    Each call runs inside a record_function span, whose own device-side
    annotation is left out of the sum.  The device records are read from
    the trace whether or not the profiler ties them to a CPU op (it ties
    none of the kernels launched through ctypes).  Every call runs the same
    kernels, so a whole trace holds a non-zero multiple of `iters` device
    records; a trace that fails that test is taken again, up to `attempts`
    times in all, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    _require_cuda("device_ms")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                with record_function(_SPAN):
                    fn()
            torch.cuda.synchronize()
        records = [ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and ev.name != _SPAN]
        if records and len(records) % iters == 0:
            return sum(records) / iters / 1e3, len(records) / iters
    raise RuntimeError(
        f"device_ms: {attempts} traces without a whole set of device records "
        f"(last: {len(records)} for {iters} calls)"
    )
