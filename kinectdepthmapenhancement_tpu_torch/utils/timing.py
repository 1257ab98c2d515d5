"""Device timing with CUDA events.

PyTorch launches return before the device finishes, so a host clock without
a synchronise measures the enqueue.  cuda_ms brackets each call with CUDA
events on the current stream, warms up first, and reports the median.  It
refuses to run without a card: a CPU time is never a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_ms(fn: Callable[[], object], *, warmup: int = 2, iters: int = 10) -> float:
    """Median device milliseconds of fn() over `iters` timed calls after
    `warmup` untimed ones."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms needs a CUDA device")
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
