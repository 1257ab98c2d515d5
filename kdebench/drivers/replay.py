"""The replay driver: a recorded sequence, closed loop, through run_stream
at the mix's batch on its capture path (the temporal buffer fold and the
pseudo-ground-truth error, kde_only=False).

The frame source yields frames as fast as run_stream pulls them and stops
at the first chunk boundary after the window's seconds, so every chunk is
whole (a smaller tail chunk would be a new compiled call, captured inside
the window).  The window runs from the first frame pulled to run_stream's
return, which has drained every chunk.  One chunk in every `judged_every`
(at an offset drawn from the seed) and the first are copied on the device
in on_outputs, for the comparison with the reference, with the final
stream state.
"""

from __future__ import annotations

import time

from kdebench.harness import Window
from kdebench.trace import no_span

SPANS = ("run_stream", "next_frame", "on_outputs")


def frame_draws(traffic: dict, step: int):
    """The draws (indices into the run's frames) of chunk `step`."""
    b, d = traffic["batch"], traffic["draws"]
    return [(step * b + t) % d for t in range(b)]


def warm(ctx, steps: int = 2) -> None:
    b = ctx.traffic["batch"]
    frames = [ctx.draws[i % len(ctx.draws)] for i in range(steps * b)]
    ctx.run_stream(iter(frames), batch=b, kde_only=False)


def window(ctx, tracer) -> Window:
    t = ctx.traffic
    b, d = t["batch"], len(ctx.draws)
    if d % b:
        raise ValueError(f"draws ({d}) must be a multiple of the batch ({b})")
    every = t["judged_every"]
    offset = int(ctx.rng.integers(every))
    span = tracer.span if tracer is not None else no_span
    judged = {}
    start = {}

    def source():
        i = 0
        start["t0"] = t0 = time.perf_counter()
        if tracer is not None:
            tracer.start_window()
        while True:
            with span("next_frame"):
                if i % b == 0:
                    if time.perf_counter() - t0 >= ctx.seconds:
                        return
                    if tracer is not None:
                        tracer.boundary(i // b)
                frame = ctx.draws[i % d]
            yield frame
            i += 1

    def on_outputs(first, pts):
        j = first // b
        if j == 0 or j % every == offset:
            with span("on_outputs"):
                judged[j] = pts.clone()

    with span("run_stream"):
        state = ctx.run_stream(source(), batch=b, kde_only=False, on_outputs=on_outputs)
    t1 = time.perf_counter()
    steps = state.frame_index // b
    if tracer is not None:
        tracer.finish(steps)
    t0 = start["t0"]
    return Window(
        t0=t0, seconds=t1 - t0, attempted=state.frame_index, completed=state.frame_index,
        frames=state.frame_index, latencies_ms=[], late_s=[], steps=steps, batch=b,
        judged_frames={j: list(zip(frame_draws(t, j), judged[j])) for j in sorted(judged)},
        state=state)
