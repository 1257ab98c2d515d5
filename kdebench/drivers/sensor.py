"""The sensor driver: one live sensor, open loop, through run_stream at
the mix's batch on its serving path (kde_only).

Frame i is due at t0 + i / fps.  The frame source waits until a frame is
due and then yields it, at once when late; run_stream enhances each chunk
of `batch` frames and hands the points to on_outputs, which reads them
back into a pinned host buffer as a live viewer does.  A frame's latency
runs from its due time to the end of its chunk's readback, so a stall
delays every frame queued behind it.  Every frame due in the window
counts; a sample of them drawn from the seed is kept as read back, for
the comparison with the reference.

The source spins until the due time instead of sleeping: a thread that
sleeps gives up its core, and on a shared host it is woken up to
milliseconds late, which would be the source's lateness and not the
program's.
"""

from __future__ import annotations

import time

import torch

from kdebench.harness import Window
from kdebench.trace import no_span

SPANS = ("run_stream", "wait_for_due", "readback")


def frame_draws(traffic: dict, step: int):
    """The draws (indices into the run's frames) of chunk `step`."""
    b, d = traffic["batch"], traffic["draws"]
    return [(step * b + t) % d for t in range(b)]


def warm(ctx, steps: int = 2) -> None:
    b = ctx.traffic["batch"]
    frames = [ctx.draws[i % len(ctx.draws)] for i in range(steps * b)]
    ctx.run_stream(iter(frames), batch=b, kde_only=True, on_outputs=lambda start, pts: pts.cpu())


def window(ctx, tracer) -> Window:
    t = ctx.traffic
    fps = float(t["fps"])
    b, d = t["batch"], len(ctx.draws)
    # whole chunks only: a smaller tail chunk would be a new compiled call
    steps = max(1, int(round(ctx.seconds * fps)) // b)
    n = steps * b
    sample = set(ctx.rng.choice(n, size=min(t["judged_frames"], n), replace=False).tolist())
    sample.add(n - 1)
    span = tracer.span if tracer is not None else no_span
    due = [0.0] * n
    late = [0.0] * n
    latency = [None] * n
    yielded = [0.0] * steps   # when the source handed over a chunk's last frame
    dispatch_ms = [0.0] * steps  # from then to on_outputs: staging and the replay's launch
    wait_ms = [0.0] * steps      # on_outputs to the end of the readback
    judged = {}
    # the viewer's readback buffer, pinned as a live viewer's would be
    on_card = ctx.device.type == "cuda"
    host = torch.empty((b, ctx.config["height"], ctx.config["width"], 3), dtype=torch.float32,
                       pin_memory=on_card)
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.start_window()

    def source():
        for i in range(n):
            if tracer is not None and i % b == 0:
                tracer.boundary(i // b)
            due[i] = t0 + i / fps
            with span("wait_for_due"):
                while time.perf_counter() < due[i]:
                    pass
            now = time.perf_counter()
            late[i] = max(0.0, now - due[i])
            if i % b == b - 1:
                yielded[i // b] = now
            yield ctx.draws[i % d]

    def on_outputs(start, pts):
        step = start // b
        t_in = time.perf_counter()
        with span("readback"):
            host.copy_(pts, non_blocking=True)
            if on_card:
                torch.cuda.current_stream(pts.device).synchronize()
        t_out = time.perf_counter()
        dispatch_ms[step] = (t_in - yielded[step]) * 1e3
        wait_ms[step] = (t_out - t_in) * 1e3
        for k in range(b):
            latency[start + k] = (t_out - due[start + k]) * 1e3
            if start + k in sample:
                judged.setdefault(step, []).append(((start + k) % d, host[k].clone()))

    with span("run_stream"):
        state = ctx.run_stream(source(), batch=b, kde_only=True, on_outputs=on_outputs)
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.finish(steps)
    done = [x for x in latency if x is not None]
    return Window(
        t0=t0, seconds=t1 - t0, attempted=n, completed=len(done), frames=state.frame_index,
        latencies_ms=done, late_s=late, steps=steps, batch=b,
        judged_frames={j: judged[j] for j in sorted(judged)}, state=None,
        host_ms={"dispatch": dispatch_ms, "wait": wait_ms})
