"""The drivers' frame sources and the end-to-end arithmetic, on a stand-in
for run_stream that returns at once: the sensor's due times and
latencies, the replay stopping on whole chunks, and the metrics over all
frames and all of the window."""

import types

import numpy as np
import pytest
import torch

from kdebench import harness
from kdebench.drivers import replay, sensor


class FakeStream:
    """run_stream's contract: pulls frames, hands (first index, points
    [B, H, W, 3]) to on_outputs a chunk, returns a state."""

    def __init__(self, work_s=0.0):
        self.work_s = work_s
        self.pulled = []

    def __call__(self, frames, *, batch, kde_only, on_outputs=None):
        chunk, n = [], 0
        for f in frames:
            self.pulled.append(f)
            chunk.append(f)
            if len(chunk) == batch:
                if self.work_s:
                    import time
                    time.sleep(self.work_s)
                if on_outputs is not None:
                    on_outputs(n, torch.zeros((batch, 2, 3, 3)))
                n += batch
                chunk = []
        assert not chunk, "the source ended inside a chunk"
        return types.SimpleNamespace(frame_index=n)


def ctx(traffic, seconds, stream):
    draws = [np.full((2, 3), i, np.float32) for i in range(traffic["draws"])]
    return types.SimpleNamespace(traffic=traffic, seconds=seconds, draws=draws,
                                 rng=np.random.default_rng(0), run_stream=stream,
                                 device=torch.device("cpu"), config={"height": 2, "width": 3})


def test_sensor_frames_are_due_at_the_sensor_rate():
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "sensor30.json"), fps=100)
    stream = FakeStream(work_s=0.001)
    w = sensor.window(ctx(traffic, 0.5, stream), None)
    assert w.attempted == 50 and w.completed == 50 and w.frames == 50
    assert len(w.latencies_ms) == 50
    # frame i is due at t0 + i / fps: a source that ran on time is at most
    # a few ms late, and every latency holds the 1 ms of work
    assert max(w.late_s) < 0.02
    assert min(w.latencies_ms) >= 1.0
    assert 0.49 <= w.seconds < 0.6
    assert [int(f[0, 0]) for f in stream.pulled] == [i % 16 for i in range(50)]
    assert set(w.judged_frames) >= {49} and len(w.judged_frames) <= 33


def test_a_late_sensor_frame_counts_from_its_due_time():
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "sensor30.json"), fps=100)
    stream = FakeStream(work_s=0.03)  # three frame times of work a frame: a backlog
    w = sensor.window(ctx(traffic, 0.2, stream), None)
    assert w.attempted == 20 and w.completed == 20
    # the last frame waits behind the 19 before it
    assert w.latencies_ms[-1] > 19 * 30 - 20 * 10 - 5


def test_a_sensor_at_batch_two_sends_whole_chunks():
    traffic = dict(harness.load_json(harness.HERE / "traffic" / "sensor30.json"), fps=100,
                   batch=2)
    stream = FakeStream(work_s=0.001)
    w = sensor.window(ctx(traffic, 0.25, stream), None)
    # 25 frames due: 12 whole chunks, and each frame's latency runs from its
    # own due time, so a chunk's first frame waits one frame time longer
    assert w.attempted == 24 and w.completed == 24 and w.steps == 12 and w.batch == 2
    assert all(a - b >= 9.0 for a, b in zip(w.latencies_ms[::2], w.latencies_ms[1::2]))
    assert len(w.host_ms["dispatch"]) == len(w.host_ms["wait"]) == 12
    assert sensor.frame_draws(traffic, 9) == [2, 3]
    for step, items in w.judged_frames.items():
        assert all(d in sensor.frame_draws(traffic, step) for d, _ in items)


def test_the_replay_stops_on_whole_chunks():
    traffic = harness.load_json(harness.HERE / "traffic" / "replay_b8.json")
    stream = FakeStream(work_s=0.002)
    w = replay.window(ctx(traffic, 0.1, stream), None)
    assert w.frames % 8 == 0 and w.frames == len(stream.pulled) and w.frames >= 8
    assert w.steps == w.frames // 8 and w.completed == w.frames
    assert 0 in w.judged_frames and all(len(v) == 8 for v in w.judged_frames.values())
    assert [d for d, _ in w.judged_frames[0]] == list(range(8))
    assert replay.frame_draws(traffic, 3) == list(range(8, 16))


def window(latencies, seconds=10.0, completed=None):
    n = len(latencies)
    return harness.Window(t0=0.0, seconds=seconds, attempted=n,
                          completed=n if completed is None else completed, frames=n,
                          latencies_ms=latencies, late_s=[], steps=n, batch=1,
                          judged_frames={}, state=None)


def test_latency_and_rate_arithmetic():
    from kdebench import harness as h

    lat = [float(i) for i in range(1, 101)]  # 1 .. 100 ms
    run = h.Run("cell", 1.0, window(lat))
    p50 = h.load_module(h.HERE / "metrics" / "latency_p50_ms.py", "p50").read(run)
    p95 = h.load_module(h.HERE / "metrics" / "latency_p95_ms.py", "p95").read(run)
    fps = h.load_module(h.HERE / "metrics" / "frames_per_s.py", "fps").read(run)
    assert p50 == pytest.approx(50.5) and p95 == pytest.approx(95.05)
    # the host's tail: the steps before the traced stretch only, and none
    # from too few of them
    dispatch = h.load_module(h.HERE / "metrics" / "host_dispatch_p95_ms.py", "d95")
    assert dispatch.read(h.Run("cell", 1.0, window([]),
                               untraced_host_ms={"dispatch": lat * 2})) == pytest.approx(95.05)
    assert dispatch.read(h.Run("cell", 1.0, window([]),
                               untraced_host_ms={"dispatch": lat})) is None
    assert fps == pytest.approx(10.0)  # all 100 frames over all 10 s
    setup = h.load_module(h.HERE / "metrics" / "setup_s.py", "setup").read(run)
    assert setup == 1.0
