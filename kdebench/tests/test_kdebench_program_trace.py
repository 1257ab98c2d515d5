"""The readers of the program's own telemetry (kdebench/program_trace.py) on
a synthetic traced run: host spans a step, the stamped stages' device ms a
frame, the kernels a frame and the gaps between replays over the steps
before the stretch, the idle put down to the innermost program span; a
ring that wrapped over the window, or a program without telemetry, gives
nothing to read, never 0; only `--trace 1` turns telemetry on."""

import types

import pytest

from kdebench import harness, program_trace
from kinectdepthmapenhancement_tpu_torch.utils.telemetry import Counter, Records, Span, Stamp

MS = 1_000_000
T0 = 10_000 * MS  # the window's start, ns


def records(steps=4, batch=2, lost=0, warm=True):
    """Each step k at T0 + 10 k ms: stream.stage 1 ms, stream.call 2 ms
    (jit.launch 0.5 ms inside), a replay of 6 ms on the device from 1 ms
    after the call opens (kde.nasp 2 ms, kde.ccl_merge 3 ms holding
    kde.projection 1 ms), stream.drain 3 ms; 40 kernels a replay."""
    spans, stamps, counters = [], [], []
    if warm:  # a warm-up replay before the window: not read
        spans.append(Span("stream.call", T0 - 50 * MS, T0 - 48 * MS, -1, 0))
        stamps += [Stamp("jit.graph", False, T0 - 47 * MS, 0),
                   Stamp("jit.graph", True, T0 - 40 * MS, 0)]
        counters.append(Counter("jit.kernels", 0, 99, T0 - 49 * MS))
    for k in range(steps):
        t = T0 + 10 * MS * k
        step = k * batch
        spans.append(Span("stream.stage", t, t + MS, -1, step))
        call = len(spans)
        spans.append(Span("stream.call", t + MS, t + 3 * MS, -1, step))
        spans.append(Span("jit.launch", t + MS, t + 3 * MS // 2, call, step))
        spans.append(Span("stream.drain", t + 3 * MS, t + 6 * MS, -1, step))
        counters.append(Counter("jit.kernels", step, 40, t + 2 * MS))
        d = t + 2 * MS
        stamps += [Stamp("jit.graph", False, d, 0), Stamp("kde.nasp", False, d, 0),
                   Stamp("kde.nasp", True, d + 2 * MS, 0),
                   Stamp("kde.ccl_merge", False, d + 2 * MS, 0),
                   Stamp("kde.projection", False, d + 4 * MS, 0),
                   Stamp("kde.projection", True, d + 5 * MS, 0),
                   Stamp("kde.ccl_merge", True, d + 5 * MS, 0),
                   Stamp("jit.graph", True, d + 6 * MS, 0)]
    if lost:
        stamps = [s for s in stamps if s.t_ns >= T0 + 10 * MS]
    return Records(spans, counters, stamps, lost, 0, 4_000.0)


def run(steps=4, batch=2, first_step=3):
    window = harness.Window(t0=T0 / 1e9, seconds=0.04, attempted=steps * batch,
                            completed=steps * batch, frames=steps * batch, latencies_ms=[],
                            late_s=[], steps=steps, batch=batch, judged_frames={}, state=None)
    stretch = types.SimpleNamespace(first_step=first_step, steps=steps - first_step,
                                    busy_s=0.006, kernel_s={"kde_stamp(long long*)": 1e-5})
    return harness.Run("kinect_v1_vga.replay_b8", 1.0, window, stretch=stretch,
                       traced_frames=(steps - first_step) * batch)


def read(monkeypatch, rec, metric, r=None):
    monkeypatch.setattr(program_trace, "collect", lambda: rec)
    program_trace._cache.clear()
    return harness.reader(metric).read(r if r is not None else run())


def test_the_readers_over_the_steps_before_the_stretch(monkeypatch, capsys):
    rec = records()
    assert read(monkeypatch, rec, "staging_host_ms.sensor") == pytest.approx(1.0)
    assert read(monkeypatch, rec, "call_host_ms.sensor") == pytest.approx(2.0)
    # 3 replays before the stretch, 2 frames each: 3 x 2 ms / 6 frames
    assert read(monkeypatch, rec, "nasp_device_ms.sensor") == pytest.approx(1.0)
    assert read(monkeypatch, rec, "ccl_plane_device_ms.kinect_v1_vga.replay_b8") == (
        pytest.approx(1.5))
    assert read(monkeypatch, rec, "kernels_per_frame.sensor") == pytest.approx(20.0)
    # exit at 8 ms, next entry at 12 ms
    assert read(monkeypatch, rec, "replay_gap_ms.kinect_v1_vga.replay_b8") == (
        pytest.approx(4.0))
    log = capsys.readouterr().err
    # the gap [8, 12) ms: [8, 10) in no program span, [10, 11) stream.stage,
    # [11, 11.5) stream.call's jit.launch (the innermost span), [11.5, 12)
    # stream.call
    assert "by the innermost program span open over it: (no program span) 4.000 ms (50.0%), " \
           "stream.stage 2.000 ms (25.0%), jit.launch 1.000 ms (12.5%), stream.call 1.000 ms " \
           "(12.5%)" in log
    assert "the stages' self time covers 83.33% of it" in log
    assert "clock error +-4.00 us" in log


def test_a_wrapped_ring_or_no_telemetry_gives_nothing_to_read(monkeypatch):
    rec = records(lost=12)
    assert read(monkeypatch, rec, "nasp_device_ms.sensor") is None
    assert read(monkeypatch, rec, "replay_gap_ms.kinect_v1_vga.replay_b8") is None
    assert read(monkeypatch, rec, "staging_host_ms.sensor") == pytest.approx(1.0)
    missing = records()._replace(stamps=records().stamps[:-1])  # a replay short
    assert read(monkeypatch, missing, "ccl_plane_device_ms.sensor") is None
    assert read(monkeypatch, None, "kernels_per_frame.sensor") is None
    assert read(monkeypatch, None, "call_host_ms.sensor") is None


def test_only_a_traced_command_turns_telemetry_on():
    assert program_trace.traced_command(["--workload", "x", "--trace", "1"])
    assert program_trace.traced_command(["--trace=1"])
    assert not program_trace.traced_command(["--workload", "x", "--trace", "0"])
    assert not program_trace.traced_command(["--seed", "1"])
