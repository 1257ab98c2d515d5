"""PyTorch port: telemetry (utils/telemetry.py) on the CPU.

Off, a span is one shared null context and nothing is recorded; on, spans
keep their names, parents and step ids (a child takes its parent's); the
device ring decodes in sequence order, a wrap over it counted as lost and
a slot holding another sequence never read; the clock fit keeps the
narrowest bracket and maps device times onto the host's clock between two
fits; run_stream at 32x40 gives each chunk the spans stream.stage,
stream.call and stream.drain under its first frame index; the kernel
wrappers' launch bookkeeping.  The stamps themselves run on the card only
(tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import streaming
from kinectdepthmapenhancement_tpu_torch.utils import telemetry


@pytest.fixture
def on():
    telemetry.collect()
    telemetry.enable()
    try:
        yield
    finally:
        telemetry.disable()
        telemetry.collect()


def test_off_is_a_shared_null_context_that_records_nothing():
    telemetry.disable()
    telemetry.collect()
    a, b = telemetry.span("stream.stage", step=0), telemetry.span("jit.key")
    assert a is b
    with a:
        telemetry.count("jit.kernels", 5)
    stage = telemetry.stage("kde.nasp", torch.zeros(1))
    assert isinstance(stage, torch.profiler.record_function)
    rec = telemetry.collect()
    assert (rec.spans, rec.counters, rec.stamps, rec.stamps_lost) == ([], [], [], 0)


def test_on_records_names_parents_and_steps(on):
    with telemetry.span("stream.call", step=16):
        with telemetry.span("jit.key"):
            pass
        with telemetry.span("jit.launch"):
            telemetry.count("jit.kernels", 7)
    with telemetry.span("stream.drain", step=8):
        pass
    with telemetry.stage("kde.jbf", torch.zeros(1)):  # the CPU: a range, no stamp
        pass
    rec = telemetry.collect()
    assert [(s.name, s.parent, s.step) for s in rec.spans] == [
        ("stream.call", -1, 16), ("jit.key", 0, 16), ("jit.launch", 0, 16),
        ("stream.drain", -1, 8)]
    call, key, launch, _ = rec.spans
    assert call.start_ns <= key.start_ns <= key.end_ns <= launch.start_ns <= call.end_ns
    assert [(c.name, c.step, c.value) for c in rec.counters] == [("jit.kernels", 16, 7)]
    assert rec.stamps == [] and telemetry.stamps_launched == 0
    assert telemetry.collect().spans == []  # collect() clears


def test_span_store_past_capacity_counts_drops(on, monkeypatch):
    monkeypatch.setattr(telemetry, "SPAN_CAPACITY", 2)
    for name in ("a", "b", "c"):
        with telemetry.span(name, step=1):
            with telemetry.span(name + ".child"):
                pass
    rec = telemetry.collect()
    assert [s.name for s in rec.spans] == ["a", "a.child"] and rec.spans_dropped == 4
    with pytest.raises(RuntimeError):
        with telemetry.span("open"):
            telemetry.collect()


def _ring(cap, n, t0=1000):
    """A ring of `cap` slots after n stamps (stamp i at device time t0 + 10 i)."""
    raw = np.full((cap, 3), -1, np.int64)
    for s in range(n):
        raw[s % cap] = (s, 2 * (s % 3) + (s % 2), t0 + 10 * s)
    return raw


def test_ring_decodes_in_order_and_counts_a_wrap():
    rows, lost = telemetry.decode_ring(_ring(8, 5), 5)
    assert lost == 0 and rows[:, 0].tolist() == [0, 1, 2, 3, 4]
    rows, lost = telemetry.decode_ring(_ring(8, 13), 13)
    assert lost == 5 and rows[:, 0].tolist() == list(range(5, 13))
    assert rows[:, 2].tolist() == [1000 + 10 * s for s in range(5, 13)]
    raw = _ring(8, 13)
    raw[13 % 8 - 1] = (99, 0, 0)  # a slot written by another sequence: lost, not 0
    rows, lost = telemetry.decode_ring(raw, 13)
    assert lost == 6 and 12 not in rows[:, 0].tolist() and 0 not in rows[:, 2].tolist()
    rows, lost = telemetry.decode_ring(_ring(8, 0), 0)
    assert lost == 0 and len(rows) == 0


def test_clock_fit_keeps_the_narrowest_bracket_and_interpolates():
    # device = host + 5000 ns at first, + 5400 ns 1e6 ns later
    fit = telemetry.best_fit([(100, 5150, 300), (1000, 6030, 1040), (2000, 7100, 2400)])
    assert fit == telemetry.Fit(6030, 5010.0, 20.0)
    late = telemetry.best_fit([(1_000_000, 1_005_410, 1_000_020)])
    assert late.offset_ns == 5400.0 and late.half_ns == 10.0
    host = telemetry.to_host(np.array([6030, 1_005_410, 506_030]), [fit, late])
    assert host.tolist() == [1020, 1_000_010, 500_825]
    assert telemetry.to_host(np.array([6030]), [fit]).tolist() == [1020]
    with pytest.raises(ValueError):
        telemetry.best_fit([(10, 5, 3)])


def test_run_stream_spans_a_chunk(on):
    h, w = 32, 40
    intr = default_kinect_intrinsics(w, h)
    color, _, gt = make_noisy_scene(h, w, intr, seed=0)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(2, 2))
    frames = [gt.astype(np.float32)] * 5
    state = streaming.run_stream(iter(frames), color, intr, cfg=cfg, batch=2, device="cpu")
    rec = telemetry.collect()
    assert state.frame_index == 5
    tree = [(s.name, s.parent, s.step) for s in rec.spans]
    assert sorted(tree, key=lambda x: x[2]) == [
        (name, -1, step) for step in (0, 2, 4)
        for name in ("stream.stage", "stream.call", "stream.drain")]
    # the drain of chunk N follows the dispatch of chunk N + 1
    order = [(s.name, s.step) for s in rec.spans]
    assert order.index(("stream.call", 2)) < order.index(("stream.drain", 0))


def test_count_launch_keeps_the_wrappers_counters():
    ns = {"launches": 0, "launch_forms": {}}
    telemetry.count_launch(ns, "jbf:w640")
    telemetry.count_launch(ns, "jbf:w640")
    assert ns == {"launches": 2, "launch_forms": {"jbf:w640": 2}}
    ns = {"launches": {"a": 0, "b": 0}, "launch_forms": {}}
    telemetry.count_launch(ns, "a:full", kernel="a")
    assert ns == {"launches": {"a": 1, "b": 0}, "launch_forms": {"a:full": 1}}
