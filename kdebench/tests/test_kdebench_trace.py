"""The traced stretch's reduction, on synthetic profiler events: the busy
union, idle gaps named by the host span the host was in, device ops by
name; and a stretch short of device records is dropped, never read as a
short number."""

from torch.autograd import DeviceType

from kdebench import trace


class Ev:
    def __init__(self, name, a, b, device=True, annotation=False):
        self._n, self._a, self._b = name, a, b
        self._d = DeviceType.CUDA if device else DeviceType.CPU
        self._u = annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._u


def events():
    ms = 1_000_000
    return [
        Ev(trace.STRETCH, 0, 100 * ms, device=False, annotation=True),
        Ev(trace.STRETCH, 0, 100 * ms, annotation=True),  # its device-side twin: no work
        Ev("run_stream", 0, 100 * ms, device=False, annotation=True),
        Ev("wait_for_due", 30 * ms, 70 * ms, device=False, annotation=True),
        Ev("readback", 90 * ms, 100 * ms, device=False, annotation=True),
        Ev("aten::copy_", 10 * ms, 11 * ms, device=False),
        Ev("k1", 10 * ms, 20 * ms),
        Ev("k2", 15 * ms, 30 * ms),   # overlaps k1
        Ev("k1", 80 * ms, 90 * ms),
    ]


def test_reduce_counts_the_union_and_names_the_gaps():
    st = trace.reduce(events(), first_step=4, steps=2, host_s=0.1,
                      span_names=("run_stream", "wait_for_due", "readback"))
    assert st.activities == 3 and st.steps == 2 and st.first_step == 4
    assert abs(st.window_s - 0.1) < 1e-12
    assert abs(st.busy_s - 0.030) < 1e-12  # [10, 30) and [80, 90)
    gaps = dict(st.idle_gaps)
    # [0, 10) run_stream; [30, 80) has its midpoint in wait_for_due; [90, 100)
    # has its midpoint in readback
    assert abs(gaps["run_stream"] - 0.010) < 1e-12
    assert abs(gaps["wait_for_due"] - 0.050) < 1e-12
    assert abs(gaps["readback"] - 0.010) < 1e-12
    assert dict(st.device_ops) == {"k1": 0.020, "k2": 0.015}


class FakeProfile:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: evs)})()})()

    def start(self):
        pass

    def stop(self):
        pass


def test_a_short_stretch_is_dropped_and_the_next_is_kept(monkeypatch):
    import torch.profiler

    batches = [events()[:6], events()]  # the first holds no device activity
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: FakeProfile(batches.pop(0)))
    monkeypatch.setattr(trace.Tracer, "span", lambda self, name: _Null())
    t = trace.Tracer(1.0, start_share=0.0, steps=2, span_names=("run_stream",),
                     sync=lambda: None)
    t.per_step = 1.0
    t.start_window()
    for step in range(6):
        t.boundary(step)
    assert t.short == [(0, 1)]
    assert t.stretch is not None and t.stretch.first_step == 2 and t.stretch.steps == 2


def test_no_whole_stretch_leaves_none():
    t = trace.Tracer(1.0, start_share=0.0, steps=2, span_names=(), sync=lambda: None)
    t.tries = 0
    t.start_window()
    t.boundary(0)
    t.finish(1)
    assert t.stretch is None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
