"""The port's own telemetry in a traced run: the host spans, device stage
stamps and replay counter of kinectdepthmapenhancement_tpu_torch/utils/
telemetry.py, for the metrics that name a program span, stamp or counter.

Turning it on.  The stamps must be in the cell's graphs, so telemetry is
on before the warm-up captures them.  The harness loads every metric
reader before the run; the first reader that imports this module turns
the port's telemetry on when the command asks for a traced run
(`--trace 1`), and never otherwise: a `--trace 0` run records nothing and
its graphs hold no stamp.

Reading it.  After the window the first read collects the records once
and keeps the window's: spans that open at or after the window's start,
and the replays whose jit.graph stamps lie after it, the k-th replay being
step k (one compiled call a step).  Each metric is taken over the steps
before the profiled stretch, as host_ms_per_frame is (the profiler slows
the host path inside it).  The first read also writes the log lines: each
span's ms a step, each stage's device ms a frame, jit.graph's device ms a
frame in each tenth of the window, the device's idle between replays by
the innermost program span open over it, and the clock's error.

A program without the telemetry module, telemetry left off, a ring that
wrapped over the window's stamps or a window whose replays do not match
its steps give nothing to read: None, never 0.

    python3 kdebench/program_trace.py --telemetry <0|1> --workload <cell> --seed <n> \\
        --seconds <s> --trace 0

runs a cell as kdebench/run.py does, with telemetry on or off and no
profiler (the cost of telemetry, and the stages' device time in each tenth
of the window), and prints the result line after its log.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

PORT_TELEMETRY = "kinectdepthmapenhancement_tpu_torch.utils.telemetry"
HOST_SPANS = ("stream.stage", "stream.call", "stream.drain", "jit.key", "jit.copy_in",
              "jit.launch", "jit.clone")
GRAPH = "jit.graph"
KERNELS = "jit.kernels"
NO_SPAN = "(no program span)"


def traced_command(argv: List[str]) -> bool:
    """Whether the command line asks for a traced run (--trace 1)."""
    for i, arg in enumerate(argv):
        if arg == "--trace" and i + 1 < len(argv):
            return argv[i + 1] == "1"
        if arg.startswith("--trace="):
            return arg.split("=", 1)[1] == "1"
    return False


def port_telemetry():
    """The port's telemetry module, or None for a program without one."""
    try:
        return importlib.import_module(PORT_TELEMETRY)
    except ImportError:
        return None


if traced_command(sys.argv[1:]):
    _tel = port_telemetry()
    if _tel is not None:
        _tel.enable()


@dataclasses.dataclass
class Program:
    """The window's program records, by step (a step is a replay)."""
    batch: int
    before: int                     # the steps before the profiled stretch
    span_ms: Dict[str, np.ndarray]  # span -> ms of each step (summed), all steps
    graph_ms: np.ndarray            # jit.graph's device ms of each replay
    stage_ms: Dict[str, np.ndarray]  # stage -> inclusive device ms of each replay
    self_ms: Dict[str, np.ndarray]  # stage -> its self device ms of each replay
    gap_ms: np.ndarray              # jit.graph exit of replay k - 1 to entry of k (k >= 1)
    gap_spans: Dict[str, float]     # idle ms before the stretch by innermost program span
    kernels: np.ndarray             # kernels replayed in each step (counter jit.kernels)
    clock_error_us: float
    stamps_lost: int
    problems: List[str]             # why a stamp metric has nothing to read

    def span_step_ms(self, name: str) -> Optional[float]:
        ms = self.span_ms.get(name)
        if ms is None or len(ms) < self.before or self.before == 0:
            return None
        return float(ms[:self.before].mean())

    def stage_frame_ms(self, name: str) -> Optional[float]:
        ms = self.stage_ms.get(name)
        if self.problems or ms is None or self.before == 0:
            return None
        return float(ms[:self.before].sum() / (self.before * self.batch))


def _depths(spans) -> List[int]:
    depth: List[int] = []
    for s in spans:
        depth.append(depth[s.parent] + 1 if s.parent >= 0 else 0)
    return depth


def _attribute(a: int, b: int, starts, ends, depths, names, out: Dict[str, float]) -> None:
    """Split [a, b) by the innermost span open over each part (ms)."""
    inside = np.nonzero((starts < b) & (ends > a))[0]
    cuts = sorted({a, b, *(int(x) for x in starts[inside] if a < x < b),
                   *(int(x) for x in ends[inside] if a < x < b)})
    for p, q in zip(cuts, cuts[1:]):
        mid = (p + q) / 2
        hold = [i for i in inside if starts[i] <= mid < ends[i]]
        name = names[max(hold, key=lambda i: depths[i])] if hold else NO_SPAN
        out[name] = out.get(name, 0.0) + (q - p) / 1e6


def _replays(stamps, t0: int):
    """The replays after t0: (entry, exit, {stage: incl ns}, {stage: self ns}),
    or the reason the stamps do not parse."""
    out, cur, stack = [], None, []
    for st in stamps:
        if st.t_ns < t0:
            continue
        if st.stage == GRAPH:
            if not st.exit:
                if cur is not None:
                    return None, "a replay's jit.graph entry without its exit"
                cur, stack = (st.t_ns, {}, {}), []
            elif cur is None or stack:
                return None, "a jit.graph exit without its entry, or inside a stage"
            else:
                out.append((cur[0], st.t_ns, cur[1], cur[2]))
                cur = None
        elif cur is not None:
            if not st.exit:
                stack.append([st.stage, st.t_ns, 0])
            else:
                if not stack or stack[-1][0] != st.stage:
                    return None, f"stage {st.stage}'s exit without its entry"
                name, t_in, child = stack.pop()
                incl = st.t_ns - t_in
                cur[1][name] = cur[1].get(name, 0) + incl
                cur[2][name] = cur[2].get(name, 0) + incl - child
                if stack:
                    stack[-1][2] += incl
    return out, None


def analyse(rec, t0_s: float, batch: int, steps: int, before: int) -> Program:
    """The window's records (it starts at t0_s on time.perf_counter and
    holds `steps` steps of `batch` frames; `before` steps come before the
    profiled stretch)."""
    t0 = int(t0_s * 1e9)
    problems: List[str] = []
    spans = rec.spans
    names = [s.name for s in spans]
    starts = np.array([s.start_ns for s in spans], dtype=np.int64)
    ends = np.array([s.end_ns for s in spans], dtype=np.int64)
    depths = np.array(_depths(spans), dtype=np.int64)
    span_ms = {n: np.zeros(steps) for n in HOST_SPANS}
    for s in spans:
        k = s.step // batch
        if s.name in span_ms and s.start_ns >= t0 and 0 <= k < steps:
            span_ms[s.name][k] += (s.end_ns - s.start_ns) / 1e6
    for n in HOST_SPANS:
        if not any(s.name == n and s.start_ns >= t0 for s in spans):
            del span_ms[n]
    if rec.spans_dropped:
        problems.append(f"{rec.spans_dropped} spans or samples past their store's capacity")
    stamps = rec.stamps
    if rec.stamps_lost and (not stamps or stamps[0].t_ns >= t0):
        problems.append(f"the stamp ring wrapped over the window ({rec.stamps_lost} lost)")
    reps, why = _replays(stamps, t0)
    if why:
        problems.append(why)
        reps = []
    if len(reps) != steps:
        problems.append(f"{len(reps)} replays stamped in the window of {steps} steps")
    stage_names = sorted({n for r in reps for n in r[2]})
    stage_ms = {n: np.array([r[2].get(n, 0) / 1e6 for r in reps]) for n in stage_names}
    self_ms = {n: np.array([r[3].get(n, 0) / 1e6 for r in reps]) for n in stage_names}
    graph_ms = np.array([(r[1] - r[0]) / 1e6 for r in reps])
    gap_ms = np.array([(reps[k][0] - reps[k - 1][1]) / 1e6 for k in range(1, len(reps))])
    prog = [i for i, n in enumerate(names) if n in HOST_SPANS and starts[i] >= t0]
    gap_spans: Dict[str, float] = {}
    for k in range(1, min(before, len(reps))):
        _attribute(reps[k - 1][1], reps[k][0], starts[prog], ends[prog], depths[prog],
                   [names[i] for i in prog], gap_spans)
    kernels = np.zeros(steps)
    for c in rec.counters:
        if c.name == KERNELS and c.t_ns >= t0 and 0 <= c.step // batch < steps:
            kernels[c.step // batch] += c.value
    return Program(batch, before, span_ms, graph_ms, stage_ms, self_ms, gap_ms, gap_spans,
                   kernels, rec.clock_error_ns / 1e3, rec.stamps_lost, problems)


def _tenths(x: np.ndarray) -> str:
    return " ".join(f"{np.median(p):.4f}" for p in np.array_split(x, min(10, len(x))) if len(p))


def log_lines(p: Program, stretch=None, traced_frames: int = 0,
              stamp_s: Optional[float] = None) -> List[str]:
    """The program's records for the log, over the steps before the
    stretch (the stretch's own steps for the comparison with the trace)."""
    n, b = p.before, p.batch
    out = [f"program telemetry over steps 0..{n - 1} (before the stretch); clock error "
           f"+-{p.clock_error_us:.2f} us, stamps lost to the ring {p.stamps_lost}"]
    for name, ms in p.span_ms.items():
        q = np.percentile(ms[:n], [50, 95]) if n else (np.nan, np.nan)
        out.append(f"span {name} ms a step p50 {q[0]:.4f} p95 {q[1]:.4f} mean "
                   f"{ms[:n].mean() if n else np.nan:.4f}")
    if p.problems:
        return out + [f"program stamps: nothing to read: {why}" for why in p.problems]
    graph = p.graph_ms[:n].sum()
    for name in p.stage_ms:
        out.append(f"stage {name} device ms a frame {p.stage_ms[name][:n].sum() / (n * b):.4f} "
                   f"(self {p.self_ms[name][:n].sum() / (n * b):.4f})")
    covered = sum(ms[:n].sum() for ms in p.self_ms.values())
    out.append(f"stage jit.graph device ms a frame {graph / (n * b):.4f}; the stages' self "
               f"time covers {100 * covered / graph if graph else np.nan:.2f}% of it")
    out.append(f"jit.graph device ms a frame, p50 of each tenth of the window: "
               f"{_tenths(p.graph_ms / b)}")
    idle = sum(p.gap_spans.values())
    if idle:
        parts = ", ".join(f"{k} {v:.3f} ms ({100 * v / idle:.1f}%)" for k, v in
                          sorted(p.gap_spans.items(), key=lambda kv: -kv[1]))
        out.append(f"device idle between replays, {idle:.3f} ms over steps 1..{n - 1}, by the "
                   f"innermost program span open over it: {parts}")
    if stretch is not None and traced_frames:
        own = p.graph_ms[stretch.first_step:stretch.first_step + stretch.steps]
        busy = stretch.busy_s * 1e3 / traced_frames
        out.append(f"over the stretch's steps: jit.graph device ms a frame "
                   f"{own.sum() / traced_frames:.4f}, the trace's busy ms a frame {busy:.4f} "
                   f"({100 * (own.sum() / traced_frames / busy - 1):+.2f}%)")
        if stamp_s is not None:
            out.append(f"kde_stamp device us a frame in the stretch "
                       f"{stamp_s * 1e6 / traced_frames:.3f}")
    return out


_cache: dict = {}


def collect():
    """The port's records, or None (no telemetry module, or telemetry off)."""
    tel = port_telemetry()
    if tel is None or not tel.enabled():
        return None
    rec = tel.collect()
    tel.disable()
    return rec


def program(run) -> Optional[Program]:
    """The traced run's Program (collected, analysed and logged once)."""
    if _cache.get("run") is not run:
        _cache.clear()
        _cache["run"] = run
        rec = collect()
        st = run.stretch
        if rec is None or st is None:
            _cache["program"] = None
        else:
            w = run.window
            p = _cache["program"] = analyse(rec, w.t0, w.batch, w.steps, st.first_step)
            stamp_s = sum(s for name, s in st.kernel_s.items() if "kde_stamp" in name)
            for line in log_lines(p, st, run.traced_frames, stamp_s):
                print(line, file=sys.stderr)
    return _cache["program"]


def main(argv=None) -> int:
    """Run a cell as kdebench/run.py does, with telemetry on or off
    (--telemetry) and no profiler; with it on, log the window's stages by
    tenth."""
    argv = list(sys.argv[1:] if argv is None else argv)
    on = "0"
    if "--telemetry" in argv:
        i = argv.index("--telemetry")
        on = argv[i + 1]
        del argv[i:i + 2]
    if traced_command(argv):
        raise SystemExit("program_trace: --trace 0 only (a traced run is kdebench/run.py's)")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from kdebench import run as bench_run

    tel = port_telemetry()
    if on == "1":
        if tel is None:
            raise SystemExit("program_trace: the program has no telemetry module")
        tel.enable()
    rc = bench_run.main(argv)
    if rc == 0 and on == "1":
        rec = tel.collect()
        tel.disable()
        firsts = [s for s in rec.spans if s.name == "stream.stage" and s.step == 0]
        if not firsts:
            raise SystemExit("program_trace: no run_stream call recorded")
        t0 = firsts[-1].start_ns  # the window: the last run_stream
        window = [s for s in rec.spans if s.name == "stream.call" and s.start_ns >= t0]
        batch = window[1].step if len(window) > 1 else 1
        p = analyse(rec, t0 / 1e9, batch, len(window), len(window))
        for line in log_lines(p):
            print(line, file=sys.stderr)
        if not p.problems:
            for name, ms in p.stage_ms.items():
                print(f"stage {name} device ms a frame, p50 of each tenth of the window: "
                      f"{_tenths(ms / batch)}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
