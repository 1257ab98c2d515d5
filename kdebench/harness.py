"""One run of one benchmark cell, driven by data.

BENCHMARK.json names each cell's configuration and traffic mix; every
piece is a file of its own, found by name:

  configs/<config>.json   frame shape, intrinsics, the pipeline's name
                          ("pipeline"; "kde" where it has none) and its
                          config's overrides (under the pipeline's name)
  pipelines/<name>.py     port_kwargs(overrides) -> run_stream's keyword
                          arguments; reference(depths, colors, intrinsics,
                          overrides) -> the plain reference's points; FILES,
                          the reference/ copies it adds to reference.FILES
  traffic/<mix>.json      the mix's parameters and the `kind` of driver
  drivers/<kind>.py       warm(ctx), window(ctx, tracer), frame_draws()
  limits/<cell>.json      the limit of each number the check compares
  metrics/<metric>.py     read(run) -> the metric, or None (not there); a
                          metric named <quantity>.<part> without a file of its
                          own is read by metrics/<quantity>.py
  kernels/<family>.py     a hand kernel's trace name and counts

An unknown name fails the run.  The run: set-up (frames from the seed,
the cell's one compiled call warmed and captured), the window, then, with
the port's state freed, the reference's comparison (check.py) and the
metrics.  The port is kinectdepthmapenhancement_tpu_torch; nothing here
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PIPELINES = HERE / "pipelines"
FORBIDDEN = ("jax", "jaxlib", "flax", "kinectdepthmapenhancement_tpu")


class BenchError(Exception):
    """A run that cannot give a result (the command exits non-zero)."""


@dataclasses.dataclass
class Window:
    t0: float                 # the window's start (time.perf_counter)
    seconds: float
    attempted: int            # frames due (sensor) or pulled (replay)
    completed: int            # frames whose outputs came back
    frames: int               # the stream state's frame count
    latencies_ms: List[float]
    late_s: List[float]       # how late the source yielded each frame
    steps: int
    batch: int
    judged_frames: Dict[int, list]  # step -> [(draw, points [H, W, 3])]
    state: Any                # the final StreamState (replay) or None
    # a step's host milliseconds by part (sensor: "dispatch", "wait"), for the log
    host_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    workload: str
    setup_s: float
    window: Window
    stretch: Any = None                   # trace.Stretch of the traced run
    kernels: Optional[Dict[str, dict]] = None  # family -> least_s, device_s, ...
    # the latencies of the traced run's frames before its stretch (tracing
    # slows a frame's host path, not its device work)
    untraced_latencies_ms: Optional[List[float]] = None
    untraced_host_ms: Optional[Dict[str, List[float]]] = None  # the same steps' host parts
    traced_frames: int = 0


@dataclasses.dataclass
class Context:
    device: Any
    config: dict
    traffic: dict
    seconds: float
    seed: int
    rng: np.random.Generator
    color: np.ndarray
    draws: List[np.ndarray]
    port_kwargs: Optional[dict]   # the pipeline's keyword arguments to run_stream
    port_intr: Any
    _run_stream: Any

    def run_stream(self, frames, *, batch: int, kde_only: bool, on_outputs=None):
        return self._run_stream(frames, self.color, self.port_intr, batch=batch,
                                kde_only=kde_only, on_outputs=on_outputs, device=self.device,
                                **self.port_kwargs)


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"no such file: {path.relative_to(REPO)}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"no such file: {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: Any
    pipeline: Any             # pipelines/<name>.py of the configuration's pipeline
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Any]


def _for_cell(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, manifest: Optional[dict] = None) -> Cell:
    """The cell's files, by the names BENCHMARK.json gives."""
    manifest = manifest if manifest is not None else load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    if w["config"] not in configs:
        raise BenchError(f"no config {w['config']!r} in BENCHMARK.json")
    config = load_json(REPO / configs[w["config"]]["file"])
    name = pipeline_name(config)
    pipe = pipeline(name)
    if name not in config:
        raise BenchError(f"config {w['config']!r} has no {name!r} key (its pipeline's "
                         "overrides)")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    driver = load_module(HERE / "drivers" / f"{traffic['kind']}.py",
                         f"kdebench.drivers.{traffic['kind']}")
    e2e = [m for m in manifest["end_to_end"] if _for_cell(m, workload)]
    layer = [m for m in manifest["per_layer"] if _for_cell(m, workload)]
    readers = {m["name"]: reader(m["name"]) for m in e2e + layer}
    return Cell(workload, w["chips"], config, traffic, limits, driver, pipe, e2e, layer,
                readers)


def pipeline_name(config: dict) -> str:
    """The configuration's pipeline: its "pipeline" key, "kde" where it
    has none."""
    return config.get("pipeline", "kde")


def pipeline(name: str):
    """pipelines/<name>.py."""
    return load_module(PIPELINES / f"{name}.py", f"kdebench.pipelines.{name}")


def overrides(cell: Cell) -> dict:
    """The configuration's overrides of its pipeline's config, which sit
    under the pipeline's name."""
    return cell.config[pipeline_name(cell.config)]


def reader(metric: str):
    """The metric's reader: metrics/<metric>.py, or else the reader of its
    quantity, metrics/<the name up to its first dot>.py (one file reads
    frames_per_s.kinect_v1_vga and frames_per_s.kinect_v2_tof)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, f"kdebench.metrics.{path.stem}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _replace(obj, overrides: dict):
    """obj (a frozen config dataclass) with the overrides: a dict for a
    nested group, a string such as "inf" for a float field (JSON has no
    infinity)."""
    changes = {}
    for key, value in overrides.items():
        current = getattr(obj, key)
        if isinstance(value, dict):
            value = _replace(current, value)
        elif isinstance(current, float) and isinstance(value, str):
            value = float(value)
        changes[key] = value
    return dataclasses.replace(obj, **changes)


def frames_context(cell: Cell, seed: int, seconds: float, device) -> Context:
    """The run's frames from the seed, without the port (the control and
    the reference need no more)."""
    from kdebench import scene

    c = cell.config
    intr = scene.Intrinsics(**c["intrinsics"])
    color, draws = scene.frames(seed, c["height"], c["width"], intr, cell.traffic["draws"])
    rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64).spawn(2)[1])
    return Context(device=device, config=c, traffic=cell.traffic, seconds=seconds, seed=seed,
                   rng=rng, color=color, draws=draws, port_kwargs=None, port_intr=None,
                   _run_stream=None)


def setup(cell: Cell, seed: int, seconds: float, device) -> Context:
    """The frames from the seed and the port's entry, ready to warm up."""
    from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics
    from kinectdepthmapenhancement_tpu_torch.models.streaming import run_stream

    ctx = frames_context(cell, seed, seconds, device)
    return dataclasses.replace(ctx, port_kwargs=cell.pipeline.port_kwargs(overrides(cell)),
                               port_intr=Intrinsics(**cell.config["intrinsics"]),
                               _run_stream=run_stream)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _conds_taken(jit) -> List[List[int]]:
    """[IF, ELSE] taken so far by each conditional node of the port's
    compiled calls (core/jit's own counters)."""
    return [list(t) for k in jit.keys() for t in k["taken"]]


def _no_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise BenchError(f"loaded {when}: {', '.join(found)}")


def _traced(cell: Cell, ctx: Context, window: Window, stretch, least_per_frame) -> dict:
    """The Run fields of the traced run: the stretch's kernels by family
    (device seconds from the trace, least seconds from the reference's
    counts of the stretch's frames) and the latencies of the frames before
    the stretch."""
    from kdebench import families

    fams = families.load()
    device_s: Dict[str, float] = {}
    unnamed: Dict[str, float] = {}
    for name, s in stretch.kernel_s.items():
        fam = families.family_of(name, fams)
        if fam is not None:
            device_s[fam] = device_s.get(fam, 0.0) + s
        elif families.PORT_KERNEL.search(name):
            unnamed[name] = s
    steps = range(stretch.first_step, stretch.first_step + stretch.steps)
    least: Dict[str, float] = {}
    for step in steps:
        for draw in cell.driver.frame_draws(cell.traffic, step):
            for fam, s in least_per_frame[draw].items():
                least[fam] = least.get(fam, 0.0) + s
    kernels = {fam: {"device_s": device_s[fam], "least_s": least[fam]}
               for fam in device_s if fam in least}
    lat = window.latencies_ms[:stretch.first_step * window.batch] or None
    host = {part: ms[:stretch.first_step] for part, ms in window.host_ms.items()}
    return dict(stretch=stretch, kernels=kernels, untraced_latencies_ms=lat,
                untraced_host_ms=host, traced_frames=stretch.steps * window.batch,
                unnamed=unnamed)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_process: float) -> dict:
    """One run: returns the result line's fields (and "log" lines for
    standard error)."""
    import torch
    from kdebench import check
    from kdebench import trace as tr

    log: List[str] = []
    device = torch.device(device)
    on_card = device.type == "cuda"
    ctx = setup(cell, seed, seconds, device)
    cell.driver.warm(ctx)  # the cell's compiled call: warmed, captured, replayed
    tracer = None
    if trace:
        t = cell.traffic["trace"]
        tracer = tr.Tracer(seconds, start_share=t["start_share"], steps=t["steps"],
                           span_names=cell.driver.SPANS, sync=lambda: _sync(device))
        tracer.calibrate(lambda: cell.driver.warm(ctx), steps=2)
    from kinectdepthmapenhancement_tpu_torch.core import jit

    _sync(device)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    before = dict(jit.stats)
    taken_before = _conds_taken(jit)
    window = cell.driver.window(ctx, tracer)
    gc.unfreeze()
    taken = [[a - b for a, b in zip(x, y)] for x, y in zip(_conds_taken(jit), taken_before)]
    captures = jit.stats["captures"] - before["captures"]
    replays = jit.stats["replays"] - before["replays"]
    if on_card and captures:
        raise BenchError(f"{captures} compiled call(s) captured inside the window")
    pool = sum(k["pool_bytes"] for k in jit.keys())
    setup_s = window.t0 - t_process
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    _no_jax("after the window")
    if trace and tracer.stretch is None:
        raise BenchError(f"the trace is short of device records in every stretch "
                         f"(activities, due): {tracer.short}")
    # the port's compiled calls and their pools go before the reference runs
    jit.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.judge(cell, ctx, window, record=trace)
    rec = Run(cell.name, setup_s, window)
    unnamed = {}
    if trace:
        extra = _traced(cell, ctx, window, tracer.stretch, verdict.least_per_frame)
        unnamed = extra.pop("unnamed")
        rec = dataclasses.replace(rec, **extra)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is None:
            if not trace:
                raise BenchError(f"end-to-end metric {m['name']} has no value")
            log.append(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if window.latencies_ms:
        q = np.percentile(window.latencies_ms, [50, 90, 95, 99, 100])
        over = sum(x > 1e3 / 30 for x in window.latencies_ms)
        log.append("latency ms p50 {:.3f} p90 {:.3f} p95 {:.3f} p99 {:.3f} max {:.3f}; "
                   "{} frames over 33.3 ms".format(*q, over))
        late_ms = np.asarray(window.late_s) * 1e3
        log.append("source late ms p50 {:.3f} p95 {:.3f} max {:.3f}; {} frames over 1 ms".format(
            *np.percentile(late_ms, [50, 95, 100]), int((late_ms > 1.0).sum())))
    for part, ms in window.host_ms.items():
        log.append("{} ms a step p50 {:.3f} p95 {:.3f} max {:.3f}; p50 of each tenth: {}".format(
            part, *np.percentile(ms, [50, 95, 100]),
            " ".join(f"{np.median(x):.3f}" for x in np.array_split(ms, min(10, len(ms))))))
    log.append(f"compiled calls: {replays} replays in the window for {window.steps} steps, "
               f"graph pools {pool} bytes; each conditional node's branches taken in the "
               f"window [IF, ELSE]: {taken}")
    log.append(f"window {window.seconds:.3f} s, {window.completed} of {window.attempted} "
               f"frames, {window.steps} steps; set-up {setup_s:.3f} s")
    if trace:
        st = tracer.stretch
        log.append(f"traced steps {st.first_step}..{st.first_step + st.steps - 1}: "
                   f"{st.activities} device activities, busy {st.busy_s * 1e3:.3f} ms of "
                   f"{st.window_s * 1e3:.3f} ms (host {st.host_s * 1e3:.3f} ms); "
                   f"{tracer.per_step:.1f} activities a step in the warm-up")
        for fam, k in sorted(rec.kernels.items()):
            log.append(f"kernel {fam}: device {k['device_s'] * 1e3:.4f} ms, "
                       f"least {k['least_s'] * 1e3:.4f} ms")
        for name, s in sorted(unnamed.items()):
            log.append(f"hand kernel named by no kernels/*.py: {name} {s * 1e3:.4f} ms")
    result = {
        "correct": verdict.correct,
        "attempted": window.attempted,
        "failed": window.attempted - window.completed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        st = tracer.stretch
        result["device"].update(busy_s=st.busy_s, window_s=st.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in st.device_ops],
                               "idle_gaps": [list(x) for x in st.idle_gaps]}
        if unnamed:
            result["unnamed_kernels"] = sorted(unnamed)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in verdict.checks}
    # the reference, the kernel counts and the metric readers were loaded
    # after the window: no result while anything of JAX is loaded
    _no_jax("before the result")
    result["log"] = log + verdict.log + [
        f"check {c.name} {c.value!r} limit {c.limit!r}" for c in verdict.checks]
    return result
