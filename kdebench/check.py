"""The comparison that decides `correct`.

After the window, with the port's state freed, the plain reference
(kdebench/reference/, through the configuration's pipelines/<name>.py)
recomputes from the same inputs everything the port derived: the
enhanced points of every draw of the run's frames, in chunks of the mix's
batch as the port runs them (so that cuBLAS picks the same products), and
for a stream with state the temporal buffer fold and the mean 3-D error
against it, chunk by chunk as run_stream's step forms them.  The port's
outputs are only judged.

The numbers compared, each against its limit in limits/<cell>.json:
  points_max_mm      the widest gap |p - p_ref| (3-D, mm) over the pixels of
                     the judged frames;
  points_mean_mm     the largest mean gap of one judged frame;
  points_off_ppm     the largest share of one judged frame's pixels whose
                     gap passes 1 mm, per million;
  buffer_depth_mm    the widest gap of the final temporal buffer's depth;
  buffer_weight      the widest gap of its weights;
  error_gap          |mean 3-D error - the reference's| / the reference's;
  error_count_gap    the same of the count of pixels it averages;
and frames_missing (frames due or pulled whose outputs never came), whose
limit is 0 in every cell.  A number that is not finite fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np

VALID_POINTS_MM = 1.0  # points_off_ppm's threshold


class Check(NamedTuple):
    name: str
    value: Optional[float]
    limit: float


@dataclasses.dataclass
class Verdict:
    correct: bool
    checks: List[Check]
    log: List[str]
    least_per_frame: Optional[list]   # per draw: family -> least seconds a frame


def reference_points(cell, ctx, *, record: bool = False, tf32: bool = False):
    """(points of every draw [D, H, W, 3] on the device, per draw the
    least seconds a frame of each hand kernel's family, or None)."""
    import torch

    import kdebench.reference as ref
    from kdebench import families, harness
    from kdebench.reference import record as rrec

    g = cell.traffic["batch"]
    d = len(ctx.draws)
    overrides = harness.overrides(cell)
    color = torch.from_numpy(ctx.color).to(ctx.device)
    fams = families.load() if record else None
    out, least = [], [None] * d
    for s in range(0, d, g):
        depths = torch.from_numpy(np.stack(ctx.draws[s:s + g])).to(ctx.device)
        colors = color.expand(depths.shape[0], -1, -1, -1).contiguous()
        with rrec.recording() if record else contextlib.nullcontext() as calls, \
                ref.tf32() if tf32 else contextlib.nullcontext():
            out.append(cell.pipeline.reference(depths, colors, cell.config["intrinsics"],
                                               overrides))
        if record:
            per = {fam: s / depths.shape[0]
                   for fam, s in families.least_by_family(calls, fams).items()}
            for k in range(s, s + depths.shape[0]):
                least[k] = per
            del calls
    return torch.cat(out), (least if record else None)


def reference_stream(cell, ctx, points, steps: int):
    """The reference's final buffer and (error sum, count) after `steps`
    chunks of the mix's batch through run_stream's fold."""
    import torch

    import kdebench.reference as ref

    b = cell.traffic["batch"]
    d = len(ctx.draws)
    rintr = ref.Intrinsics(**cell.config["intrinsics"])
    depths = torch.from_numpy(np.stack(ctx.draws)).to(ctx.device)
    buf = ref.init_buffer(depths.shape[1], depths.shape[2], ctx.device)
    total, count = 0.0, 0
    for j in range(steps):
        err = torch.zeros((), dtype=torch.float32, device=ctx.device)
        n = torch.zeros((), dtype=torch.int64, device=ctx.device)
        for t in range(b):
            k = (j * b + t) % d
            buf = ref.fold(buf, depths[k])
            e, nk = ref.frame_error(points[k], buf, rintr)
            err = err + e * nk.to(torch.float32)
            n = n + nk
        total += float(err)
        count += int(n)
    return buf, total, count


def _finite(x) -> Optional[float]:
    x = float(x)
    return x if math.isfinite(x) else None


def numbers(window, ref_points, ref_state=None) -> Dict[str, Optional[float]]:
    """The compared numbers of a window's judged outputs and final state."""
    import torch

    worst = {"points_max_mm": 0.0, "points_mean_mm": 0.0, "points_off_ppm": 0.0}
    for items in window.judged_frames.values():
        for draw, pts in items:
            p = pts.to(ref_points.device, torch.float32)
            gap = torch.linalg.vector_norm(p - ref_points[draw], dim=-1)
            for key, v in (("points_max_mm", gap.max()), ("points_mean_mm", gap.mean()),
                           ("points_off_ppm", (gap > VALID_POINTS_MM).double().mean() * 1e6)):
                v = _finite(v)
                worst[key] = None if v is None or worst[key] is None else max(worst[key], v)
    out: Dict[str, Optional[float]] = dict(worst)
    out["frames_missing"] = float(window.attempted - window.completed)
    if window.state is not None:
        buf, total, count = ref_state
        st = window.state
        out["buffer_depth_mm"] = _finite((st.buffer.depth - buf.depth).abs().max())
        out["buffer_weight"] = _finite((st.buffer.weight - buf.weight).abs().max())
        mean = total / count if count else float("nan")
        port_n = st.metric_counts["kde_error_mm"]
        port_mean = st.metric_sums["kde_error_mm"] / port_n if port_n else float("nan")
        out["error_gap"] = _finite(abs(port_mean - mean) / mean)
        out["error_count_gap"] = _finite(abs(port_n - count) / count) if count else None
    return out


def judge(cell, ctx, window, *, record: bool = False) -> Verdict:
    """The reference's verdict on a window (record: also count the hand
    kernels' least time, for the traced run)."""
    points, least = reference_points(cell, ctx, record=record)
    state = None
    if window.state is not None:
        state = reference_stream(cell, ctx, points, window.frames // cell.traffic["batch"])
    got = numbers(window, points, state)
    limits = dict(cell.limits["limits"], frames_missing=0.0)
    checks, log = [], []
    for name, value in got.items():
        if name in limits:
            checks.append(Check(name, value, float(limits[name])))
        else:
            log.append(f"not compared: {name} {value!r}")
    missing = sorted(set(limits) - set(got))
    if missing:
        raise KeyError(f"limits for numbers this cell does not have: {missing}")
    judged = sum(len(v) for v in window.judged_frames.values())
    correct = judged > 0 and all(c.value is not None and c.value <= c.limit for c in checks)
    log.insert(0, f"judged {judged} frames of {len(window.judged_frames)} steps against the "
                  f"reference's {points.shape[0]} draws")
    return Verdict(correct, checks, log, least)


class _State(NamedTuple):
    """A StreamState's fields that numbers() reads."""
    buffer: object
    metric_sums: dict
    metric_counts: dict


def control_numbers(cell, ctx, steps: int) -> Dict[str, Optional[float]]:
    """The control's numbers: the reference in TF32 (every product; the
    configuration states f32 with TF32 off) put in the port's place, every
    draw judged and, for a stream with state, `steps` chunks folded."""
    from kdebench.harness import Window

    exact, _ = reference_points(cell, ctx)
    low, _ = reference_points(cell, ctx, tf32=True)
    d = exact.shape[0]
    state = ref_state = None
    if cell.traffic["kind"] == "replay":
        buf, total, count = reference_stream(cell, ctx, low, steps)
        state = _State(buf, {"kde_error_mm": total}, {"kde_error_mm": count})
        ref_state = reference_stream(cell, ctx, exact, steps)
    window = Window(t0=0.0, seconds=0.0, attempted=d, completed=d, frames=d, latencies_ms=[],
                    late_s=[], steps=d, batch=1,
                    judged_frames={k: [(k, low[k])] for k in range(d)}, state=state)
    return numbers(window, exact, ref_state)
