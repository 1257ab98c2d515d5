"""Streaming sequence runner: frames -> pipeline -> metrics, resumable.

PyTorch counterpart of the JAX package's models/streaming.py.  The
reference's only multi-frame mode is the 1000-frame ground-truth capture
loop (main.cpp:86-116); this runner generalises it:
  * pulls depth frames from any iterator, with one fixed colour image;
  * runs kde_pipeline on chunks of `batch` frames, [B, H, W] a call;
  * folds the temporal DepthBuffer (core/buffer2d.py) and the mean 3-D
    error against it (utils/metrics.py) over the chunk's frames in order,
    on the device: the host reads two scalars a chunk, never a frame;
  * runs the KDE and the fold as one compiled step (core/jit.py, the JAX
    package's jitted step, streaming.py:49): on the card each chunk shape
    is captured once into a CUDA graph and replayed;
  * reads chunk N's scalars back only after chunk N+1 is enqueued, so the
    host's staging and dispatch of the next chunk overlap the device's
    work on this one;
  * checkpoints cursor, buffer and metrics at chunk boundaries every
    `checkpoint_every` frames (utils/checkpoint.py), so a killed run
    resumes where it left off.

On the card each chunk's frames are staged in pinned host memory and
copied on a copy stream with non_blocking=True; the compute stream waits on
the copy's event before the step copies them into its graph's inputs.  A staging buffer is refilled only after the event of
its previous copy has completed (two buffers take turns).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core import buffer2d, jit
from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device
from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu_torch.utils import checkpoint, metrics


def _chunk_step(buf: buffer2d.DepthBuffer, depths: torch.Tensor, color: torch.Tensor,
                intr: Intrinsics, cfg: KDEConfig, kde_only: bool):
    """One chunk: KDE on depths [B, H, W] with color [B, H, W, 3], then the
    buffer and metric fold frame by frame.  Returns (buffer, points
    [B, H, W, 3], error sum, count): kde_only skips the fold and returns a
    checksum of the points (which forces the chunk to complete when read)
    and a zero count."""
    pts = kde_pipeline(depths, color, intr, cfg).optimized_points
    if kde_only:
        return buf, pts, pts.sum() * 1e-30, torch.zeros((), dtype=torch.int64, device=pts.device)
    err_sum = torch.zeros((), dtype=torch.float32, device=pts.device)
    n_sum = torch.zeros((), dtype=torch.int64, device=pts.device)
    for depth, p in zip(depths, pts):
        buf = buffer2d.update(buf, depth)
        err, n = metrics.mean_3d_error(p, projective_to_real(buf.depth, intr))
        err_sum = err_sum + err * n.to(torch.float32)
        n_sum = n_sum + n
    return buf, pts, err_sum, n_sum


# the compiled step: one graph per (chunk shape, intr, cfg, kde_only)
_step = jit.jit(_chunk_step)


class _Stager:
    """Host frames to the device.  On the card: two pinned staging buffers
    taking turns, each copied on a copy stream with its event; the compute
    stream waits on the event, and a buffer is refilled only once its last
    copy's event has completed.  On the CPU: the stacked frames."""

    def __init__(self, batch: int, h: int, w: int, dev: torch.device):
        self.dev = dev
        self.turn = 0
        if dev.type == "cuda":
            self.copy_stream = torch.cuda.Stream(dev)
            self.host = [torch.empty((batch, h, w), dtype=torch.float32, pin_memory=True)
                         for _ in range(2)]
            self.done: List[Optional[torch.cuda.Event]] = [None, None]

    def __call__(self, chunk: List[np.ndarray]) -> torch.Tensor:
        frames = np.stack(chunk).astype(np.float32, copy=False)
        if self.dev.type != "cuda":
            return torch.from_numpy(frames).to(self.dev)
        k = len(chunk)
        slot = self.turn
        self.turn ^= 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # the buffer's last copy has finished
        host = self.host[slot][:k]
        host.copy_(torch.from_numpy(frames))
        compute = torch.cuda.current_stream(self.dev)
        with torch.cuda.stream(self.copy_stream):
            dst = torch.empty((k,) + host.shape[1:], dtype=torch.float32, device=self.dev)
            dst.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.copy_stream)
        self.done[slot] = ev
        compute.wait_event(ev)
        dst.record_stream(compute)  # freed only after the compute stream's use
        return dst


def run_stream(
    frames: Iterator[np.ndarray],
    color: np.ndarray,
    intr: Intrinsics,
    *,
    cfg: KDEConfig = KDEConfig(),
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    max_frames: Optional[int] = None,
    batch: int = 8,
    kde_only: bool = False,
    on_outputs: Optional[Callable[[int, torch.Tensor], None]] = None,
    device=None,
) -> checkpoint.StreamState:
    """Process a depth-frame stream with a fixed colour image (file-replay
    style).  Returns the final StreamState with the accumulated metrics.

    frames: f32 [H, W] mm arrays; color: u8 [H, W, 3].  `batch` frames go
    through kde_pipeline a call; the stream's tail runs as one smaller
    chunk.  kde_only=True skips the temporal-buffer fold and the pseudo-GT
    metric (the serving path) and accumulates a "kde_checksum" metric that
    counts frames instead.  on_outputs, when given, receives
    (start_frame_index, points) per chunk, points [B, H, W, 3] still on the
    device.  device=None runs on "cuda" and raises without a card."""
    dev = resolve_device(device)
    h, w = color.shape[:2]
    state = checkpoint.load(checkpoint_path, dev) if checkpoint_path else None
    if state is None:
        state = checkpoint.StreamState(
            frame_index=0,
            buffer=buffer2d.init(h, w, dev),
            metric_sums={"kde_error_mm": 0.0},
            metric_counts={"kde_error_mm": 0},
        )
    metric = "kde_checksum" if kde_only else "kde_error_mm"
    state.metric_sums.setdefault(metric, 0.0)
    state.metric_counts.setdefault(metric, 0)

    c = torch.from_numpy(np.array(color, dtype=np.uint8)).to(dev)
    colors: Dict[int, torch.Tensor] = {}  # the colour image repeated for B frames
    stage = _Stager(batch, h, w, dev)
    inflight: List[tuple] = []  # <= 1 dispatched chunk awaiting readback

    def dispatch(chunk: List[np.ndarray]) -> None:
        if not chunk:
            return
        k = len(chunk)
        depths = stage(chunk)
        if k not in colors:
            colors[k] = c.expand(k, -1, -1, -1).contiguous()
        start = state.frame_index + sum(e[2] for e in inflight)
        state.buffer, pts, err_sum, n_sum = _step(
            state.buffer, depths, colors[k], intr, cfg, kde_only)
        if on_outputs is not None:
            on_outputs(start, pts)
        inflight.append((err_sum, n_sum, k))
        chunk.clear()

    def drain() -> None:
        """Account the oldest in-flight chunk (blocks until it is done)."""
        if not inflight:
            return
        err_sum, n_sum, k = inflight.pop(0)
        state.metric_sums[metric] += float(err_sum)
        state.metric_counts[metric] += int(n_sum) if not kde_only else k
        state.frame_index += k

    pending: List[np.ndarray] = []
    last_ckpt = state.frame_index
    for i, frame in enumerate(frames):
        if i < state.frame_index:
            continue  # fast-forward after resume
        if max_frames is not None and i >= max_frames:
            break
        pending.append(np.asarray(frame))
        if len(pending) == batch:
            dispatch(pending)
            while len(inflight) > 1:  # keep exactly one chunk in flight
                drain()
            dispatched = state.frame_index + sum(e[2] for e in inflight)
            if checkpoint_path and dispatched - last_ckpt >= checkpoint_every:
                while inflight:  # frame_index must match the saved buffer
                    drain()
                checkpoint.save(checkpoint_path, state)
                last_ckpt = state.frame_index
    dispatch(pending)
    while inflight:
        drain()

    if checkpoint_path:
        checkpoint.save(checkpoint_path, state)
    return state


def mean_metric(state: checkpoint.StreamState, name: str) -> float:
    n = state.metric_counts.get(name, 0)
    return state.metric_sums.get(name, 0.0) / n if n else float("nan")
