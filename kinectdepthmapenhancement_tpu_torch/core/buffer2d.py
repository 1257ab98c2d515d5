"""Temporal weighted depth accumulation (pseudo-ground-truth capture).

PyTorch counterpart of the JAX package's core/buffer2d.py (the reference's
ArrayBuffer/Buffer2D.cu:13-30): a per-pixel {depth, weight} state updated
with a running weighted average, gated on agreement between the incoming
and the stored depth:

    if d > 50:
        if stored.d != 0 and |int(stored.d) - int(d)| < d * 0.01:
            stored.d = (stored.d*(w+1) + d*w) / (2w + 1);  w += 1
        elif stored.d == 0:
            stored.d = d; w = 1

(disagreeing samples are dropped).  A buffer holds one frame, [H, W].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kinectdepthmapenhancement_tpu_torch.core import jit
from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM


class DepthBuffer(NamedTuple):
    depth: torch.Tensor   # [H, W] f32, mm; 0 = empty
    weight: torch.Tensor  # [H, W] f32


def init(height: int, width: int, device=None) -> DepthBuffer:
    z = torch.zeros((height, width), dtype=torch.float32, device=device)
    return DepthBuffer(depth=z, weight=z)


def insert(buf: DepthBuffer, depth: torch.Tensor) -> DepthBuffer:
    """Unconditional overwrite (insertDataKernel, Buffer2D.cu:33-56)."""
    return DepthBuffer(depth=depth, weight=torch.ones_like(depth))


def update(buf: DepthBuffer, depth: torch.Tensor) -> DepthBuffer:
    """Gated weighted-average update (Buffer2D.cu:13-30)."""
    d, w = buf.depth, buf.weight
    valid_new = depth > VALID_DEPTH_MM
    # the reference truncates both depths to int before differencing
    agree = (torch.trunc(d) - torch.trunc(depth)).abs() < depth * 0.01
    has_old = d != 0.0

    merged_d = (d * (w + 1.0) + depth * w) / (w * 2.0 + 1.0)
    take_merge = valid_new & has_old & agree
    take_init = valid_new & ~has_old

    new_d = torch.where(take_merge, merged_d, torch.where(take_init, depth, d))
    new_w = torch.where(take_merge, w + 1.0, torch.where(take_init, 1.0, w))
    return DepthBuffer(depth=new_d, weight=new_w)


@jit.jit
def accumulate(buf: DepthBuffer, frames: torch.Tensor) -> DepthBuffer:
    """Fold a stack of frames [N, H, W] through `update` in order (the
    capture loop, main.cpp:86-116, runs 1000 live frames through
    Buffer2D::updateData).  A compiled call (core/jit.py), as the JAX
    package's @jax.jit lax.scan is: on the card one graph per N."""
    for frame in frames:
        buf = update(buf, frame)
    return buf


def synthetic_noise(
    ground_truth: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Kinect-like depth noise from the reference's (commented) generator
    (main.cpp:127-130): variance = 0.45*2.85*(z/10)^2 / 1e4 mm, noise uniform
    in [-variance, +variance).  The draws come from `generator` (on the
    tensor's device); their statistics, not their bits, match the JAX
    package's jax.random draws."""
    variance = 0.45 * 2.85 * torch.square(ground_truth / 10.0) / 1.0e4
    u = torch.rand(ground_truth.shape, generator=generator, dtype=ground_truth.dtype,
                   device=ground_truth.device) * 2.0 - 1.0
    return ground_truth + u * variance
