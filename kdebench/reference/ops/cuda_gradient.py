"""The SLIC seed-sampling gradient's plain PyTorch version (the port's
ops/cuda_gradient.py without its CUDA wrapper and launch counter).
`seed_gradient` is the plain version, recorded (record.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import record
from ..ops import stencil


R = 5  # the 11x11 gradient window half-width
INVALID_NORMAL = -1.0


def _valid_and(n: torch.Tensor) -> torch.Tensor:
    return (
        (n[..., 0] != INVALID_NORMAL)
        & (n[..., 1] != INVALID_NORMAL)
        & (n[..., 2] != INVALID_NORMAL)
    )


def seed_gradient_plain(
    color_f: torch.Tensor, normals: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version: color_f [B, H, W, 3] f32 (and normals
    [B, H, W, 3] f32 for the NASP form) -> [B, H, W] f32.  Mean over the
    11x11 edge-padded window of the colour distance (scaled by 1 - |n.n'|
    where both normals are valid); only g > 0 terms count; +inf where none
    does.  dy outer, dx inner, as in the JAX package."""
    _, h, w, _ = color_f.shape
    nasp = normals is not None
    cpad = stencil.pad_channels_last(color_f, R, "replicate")
    c = [color_f[..., i] for i in range(3)]
    if nasp:
        npad = stencil.pad_channels_last(normals, R, "replicate")
        n = [normals[..., i] for i in range(3)]
        valid_c = _valid_and(normals)
    sum_g = torch.zeros_like(c[0])
    count = torch.zeros_like(c[0])
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            nb = stencil.shift(cpad, dy, dx, R, (h, w))
            d = [c[i] - nb[..., i] for i in range(3)]
            g = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
            if nasp:
                nn = stencil.shift(npad, dy, dx, R, (h, w))
                both = valid_c & _valid_and(nn)
                ndiff = torch.abs((n[0] * nn[..., 0] + n[1] * nn[..., 1]) + n[2] * nn[..., 2])
                g = torch.where(both, g * (1.0 - ndiff), g)
            sum_g = sum_g + g
            count = count + (g > 0.0).to(torch.float32)
    return torch.where(
        count > 0.0, sum_g / torch.clamp_min(count, 1.0), torch.full_like(sum_g, float("inf"))
    )


@functools.partial(record.recorded, "seed_gradient")
def seed_gradient(
    color_f: torch.Tensor, normals: Optional[torch.Tensor] = None, form: Optional[str] = None
) -> torch.Tensor:
    """Seed gradient (NASP form when `normals` is given): the plain version
    (`form` names the port's launch form and changes nothing here)."""
    return seed_gradient_plain(color_f, normals)
