"""Shared helpers for window-stencil ops (PyTorch counterpart of the JAX
package's ops/stencil.py).

The reference implements every stencil as a per-thread loop over a small
window with an in-bounds check (e.g. JointBilateralFilter.cu:17-21).  The
plain PyTorch versions sum shifted views of a padded image; the pad value
doubles as the out-of-bounds sentinel (invalid depth 0 is rejected by the
z > 50 test, so padding with 0 reproduces the bounds check exactly).

Image tensors carry a leading batch dimension: [B, H, W] or [B, H, W, C].
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F


def offsets(window: int) -> Iterator[Tuple[int, int]]:
    """(dy, dx) pairs covering the reference loop
    `for i in -w/2..w/2: for j in -w/2..w/2` in the same order."""
    r = window // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yield dy, dx


def pad2d(x: torch.Tensor, radius: int, fill: float = 0.0) -> torch.Tensor:
    """Pad the image axes (1 and 2) of [B, H, W, ...] by `radius` with `fill`."""
    pads = (0, 0) * (x.dim() - 3) + (radius, radius, radius, radius)
    return F.pad(x, pads, value=fill)


def shift(padded: torch.Tensor, dy: int, dx: int, radius: int, shape) -> torch.Tensor:
    """View of the padded array displaced by (dy, dx); shape = original (H, W)."""
    h, w = shape
    return padded[:, radius + dy : radius + dy + h, radius + dx : radius + dx + w]


def pad_channels_last(x: torch.Tensor, radius: int, mode: str) -> torch.Tensor:
    """[B, H, W, C] padded on the image axes with an F.pad mode
    ("reflect" is reflect-101, "replicate" is edge)."""
    p = F.pad(x.permute(0, 3, 1, 2), (radius, radius, radius, radius), mode=mode)
    return p.permute(0, 2, 3, 1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last (size-3) axis of a * b as ((x0 + x1) + x2), the
    association the kernels and the JAX package use."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device.  (On CUDA, PyTorch turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which rounds differently from the kernels' and the JAX package's
    division.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


FLT_MIN = 1.17549435e-38  # the least normal f32


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with every value below FLT_MIN set to 0, for non-negative weights.

    XLA on the CPU and the TPU flush subnormal results to zero; PyTorch and
    the port's kernels (built without -ftz) keep them.  The JAX package is
    the reference, so each factor and product of a bilateral weight (all in
    [0, 1]) is flushed here and in the kernels at the same places.  A weight
    sum of subnormals then reads 0 (no support), as it does in XLA."""
    return torch.where(x < FLT_MIN, torch.zeros_like(x), x)


def gaussian_spatial_filter(
    window: int, sigma: float, device: Optional[torch.device] = None
) -> torch.Tensor:
    """exp(-(dx^2+dy^2) / (2 sigma^2)) over the window, f32 [window, window]
    (calcSpatialFilter, JointBilateralFilter.cpp:33-43)."""
    r = window // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    return torch.exp(div_const(-(d[:, None] * d[:, None] + d[None, :] * d[None, :]), 2.0 * sigma**2))
