"""SLIC seed-sampling gradient: CUDA kernel wrapper, its plain PyTorch
version, and a launch counter.

Counterpart of the JAX package's ops/pallas_gradient.py (seed_gradient) and
of the XLA slic._color_gradient / slic._nasp_gradient.  Kernel source:
csrc/seed_gradient.cu.  The gradient feeds an argmin with near-ties, so the
kernel keeps the plain version's operation order and is bitwise equal to it.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from kinectdepthmapenhancement_tpu_torch import _build
from kinectdepthmapenhancement_tpu_torch.ops import stencil

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/seed_gradient.cu"
REPLACES = "kinectdepthmapenhancement_tpu/ops/pallas_gradient.py:89"
launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
# the same launches by form, "seed_gradient:nasp" or "seed_gradient:color",
# with the caller's ":<form>" where it names one (chip_smoke.py clears it
# with launches)
launch_forms: Dict[str, int] = {}

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


def seed_gradient(
    color_f: torch.Tensor, normals: Optional[torch.Tensor] = None, form: Optional[str] = None
) -> torch.Tensor:
    """Seed gradient (NASP form when `normals` is given): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  form: the caller's
    name of the input's shape for launch_forms ("tile" for a width tile's
    sub-grid, "halo" for a haloed width tile)."""
    if color_f.device.type == "cpu":
        return seed_gradient_plain(color_f, normals)
    global launches
    b, h, w, _ = color_f.shape
    _build.check_tensor(color_f, "gradient color", torch.float32, (b, h, w, 3))
    if normals is not None:
        _build.check_tensor(normals, "gradient normals", torch.float32, (b, h, w, 3))
    out = torch.empty((b, h, w), dtype=torch.float32, device=color_f.device)
    _build.launch(
        "kde_seed_gradient", [_build.PTR] * 3 + [_build.INT] * 4, color_f.device,
        (color_f.data_ptr(), normals.data_ptr() if normals is not None else None,
         out.data_ptr(), b, h, w, int(normals is not None)),
    )
    launches += 1
    key = "seed_gradient:" + ("nasp" if normals is not None else "color") + (
        f":{form}" if form else "")
    launch_forms[key] = launch_forms.get(key, 0) + 1
    return out
