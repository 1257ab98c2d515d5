"""The chamfer distance transform's plain PyTorch version (the port's
ops/cuda_dt.py without its CUDA wrapper and launch counter).
`distance_transform` is the plain version, recorded (record.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import record


# chamfer 3x3 neighbourhood, weights 1 / 1.4 (JAX ops/normals.py:81-85)
_NEIGH = (
    (-1, -1, 1.4), (-1, 0, 1.0), (-1, 1, 1.4),
    (0, -1, 1.0), (0, 1, 1.0),
    (1, -1, 1.4), (1, 0, 1.0), (1, 1, 1.4),
)


def _init(dci: torch.Tensor) -> torch.Tensor:
    """0 where dci == 0, w + h elsewhere (f32)."""
    h, w = dci.shape[-2:]
    init = torch.full(dci.shape, float(w + h), dtype=torch.float32, device=dci.device)
    return init.masked_fill(dci == 0, 0.0)


def distance_transform_plain(dci: torch.Tensor, iterations: int) -> torch.Tensor:
    """Plain PyTorch version: dci i32 [B, H, W] -> f32 [B, H, W];
    `iterations` Jacobi rounds of 3x3 min-plus relaxation, +inf outside the
    image."""
    _, h, w = dci.shape
    dt = _init(dci)
    for _ in range(iterations):
        best = dt
        pad = F.pad(dt, (1, 1, 1, 1), value=float("inf"))
        for dy, dx, cost in _NEIGH:
            nb = pad[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            best = torch.minimum(best, nb + cost)
        dt = best
    return dt


distance_transform = record.recorded("chamfer_dt", distance_transform_plain)
