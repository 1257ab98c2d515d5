"""Depth-quality metrics (copies of mean_3d_error and depth_rmse from the
JAX package's utils/metrics.py), on tensors of one frame.

The reference's evaluation (main.cpp:217-309) counts a pixel where both
depths lie in (50, 15000) mm.
"""

from __future__ import annotations

from typing import Tuple

import torch

VALID_MIN = 50.0
VALID_MAX = 15000.0


def _valid(z: torch.Tensor) -> torch.Tensor:
    return (z > VALID_MIN) & (z < VALID_MAX)


def mean_3d_error(
    points: torch.Tensor, reference_points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean ||p - p_ref|| over pixels where BOTH z's are in (50, 15000) mm
    (main.cpp:302-309).  Returns (mean_error_mm, count)."""
    valid = _valid(points[..., 2]) & _valid(reference_points[..., 2])
    d = points - reference_points
    err = torch.sqrt((d * d).sum(dim=-1))
    count = valid.sum()
    total = torch.where(valid, err, 0.0).sum()
    return total / torch.clamp_min(count, 1), count


def depth_rmse(depth: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
    """Per-pixel depth RMSE (mm) over jointly valid pixels."""
    valid = _valid(depth) & _valid(reference)
    d = depth - reference
    se = torch.where(valid, d * d, 0.0)
    return torch.sqrt(se.sum() / torch.clamp_min(valid.sum(), 1))
