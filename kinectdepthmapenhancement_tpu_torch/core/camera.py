"""Camera model: projective (u, v, z[mm]) <-> real-world (X, Y, Z[mm]).

PyTorch counterpart of kinectdepthmapenhancement_tpu/core/camera.py (the
reference's DimensionConvertor, DimensionConvertor.h:19-148, and the
normalised-ray map of Projection_GPU.cu:3-19).

Coordinate convention (reference DimensionConvertor.h:36-43):
    X = (u - cx) / fx * z
    Y = (cy - v) / fy * z        # note the y-axis flip
    Z = z                        # millimetres
Every pixel is converted, including invalid ones (z == 0 maps to the origin).

Batching: functions take any number of leading batch dimensions before the
image axes ([..., H, W] depth, [..., H, W, 3] points).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core.device import constant

# global invalid-depth sentinel threshold (core/buffer2d.py:23 of the JAX package)
VALID_DEPTH_MM = 50.0


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (plain floats)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


# Kinect v1 frame geometry (reference Kinect/Kinect.cpp:10-11).
KINECT_WIDTH = 640
KINECT_HEIGHT = 480


def default_kinect_intrinsics(
    width: int = KINECT_WIDTH, height: int = KINECT_HEIGHT
) -> Intrinsics:
    """Typical Kinect v1 intrinsics (ZPD=120mm, ZPPS≈0.1042mm -> f≈575.8),
    the widely used OpenNI default (reference Kinect/Kinect.cpp:89-95)."""
    f = 575.8157349582916
    return Intrinsics(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)


def normalized_rays(
    intr: Intrinsics, height: int, width: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """Unit-z ray map [H, W, 3] f32: (rx, ry, 1) with rx=(u-cx)/fx,
    ry=(cy-v)/fy (Projection_GPU.cu:3-19).  Computed in f32 in the same
    order as the JAX package."""
    f32 = torch.float32
    u = torch.arange(width, dtype=f32, device=device)[None, :]
    v = torch.arange(height, dtype=f32, device=device)[:, None]

    def c(x):  # f32 0-dim operand: a true division on every device
        return constant(float(x), f32, device)

    rx = ((u - c(intr.cx)) / c(intr.fx)).expand(height, width)
    ry = ((c(intr.cy) - v) / c(intr.fy)).expand(height, width)
    ones = torch.ones((height, width), dtype=f32, device=device)
    return torch.stack([rx, ry, ones], dim=-1)


def projective_to_real(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Depth map [..., H, W] (mm) -> point map [..., H, W, 3] (mm)
    (DimensionConvertor.h:36-43)."""
    h, w = depth.shape[-2:]
    rays = normalized_rays(intr, h, w, depth.device)
    return rays * depth[..., None]


def real_to_projective(points: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Point map [..., 3] (mm) -> (u, v, z); |z| < 1 gets the sentinel
    (u, v) = (-1, -1) (convert_rtp, DimensionConvertor.h:122-148)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    bad = z.abs() < 1.0
    safe_z = torch.where(bad, torch.ones_like(z), z)
    u = x / safe_z * intr.fx + intr.cx
    v = intr.cy - y / safe_z * intr.fy
    u = torch.where(bad, torch.full_like(u, -1.0), u)
    v = torch.where(bad, torch.full_like(v, -1.0), v)
    return torch.stack([u, v, z], dim=-1)
