"""Procedural RGB-D test scene (NumPy only).

A copy of make_noisy_scene and its helpers from the JAX package's
core/testdata.py: a piecewise-planar indoor-like scene (back wall, floor,
two boxes) rendered through the pinhole model, plus the reference's own
synthetic Kinect noise model (main.cpp:127-130).  Deterministic (fixed numpy
RNG seed); the arrays are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
)


def _plane_depth(
    intr: Intrinsics, h: int, w: int, n: np.ndarray, d: float
) -> np.ndarray:
    """z such that the 3-D point along each pixel ray lies on plane n.p = d."""
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    rx = (u - intr.cx) / intr.fx
    ry = (intr.cy - v) / intr.fy
    denom = n[0] * rx + n[1] * ry + n[2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    return d / denom


def make_scene(
    height: int = 480, width: int = 640, intr: Intrinsics | None = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (color u8 [H,W,3], depth f32 [H,W] mm) for a piecewise-planar scene."""
    intr = intr or default_kinect_intrinsics(width, height)
    rng = np.random.default_rng(seed)

    # back wall at z = 3000 mm
    depth = np.full((height, width), 3000.0)
    color = np.zeros((height, width, 3), np.float64)
    color[...] = (180.0, 170.0, 150.0)

    # floor plane at the image bottom (y-up camera convention); recedes
    # under the wall
    floor = _plane_depth(intr, height, width, np.array([0.0, -0.866, 0.5]), 1200.0)
    floor_mask = (floor > 0) & (floor < depth)
    depth = np.where(floor_mask, floor, depth)
    color[floor_mask] = (90.0, 110.0, 140.0)

    # box 1: frontal plane patch (feature positions scale with resolution)
    u = np.arange(width)[None, :]
    v = np.arange(height)[:, None]
    b1 = (
        (u > 0.19 * width) & (u < 0.44 * width)
        & (v > 0.29 * height) & (v < 0.69 * height)
    )
    b1 = b1 & (1800.0 < depth)
    depth = np.where(b1, 1800.0, depth)
    color[b1] = (200.0, 80.0, 70.0)

    # box 2: slanted plane patch
    slant = _plane_depth(intr, height, width, np.array([0.35, 0.0, 0.937]), 2100.0)
    b2 = (
        (u > 0.56 * width) & (u < 0.88 * width)
        & (v > 0.19 * height) & (v < 0.63 * height)
        & (slant > 0) & (slant < depth)
    )
    depth = np.where(b2, slant, depth)
    color[b2] = (70.0, 170.0, 90.0)

    # mild colour texture + sensor-style holes near depth edges
    tex = rng.normal(0.0, 6.0, size=(height, width, 3))
    color = np.clip(color + tex, 0, 255).astype(np.uint8)

    gy, gx = np.gradient(depth)
    edge = np.hypot(gx, gy) > 40.0
    holes = edge & (rng.random((height, width)) < 0.7)
    speckle = rng.random((height, width)) < 0.002
    depth = np.where(holes | speckle, 0.0, depth)

    return color, depth.astype(np.float32)


def make_noisy_scene(
    height: int = 480, width: int = 640, intr: Intrinsics | None = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(color, noisy_depth, ground_truth_depth) with the reference noise model."""
    color, gt = make_scene(height, width, intr, seed)
    rng = np.random.default_rng(seed + 1)
    variance = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    noisy = gt + rng.uniform(-1.0, 1.0, gt.shape) * variance
    noisy = np.where(gt == 0.0, 0.0, noisy).astype(np.float32)
    return color, noisy, gt
