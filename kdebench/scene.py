"""The traffic's frames: one piecewise-planar indoor scene a run, seen by a
Kinect through the reference's synthetic depth noise, in NumPy on the host.

make_scene and the noise model are copies of make_scene / make_noisy_scene
(kinectdepthmapenhancement_tpu_torch/core/testdata.py at 327a054, themselves
copies of the JAX package's): a back wall at 3 m, a floor, a frontal and a
slanted box, colour texture and sensor-style holes at depth edges; noise
uniform in +-0.45 * 2.85 * (z / 10)^2 / 1e4 mm (main.cpp:127-130).  Here
the scene is drawn from the run's seed and each frame is a fresh noise draw
of it, so every seed gives the same sizes and the same amount of work.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float


def _plane_depth(intr: Intrinsics, h: int, w: int, n: np.ndarray, d: float) -> np.ndarray:
    """z such that the 3-D point along each pixel ray lies on plane n.p = d."""
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    rx = (u - intr.cx) / intr.fx
    ry = (intr.cy - v) / intr.fy
    denom = n[0] * rx + n[1] * ry + n[2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    return d / denom


def make_scene(height: int, width: int, intr: Intrinsics,
               rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(color u8 [H, W, 3], ground-truth depth f32 [H, W] mm)."""
    depth = np.full((height, width), 3000.0)
    color = np.zeros((height, width, 3), np.float64)
    color[...] = (180.0, 170.0, 150.0)

    floor = _plane_depth(intr, height, width, np.array([0.0, -0.866, 0.5]), 1200.0)
    floor_mask = (floor > 0) & (floor < depth)
    depth = np.where(floor_mask, floor, depth)
    color[floor_mask] = (90.0, 110.0, 140.0)

    u = np.arange(width)[None, :]
    v = np.arange(height)[:, None]
    b1 = (
        (u > 0.19 * width) & (u < 0.44 * width)
        & (v > 0.29 * height) & (v < 0.69 * height)
    )
    b1 = b1 & (1800.0 < depth)
    depth = np.where(b1, 1800.0, depth)
    color[b1] = (200.0, 80.0, 70.0)

    slant = _plane_depth(intr, height, width, np.array([0.35, 0.0, 0.937]), 2100.0)
    b2 = (
        (u > 0.56 * width) & (u < 0.88 * width)
        & (v > 0.19 * height) & (v < 0.63 * height)
        & (slant > 0) & (slant < depth)
    )
    depth = np.where(b2, slant, depth)
    color[b2] = (70.0, 170.0, 90.0)

    tex = rng.normal(0.0, 6.0, size=(height, width, 3))
    color = np.clip(color + tex, 0, 255).astype(np.uint8)

    gy, gx = np.gradient(depth)
    edge = np.hypot(gx, gy) > 40.0
    holes = edge & (rng.random((height, width)) < 0.7)
    speckle = rng.random((height, width)) < 0.002
    depth = np.where(holes | speckle, 0.0, depth)
    return color, depth.astype(np.float32)


def noisy(gt: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One sensor frame of the ground truth: the reference's noise model,
    0 where the truth is a hole."""
    variance = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    frame = gt + rng.uniform(-1.0, 1.0, gt.shape) * variance
    return np.where(gt == 0.0, 0.0, frame).astype(np.float32)


def frames(seed: int, height: int, width: int, intr: Intrinsics,
           draws: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(colour, `draws` noisy depth frames) of the seed's scene."""
    root = np.random.SeedSequence(seed % 2**64)
    scene_seq, *draw_seqs = root.spawn(1 + draws)
    color, gt = make_scene(height, width, intr, np.random.default_rng(scene_seq))
    return color, [noisy(gt, np.random.default_rng(s)) for s in draw_seqs]
