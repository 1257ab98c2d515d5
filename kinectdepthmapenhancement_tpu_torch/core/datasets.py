"""Sensor models for synthetic RGB-D data (NumPy only).

A copy of kinect_v1_sensor_model from the JAX package's core/datasets.py:
a physically-faithful Kinect v1 synthesizer (triangulation disparity
quantization + axial noise).  The quantization banding it reproduces is the
dominant Kinect v1 artifact the enhancement pipelines exist to remove (the
reference's own uniform-noise model, main.cpp:127-130, has none).  The
dataset loaders of that module are not ported yet.
"""

from __future__ import annotations

import numpy as np

# Kinect v1 triangulation constants: baseline 75 mm, depth-camera focal
# ~580 px, disparity measured in 1/8-pixel steps (Khoshelham & Elberink,
# "Accuracy and Resolution of Kinect Depth Data", Sensors 2012).
KINECT_BASELINE_MM = 75.0
KINECT_FOCAL_PX = 580.0
KINECT_DISPARITY_STEP = 1.0 / 8.0


def kinect_v1_sensor_model(
    depth_mm: np.ndarray,
    rng: np.random.Generator,
    *,
    disparity_noise_px: float = 0.06,
    max_range_mm: float = 10000.0,
) -> np.ndarray:
    """Simulate Kinect v1 measurement of a true depth map: the sensor
    triangulates disparity d = b*f/z, jitters it by ~0.06 px (empirical
    plane-fit residuals), QUANTIZES to 1/8-px steps, and back-projects.
    Output has the characteristic depth banding (step ~ z^2/(8 b f):
    ~2.4 mm at 1 m, ~22 mm at 3 m) and z^2-growing axial noise.  Invalid
    (<=0 or out-of-range) pixels return 0."""
    z = np.asarray(depth_mm, np.float64)
    valid = (z > 0) & (z < max_range_mm)
    bf = KINECT_BASELINE_MM * KINECT_FOCAL_PX
    disp = np.where(valid, bf / np.where(valid, z, 1.0), 0.0)
    disp = disp + rng.normal(0.0, disparity_noise_px, z.shape)
    disp = np.round(disp / KINECT_DISPARITY_STEP) * KINECT_DISPARITY_STEP
    ok = valid & (disp > bf / max_range_mm)
    out = np.where(ok, bf / np.where(ok, disp, 1.0), 0.0)
    return out.astype(np.float32)
