"""Median latency of every frame of the window: from the frame's due time
on the sensor's clock to the end of its points' readback."""

import numpy as np


def read(run):
    lat = run.window.latencies_ms
    return float(np.percentile(lat, 50)) if lat else None
