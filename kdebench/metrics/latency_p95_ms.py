"""95th percentile of the latency of every frame of the window: from the
frame's due time on the sensor's clock to the end of its points'
readback (900 frames at 30 s, 45 beyond it)."""

import numpy as np


def read(run):
    lat = run.window.latencies_ms
    return float(np.percentile(lat, 95)) if lat else None
