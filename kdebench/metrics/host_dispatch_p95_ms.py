"""95th percentile of a step's host dispatch on the sensor's path: from
the source handing over the step's last frame to run_stream handing its
points to on_outputs (the pinned staging, the compiled call's key, input
copies, replay launch and output clones), over the traced run's steps
before its profiled stretch (the profiler slows the host path inside it).
The host's share of the latency tail."""

import numpy as np


def read(run):
    ms = (run.untraced_host_ms or {}).get("dispatch")
    return float(np.percentile(ms, 95)) if ms and len(ms) >= 200 else None
