"""Device milliseconds a frame of SPDSP's per-cluster PCA planes and
pseudo-depth (the ERS labels' index cond included): the program's stamps
of stage spdsp.planes, summed over the traced run's replays before the
profiled stretch, over their frames (kdebench/program_trace.py)."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    return None if p is None else p.stage_frame_ms("spdsp.planes")
