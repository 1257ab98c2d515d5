"""Device milliseconds a frame of the edge-refined superpixels: the
program's stamps of stage rgbf.ers, summed over the traced run's replays
before the profiled stretch, over their frames (kdebench/program_trace.py)."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    return None if p is None else p.stage_frame_ms("rgbf.ers")
