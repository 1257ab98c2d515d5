"""Device milliseconds a frame of the global route's assignment sweeps:
the program's stamps of stage slic.assign (one a sweep: a NASP iteration
on a frame that grid 15x20 does not divide, each SP / DASP iteration, ten
a SPDSP frame), summed over the traced run's replays before the profiled
stretch, over their frames (kdebench/program_trace.py); None where the
program stamps no such stage."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    return None if p is None else p.stage_frame_ms("slic.assign")
