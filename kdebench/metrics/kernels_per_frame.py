"""Kernels a frame launched by the replays: the program's counter
jit.kernels (each replay's kernel nodes, counted from its graph at the
capture, stamps left out) over the traced run's steps before the profiled
stretch, over their frames (kdebench/program_trace.py)."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    if p is None or p.before == 0 or not p.kernels[:p.before].all():
        return None
    return float(p.kernels[:p.before].sum() / (p.before * p.batch))
