"""Device idle between two replays, ms a step: from one replay's jit.graph
exit stamp to the next one's entry stamp (the program's stamps, on the
device's clock), the mean over the traced run's steps before the profiled
stretch.  The log names the innermost program span open over each gap
(kdebench/program_trace.py)."""

import numpy as np

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    if p is None or p.problems or p.before < 2:
        return None
    return float(np.mean(p.gap_ms[:p.before - 1]))
