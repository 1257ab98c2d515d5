"""Host milliseconds a step of run_stream's staging: the program's span
stream.stage (np.stack, the pinned copy, the copy stream's event), its
mean over the traced run's steps before the profiled stretch
(kdebench/program_trace.py)."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    return None if p is None else p.span_step_ms("stream.stage")
