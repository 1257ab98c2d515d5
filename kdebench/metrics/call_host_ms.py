"""Host milliseconds a step of the compiled call: the program's span
stream.call around run_stream's step (core/jit's jit.key, jit.copy_in,
jit.launch and jit.clone), its mean over the traced run's steps before the
profiled stretch (kdebench/program_trace.py)."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    return None if p is None else p.span_step_ms("stream.call")
