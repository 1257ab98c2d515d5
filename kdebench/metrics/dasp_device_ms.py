"""Device milliseconds a frame of the colour and the depth SLIC (the DASP
variant, 5 iterations each, their later iterations' conds included): the
program's stamps of stages rgbf.color_slic and rgbf.depth_slic, summed over
the traced run's replays before the profiled stretch, over their frames
(kdebench/program_trace.py); None unless both are stamped."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    if p is None:
        return None
    ms = [p.stage_frame_ms(s) for s in ("rgbf.color_slic", "rgbf.depth_slic")]
    return None if None in ms else sum(ms)
