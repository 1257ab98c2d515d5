"""Device milliseconds a frame of the global label index taken by a cond
(slic.with_capped_index's ELSE branch, _GlobalIndex, where labels left
their cell-local cap): the program's stamps of stage slic.global_index,
summed over the traced run's replays before the profiled stretch, over
their frames (kdebench/program_trace.py).  Stamps fire only in the branch
the device takes, so a run whose conds all took the cell-local branch
(stage slic.cell_index stamped, slic.global_index never) reads 0.0; a run
with neither stamped has nothing to read."""

from kdebench import program_trace


def read(run):
    p = program_trace.program(run)
    if p is None:
        return None
    ms = p.stage_frame_ms("slic.global_index")
    if ms is None and p.stage_frame_ms("slic.cell_index") is not None:
        return 0.0
    return ms
