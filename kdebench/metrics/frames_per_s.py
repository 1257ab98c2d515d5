"""Frames completed in the window over the window's seconds (first frame
pulled to run_stream's return)."""


def read(run):
    w = run.window
    return w.completed / w.seconds if w.seconds > 0 else None
