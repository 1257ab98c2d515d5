"""Set-up: process start to the window's first frame (imports, the card's
context, the kernel library, the frames, the cell's compiled call warmed,
captured and replayed once)."""


def read(run):
    return run.setup_s
