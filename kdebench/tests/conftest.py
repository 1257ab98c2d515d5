"""Shared set-up of the benchmark's own tests: a small cell on the CPU."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def small(cell, *, rows=3, cols=4, height=96, width=128):
    """The cell at a size the CPU runs in seconds: the frame and the grid
    cut (the overrides under the pipeline's name), the intrinsics scaled
    with the frame."""
    from kdebench import harness

    s = width / cell.config["width"]
    intr = cell.config["intrinsics"]
    cell.config = dict(cell.config, height=height, width=width,
                       intrinsics={"fx": intr["fx"] * s, "fy": intr["fy"] * s,
                                   "cx": width / 2.0, "cy": height / 2.0})
    cell.config[harness.pipeline_name(cell.config)] = {"grid": {"rows": rows, "cols": cols}}
    return cell


@pytest.fixture
def small_cell():
    from kdebench import harness

    def make(workload, **kw):
        return small(harness.resolve(workload), **kw)

    return make
