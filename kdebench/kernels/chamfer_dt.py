"""csrc/dt.cu's chamfer distance transform (ops/cuda_dt.py).

The least a round needs per pixel is 10 operations: as min(a + c, b + c) ==
min(a, b) + c exactly, the min of the 4 edge and of the 4 corner neighbours
(3 + 3), their costs added (2), and the min of those two and the pixel's
own value (2).  The rounds counted are those in which the map still
changes for these inputs, found by relaxing the reference's own discon-
tinuity map round by round (at most the call's rounds).  Bytes: the i32
map read, the f32 distances written.  Under the operations bound (row 2).
"""

import torch
import torch.nn.functional as F

from kdebench.peaks import nbytes, pixels
from kdebench.reference.ops.cuda_dt import _NEIGH, _init

PATTERN = r"^(?:void )?\(anonymous namespace\)::dt_kernel\b"
BOUND = "operations"


def rounds_changed(dci: torch.Tensor, iterations: int) -> int:
    """The rounds of the min-plus relaxation that change the map."""
    _, h, w = dci.shape
    dt = _init(dci)
    for k in range(iterations):
        pad = F.pad(dt, (1, 1, 1, 1), value=float("inf"))
        best = dt
        for dy, dx, c in _NEIGH:
            best = torch.minimum(best, pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] + c)
        if torch.equal(best, dt):
            return k
        dt = best
    return iterations


def count(call):
    dci, iterations = call.args[:2]
    return pixels(dci) * rounds_changed(dci, iterations) * 10, nbytes(dci, call.result)
