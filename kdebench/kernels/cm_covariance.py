"""csrc/cov.cu's CM-normals covariance sweep (ops/cuda_cov.py).

Each pixel needs the taps of its own window, min(rect, 21)^2 of them (none
below a window of 2), read from the reference's own smoothing map (the
call's rect); per tap 22 operations: 3 residuals (3 subs, 3 muls by the
validity factor), the count, 3 first and 6 second moments (6 products).
Bytes: the points and the window map read, the count and the 6 entries
written.  Under the operations bound (row 3).
"""

import torch

from kdebench.peaks import nbytes

PATTERN = r"^(?:void )?\(anonymous namespace\)::cov_kernel\b"
BOUND = "operations"


def count(call):
    vertices, rect = call.args[:2]
    r = rect.clamp(max=21).to(torch.float64)
    taps = float(torch.where(rect >= 2, r * r, torch.zeros_like(r)).sum())
    return 22 * taps, nbytes(vertices, rect, call.result)
