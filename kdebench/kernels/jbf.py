"""csrc/jbf.cu's fused joint bilateral filter (ops/cuda_bilateral.py).

Per pixel and tap 17 operations of the depth and colour weights and 25 of
the range terms and sums (an expf or a division counted as one), over the
window's taps; bytes: the depth and the pre-smoothed guide read once, the
filtered depth written once.  Under the operations bound at the path's
shapes (PERF.md's kernel table, row 1).
"""

from kdebench.peaks import nbytes, pixels

PATTERN = r"^(?:void )?\(anonymous namespace\)::jbf_kernel\b"
BOUND = "operations"


def count(call):
    depth, guide = call.args[:2]
    taps = call.kwargs["window"] ** 2
    return pixels(depth) * taps * (17 + 25), nbytes(depth, guide, call.result)
