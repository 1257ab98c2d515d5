"""csrc/nasp.cu's per-pixel cluster-table gather (ops/cuda_nasp.py:
label_cell_gather).

No arithmetic; bytes: the labels and the cluster table read, each pixel's
row written.  Under the bytes bound (row 8).
"""

from kdebench.peaks import nbytes

PATTERN = r"^(?:void )?\(anonymous namespace\)::label_gather_kernel\b"
BOUND = "bytes"


def count(call):
    labels, table = call.args[:2]
    return 0, nbytes(labels, table, call.result)
