"""csrc/nasp.cu's per-cell label sums (ops/cuda_nasp.py: label_cell_sums).

One add per pixel and feature; bytes: the labels and the pre-masked
features read, the partial sums written.  Under the bytes bound (row 7).
"""

from kdebench.peaks import nbytes, pixels

PATTERN = r"^(?:void )?\(anonymous namespace\)::label_sums_kernel\b"
BOUND = "bytes"


def count(call):
    labels, feats = call.args[:2]
    return pixels(feats) * feats.shape[-1], nbytes(labels, feats, call.result)
