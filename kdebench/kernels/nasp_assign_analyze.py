"""csrc/nasp.cu's fused first NASP assignment and analyze sums
(ops/cuda_nasp.py: nasp_assign_and_analyze).

Per pixel and in-grid candidate 33 operations (colour 8, pixel 7, depth 2,
weighting 7, normal dot 5, normal term 3, the running argmin's compare 1),
per out-of-grid candidate 1; per pixel 5 (its depth and normal validity,
the invalid-depth override); per cell and in-grid candidate 4 (the
candidate's depth and normal validity); per labelled pixel of the
reference's own labels the 16 analyze features and their 13 sums.  Bytes:
the colour, point and normal planes and the candidate fields read, the
labels, distances and partial sums written.  Under the operations bound
(row 5).
"""

from kdebench.peaks import nbytes, pixels
from kdebench.reference.ops.cuda_nasp import cand_grid, candidate_offsets

PATTERN = r"^(?:void )?\(anonymous namespace\)::assign_analyze_kernel\b"
BOUND = "operations"


def count(call):
    color_f, points, normals, cand_fields = call.args[:4]
    rows, cols, r = call.kwargs["rows"], call.kwargs["cols"], call.kwargs["r"]
    labels = call.result[0]
    b, h, w = labels.shape
    n_cand = (2 * r) ** 2
    n_in = (cand_grid(rows, cols, candidate_offsets(r), labels.device) >= 0).sum(-1).double()
    per_cell = (w // cols) * (h // rows) * (33 * n_in + (n_cand - n_in)) + 4 * n_in
    labelled = int((labels >= 0).sum())
    ops = b * float(per_cell.sum()) + 5 * pixels(color_f) + (16 + 13) * labelled
    return ops, nbytes(color_f, points, normals, cand_fields, call.result)
