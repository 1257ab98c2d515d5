"""csrc/nasp.cu's NASP update sums (ops/cuda_nasp.py: nasp_cell_sums).

Per labelled pixel of the reference's own labels: in the weighted mode the
window 6, normal validity 3, colour weight 12, pixel weight 7, product 2,
normal dot 6, accept 3 and features 12 operations and the 14 sums; in the
analyze mode the window 6, validity 4 and features 6 and the 13 sums.
Bytes: the labels, the colour, point and normal planes and the candidate
fields read, the partial sums written.  Under the bytes bound (row 6).
"""

from kdebench.peaks import nbytes

PATTERN = r"^(?:void )?\(anonymous namespace\)::nasp_sums_kernel\b"
BOUND = "bytes"
PER_PIXEL = {"weighted": 51 + 14, "analyze": 16 + 13}


def count(call):
    labels, color_f, points, normals, fields = call.args[:5]
    labelled = int((labels >= 0).sum())
    ops = labelled * PER_PIXEL[call.kwargs["mode"]]
    return ops, nbytes(labels, color_f, points, normals, fields, call.result)
