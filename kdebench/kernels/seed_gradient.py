"""csrc/seed_gradient.cu's seed-sampling gradient (ops/cuda_gradient.py),
in its NASP form (with normals) or its colour form.

Per pixel and tap of the 11x11 window 20 operations in the NASP form and
12 in the colour form (a sqrt counted as one); bytes: the colour (and
normal) planes read, the gradient written.  Under the operations bound
(row 4).
"""

from kdebench.peaks import nbytes, pixels

PATTERN = r"^(?:void )?\(anonymous namespace\)::grad_kernel\b"
BOUND = "operations"


def count(call):
    color_f = call.args[0]
    normals = call.args[1] if len(call.args) > 1 else call.kwargs.get("normals")
    per_tap = 20 if normals is not None else 12
    return pixels(color_f) * 121 * per_tap, nbytes(color_f, normals, call.result)
