"""The card's published peaks and the least time a kernel's work could take.

One H100 SXM at 700 W (NVIDIA's data sheet): HBM3 at 3.35 TB/s, and
67 TFLOP/s in f32 outside the tensor cores.  The f32 rate counts an FMA as
two operations; the port's kernels are built with -fmad=false and issue
separate adds and muls, at half that rate, but the same work could be done
with FMAs, so the bound uses the published rate (chip_smoke.py's bound_ms,
copied here).
"""

from __future__ import annotations

from typing import Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def least_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, "operations" | "bytes"): each input read and each output
    written once at the memory rate, or the operations at the f32 rate,
    whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped; tuples and lists flattened)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def pixels(t: torch.Tensor) -> int:
    """B * H * W of a [B, H, W, ...] tensor."""
    return t.shape[0] * t.shape[1] * t.shape[2]
