"""Per-pixel covariance pyramid for CM normals: CUDA kernel wrapper, its
plain PyTorch version, and a launch counter.

Counterpart of the JAX package's ops/pallas_cov.py (cm_covariances) and of
the XLA sweep in ops/normals.py::cm_normals (direct_cov_all + _per_size).
Kernel source: csrc/cov.cu.  Both walk the taps of the nested windows in
ring_taps() order and keep the snapshot of each pixel's own window size, so
with FMA contraction off the kernel is bitwise equal to the plain version.
The kernel walks each ring as one row and one column (ring_walk spells out
its order) and stops after the pixel's own size.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch import _build
from kinectdepthmapenhancement_tpu_torch.ops import stencil
from kinectdepthmapenhancement_tpu_torch.utils import telemetry

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/cov.cu"
REPLACES = "kinectdepthmapenhancement_tpu/ops/pallas_cov.py:197"
launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
# the same launches by the width of the array launched on, "cm_covariance:w<W>"
# (chip_smoke.py clears it with launches)
launch_forms: Dict[str, int] = {}

MAX_RECT = 21  # ddsa = 20 + z/10 with z <= ~15 m caps the window at 21 px
MAX_R = MAX_RECT >> 1


def ring_taps() -> Dict[int, List[Tuple[int, int]]]:
    """Per-size NEW taps of the nested reference windows, in the exact
    accumulation order of the JAX package's direct_cov_all
    (pallas_cov.py:44-58)."""
    rings = {}
    prev: set = set()
    for s in range(2, MAX_RECT + 1):
        r2 = s >> 1
        taps = {(dy, dx) for dy in range(-r2, -r2 + s) for dx in range(-r2, -r2 + s)}
        rings[s] = sorted(taps - prev)
        prev = taps
    return rings


def ring_walk(s: int) -> List[Tuple[int, int]]:
    """The taps csrc/cov.cu adds going from size s - 1 to size s, in its
    order: with lo = -(s >> 1) and hi = lo + s - 1, for even s the row
    dy = lo then the column dx = lo below it, for odd s the column dx = hi
    then the row dy = hi; size 2 adds its centre tap last (its ring is the
    whole 2x2 window).  Equal to ring_taps()[s].  This is the kernel's
    specification, not a check of it: what holds csrc/cov.cu to this order
    is the card tests, which compare it bitwise with the plain version."""
    lo = -(s >> 1)
    hi = lo + s - 1
    row_top = [(lo, dx) for dx in range(lo, hi + 1)]
    col_left = [(dy, lo) for dy in range(lo + 1, hi + 1)]
    col_right = [(dy, hi) for dy in range(lo, hi)]
    row_bottom = [(hi, dx) for dx in range(lo, hi + 1)]
    if s % 2 == 0:
        return row_top + col_left + ([(0, 0)] if s == 2 else [])
    return col_right + row_bottom


def cm_covariances_plain(
    vertices_m: torch.Tensor, rect: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: vertices [B, H, W, 3] f32 metres (z == 0
    invalid), rect i32 [B, H, W] -> (cnt [B, H, W], cov [B, H, W, 6]).

    Incremental nested-window sweep: every tap is accumulated once for all
    sizes and the per-pixel (cnt, cov) snapshot is kept where rect == s
    (rect >= 21 at the largest size), as _per_size selects in the JAX
    package."""
    _, h, w, _ = vertices_m.shape
    valid_f = (vertices_m[..., 2] != 0.0).to(torch.float32)
    vpad = stencil.pad2d(vertices_m, MAX_R, 0.0)
    mpad = stencil.pad2d(valid_f, MAX_R, 0.0)
    a = [vertices_m[..., c] for c in range(3)]
    zero = torch.zeros_like(valid_f)
    cnt = zero
    s1 = [zero] * 3
    s2 = [zero] * 6
    out_cnt = zero
    out_cov = [zero] * 6
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    for s, taps in ring_taps().items():
        for dy, dx in taps:
            pv = stencil.shift(vpad, dy, dx, MAX_R, (h, w))
            m = stencil.shift(mpad, dy, dx, MAX_R, (h, w))
            res = [(pv[..., c] - a[c]) * m for c in range(3)]
            cnt = cnt + m
            s1 = [s1[c] + res[c] for c in range(3)]
            s2 = [s2[e] + res[i] * res[j] for e, (i, j) in enumerate(pairs)]
        n_s = torch.clamp_min(cnt, 1.0)
        sel = (rect >= s) if s == MAX_RECT else (rect == s)
        out_cnt = torch.where(sel, cnt, out_cnt)
        out_cov = [
            torch.where(sel, s2[e] - (s1[i] * s1[j]) / n_s, out_cov[e])
            for e, (i, j) in enumerate(pairs)
        ]
    return out_cnt, torch.stack(out_cov, dim=-1)


def cm_covariances(
    vertices_m: torch.Tensor, rect: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (count, 6 covariance entries) at each pixel's own window
    size: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if vertices_m.device.type == "cpu":
        return cm_covariances_plain(vertices_m, rect)
    b, h, w, _ = vertices_m.shape
    _build.check_tensor(vertices_m, "cov vertices", torch.float32, (b, h, w, 3))
    _build.check_tensor(rect, "cov rect", torch.int32, (b, h, w))
    dev = vertices_m.device
    cnt = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    cov = torch.empty((b, h, w, 6), dtype=torch.float32, device=dev)
    _build.launch(
        "kde_cov", [_build.PTR] * 4 + [_build.INT] * 3, dev,
        (vertices_m.data_ptr(), rect.data_ptr(), cnt.data_ptr(), cov.data_ptr(), b, h, w),
    )
    telemetry.count_launch(globals(), f"cm_covariance:w{w}")
    return cnt, cov
