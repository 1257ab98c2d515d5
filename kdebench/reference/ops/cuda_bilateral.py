"""The joint bilateral filter's plain PyTorch version (the port's
ops/cuda_bilateral.py without its CUDA wrapper, launch counter and
spatial table).  `jbf` is the plain version, recorded (record.py).
"""

from __future__ import annotations

import torch

from ..core.camera import VALID_DEPTH_MM
from .. import record
from ..ops import stencil

def jbf_plain(
    depth: torch.Tensor,
    guide: torch.Tensor,
    *,
    window: int,
    spatial_sigma: float,
    color_sigma: float,
    depth_sigma: float,
) -> torch.Tensor:
    """Plain PyTorch version: depth [B, H, W] f32 mm, guide [B, H, W, 3] f32
    (pre-smoothed) -> [B, H, W] f32.  The JAX package's _jbf_core op for op."""
    _, h, w = depth.shape
    r = window // 2
    spatial = stencil.gaussian_spatial_filter(window, spatial_sigma, depth.device)
    dpad = stencil.pad2d(depth, r, 0.0)
    gpad = stencil.pad2d(guide, r, 0.0)
    color_c2 = 2.0 * color_sigma**2
    depth_c2 = 2.0 * depth_sigma**2

    flush = stencil.flush_subnormal

    def color_filter(nb_guide):
        e = guide - nb_guide
        return flush(torch.exp(stencil.div_const(-stencil.dot3(e, e), color_c2)))

    # terms are gated on their SIGMA, not their value (JAX ops/bilateral.py
    # docstring: the reference's value-guards are a computed-or-not proxy);
    # each weight factor and product flushes subnormals as XLA does

    # pass 1: spatial x colour weighted mean of valid depth
    zero = torch.zeros_like(depth)
    wsum = zero
    dsum = zero
    for dy, dx in stencil.offsets(window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        ng = stencil.shift(gpad, dy, dx, r, (h, w))
        valid = nd > VALID_DEPTH_MM
        filt = spatial[dy + r, dx + r].expand_as(depth)
        if color_sigma != 0.0:
            filt = flush(filt * color_filter(ng))
        filt = torch.where(valid, filt, zero)
        dsum = dsum + nd * filt
        wsum = wsum + filt
    mean = dsum / torch.where(wsum > 0.0, wsum, torch.ones_like(wsum))

    # pass 2: spatial x colour x depth (vs the pass-1 mean)
    num = zero
    den = zero
    for dy, dx in stencil.offsets(window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        ng = stencil.shift(gpad, dy, dx, r, (h, w))
        valid = nd > VALID_DEPTH_MM
        filt = spatial[dy + r, dx + r].expand_as(depth)
        if color_sigma != 0.0:
            filt = flush(filt * color_filter(ng))
        if depth_sigma != 0.0:
            e = nd - mean
            filt = flush(filt * flush(torch.exp(stencil.div_const(-(e * e), depth_c2))))
        filt = torch.where(valid, filt, zero)
        num = num + nd * filt
        den = den + filt
    nz = den != 0.0
    out = torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)), zero)
    return torch.where(wsum > 0.0, out, zero)


jbf = record.recorded("jbf", jbf_plain)
