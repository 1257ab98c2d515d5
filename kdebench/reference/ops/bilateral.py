"""Bilateral-family depth filters: guide smoothing, JBF, MRF.

PyTorch counterpart of the JAX package's ops/bilateral.py:
  * cv::gpu::bilateralFilter on the colour guide (JointBilateralFilter.cu:285)
  * joint_bilateral_filtering (JointBilateralFilter.cu:4-83)
  * markov_random_field (MarkovRandomField.cu:4-40)

The numerical contracts are the JAX package's (invalid depth z <= 50 mm,
0 where there is no support, terms gated on their sigma — see that module's
docstring).  The JBF itself runs in the fused kernel of ops/cuda_bilateral.py
on the card and in its plain version on the CPU; the MRF, which the JAX
package leaves to XLA, is plain PyTorch on every device.

Image tensors carry a leading batch dimension: depth [B, H, W], colour
[B, H, W, 3].
"""

from __future__ import annotations

import torch

from ..core.camera import VALID_DEPTH_MM
from ..core.config import JBFParams, MRFParams
from ..ops import cuda_bilateral, stencil


def _color_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance over the (size-3) channel axis, in f32."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return stencil.dot3(d, d)


def guide_bilateral(color: torch.Tensor, p: JBFParams) -> torch.Tensor:
    """Colour-guide pre-smoothing, modelled on cv::gpu::bilateralFilter
    (square window, Gaussian space and squared-Euclidean colour terms,
    reflect-101 border, round half to even and saturate to u8).

    color: u8 [B, H, W, 3] -> u8 [B, H, W, 3]."""
    _, h, w, _ = color.shape
    window = p.guide_diameter
    r = window // 2
    cf = color.to(torch.float32)
    padded = stencil.pad_channels_last(cf, r, "reflect")
    space_coeff = -0.5 / (p.guide_spatial_sigma**2)
    color_coeff = -0.5 / (p.guide_color_sigma**2)

    num = torch.zeros_like(cf)
    den = torch.zeros_like(cf[..., 0])
    for dy, dx in stencil.offsets(window):
        nb = stencil.shift(padded, dy, dx, r, (h, w))
        e = cf - nb
        wgt = torch.exp(
            stencil.dot3(e, e) * color_coeff
            + (dy * dy + dx * dx) * space_coeff
        )
        num = num + nb * wgt[..., None]
        den = den + wgt
    out = num / den[..., None]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def joint_bilateral_filter(
    depth: torch.Tensor, color: torch.Tensor, p: JBFParams = JBFParams()
) -> torch.Tensor:
    """Two-pass cross-bilateral depth filter (JointBilateralFilter.cu:4-83).

    depth: f32 [B, H, W] mm; color: u8 [B, H, W, 3] (raw — the guide
    smoothing is applied here, as in JointBilateralFilter::Process)."""
    guide = guide_bilateral(color, p).to(torch.float32).contiguous()
    return _jbf_core(
        depth.contiguous(),
        guide,
        window=p.window,
        spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma,
        depth_sigma=p.depth_sigma,
    )


def _jbf_core(
    depth: torch.Tensor,
    guide: torch.Tensor,
    *,
    window: int,
    spatial_sigma: float,
    color_sigma: float,
    depth_sigma: float,
) -> torch.Tensor:
    """Both JBF passes on a pre-smoothed f32 guide: the kernel on the card,
    its plain version on the CPU (ops/cuda_bilateral.py)."""
    return cuda_bilateral.jbf(
        depth, guide, window=window, spatial_sigma=spatial_sigma,
        color_sigma=color_sigma, depth_sigma=depth_sigma,
    )


def markov_random_field(
    depth: torch.Tensor, color: torch.Tensor, p: MRFParams = MRFParams()
) -> torch.Tensor:
    """One weighted-average sweep of the MRF energy (MarkovRandomField.cu:4-40).

    z' = (z + sum lam * w_c * z_n) / (1 + sum lam * w_c),
    w_c = exp(-sigma_c * |dc|^2), lam = smooth_sigma, over the valid
    (z > 50 mm) neighbours of the window.  The raw colour image is the
    guide.  The colour weight is flushed below FLT_MIN, as XLA flushes it
    (stencil.flush_subnormal); every later factor keeps it normal.

    depth: f32 [B, H, W] mm; color: u8 [B, H, W, 3]."""
    _, h, w = depth.shape
    r = p.window // 2
    cf = color.to(torch.float32)
    dpad = stencil.pad2d(depth, r, 0.0)
    cpad = stencil.pad2d(cf, r, 0.0)

    num = depth
    den = torch.ones_like(depth)
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        nc = stencil.shift(cpad, dy, dx, r, (h, w))
        valid = nd > VALID_DEPTH_MM
        if p.color_sigma != 0.0:
            cfilt = stencil.flush_subnormal(torch.exp(-p.color_sigma * _color_dist2(cf, nc)))
        else:
            cfilt = torch.zeros_like(depth)
        filt = torch.where(valid, p.smooth_sigma * cfilt, 0.0)
        num = num + nd * filt
        den = den + filt
    return num / den
