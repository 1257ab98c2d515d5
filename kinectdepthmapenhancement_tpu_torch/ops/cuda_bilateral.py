"""Fused two-pass joint bilateral filter: CUDA kernel wrapper, its plain
PyTorch version, and a launch counter.

Counterpart of the JAX package's ops/pallas_bilateral.py (jbf_pallas), which
is bit-identical to the XLA _jbf_core the JAX kde_pipeline runs.  Kernel
source: csrc/jbf.cu.  The kernel takes its spatial weights by value, from
a table built once per (window, sigma, device) (spatial_table), so a call
is one device activity.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch import _build
from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.ops import stencil
from kinectdepthmapenhancement_tpu_torch.utils import telemetry

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/jbf.cu"
REPLACES = "kinectdepthmapenhancement_tpu/ops/pallas_bilateral.py:108"
launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
# the same launches by the width of the array launched on, "jbf:w<W>"
# (chip_smoke.py clears it with launches)
launch_forms: Dict[str, int] = {}

_ARGTYPES = (
    [_build.PTR] * 4 + [_build.INT] * 4 + [_build.FLOAT] * 2 + [_build.INT] * 2
)
# (window, spatial_sigma, device) -> the spatial table, flat, on the host
_spatial_tables: Dict[Tuple[int, float, torch.device], ctypes.Array] = {}


def spatial_table(window: int, spatial_sigma: float, device) -> ctypes.Array:
    """The kernel's spatial weights: stencil.gaussian_spatial_filter's
    [window, window] f32 table, built once per (window, sigma, device) on
    `device` (so with the bits the plain version uses there) and kept on the
    host, flat, since the kernel takes it by value.  Later calls build
    nothing and launch nothing on the device."""
    key = (window, float(spatial_sigma), torch.device(device))
    table = _spatial_tables.get(key)
    if table is None:
        flat = stencil.gaussian_spatial_filter(window, spatial_sigma, key[2]).reshape(-1).cpu()
        table = (ctypes.c_float * flat.numel())()
        ctypes.memmove(table, flat.data_ptr(), flat.numel() * flat.element_size())
        _spatial_tables[key] = table
    return table


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


def jbf(
    depth: torch.Tensor,
    guide: torch.Tensor,
    *,
    window: int,
    spatial_sigma: float,
    color_sigma: float,
    depth_sigma: float,
) -> torch.Tensor:
    """Fused JBF: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  depth [B, H, W] f32 mm, guide [B, H, W, 3] f32."""
    kw = dict(
        window=window, spatial_sigma=spatial_sigma, color_sigma=color_sigma,
        depth_sigma=depth_sigma,
    )
    if depth.device.type == "cpu":
        return jbf_plain(depth, guide, **kw)
    b, h, w = depth.shape
    _build.check_tensor(depth, "jbf depth", torch.float32, (b, h, w))
    _build.check_tensor(guide, "jbf guide", torch.float32, (b, h, w, 3))
    table = spatial_table(window, spatial_sigma, depth.device)
    out = torch.empty_like(depth)
    _build.launch(
        "kde_jbf", _ARGTYPES, depth.device,
        (depth.data_ptr(), guide.data_ptr(), table, out.data_ptr(), b, h, w, window // 2,
         2.0 * color_sigma**2, 2.0 * depth_sigma**2,
         int(color_sigma != 0.0), int(depth_sigma != 0.0)),
    )
    telemetry.count_launch(globals(), f"jbf:w{w}")
    return out
