"""Plane projection and optimisation of the KDE path.

PyTorch counterpart of the KDE part of the JAX package's ops/plane.py
(Projection_GPU in the reference):
  * set_pseudo_depth_map — project each pixel onto its merged cluster's
    plane along the unit ray (setPsuedoDepth, Projection_GPU.cu:20-48);
  * plane_fit_residual — the plane-confidence gate (spec extension);
  * variance_optimization — blend toward the plane for big coherent
    clusters (Projection_GPU.cu:174-196);
  * depth_bilateral — 7x7 depth-Gaussian cleanup (Projection_GPU.cu:198-227).

Per-merged-cluster tables are gathered as (table[rep])[original label]
through the cell-local index over the ORIGINAL superpixel labels.  Depths
are in millimetres.  Tensors carry a leading batch dimension.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import ProjectionParams
from kinectdepthmapenhancement_tpu_torch.ops import stencil, tables
from kinectdepthmapenhancement_tpu_torch.ops.slic import _CellIndex

PI_8 = 3.141592653 / 8.0
COS_PI_8 = math.cos(PI_8)


def _project(nd: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """z = |d / (a*rx + b*ry + c)| along the unit-z ray; returns [..., 3]."""
    a, b, c, d = nd[..., 0], nd[..., 1], nd[..., 2], nd[..., 3]
    denom = a * rays[..., 0] + b * rays[..., 1] + c
    z = (d / torch.where(denom == 0.0, torch.full_like(denom, 1e-30), denom)).abs()
    return rays * z[..., None]


def _by_rep(index: _CellIndex, table: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Per-pixel rows of a per-merged-cluster table [B, K, F]:
    (table[rep])[original label] through the cell-local index."""
    return index.gather(tables.gather(table, rep))


def set_pseudo_depth_map(
    points: torch.Tensor,
    rays: torch.Tensor,
    nd_map: torch.Tensor,
    labels: torch.Tensor,
    variance: torch.Tensor,
    *,
    index: _CellIndex,
    rep: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel nd map + variance gate (Projection_GPU.cu:20-48):
    plane-project where label > -1 and acos(variance) < pi/8, else pass the
    input points through.  variance > 1 is clamped to 1 (documented fix in
    the JAX package: a fully coherent cluster is accepted)."""
    var_map = _by_rep(index, variance[..., None], rep)[..., 0]
    var = torch.clamp_max(var_map, 1.0)
    gate = (labels > -1) & (var > COS_PI_8)
    proj = _project(nd_map, rays)
    return torch.where(gate[..., None], proj, points)


def plane_fit_residual(
    points: torch.Tensor,
    plane_fitted: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    *,
    index: _CellIndex,
    rep: torch.Tensor,
) -> torch.Tensor:
    """Per-cluster relative RMS plane-fit residual [B, K]: sqrt(mean over
    member pixels with valid depth of ((z_plane - z)/z)^2).  Pixel sums are
    keyed by the original labels (`index`) and folded K-side by `rep`; the
    merged `labels` are rep[original] of the same frame."""
    del labels  # keyed through index.labels and rep
    z = points[..., 2]
    zp = plane_fitted[..., 2]
    ok = (z > VALID_DEPTH_MM) & (index.labels >= 0)
    e = (zp - z) / torch.clamp_min(z, 1.0)
    rel2 = torch.where(ok, e * e, torch.zeros_like(e))
    feats = torch.stack([rel2, ok.to(torch.float32)], dim=-1)
    s_orig = index.segment_sum(feats, index.labels >= 0)   # [B, K, 2]
    sums = tables.segment_sum(s_orig, rep, k)              # tiny fold
    return torch.sqrt(sums[..., 0] / torch.clamp_min(sums[..., 1], 1.0))


def variance_optimization(
    optimized: torch.Tensor,
    plane_fitted: torch.Tensor,
    labels: torch.Tensor,
    variance: torch.Tensor,
    sizes: torch.Tensor,
    *,
    min_cluster_size: int = 1300,
    agree_tight: float = 0.01,
    agree_loose: float = 0.03,
    fit_residual: Optional[torch.Tensor] = None,
    max_fit_residual: float = 0.0,
    index: _CellIndex,
    rep: torch.Tensor,
) -> torch.Tensor:
    """variance_optimization (Projection_GPU.cu:174-196): where the plane
    fit agrees with the current depth within 3%, a big (> 1300 px) coherent
    cluster snaps (within 1%) or blends (by variance) toward the plane.
    fit_residual ([B, K], optional): clusters whose plane mis-fits their own
    depths by more than max_fit_residual are left untouched (spec extension;
    None is the reference behaviour)."""
    zo = optimized[..., 2]
    zp = plane_fitted[..., 2]
    diff = (zo - zp).abs()
    cols = [variance[..., None], sizes.to(torch.float32)[..., None]]
    if fit_residual is not None:
        cols.append(fit_residual[..., None])
    g = _by_rep(index, torch.cat(cols, dim=-1), rep)
    var, size = torch.clamp_max(g[..., 0], 1.0), g[..., 1]
    gate = (
        (zp > VALID_DEPTH_MM)
        & (diff < zo * agree_loose)
        & (labels > -1)
        & (var > COS_PI_8)
        & (size > min_cluster_size)
    )
    if fit_residual is not None:
        gate = gate & (g[..., 2] < max_fit_residual)
    snap = diff < zo * agree_tight
    blended = zp * var + zo * (1.0 - var)
    new_z = torch.where(gate, torch.where(snap, zp, blended), zo)
    out = optimized.clone()
    out[..., 2] = new_z
    return out


def depth_bilateral(
    optimized: torch.Tensor, rays: torch.Tensor, p: ProjectionParams = ProjectionParams()
) -> torch.Tensor:
    """bilateralfilter (Projection_GPU.cu:198-227): 7x7 spatial x depth
    Gaussian on z; x, y recomputed from the rays; 0 where no valid support."""
    _, h, w, _ = optimized.shape
    r = p.window // 2
    spatial = stencil.gaussian_spatial_filter(p.window, p.spatial_sigma, optimized.device)
    z = optimized[..., 2]
    zpad = stencil.pad2d(z, r, 0.0)
    zero = torch.zeros_like(z)
    num = zero
    den = zero
    for dy, dx in stencil.offsets(p.window):
        nz = stencil.shift(zpad, dy, dx, r, (h, w))
        ok = nz > VALID_DEPTH_MM
        e = nz - z
        filt = torch.exp(-(e * e) / (2.0 * p.depth_sigma**2))
        filt = filt * spatial[dy + r, dx + r]
        filt = torch.where(ok, filt, zero)
        num = num + nz * filt
        den = den + filt
    empty = den == 0.0
    new_z = torch.where(empty, zero, num / torch.where(empty, torch.ones_like(den), den))
    return rays * new_z[..., None]
