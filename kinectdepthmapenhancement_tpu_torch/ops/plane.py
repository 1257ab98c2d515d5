"""Plane fitting, projection and optimisation.

PyTorch counterpart of the JAX package's ops/plane.py (Projection_GPU,
Projection_PCA and the host PCA stage in the reference):
  * set_pseudo_depth_map — project each pixel onto its merged cluster's
    plane along the unit ray (setPsuedoDepth, Projection_GPU.cu:20-48);
  * set_pseudo_depth_cluster / set_pseudo_depth_normals — the per-cluster
    nd and the normals + centres overloads (Projection_GPU.cu:50-115,
    Projection_PCA.cu:20-48; SPDSP and TOF);
  * pca_planes — the per-cluster plane fit that replaces the reference's
    host cv::PCA stage (SPDepthSuperResolution.cpp:82-142);
  * mrf_optimization — 20 Jacobi sweeps of the 5x5 plane-anchored
    smoother (Projection_GPU.cu:139-172; SPDSP);
  * eigenvalue_optimization — the PCA variant's blend (present but
    disabled in the reference, Projection_PCA.cu:76-108);
  * plane_fit_residual — the plane-confidence gate (spec extension);
  * variance_optimization — blend toward the plane for big coherent
    clusters (Projection_GPU.cu:174-196);
  * plane_hole_fill — label-consistent plane fill of sensor dropouts
    (spec extension, KDEConfig.fill_holes);
  * depth_bilateral — 7x7 depth-Gaussian cleanup (Projection_GPU.cu:198-227).

Per-merged-cluster tables are gathered as (table[rep])[original label]
through the label index over the ORIGINAL superpixel labels
(slic.label_index: cell-local, or global where the labels have no
locality); per-cluster ones through the index over the labels they key.
Every product runs in f32 with TF32 off (tables.exact_matmul).  Depths are
in millimetres.  Tensors carry a leading batch dimension.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import ProjectionParams
from kinectdepthmapenhancement_tpu_torch.core.device import constant
from kinectdepthmapenhancement_tpu_torch.ops import stencil, tables
from kinectdepthmapenhancement_tpu_torch.ops.normals import smallest_eigenvector
from kinectdepthmapenhancement_tpu_torch.ops.slic import LabelIndex

PI_8 = 3.141592653 / 8.0
COS_PI_8 = math.cos(PI_8)


def _project(nd: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """z = |d / (a*rx + b*ry + c)| along the unit-z ray; returns [..., 3]."""
    a, b, c, d = nd[..., 0], nd[..., 1], nd[..., 2], nd[..., 3]
    denom = a * rays[..., 0] + b * rays[..., 1] + c
    z = (d / torch.where(denom == 0.0, torch.full_like(denom, 1e-30), denom)).abs()
    return rays * z[..., None]


def by_merged_label(table: torch.Tensor, index: LabelIndex, rep: torch.Tensor) -> torch.Tensor:
    """Per-pixel rows [B, H, W, F] of a per-merged-cluster table [B, K, F]:
    (table[rep])[original label] through the label index over the original
    labels, 0 for -1.  That is table[merged label] on every pixel with a
    merged label; callers gate the rest on merged labels > -1."""
    return index.gather(tables.gather(table, rep))


def set_pseudo_depth_map(
    points: torch.Tensor,
    rays: torch.Tensor,
    nd_map: torch.Tensor,
    labels: torch.Tensor,
    variance: torch.Tensor,
    *,
    index: LabelIndex,
    rep: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel nd map + variance gate (Projection_GPU.cu:20-48):
    plane-project where label > -1 and acos(variance) < pi/8, else pass the
    input points through.  variance > 1 is clamped to 1 (documented fix in
    the JAX package: a fully coherent cluster is accepted)."""
    var_map = by_merged_label(variance[..., None], index, rep)[..., 0]
    var = torch.clamp_max(var_map, 1.0)
    gate = (labels > -1) & (var > COS_PI_8)
    proj = _project(nd_map, rays)
    return torch.where(gate[..., None], proj, points)


def set_pseudo_depth_cluster(
    points: torch.Tensor,
    rays: torch.Tensor,
    cluster_nd: torch.Tensor,
    labels: torch.Tensor,
    *,
    strict: bool = False,
    index: LabelIndex,
) -> torch.Tensor:
    """Per-cluster nd table [B, K, 4] (second overload, Projection_GPU.cu:
    50-77; SPDSP): project where label > -1 and |nd.x| < 1 (invalid
    sentinel 5.0); strict=True takes <= 1.0 (the PCA variant,
    Projection_PCA.cu:20-48).  `index`: the label index over `labels`
    (its gather gives 0 for -1, which the label gate masks)."""
    nd = index.gather(cluster_nd)
    ok = nd[..., 0].abs() <= 1.0 if strict else nd[..., 0].abs() < 1.0
    gate = (labels > -1) & ok
    return torch.where(gate[..., None], _project(nd, rays), points)


def set_pseudo_depth_normals(
    points: torch.Tensor,
    rays: torch.Tensor,
    cluster_normals: torch.Tensor,
    cluster_centers: torch.Tensor,
    labels: torch.Tensor,
    variance: torch.Tensor,
    *,
    index: LabelIndex,
) -> torch.Tensor:
    """Normals + centres overload (Projection_GPU.cu:79-115): d = |n.c|,
    gated on acos(variance[label]) < pi/8 (variance > 1 clamped to 1, as
    in set_pseudo_depth_map).  Tables [B, K, 3], [B, K, 3], [B, K]; one
    gather of 7 features through `index`."""
    g = index.gather(torch.cat([cluster_normals, cluster_centers, variance[..., None]], dim=-1))
    n, c, var = g[..., 0:3], g[..., 3:6], torch.clamp_max(g[..., 6], 1.0)
    d = stencil.dot3(n, c).abs()
    nd = torch.cat([n, d[..., None]], dim=-1)
    gate = (labels > -1) & (var > COS_PI_8)
    return torch.where(gate[..., None], _project(nd, rays), points)


def plane_fit_residual(
    points: torch.Tensor,
    plane_fitted: torch.Tensor,
    *,
    index: LabelIndex,
    rep: torch.Tensor,
) -> torch.Tensor:
    """Per-cluster relative RMS plane-fit residual [B, K]: sqrt(mean over
    member pixels with valid depth of ((z_plane - z)/z)^2).  Pixel sums are
    keyed by the original labels and folded K-side by `rep` (the merged
    labels are rep[original] of the same frame): the merged clusters'
    residuals, summed in another order than the JAX package's sums over
    the merged labels."""
    z = points[..., 2]
    zp = plane_fitted[..., 2]
    member = index.labels >= 0
    ok = (z > VALID_DEPTH_MM) & member
    e = (zp - z) / torch.clamp_min(z, 1.0)
    rel2 = torch.where(ok, e * e, torch.zeros_like(e))
    feats = torch.stack([rel2, ok.to(torch.float32)], dim=-1)
    s_orig = index.segment_sum(feats, member)                  # [B, K, 2]
    sums = tables.segment_sum(s_orig, rep, rep.shape[-1])      # tiny fold
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
    index: LabelIndex,
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
    g = by_merged_label(torch.cat(cols, dim=-1), index, rep)
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


def mrf_optimization(
    optimized: torch.Tensor,
    plane_fitted: torch.Tensor,
    rays: torch.Tensor,
    p: ProjectionParams = ProjectionParams(),
    *,
    gate_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mrf_optimization x p.mrf_iterations (Projection_GPU.cu:139-172, call
    sites cu:296-301): Jacobi sweeps of z' = (z_plane + sum w z_n) /
    (1 + sum w), w = smooth_sigma * K / (1 + dz^2) over the valid taps of
    the 5x5 window, applied only where the plane fit is valid and agrees
    with the current depth within 1%.  gate_mask ([B, H, W] bool,
    optional): the plane-confidence gate, pixels outside it are never
    pulled toward their plane (spec extension; None is the reference).
    Plain PyTorch: the JAX package has no kernel here."""
    h, w = optimized.shape[1:3]
    r = p.mrf_window // 2
    zp = plane_fitted[..., 2]
    k = torch.full((), p.mrf_k, dtype=torch.float32, device=optimized.device)
    base_gate = zp > VALID_DEPTH_MM
    if gate_mask is not None:
        base_gate = base_gate & gate_mask
    opt = optimized
    for _ in range(p.mrf_iterations):
        z = opt[..., 2]
        gate = base_gate & ((z - zp).abs() < z * 0.01)
        zpad = stencil.pad2d(z, r, 0.0)
        zero = torch.zeros_like(z)
        num = zp
        den = torch.ones_like(z)
        for dy, dx in stencil.offsets(p.mrf_window):
            nz = stencil.shift(zpad, dy, dx, r, (h, w))
            e = (z - nz).abs()
            dfil = k / (1.0 + e * e)
            filt = torch.where(nz > VALID_DEPTH_MM, p.mrf_smooth_sigma * dfil, zero)
            num = num + nz * filt
            den = den + filt
        upd = gate & (den != 0.0)
        new_z = torch.where(upd, num / den, z)
        opt = torch.where(upd[..., None], rays * new_z[..., None], opt)
    return opt


def eigenvalue_optimization(
    optimized: torch.Tensor,
    plane_fitted: torch.Tensor,
    rays: torch.Tensor,
    eigen_map: torch.Tensor,
    labels: torch.Tensor,
    eigenvalue_sigma: float,
) -> torch.Tensor:
    """eigenvalues_optimizationPCA (Projection_PCA.cu:76-108): blend toward
    the plane by exp(-sigma / (2 eigen^2)) where the fit agrees within 1%.
    Present as in the JAX package; the reference's call site is commented
    out (cu:118-125), so no pipeline runs it."""
    zo = optimized[..., 2]
    zp = plane_fitted[..., 2]
    gate = (zp > VALID_DEPTH_MM) & ((zo - zp).abs() < zo * 0.01) & (labels > -1)
    sig = torch.full((), -eigenvalue_sigma, dtype=torch.float32, device=zo.device)
    wgt = torch.exp(sig / (2.0 * torch.square(torch.clamp_min(eigen_map, 1e-30))))
    new_z = wgt * zo + (1.0 - wgt) * zp
    return torch.where(gate[..., None], rays * new_z[..., None], optimized)


def plane_hole_fill(
    optimized: torch.Tensor,
    rays: torch.Tensor,
    labels: torch.Tensor,
    nd_map: torch.Tensor,
    trust: torch.Tensor,
    invalid: torch.Tensor,
    steps: int,
) -> torch.Tensor:
    """Label-consistent plane hole-fill (JAX plane.py:302-361; a spec
    extension, KDEConfig.fill_holes).  Dilates (label, plane) from TRUSTED
    pixels (their cluster passed variance_optimization's gates) into
    `invalid` ones, `steps` rounds: a pixel fills only while its labelled
    4-neighbours agree on one cluster, the first of (up, down, left, right)
    giving the plane; filled pixels are projected onto it along their ray.
    labels [B, H, W] i32, nd_map [B, H, W, 4], trust / invalid [B, H, W]
    bool."""
    lab = torch.where(trust, labels, -1)
    nd = torch.where(trust[..., None], nd_map, 0.0)
    lab0 = lab
    h, w = labels.shape[-2:]

    def shifted(x, dy, dx, fill):  # out[y, x] = x[y + dy, x + dx], `fill` outside
        tail = (0, 0) if x.dim() == 4 else ()
        pad = torch.nn.functional.pad(x, tail + (1, 1, 1, 1), value=fill)
        return pad[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    for _ in range(steps):
        cand_l = torch.full_like(lab, -1)
        cand_nd = torch.zeros_like(nd)
        consistent = torch.ones_like(trust)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            l2 = shifted(lab, dy, dx, -1)
            n2 = shifted(nd, dy, dx, 0.0)
            take = (cand_l < 0) & (l2 >= 0)
            cand_l = torch.where(take, l2, cand_l)
            cand_nd = torch.where(take[..., None], n2, cand_nd)
            consistent = consistent & ((l2 < 0) | (l2 == cand_l))
        fill = (lab < 0) & invalid & (cand_l >= 0) & consistent
        lab = torch.where(fill, cand_l, lab)
        nd = torch.where(fill[..., None], cand_nd, nd)
    filled = (lab >= 0) & (lab0 < 0) & invalid
    return torch.where(filled[..., None], _project(nd, rays), optimized)


def depth_bilateral(
    optimized: torch.Tensor, rays: torch.Tensor, p: ProjectionParams = ProjectionParams()
) -> torch.Tensor:
    """bilateralfilter (Projection_GPU.cu:198-227): 7x7 spatial x depth
    Gaussian on z; x, y recomputed from the rays; 0 where no valid support.

    The depth factor and the weight flush to 0 below FLT_MIN, as XLA does
    (stencil.flush_subnormal): a hole pixel whose valid neighbours lie
    1.3-1.45 m from its z = 0 (depth_sigma 100) has only subnormal weights,
    so no support, and stays 0."""
    return rays * bilateral_depth(optimized[..., 2], p)[..., None]


def bilateral_depth(z: torch.Tensor, p: ProjectionParams = ProjectionParams()) -> torch.Tensor:
    """depth_bilateral's new depth [B, H, W] from z [B, H, W] (zeros past
    the image; parallel/stencil_shard.py runs it on haloed width tiles)."""
    _, h, w = z.shape
    r = p.window // 2
    spatial = stencil.gaussian_spatial_filter(p.window, p.spatial_sigma, z.device)
    zpad = stencil.pad2d(z, r, 0.0)
    zero = torch.zeros_like(z)
    num = zero
    den = zero
    for dy, dx in stencil.offsets(p.window):
        nz = stencil.shift(zpad, dy, dx, r, (h, w))
        ok = nz > VALID_DEPTH_MM
        e = nz - z
        filt = torch.exp(stencil.div_const(-(e * e), 2.0 * p.depth_sigma**2))
        filt = stencil.flush_subnormal(filt)
        filt = stencil.flush_subnormal(filt * spatial[dy + r, dx + r])
        filt = torch.where(ok, filt, zero)
        num = num + nz * filt
        den = den + filt
    empty = den == 0.0
    return torch.where(empty, zero, num / torch.where(empty, torch.ones_like(den), den))


# ---------------------------------------------------------------- PCA planes


class PCAPlanes(NamedTuple):
    nd: torch.Tensor           # [B, K, 4] plane (n, d); invalid (5, 5, 5, 0)
    centers: torch.Tensor      # [B, K, 3] cluster centroids
    eigenvalues: torch.Tensor  # [B, K] smallest eigenvalue
    count: torch.Tensor        # [B, K] i32 point count


def pca_planes(
    points: torch.Tensor, labels: torch.Tensor, k: int, *, index: LabelIndex
) -> PCAPlanes:
    """Per-cluster plane fit on the device (replaces the host loop and
    cv::PCA of SPDepthSuperResolution.cpp:66-142 /
    TOFDepthInterpolation.cpp:69-146; JAX plane.py:400-476).

    Every pixel with a label contributes, valid depth or not (as the
    reference pushes every labelled point).  The covariance comes from
    centred second moments: the sums (4 features), then the gathered mean
    (3) and the squared residuals about it (6), all through `index` (the
    label-cell kernels on the cell route) — two passes keep f32 where the
    reference needed f64.  The normal is the smallest eigenvalue's
    eigenvector, flipped so that d = n . centroid >= 0; clusters with
    < 3 points get the sentinel (5, 5, 5, 0)."""
    mask = labels >= 0
    ones = torch.ones_like(points[..., :1])
    sums = index.segment_sum(torch.cat([points, ones], dim=-1), mask)
    count = sums[..., 3]
    mean = sums[..., 0:3] / torch.clamp_min(count, 1.0)[..., None]
    centered = torch.where(mask[..., None], points - index.gather(mean), 0.0)
    cx, cy, cz = centered.unbind(-1)
    m = index.segment_sum(
        torch.stack([cx * cx, cx * cy, cx * cz, cy * cy, cy * cz, cz * cz], dim=-1), mask)
    # cv::PCA scales the scatter matrix by 1/N (CV_COVAR_SCALE with rows)
    rows = [torch.stack([m[..., i] for i in r], dim=-1) for r in ((0, 1, 2), (1, 3, 4), (2, 4, 5))]
    cov = torch.stack(rows, dim=-2) / torch.clamp_min(count, 1.0)[..., None, None]

    eigval, vec = smallest_eigenvector(cov)
    d_signed = stencil.dot3(vec, mean)
    vec = torch.where((d_signed < 0)[..., None], -vec, vec)
    valid = count >= 3
    nd = torch.cat([vec, d_signed.abs()[..., None]], dim=-1)
    sentinel = constant((5.0, 5.0, 5.0, 0.0), nd.dtype, nd.device)
    return PCAPlanes(
        nd=torch.where(valid[..., None], nd, sentinel),
        centers=torch.where(valid[..., None], mean, 0.0),
        eigenvalues=torch.where(valid, eigval, 0.0),
        count=count.to(torch.int32),
    )
