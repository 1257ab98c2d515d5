"""The KDE ("PROPOSED") enhancement pipeline and the JBF baseline.

PyTorch counterpart of kde_pipeline and jbf_pipeline in the JAX package's
models/pipelines.py (KinectDepthEnhancement::Process,
KinectDepthEnhancement.cpp:56-81): JBF -> projective-to-real -> CM normals
-> NASP -> CCL merge (normal merge, or the plane-consistency merge) ->
plane projection with variance_optimization, the optional plane hole fill,
and the depth bilateral.

On a CUDA device the stencil stages run in the port's hand-written kernels
(JBF, chamfer DT, covariance sweep, seed gradient) and, on the default
stats_impl="auto" route, so do NASP's statistics and every cell-local
gather and segment sum (ops/cuda_nasp.py); everything else is plain
PyTorch.  On the CPU every stage is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    normalized_rays,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import KDEConfig
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, ccl, normals, plane, slic


class KDEResult(NamedTuple):
    optimized_points: torch.Tensor  # [(B,) H, W, 3] mm — the PROPOSED output
    plane_fitted: torch.Tensor
    jbf_depth: torch.Tensor
    normals: torch.Tensor
    nasp_labels: torch.Tensor
    merged_labels: torch.Tensor
    merged_variance: torch.Tensor
    merged_sizes: torch.Tensor


def jbf_pipeline(depth: torch.Tensor, color: torch.Tensor, cfg: KDEConfig = KDEConfig()):
    """Standalone JBF baseline (main.cpp:179): depth f32 [(B,) H, W] mm,
    color u8 [(B,) H, W, 3] -> filtered depth of the input's batching."""
    if depth.dim() == 2:
        return bilateral.joint_bilateral_filter(depth[None], color[None], cfg.jbf)[0]
    return bilateral.joint_bilateral_filter(depth, color, cfg.jbf)


def kde_pipeline(
    depth: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    cfg: KDEConfig = KDEConfig(),
) -> KDEResult:
    """KinectDepthEnhancement::Process — the PROPOSED method.

    depth: f32 [H, W] or [B, H, W] mm; color: u8 [H, W, 3] or [B, H, W, 3].
    The result keeps the input's batching.  Every KDEConfig of the JAX
    package runs but the non-"cm" normal methods, which raise: both plane
    gate modes (max_plane_residual 0.0025 or inf), plane_merge, fill_holes,
    any number of NASP iterations and grids that do not divide the frame.
    CCL and the plane stage take slic.label_index's index (cell-local, or
    global); the single-iteration path makes no host sync."""
    batched = depth.dim() == 3
    if not batched:
        depth, color = depth[None], color[None]
    _, h, w = depth.shape
    rays = normalized_rays(intr, h, w, depth.device)
    k = cfg.grid.num_clusters

    # record_function names each stage in torch.profiler traces (the JAX
    # package's named_scope labels); outside a profiler it only opens and
    # closes a range
    with record_function("kde.jbf"):
        jbf_depth = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
        points = projective_to_real(jbf_depth, intr)
    with record_function("kde.normals"):
        nmap = normals.generate_normal_map(points, cfg.normals)
    with record_function("kde.nasp"):
        nasp = slic.segment(
            color, points, nmap, grid=cfg.grid, params=cfg.nasp, variant="nasp"
        )
    with record_function("kde.ccl_merge"):
        index = slic.label_index(nasp.labels, cfg.grid, cfg.nasp)
        if cfg.plane_merge:
            # plane-consistency merge: the same MergeResult keying, so the
            # projection, gates and fill below are unchanged
            merged = ccl.merge_planes(points, nasp.labels, k, index=index, tau=cfg.pm_tau)
        else:
            merged = ccl.merge_normals(
                nasp.labels, nasp.clusters.normal, nasp.clusters.center, cfg.ccl,
                index=index,
            )
    with record_function("kde.projection"):
        rep = merged.rep
        plane_fitted = plane.set_pseudo_depth_map(
            points, rays, merged.nd_map, merged.labels, merged.variance,
            index=index, rep=rep,
        )
        # inf disables the plane-confidence gate (and skips the residual):
        # exact reference behaviour
        if math.isinf(cfg.max_plane_residual):
            resid = None
        else:
            resid = plane.plane_fit_residual(points, plane_fitted, index=index, rep=rep)
        optimized = plane.variance_optimization(
            points,
            plane_fitted,
            merged.labels,
            merged.variance,
            merged.sizes,
            min_cluster_size=cfg.min_cluster_size,
            agree_tight=cfg.agree_tight,
            agree_loose=cfg.agree_loose,
            fit_residual=resid,
            max_fit_residual=cfg.max_plane_residual,
            index=index,
            rep=rep,
        )
        if cfg.fill_holes > 0:
            # per-pixel cluster trust: variance_optimization's gates
            cols = [merged.variance[..., None], merged.sizes.to(torch.float32)[..., None]]
            if resid is not None:
                cols.append(resid[..., None])
            g = plane.by_merged_label(torch.cat(cols, dim=-1), index, rep)
            trust = (
                (merged.labels > -1)
                & (torch.clamp_max(g[..., 0], 1.0) > plane.COS_PI_8)
                & (g[..., 1] > cfg.min_cluster_size)
            )
            if resid is not None:
                trust = trust & (g[..., 2] < cfg.max_plane_residual)
            optimized = plane.plane_hole_fill(
                optimized, rays, merged.labels, merged.nd_map, trust,
                points[..., 2] <= plane.VALID_DEPTH_MM, cfg.fill_holes,
            )
        optimized = plane.depth_bilateral(optimized, rays, cfg.projection)
    result = KDEResult(
        optimized_points=optimized,
        plane_fitted=plane_fitted,
        jbf_depth=jbf_depth,
        normals=nmap,
        nasp_labels=nasp.labels,
        merged_labels=merged.labels,
        merged_variance=merged.variance,
        merged_sizes=merged.sizes,
    )
    if not batched:
        result = KDEResult(*(t[0] for t in result))
    return result
