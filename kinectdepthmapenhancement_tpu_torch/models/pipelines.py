"""The KDE ("PROPOSED") enhancement pipeline.

PyTorch counterpart of kde_pipeline in the JAX package's models/pipelines.py
(KinectDepthEnhancement::Process, KinectDepthEnhancement.cpp:56-81):
JBF -> projective-to-real -> CM normals -> NASP -> CCL merge -> plane
projection with variance_optimization + depth bilateral.

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


def kde_pipeline(
    depth: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    cfg: KDEConfig = KDEConfig(),
) -> KDEResult:
    """KinectDepthEnhancement::Process — the PROPOSED method.

    depth: f32 [H, W] or [B, H, W] mm; color: u8 [H, W, 3] or [B, H, W, 3].
    The result keeps the input's batching.  Supports the default plane gate
    (max_plane_residual=0.0025) and the reference-exact mode (inf).  The
    quality extensions plane_merge and fill_holes, later NASP iterations and
    the non-"cm" normal methods are not ported yet and raise."""
    if cfg.plane_merge:
        raise NotImplementedError("KDEConfig.plane_merge is not ported yet")
    if cfg.fill_holes > 0:
        raise NotImplementedError("KDEConfig.fill_holes is not ported yet")
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
        # single-iteration NASP labels are cell-local, so CCL and the plane
        # stage run on the cell-local index over them
        nasp_cell = slic.cell_index(
            nasp.labels, cfg.grid, neighborhood=8, stats_impl=cfg.nasp.stats_impl
        )
        merged = ccl.merge_normals(
            nasp.labels, nasp.clusters.normal, nasp.clusters.center, cfg.ccl,
            index=nasp_cell,
        )
    with record_function("kde.projection"):
        rep = merged.rep
        plane_fitted = plane.set_pseudo_depth_map(
            points, rays, merged.nd_map, merged.labels, merged.variance,
            index=nasp_cell, rep=rep,
        )
        # inf disables the plane-confidence gate (and skips the residual):
        # exact reference behaviour
        if math.isinf(cfg.max_plane_residual):
            resid = None
        else:
            resid = plane.plane_fit_residual(
                points, plane_fitted, merged.labels, k, index=nasp_cell, rep=rep
            )
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
            index=nasp_cell,
            rep=rep,
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
