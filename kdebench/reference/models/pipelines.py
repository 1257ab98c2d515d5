"""The KDE pipeline ("PROPOSED"), with the JBF and MRF baselines, on the
plain route: the port's models/pipelines.py cut to kde_pipeline and what it
runs (KinectDepthEnhancement::Process, KinectDepthEnhancement.cpp:56-81):
JBF -> projective-to-real -> CM normals (or SDC / bilateral) -> NASP -> CCL
merge (normal merge, or the plane-consistency merge) -> plane projection
with variance_optimization, the optional plane hole fill, and the depth
bilateral.  Every stage is plain PyTorch on every device; the stages the
port runs as hand kernels are their plain versions (ops/cuda_*.py here).
Every pipeline takes [H, W] or [B, H, W] frames and returns its input's
batching.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..core.camera import (
    Intrinsics,
    normalized_rays,
    projective_to_real,
)
from ..core.config import KDEConfig
from ..ops import bilateral, ccl, normals, plane, slic


class KDEResult(NamedTuple):
    optimized_points: torch.Tensor  # [(B,) H, W, 3] mm — the PROPOSED output
    plane_fitted: torch.Tensor
    jbf_depth: torch.Tensor
    normals: torch.Tensor
    nasp_labels: torch.Tensor
    merged_labels: torch.Tensor
    merged_variance: torch.Tensor
    merged_sizes: torch.Tensor


def _batch(*frames: torch.Tensor):
    """(batched, frames with a leading batch axis): depth-like [H, W]
    inputs gain one."""
    batched = frames[0].dim() == 3
    return batched, frames if batched else tuple(f[None] for f in frames)


def _unbatch(result, batched: bool):
    return result if batched else type(result)(*(t[0] for t in result))


def jbf_pipeline(depth: torch.Tensor, color: torch.Tensor, cfg: KDEConfig = KDEConfig()):
    """Standalone JBF baseline (main.cpp:179): depth f32 [(B,) H, W] mm,
    color u8 [(B,) H, W, 3] -> filtered depth of the input's batching."""
    batched, (depth, color) = _batch(depth, color)
    out = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
    return out if batched else out[0]


def mrf_pipeline(depth: torch.Tensor, color: torch.Tensor, cfg: KDEConfig = KDEConfig()):
    """Standalone MRF baseline (main.cpp:186): depth f32 [(B,) H, W] mm,
    color u8 [(B,) H, W, 3] -> one MRF sweep, of the input's batching."""
    batched, (depth, color) = _batch(depth, color)
    out = bilateral.markov_random_field(depth, color, cfg.mrf)
    return out if batched else out[0]


def kde_pipeline(
    depth: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    cfg: KDEConfig = KDEConfig(),
) -> KDEResult:
    """KinectDepthEnhancement::Process — the PROPOSED method.

    depth: f32 [H, W] or [B, H, W] mm; color: u8 [H, W, 3] or [B, H, W, 3].
    The result keeps the input's batching.  Every KDEConfig of the JAX
    package runs: the three normal methods (the bilateral method skips the
    smoothing map, so it runs neither the DT nor the covariance kernel),
    both plane gate modes (max_plane_residual 0.0025 or inf), plane_merge, fill_holes,
    any number of NASP iterations and grids that do not divide the frame.
    CCL and the plane stage take slic.with_label_index's index (cell-local,
    or global); the single-iteration path makes no host sync, and under
    core/jit.py no path does (each cap check a conditional node)."""
    batched, (depth, color) = _batch(depth, color)
    # record_function names each stage in torch.profiler traces (the JAX
    # package's named_scope labels); outside a profiler it only opens and
    # closes a range
    with record_function("kde.jbf"):
        jbf_depth = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
    return _unbatch(_kde_from_jbf(jbf_depth, color, intr, cfg), batched)


def _kde_from_jbf(
    jbf_depth: torch.Tensor, color: torch.Tensor, intr: Intrinsics, cfg: KDEConfig,
    tile=None,
) -> KDEResult:
    """kde_pipeline after its JBF, on batched frames: jbf_depth f32 [B, H, W]
    mm (the filtered depth), color u8 [B, H, W, 3].  parallel/sharding.py's
    spatial route runs the JBF on width tiles, then this on the gathered
    frames (its replicated route) or on each rank's own tile (its tiled
    route): `tile` is then that route's sharding.WidthTile, the frames are
    the tile's, and the normals, NASP, the label index, the hole fill and
    the depth bilateral take their tiled forms (the frames must be ones
    that sharding.spatial_route tiles).  The result is the tile's, its
    cluster tables the whole frames'."""
    _, h, w = jbf_depth.shape
    rays = normalized_rays(intr, h, w if tile is None else tile.width, jbf_depth.device)
    if tile is not None:
        rays = tile.crop_rays(rays)
    k = cfg.grid.num_clusters
    with record_function("kde.jbf"):
        points = rays * jbf_depth[..., None]  # core.camera.projective_to_real
    with record_function("kde.normals"):
        nmap = (normals.generate_normal_map(points, cfg.normals) if tile is None
                else tile.normal_map(points, cfg.normals))
    with record_function("kde.nasp"):
        if tile is None:
            nasp = slic.segment(
                color, points, nmap, grid=cfg.grid, params=cfg.nasp, variant="nasp"
            )
        else:
            nasp = slic.segment_tile(color, points, nmap, grid=cfg.grid, params=cfg.nasp,
                                     tile=tile)

    def tail(index):
        """CCL and the plane stage on `index`: (plane_fitted, optimized,
        merged labels, variance, sizes)."""
        if cfg.plane_merge:
            # plane-consistency merge: the same MergeResult keying, so the
            # projection, gates and fill below are unchanged
            merged = ccl.merge_planes(points, nasp.labels, k, index=index, tau=cfg.pm_tau)
        else:
            merged = ccl.merge_normals(
                nasp.labels, nasp.clusters.normal, nasp.clusters.center, cfg.ccl,
                index=index,
            )
        # the last part of the kde.ccl_merge span, so a device activity lies
        # in the innermost span that holds it
        with record_function("kde.projection"):
            plane_fitted, optimized = _project(points, rays, merged, index, cfg, tile)
        return plane_fitted, optimized, merged.labels, merged.variance, merged.sizes

    with record_function("kde.ccl_merge"):
        # the label index's route: a host branch, or in a jit call with
        # three or more NASP iterations a conditional node
        plane_fitted, optimized, merged_labels, merged_variance, merged_sizes = (
            slic.with_label_index(tail, nasp.labels, cfg.grid, cfg.nasp, tile=tile))
    return KDEResult(
        optimized_points=optimized,
        plane_fitted=plane_fitted,
        jbf_depth=jbf_depth,
        normals=nmap,
        nasp_labels=nasp.labels,
        merged_labels=merged_labels,
        merged_variance=merged_variance,
        merged_sizes=merged_sizes,
    )


def _project(points, rays, merged, index, cfg: KDEConfig, tile):
    """kde_pipeline's plane stage on the merged clusters: the plane fit,
    variance_optimization's gates, the optional hole fill and the depth
    bilateral.  Returns (plane_fitted, optimized)."""
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
        fill = plane.plane_hole_fill if tile is None else tile.plane_hole_fill
        optimized = fill(
            optimized, rays, merged.labels, merged.nd_map, trust,
            points[..., 2] <= plane.VALID_DEPTH_MM, cfg.fill_holes,
        )
    if tile is None:
        optimized = plane.depth_bilateral(optimized, rays, cfg.projection)
    else:
        optimized = tile.depth_bilateral(optimized, rays, cfg.projection)
    return plane_fitted, optimized
