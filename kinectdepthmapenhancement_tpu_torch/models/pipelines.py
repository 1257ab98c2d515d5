"""The enhancement pipelines: JBF, MRF, RGBF, KDE ("PROPOSED"), SPDSP, TOF.

PyTorch counterpart of the JAX package's models/pipelines.py:
  * kde_pipeline (KinectDepthEnhancement::Process,
    KinectDepthEnhancement.cpp:56-81): JBF -> projective-to-real -> CM
    normals (or SDC / bilateral) -> NASP -> CCL merge (normal merge, or
    the plane-consistency merge) -> plane projection with
    variance_optimization, the optional
    plane hole fill, and the depth bilateral;
  * rgbf_pipeline (RegionGrowingBilateralFilter::Process): colour SLIC and
    depth SLIC (both the DASP variant) -> edge-refined superpixels;
  * spdsp_pipeline / tof_pipeline (SPDepthSuperResolution::Process,
    TOFDepthInterpolation::Process): RGBF's front end at 5 iterations ->
    per-cluster PCA planes -> projection (SPDSP: 20 MRF sweeps; TOF: the
    PCA merge, no optimisation);
  * jbf_pipeline and mrf_pipeline, the JBF and MRF baselines.

On a CUDA device the stencil stages run in the port's hand-written kernels
(JBF, chamfer DT, covariance sweep, seed gradient in its NASP and colour
forms) and, on the default stats_impl="auto" route, so do NASP's
statistics and every cell-local gather and segment sum (ops/cuda_nasp.py);
everything else is plain PyTorch (ERS, the MRF baseline and sweeps, the
SDC and bilateral normals and the assignment sweeps of SP / DASP have no
TPU kernel).  On the CPU every stage is plain
PyTorch.  Every pipeline takes [H, W] or [B, H, W] frames and returns its
input's batching.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    normalized_rays,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import (
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, ccl, ers, normals, plane, slic
from kinectdepthmapenhancement_tpu_torch.utils import telemetry


class RGBFResult(NamedTuple):
    refined_depth: torch.Tensor   # [(B,) H, W] mm
    refined_labels: torch.Tensor
    color_labels: torch.Tensor
    depth_labels: torch.Tensor


class KDEResult(NamedTuple):
    optimized_points: torch.Tensor  # [(B,) H, W, 3] mm — the PROPOSED output
    plane_fitted: torch.Tensor
    jbf_depth: torch.Tensor
    normals: torch.Tensor
    nasp_labels: torch.Tensor
    merged_labels: torch.Tensor
    merged_variance: torch.Tensor
    merged_sizes: torch.Tensor


class SPDSPResult(NamedTuple):
    optimized_points: torch.Tensor  # [(B,) H, W, 3] mm
    plane_fitted: torch.Tensor
    refined_depth: torch.Tensor
    refined_labels: torch.Tensor
    planes_nd: torch.Tensor         # [(B,) K, 4]


class TOFResult(NamedTuple):
    optimized_points: torch.Tensor  # == the refined points (the reference's
                                    # optimisation is disabled, Projection_PCA.cu:118-125)
    plane_fitted: torch.Tensor
    refined_depth: torch.Tensor
    refined_labels: torch.Tensor
    merged_labels: torch.Tensor
    merged_eigenvalues: torch.Tensor  # [(B,) K]


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
    # telemetry.stage names each stage in torch.profiler traces (the JAX
    # package's named_scope labels) and, with telemetry on, stamps its entry
    # and exit on the card; otherwise it only opens and closes a range
    with telemetry.stage("kde.jbf", depth):
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
    with telemetry.stage("kde.jbf", jbf_depth):
        points = rays * jbf_depth[..., None]  # core.camera.projective_to_real
    with telemetry.stage("kde.normals", points):
        nmap = (normals.generate_normal_map(points, cfg.normals) if tile is None
                else tile.normal_map(points, cfg.normals))
    with telemetry.stage("kde.nasp", points):
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
        # the last part of the kde.ccl_merge stage, so a device activity lies
        # in the innermost stage that holds it
        with telemetry.stage("kde.projection", points):
            plane_fitted, optimized = _project(points, rays, merged, index, cfg, tile)
        return plane_fitted, optimized, merged.labels, merged.variance, merged.sizes

    with telemetry.stage("kde.ccl_merge", points):
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


def _ers_front_end(depth, points, color, cfg):
    """RGBF's, SPDSP's and TOF's front end: colour SLIC and depth SLIC (the
    DASP variant, cfg.color_slic / cfg.depth_slic) -> edge-refined
    superpixels.  Returns (colour SLIC, depth SLIC, ERS result)."""
    with telemetry.stage("rgbf.color_slic", points):
        sp = slic.segment(color, points, grid=cfg.grid, params=cfg.color_slic, variant="dasp")
    with telemetry.stage("rgbf.depth_slic", points):
        dasp = slic.segment(color, points, grid=cfg.grid, params=cfg.depth_slic, variant="dasp")
    with telemetry.stage("rgbf.ers", points):
        refined = ers.edge_refined_superpixel(sp.labels, dasp.labels, depth, color, cfg.ers)
    return sp, dasp, refined


def rgbf_pipeline(
    depth: torch.Tensor,
    points: torch.Tensor,
    color: torch.Tensor,
    cfg: RGBFConfig = RGBFConfig(),
) -> RGBFResult:
    """RegionGrowingBilateralFilter::Process (RegionGrowingBilateralFilter.cpp:
    27-38): colour SLIC + depth SLIC -> edge-refined superpixel filter.

    depth f32 [(B,) H, W] mm; points f32 [(B,) H, W, 3] mm (the raw
    depth's, projective_to_real); color u8 [(B,) H, W, 3]."""
    batched, (depth, points, color) = _batch(depth, points, color)
    sp, dasp, refined = _ers_front_end(depth, points, color, cfg)
    result = RGBFResult(
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        color_labels=sp.labels,
        depth_labels=dasp.labels,
    )
    return _unbatch(result, batched)


_LOCAL_CAP = 4  # cell-locality cap of ERS-refined labels (checked on the device)


def _with_local_index(fn, labels: torch.Tensor, cfg):
    """fn(index) over ERS-refined labels (JAX pipelines.py:232-260): the
    cell-local index at r = 4 when every label lies in its pixel's [-4, 3]^2
    cell neighbourhood (ERS only swaps labels within a 7 px window of
    5-iteration DASP labels, so in practice it does), the global one
    otherwise.  The JAX lax.cond is slic.with_capped_index's: a device check
    read on the host (one sync) when eager, a conditional node with fn on
    each index as its branches in a jit call, so fn returns tensors only.
    Follows cfg.depth_slic's stats_impl and locality ("cell" skips the
    check, "global" takes the global index)."""
    p = cfg.depth_slic
    return slic.with_capped_index(fn, labels, cfg.grid, _LOCAL_CAP, stats_impl=p.stats_impl,
                                  locality=p.locality)


def _local_index(labels: torch.Tensor, cfg) -> slic.LabelIndex:
    """_with_local_index's index itself, for an eager call."""
    return _with_local_index(lambda index: index, labels, cfg)


def spdsp_pipeline(
    depth: torch.Tensor,
    points: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    cfg: SPDSPConfig = SPDSPConfig(),
) -> SPDSPResult:
    """SPDepthSuperResolution::Process (SPDepthSuperResolution.cpp:57-191):
    SP + DASP (5 iterations each) -> ERS -> per-cluster PCA planes (on the
    device) -> plane projection with 20 MRF sweeps.

    The plane-confidence gate (spec extension, SPDSPConfig): a cluster's
    plane is trusted only when its fit thickness sqrt(smallest eigenvalue)
    is below max_plane_residual of the centroid depth; inf disables the gate
    and skips its gather (the reference's behaviour).  An eager call reads
    one cap check per later SLIC iteration (8) and one for the ERS labels'
    index on the host; a jit call (core/jit.py) reads none: each is a
    conditional node."""
    batched, (depth, points, color) = _batch(depth, points, color)
    h, w = depth.shape[-2:]
    rays = normalized_rays(intr, h, w, depth.device)
    k = cfg.grid.num_clusters
    _, _, refined = _ers_front_end(depth, points, color, cfg)
    rpoints = projective_to_real(refined.depth, intr)

    def fit_and_project(index):
        """The planes, the plane-fitted points and the gate map, or () in
        its place when max_plane_residual is inf (JAX :288-305)."""
        planes = plane.pca_planes(rpoints, refined.labels, k, index=index)
        plane_fitted = plane.set_pseudo_depth_cluster(
            rpoints, rays, planes.nd, refined.labels, strict=False, index=index)
        if math.isinf(cfg.max_plane_residual):
            return planes, plane_fitted, ()
        resid_rel = torch.sqrt(torch.clamp_min(planes.eigenvalues, 0.0)) / torch.clamp_min(
            planes.centers[..., 2].abs(), 1.0)
        okf = (resid_rel < cfg.max_plane_residual).to(torch.float32)
        return planes, plane_fitted, (index.gather(okf[..., None])[..., 0] > 0.0,)

    with telemetry.stage("spdsp.planes", rpoints):
        planes, plane_fitted, gate = _with_local_index(fit_and_project, refined.labels, cfg)
    with telemetry.stage("spdsp.mrf", rpoints):
        optimized = plane.mrf_optimization(
            rpoints, plane_fitted, rays, cfg.projection, gate_mask=gate[0] if gate else None)
    result = SPDSPResult(
        optimized_points=optimized,
        plane_fitted=plane_fitted,
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        planes_nd=planes.nd,
    )
    return _unbatch(result, batched)


def tof_pipeline(
    depth: torch.Tensor,
    points: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    cfg: TOFConfig = TOFConfig(),
) -> TOFResult:
    """TOFDepthInterpolation::Process (TOFDepthInterpolation.cpp:60-195):
    SPDSP's front end and planes, keeps the smallest eigenvalue, merges with
    the PCA predicate (ccl.merge_pca), and projects WITHOUT iterative
    optimisation (the reference's optimisation kernels are commented out,
    so optimized_points are the refined points).  Host syncs as SPDSP's."""
    batched, (depth, points, color) = _batch(depth, points, color)
    h, w = depth.shape[-2:]
    rays = normalized_rays(intr, h, w, depth.device)
    k = cfg.grid.num_clusters
    _, _, refined = _ers_front_end(depth, points, color, cfg)
    rpoints = projective_to_real(refined.depth, intr)

    def fit_merge_project(index):
        """The planes, their PCA merge and the plane-fitted points (JAX
        :343-356)."""
        planes = plane.pca_planes(rpoints, refined.labels, k, index=index)
        merged = ccl.merge_pca(
            refined.labels, planes.nd, planes.centers, planes.eigenvalues, cfg.ccl_pca,
            index=index)
        plane_fitted = plane.set_pseudo_depth_cluster(
            rpoints, rays, planes.nd, refined.labels, strict=True, index=index)
        return planes, merged, plane_fitted

    with telemetry.stage("tof.planes", rpoints):
        _, merged, plane_fitted = _with_local_index(fit_merge_project, refined.labels, cfg)
    result = TOFResult(
        optimized_points=rpoints,
        plane_fitted=plane_fitted,
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        merged_labels=merged.labels,
        merged_eigenvalues=merged.eigenvalues,
    )
    return _unbatch(result, batched)
