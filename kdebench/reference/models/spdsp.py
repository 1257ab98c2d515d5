"""SPDSP (SPDepthSuperResolution::Process, SPDepthSuperResolution.cpp:
57-191) on the plain route: the port's models/pipelines.py cut to
spdsp_pipeline and what it runs: the colour and depth SLICs (the DASP
variant, 5 iterations each) -> edge-refined superpixels -> per-cluster PCA
planes and pseudo-depth on the ERS labels' index -> 20 MRF sweeps toward
the planes.  Every stage is plain PyTorch on every device.

The copy differs from its source only as reference.FILES' copies do:
imports are relative, and the ERS labels' index is slic.with_capped_index's
eager host branch (core/jit.py here has no compiled call), which takes the
same index as the port's conditional node.  `enhance` is the harness's
entry: spdsp_pipeline on the raw depth's points, as run_stream's chunk
step forms them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..core.camera import Intrinsics, normalized_rays, projective_to_real
from ..core.config import SPDSPConfig
from ..ops import ers, plane, slic
from .pipelines import _batch, _unbatch


class SPDSPResult(NamedTuple):
    optimized_points: torch.Tensor  # [(B,) H, W, 3] mm
    plane_fitted: torch.Tensor
    refined_depth: torch.Tensor
    refined_labels: torch.Tensor
    planes_nd: torch.Tensor         # [(B,) K, 4]


def _ers_front_end(depth, points, color, cfg):
    """RGBF's, SPDSP's and TOF's front end: colour SLIC and depth SLIC (the
    DASP variant, cfg.color_slic / cfg.depth_slic) -> edge-refined
    superpixels.  Returns (colour SLIC, depth SLIC, ERS result)."""
    with record_function("rgbf.color_slic"):
        sp = slic.segment(color, points, grid=cfg.grid, params=cfg.color_slic, variant="dasp")
    with record_function("rgbf.depth_slic"):
        dasp = slic.segment(color, points, grid=cfg.grid, params=cfg.depth_slic, variant="dasp")
    with record_function("rgbf.ers"):
        refined = ers.edge_refined_superpixel(sp.labels, dasp.labels, depth, color, cfg.ers)
    return sp, dasp, refined


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

    with record_function("spdsp.planes"):
        planes, plane_fitted, gate = _with_local_index(fit_and_project, refined.labels, cfg)
    with record_function("spdsp.mrf"):
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


def enhance(depths: torch.Tensor, color: torch.Tensor, intr: Intrinsics,
            cfg: SPDSPConfig) -> torch.Tensor:
    """spdsp_pipeline's optimized points [B, H, W, 3] (mm) of depths
    [B, H, W] f32 mm and color [B, H, W, 3] u8, on the raw depth's points."""
    return spdsp_pipeline(depths, projective_to_real(depths, intr), color, intr,
                          cfg).optimized_points
