"""The stencil stages of KDE on width tiles, under explicit halo exchange:
the joint bilateral filter, the normals (CM, SDC, bilateral), the plane
hole fill and the depth bilateral.

PyTorch counterpart of the JAX package's parallel/stencil_shard.py (the
semantics of JointBilateralFilter.cu:4-83, identical to
ops.bilateral.joint_bilateral_filter):

  * colour halo = guide radius + filter radius, with a reflect-101 fixup at
    the GLOBAL image edges (the guide pre-smoothing's border mode,
    ops.bilateral.guide_bilateral);
  * depth halo = filter radius, zeros at the global edges (the JBF's pad2d
    convention: out-of-image taps are invalid anyway, z = 0 <= 50 mm);
  * the guide is computed on the haloed colour tile, so its values are
    exact wherever they can reach an output pixel of the tile;
  * the filter itself is the csrc/jbf.cu kernel (ops/cuda_bilateral.py) on
    the padded tile, and its plain version on a CPU tensor.

The output is bitwise equal to the unsharded bilateral.joint_bilateral_filter
(tests/test_torch_parallel.py on the CPU, chip_smoke.py phase 11 on the
card).  normals_sharded, plane_hole_fill_sharded and
depth_bilateral_sharded (the tiled KDE route, sharding.py) are likewise
bitwise the tile's columns of the unsharded normals.generate_normal_map
(every method), plane.plane_hole_fill and plane.depth_bilateral.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from kinectdepthmapenhancement_tpu_torch.core.config import (
    JBFParams, NormalParams, ProjectionParams,
)
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, cuda_cov, normals, plane
from kinectdepthmapenhancement_tpu_torch.parallel import halo
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import Mesh

IMPLS = ("xla", "pallas")


def jbf_sharded(
    depth: torch.Tensor,
    color: torch.Tensor,
    mesh: Mesh,
    p: JBFParams = JBFParams(),
    *,
    axis: str = "x",
    impl: str = "xla",
) -> torch.Tensor:
    """Joint bilateral filter of this rank's width tile: depth f32 [B, H, ws]
    mm and color u8 [B, H, ws, 3], the 'x' coordinate s's columns of its
    data row's frames (mesh.width_tile) -> the filtered tile [B, H, ws].
    Every rank of the 'x' group calls it.  `impl` is taken for the JAX
    signature and not read (the kernel runs on every CUDA tile, as the
    port's grad_impl / cov_impl / dt_impl are not read); values other than
    the JAX package's raise, as does an axis other than "x"."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if axis != "x":
        raise ValueError(f"the width is tiled over mesh axis 'x', got {axis!r}")
    rg = p.guide_diameter // 2
    rj = p.window // 2
    ws = depth.shape[2]

    cpad = halo.exchange_width(color, rg + rj, mesh)
    cpad = halo.reflect101_at_global_edges(cpad, rg + rj, mesh)
    # guide values for columns [-rj, ws + rj) of this tile; the outer rg
    # columns of the smoothed block depend on guide_bilateral's own reflect
    # pad of the BLOCK and are dropped
    guide = bilateral.guide_bilateral(cpad, p).to(torch.float32)
    guide = guide[:, :, rg:rg + ws + 2 * rj].contiguous()

    dpad = halo.exchange_width(depth, rj, mesh).contiguous()  # zeros at global edges
    out = bilateral._jbf_core(
        dpad, guide, window=p.window, spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma, depth_sigma=p.depth_sigma,
    )
    return out[:, :, rj:rj + ws].contiguous()


def normals_halo(p: NormalParams = NormalParams()) -> int:
    """Columns of points each side that the normals of a tile read.  The
    bilateral normals: 1 (the cross product's neighbours).  CM and SDC: the
    DT's dt_iterations rounds of one pixel over the depth-change map, which
    reads one column further (dci_map's right neighbour and the left
    neighbour's test); CM's covariance window (cuda_cov.MAX_R = 10, the
    window min(DT, 20 + z/10) <= 21 px), SDC's edge shifts (r4 + 1 <= 6
    at its window cap normals.MAX_RECT) and the rest normals' 1 lie
    within.  27 at the default 26 rounds.  (SDC's box sums read the whole
    frame's summed-area tables, not the halo.)"""
    if p.method == "bilateral":
        return 1
    reach = cuda_cov.MAX_R if p.method == "cm" else normals.MAX_RECT // 4 + 1
    return max(p.dt_iterations + 1, reach, 1)


def normals_sharded(
    points: torch.Tensor, mesh: Mesh, p: NormalParams, x0: int, width: int,
    widths: Sequence[int],
) -> torch.Tensor:
    """Normal map of this rank's width tile, any method: points f32
    [B, H, ws, 3] mm -> normals [B, H, ws, 3], bitwise the tile's columns
    of normals.generate_normal_map on the whole frames.  Every rank of the
    'x' group calls it: one exchange of normals_halo(p) columns of points
    and, for SDC, one gather of the group's depth (its summed-area tables
    are whole-frame prefixes, [B, H, W] f32), then haloed_normals.  The
    tile starts at global column x0 of frames `width` wide, and widths is
    every rank's tile width."""
    padded = halo.exchange_width(points, normals_halo(p), mesh)
    frame_z = (halo.gather_width(points[..., 2].contiguous(), mesh, widths)
               if p.method == "sdc" else None)
    return haloed_normals(padded, mesh, p, x0, width, frame_z=frame_z)


def haloed_normals(
    padded: torch.Tensor, mesh: Mesh, p: NormalParams, x0: int, width: int,
    frame_z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The tile's normals [B, H, ws, 3] from its points padded with
    normals_halo(p) columns as exchange_width pads them (and, for SDC, the
    whole frame's depth frame_z [B, H, W] mm); the tile starts at global
    column x0 of frames `width` wide.  The halos at the global image edges
    are dropped (drop_global_edges: dci_map's replicate right neighbour,
    the cross product's replicate pad, the covariance sweep's zero pad,
    SDC's clamped edge shifts and the DT's +inf border then see the frame's
    edge there); the smoothing map, the DT kernel (csrc/dt.cu), the
    covariance kernel (csrc/cov.cu) or SDC's box reads at global columns
    run unchanged on the haloed tile, the border tests on global columns,
    and the halo is cropped.  No kept value reads the outermost halo
    column.  (The DT's far value is w + h of the haloed tile, not of the
    frame: both exceed the smoothing size 20 + z/10 the map clamps to.)"""
    radius = normals_halo(p)
    ws = padded.shape[2] - 2 * radius
    tile, left = halo.drop_global_edges(padded, radius, mesh)
    nmap = normals.generate_normal_map(tile.contiguous(), p, x0=x0 - left, width=width,
                                       frame_z=frame_z)
    return nmap[:, :, left:left + ws].contiguous()


def plane_hole_fill_sharded(
    optimized: torch.Tensor, rays: torch.Tensor, labels: torch.Tensor, nd_map: torch.Tensor,
    trust: torch.Tensor, invalid: torch.Tensor, steps: int, mesh: Mesh,
) -> torch.Tensor:
    """plane.plane_hole_fill of this rank's width tile: optimized points
    [B, H, ws, 3], the tile's rays [H, ws, 3], merged labels [B, H, ws],
    their planes nd_map [B, H, ws, 4], trust and invalid [B, H, ws] ->
    [B, H, ws, 3], bitwise the tile's columns of the unsharded fill.  A
    pixel's fill reads its 4-neighbours' (label, plane) `steps` rounds
    deep, so `steps` columns of halo are exact.  Every rank of the 'x'
    group calls it: one exchange of labels + 1, the planes, trust and
    invalid packed into one f32 tensor (labels < 2^24 are exact), zeros
    past the frame: label -1, no plane, untrusted and not a hole, so a
    halo pixel there never fills and reads as the fill's own out-of-image
    value."""
    f32 = torch.float32
    packed = torch.cat([(labels + 1).to(f32)[..., None], nd_map,
                        trust.to(f32)[..., None], invalid.to(f32)[..., None]], dim=-1)
    return haloed_plane_hole_fill(halo.exchange_width(packed, steps, mesh), optimized, rays,
                                  steps)


def haloed_plane_hole_fill(
    padded: torch.Tensor, optimized: torch.Tensor, rays: torch.Tensor, steps: int
) -> torch.Tensor:
    """The tile's filled points [B, H, ws, 3] from the packed (labels + 1,
    planes, trust, invalid) [B, H, ws + 2 * steps, 7] padded as
    plane_hole_fill_sharded exchanges it: plane.plane_hole_fill unchanged
    on the haloed tile (the halo's points and rays zero: only the kept
    columns' projections are read), the halo cropped."""
    ws = optimized.shape[2]
    labels = padded[..., 0].to(torch.int32) - 1
    trust, invalid = padded[..., 5] > 0.0, padded[..., 6] > 0.0
    out = plane.plane_hole_fill(F.pad(optimized, (0, 0, steps, steps)),
                                F.pad(rays, (0, 0, steps, steps)), labels, padded[..., 1:5],
                                trust, invalid, steps)
    return out[:, :, steps:steps + ws]


def depth_bilateral_sharded(
    optimized: torch.Tensor, rays: torch.Tensor, mesh: Mesh,
    p: ProjectionParams = ProjectionParams(),
) -> torch.Tensor:
    """plane.depth_bilateral of this rank's width tile: optimized points
    [B, H, ws, 3] mm and the tile's rays [H, ws, 3] -> [B, H, ws, 3],
    bitwise the tile's columns of the unsharded filter.  The depth takes a
    halo of window // 2 columns, zeros at the global edges (the filter's
    pad2d convention)."""
    zpad = halo.exchange_width(optimized[..., 2].contiguous(), p.window // 2, mesh)
    return haloed_depth_bilateral(zpad, rays, p)


def haloed_depth_bilateral(
    zpad: torch.Tensor, rays: torch.Tensor, p: ProjectionParams = ProjectionParams()
) -> torch.Tensor:
    """The tile's depth-bilateral points from its depth [B, H, ws + 2r]
    padded with r = window // 2 columns as exchange_width pads it."""
    r = p.window // 2
    ws = zpad.shape[2] - 2 * r
    return rays * plane.bilateral_depth(zpad, p)[:, :, r:r + ws][..., None]
