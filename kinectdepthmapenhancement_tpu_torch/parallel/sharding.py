"""The KDE step over a ('data', 'x') mesh of processes, and the dryrun.

PyTorch counterpart of the JAX package's parallel/sharding.py.  Frames are
data-parallel over 'data'; the image width is tiled over 'x'.  The JAX
package gets its spatial partition from GSPMD with the Pallas kernels off;
PyTorch has no such partitioner, so the two regimes are written out:

  * 'x' == 1, data parallel: each rank runs the whole kde_pipeline on its
    own frames (no collective), every kernel of the path on each rank;
  * 'x' > 1, spatial: each rank holds a width tile of its data row's
    frames and the JBF runs on the haloed tile (stencil_shard.jbf_sharded,
    the csrc/jbf.cu kernel).  spatial_route then picks, from the config
    and the shapes alone, one of two routes for the stages after the JBF:
      - "tiled" (any KDEConfig, whenever each tile is at least as wide as
        its halos): each rank runs them on its own tile
        (pipelines._kde_from_jbf with a WidthTile).  Over a grid that
        divides the frame the tile holds whole cells: the data tile itself
        where it does, else the cell-aligned tile (Mesh.cell_tiles: the
        cells whose first column lies in the data tile), to which the
        filtered depth and the colour move first and from which the maps
        move back after (halo.retile).  The normals from a haloed tile of
        points (stencil_shard.normals_sharded: CM and SDC 27 columns, the
        DT and covariance kernels on the haloed tile, SDC's summed-area
        tables built from the group's gathered depth; bilateral 1 column);
        NASP's seeds on the tile's own cells (the sub-grid gradient) or,
        where a seed window's support leaves its cell, from the gradient on
        a 5-column haloed tile with each window read from the tile that
        holds each pixel; its first iteration and weighted update on the
        tile's cells (the cell kernels at the tile's first cell column)
        over a grid that divides the frame, else the global sweep from the
        grid-init labels at the tile's global columns and the global
        index; its later iterations' sweep on the tile's pixels, the cap
        check's verdict combined over the group; the CCL merge (normal or
        plane merge) with a one-column label halo, the plane stage per
        pixel, the hole fill from a fill_holes-column halo and the depth
        bilateral from a 3-column halo.  Every cluster sum goes through
        per-(cell, candidate) partials gathered in cell order (not summed)
        and folded replicated, or, on the global index, through the
        group's gathered features in one whole-frame product, so the
        [B, K, ...] tables are the unsharded ones bitwise;
      - "replicated" (tiles narrower than a halo, data tiles narrower than
        a cell; and by name, spatial_kde(route="replicated")): the filtered
        depth and the colour tiles are all-gathered over the 'x' group, the
        stages after the JBF run on the whole frames on every rank of the
        group, and each rank keeps its own width slice.

Either way the output is bitwise equal to kde_pipeline on the same frames.
sharded_kde_step returns the step as a compiled call (core/jit.py), as the
JAX package jits it: on the card each rank captures its step once per
shape and replays it, every collective a host step between graph pieces
(the transfer on the host under gloo) and, on the tiled route, every cap
check a host branch on the group's verdict; on CPU tensors the step runs
eagerly.  `dryrun(n)` is the counterpart of the JAX dryrun and of
__graft_entry__.dryrun_multichip: n spawned ranks run one step on 96x128
frames and rank 0 holds it against an unsharded, compiled kde_pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.core import jit
from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import (
    GridParams, KDEConfig, NormalParams, ProjectionParams,
)
from kinectdepthmapenhancement_tpu_torch.core.device import constant
from kinectdepthmapenhancement_tpu_torch.models.pipelines import (
    KDEResult, _kde_from_jbf, kde_pipeline,
)
from kinectdepthmapenhancement_tpu_torch.ops import cuda_bilateral, slic
from kinectdepthmapenhancement_tpu_torch.parallel import halo, multihost
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import (
    Mesh, all_gather_x, all_x, gather_cells, make_mesh, wire,
)
from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import (
    depth_bilateral_sharded, jbf_sharded, normals_halo, normals_sharded,
    plane_hole_fill_sharded,
)

ROUTES = ("tiled", "replicated")


def disable_pallas(cfg: KDEConfig) -> KDEConfig:
    """cfg with every kernel route set to its plain ("xla") twin, as the JAX
    package's disable_pallas: GSPMD cannot partition a pallas_call, so its
    spatially sharded step must never reach one.  The port's spatial step
    does not call it, and reads none of the four fields it sets: no
    partitioner ever meets its kernels.  On its tiled
    route every kernel of the path runs on the rank's own tile (the JBF,
    DT and covariance on haloed tiles, the seed gradient on the tile's
    sub-grid or on a haloed tile, the NASP cell kernels at the tile's first
    cell column); on its replicated route the JBF runs on the tile and the
    rest on the gathered whole frames."""
    return dataclasses.replace(
        cfg,
        normals=dataclasses.replace(cfg.normals, cov_impl="xla", dt_impl="xla"),
        nasp=dataclasses.replace(cfg.nasp, grad_impl="xla", stats_impl="xla"),
    )


class WidthTile:
    """This rank's width tile on the tiled route: the slic.CellTile that
    NASP, CCL and the plane stage read (its pixel columns and, over a grid
    that divides the frame, its cell columns; the 'x' group's cell and width
    gathers, pixel lookup, count sum, halos and label halo), and the stencil
    stages that pipelines._kde_from_jbf runs on haloed tiles.  The tiles of
    frames h x w are tile_spans': cell-aligned over a grid that divides the
    frame (uneven where a data tile splits a cell), else the data tiles,
    pixel columns only (no cell kernel runs there).  Every method that
    communicates is a collective of the 'x' group."""

    def __init__(self, mesh: Mesh, grid: GridParams, h: int, w: int):
        self.mesh = mesh
        self.width = w
        self.spans, self.tile_cols = tile_spans(mesh, grid, h, w)
        self.widths = tuple(width for _, width in self.spans)
        self.x0, self.ws = self.spans[mesh.s]
        self.c0 = self.cols = None
        if self.tile_cols is not None:
            self.c0, self.cols = self.x0 // (w // grid.cols), self.tile_cols[mesh.s]

    def gather_cells(self, x: torch.Tensor) -> torch.Tensor:
        return gather_cells(x, self.mesh, self.tile_cols)

    def pixels_at(self, img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """img [B, H, ws, ...] (the tile) at global pixels (x, y) [B, N]:
        each rank reads the pixels of its columns, the group's reads are
        gathered, and each pixel takes the value of the tile that holds it
        (a selection, exact)."""
        b, h, ws = img.shape[:3]
        flat = img.reshape((b, h * ws) + tuple(img.shape[3:]))
        local = (x.long() - self.x0).clamp(0, ws - 1)
        mine = flat[torch.arange(b, device=img.device)[:, None], y.long() * ws + local]
        every = all_gather_x(mine[None], self.mesh, dim=0)  # [x, B, N, ...]
        starts = constant(tuple(x0 for x0, _ in self.spans[1:]), torch.int64, x.device)
        owner = torch.bucketize(x.long().contiguous(), starts, right=True)
        owner = owner.reshape((1,) + tuple(x.shape) + (1,) * (mine.dim() - 2))
        return torch.gather(every, 0, owner.expand((1,) + tuple(mine.shape)))[0]

    def gather_width(self, x: torch.Tensor) -> torch.Tensor:
        """The frames [B, H, W, ...] from every rank's tile x [B, H, ws, ...]."""
        return halo.gather_width(x.contiguous(), self.mesh, self.widths)

    def sum_counts(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the 'x' group of each rank's integer-valued f32
        counts x (< 2^24: exact, the same in any order), gathered and added
        in 'x' order."""
        return all_gather_x(x[None], self.mesh, dim=0).sum(dim=0)

    def all_true(self, ok: torch.Tensor) -> torch.Tensor:
        """0-dim bool: every element of every rank's ok holds (mesh.all_x,
        one host step)."""
        return all_x(ok, self.mesh)

    def haloed(self, x: torch.Tensor, radius: int):
        """(x [B, H, ws, ...] with `radius` columns of its neighbours each
        side and none past the frame, the columns kept on the left): the
        tile's edge at the frame's edge is the frame's."""
        return halo.drop_global_edges(halo.exchange_width(x, radius, self.mesh), radius,
                                      self.mesh)

    def right_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """[B, H, 1]: the labels of the column right of the tile (its right
        neighbour's first), -1 past the frame."""
        return halo.exchange_width(labels, 1, self.mesh, fill=-1)[:, :, -1:]

    def crop_rays(self, rays: torch.Tensor) -> torch.Tensor:
        """The tile's columns of the frame's ray map [H, W, 3]."""
        return rays[:, self.x0:self.x0 + self.ws]

    def normal_map(self, points: torch.Tensor, p: NormalParams) -> torch.Tensor:
        return normals_sharded(points, self.mesh, p, x0=self.x0, width=self.width,
                               widths=self.widths)

    def plane_hole_fill(self, optimized, rays, labels, nd_map, trust, invalid,
                        steps: int) -> torch.Tensor:
        return plane_hole_fill_sharded(optimized, rays, labels, nd_map, trust, invalid, steps,
                                       self.mesh)

    def depth_bilateral(self, optimized: torch.Tensor, rays: torch.Tensor,
                        p: ProjectionParams) -> torch.Tensor:
        return depth_bilateral_sharded(optimized, rays, self.mesh, p)


def tile_spans(mesh: Mesh, grid: GridParams, h: int, w: int):
    """(spans, tile_cols) of the tiles the tiled route's stages after the
    JBF run on for frames h x w: over a grid that divides the frame the
    cell-aligned tiles (Mesh.cell_tiles), every rank's (x0, width) and its
    count of cell columns; else the data tiles' (x0, width) and None.
    Raises where a data tile is narrower than a cell of a grid that divides
    the frame."""
    if not slic.grid_divides(grid, h, w):
        return mesh.tile_spans(w), None
    cell = w // grid.cols
    tiles = mesh.cell_tiles(w, grid.cols)
    return (tuple((x0, cols * cell) for x0, _, cols in tiles),
            tuple(cols for _, _, cols in tiles))


def tile_halo(cfg: KDEConfig) -> int:
    """The widest halo a tile of the tiled route supplies: the normals'
    (normals_halo), the depth bilateral's, the hole fill's and the seed
    gradient's (slic.GRAD_MARGIN)."""
    return max(normals_halo(cfg.normals), cfg.projection.window // 2, cfg.fill_holes,
               slic.GRAD_MARGIN)


def spatial_route(mesh: Mesh, cfg: KDEConfig, h: int, w: int) -> str:
    """The route of the stages after the JBF on this mesh for frames h x w:
    "tiled" when 'x' > 1 cuts the width into data tiles at least one grid
    cell wide and every tile the stages run on is at least as wide as its
    halos (tile_halo): the data tiles where the grid does not divide the
    frame (NASP's global route), else the cell-aligned tiles (tile_spans),
    for any normal method, NASP iteration count, merge and hole fill;
    "replicated" otherwise, and at 'x' == 1 (where each rank runs
    kde_pipeline on its own frames).  A choice on the static arguments,
    not a fallback: a kernel that fails on a tile raises."""
    if mesh.x == 1 or w % mesh.x or w // mesh.x < w // cfg.grid.cols:
        return "replicated"
    spans, _ = tile_spans(mesh, cfg.grid, h, w)
    return "tiled" if min(width for _, width in spans) >= tile_halo(cfg) else "replicated"


def _tiled_kde_from_jbf(jbf_t: torch.Tensor, color_t: torch.Tensor, mesh: Mesh,
                        intr: Intrinsics, cfg: KDEConfig) -> KDEResult:
    """The stages after the JBF on this rank's width tile (the tiled
    route): jbf_t f32 [B, H, ws], color u8 [B, H, ws, 3] (the data tile)
    -> the data tile's KDEResult ([B, H, ws, ...] maps, the whole frames'
    [B, K] tables).  Where the data tiles split a grid cell, the filtered
    depth and the colour (packed in one tensor) move to the cell-aligned
    tiles first and the maps back after (halo.retile).  Raises where
    spatial_route does not read "tiled"."""
    b, h, ws = jbf_t.shape
    w = ws * mesh.x
    if spatial_route(mesh, cfg, h, w) != "tiled":
        raise ValueError(f"the stages after the JBF have no tiled form for this config on "
                         f"{mesh.x} tiles of {h}x{w}")
    tile = WidthTile(mesh, cfg.grid, h, w)
    data = mesh.tile_spans(w)
    if tile.spans == data:
        return _kde_from_jbf(jbf_t, color_t, intr, cfg, tile=tile)
    f32 = torch.float32
    moved = halo.retile(torch.cat([jbf_t[..., None], color_t.to(f32)], dim=-1), data,
                        tile.spans, mesh)
    res = _kde_from_jbf(moved[..., 0].contiguous(), moved[..., 1:].to(torch.uint8).contiguous(),
                        intr, cfg, tile=tile)
    # the maps in one tensor (labels < 2^24, exact in f32)
    maps = torch.cat([res.optimized_points, res.plane_fitted, res.normals,
                      res.nasp_labels.to(f32)[..., None], res.merged_labels.to(f32)[..., None]],
                     dim=-1)
    back = halo.retile(maps, tile.spans, data, mesh)
    return res._replace(
        optimized_points=back[..., 0:3].contiguous(), plane_fitted=back[..., 3:6].contiguous(),
        jbf_depth=jbf_t, normals=back[..., 6:9].contiguous(),
        nasp_labels=back[..., 9].to(torch.int32), merged_labels=back[..., 10].to(torch.int32))


# the KDEResult fields that are maps [B, H, W, ...]; the rest are [B, K] tables
PER_PIXEL_FIELDS = ("optimized_points", "plane_fitted", "jbf_depth", "normals",
                    "nasp_labels", "merged_labels")


def spatial_kde(depth_t: torch.Tensor, color_t: torch.Tensor, mesh: Mesh, intr: Intrinsics,
                cfg: KDEConfig, route: Optional[str] = None):
    """KDE of this rank's width tile at 'x' > 1: depth f32 [b, H, ws] and
    color u8 [b, H, ws, 3] -> (route, the tile's KDEResult): the JBF on the
    haloed tile, then the stages after it on spatial_route's route (on the
    tiled one on the data tile or the cell-aligned tile, each per-pixel
    field moved back to the data tile; on the replicated one on the
    gathered frames, each per-pixel field cut to the tile).  Every field
    is bitwise the tile's part of kde_pipeline on the whole frames.  Every
    rank of the 'x' group calls it.  `route` names one to take instead
    (chip_smoke.py measures the replicated route beside the tiled one);
    "tiled" raises where spatial_route does not read it."""
    if route not in (None,) + ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    b, h, ws = depth_t.shape
    route = route or spatial_route(mesh, cfg, h, ws * mesh.x)
    jbf_t = jbf_sharded(depth_t, color_t, mesh, cfg.jbf)
    if route == "tiled":
        return route, _tiled_kde_from_jbf(jbf_t, color_t, mesh, intr, cfg)
    full = _kde_from_jbf(halo.gather_width(jbf_t, mesh), halo.gather_width(color_t, mesh),
                         intr, cfg)
    return route, full._replace(
        **{f: mesh.width_tile(getattr(full, f)) for f in PER_PIXEL_FIELDS})


def sharded_kde_step(mesh: Mesh, intr: Intrinsics, cfg: KDEConfig):
    """Returns the batched KDE step on this rank's local blocks as a
    compiled call (core/jit.py; the JAX step is a jax.jit in both regimes):
    depth f32 [b, H, ws] and color u8 [b, H, ws, 3] on mesh.device ->
    optimized points f32 [b, H, ws, 3], where b is this data row's frames
    and ws = W / x its width tile (the whole width at x == 1).  The layout
    of the JAX step's P("data", None, "x", None) output.  Every rank of the
    mesh calls it.  On the card each rank's first call of a shape captures
    its step and later calls replay it: at 'x' > 1 with every collective a
    host step between graph pieces and the tiled route's cap checks host
    branches.  At 'x' > 1 every call records the route it takes in
    `step.route` (spatial_route, from the shapes)."""

    def prologue(depth_b, color_b):
        for t in (depth_b, color_b):
            if t.device != mesh.device:
                raise ValueError(f"a block on {t.device}; this rank's device is {mesh.device}")
        if mesh.x > 1:
            b, h, ws = depth_b.shape
            step.route = spatial_route(mesh, cfg, h, ws * mesh.x)

    if mesh.x == 1:
        def local_step(depth_b, color_b):
            return kde_pipeline(depth_b, color_b, intr, cfg).optimized_points

        step = jit.jit(local_step, prologue)
        return step

    def spatial_step(depth_t, color_t):
        _, result = spatial_kde(depth_t, color_t, mesh, intr, cfg)
        return result.optimized_points.contiguous()

    step = jit.jit(spatial_step, prologue)
    step.route = None
    return step


def gather_global(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch [data * b, H, W, ...] on every rank from each rank's
    output block [b, H, ws, ...] (dist.all_gather over the world; rank
    d * x + s holds rows d's frames, tile s)."""
    if mesh.world_size == 1:
        return local
    mine = wire(local.contiguous(), None)
    parts = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(parts, mine)
    rows = [torch.cat(parts[d * mesh.x:(d + 1) * mesh.x], dim=2) for d in range(mesh.data)]
    return torch.cat(rows, dim=0).to(local.device)


def _dryrun_rank(device) -> dict:
    """One rank of dryrun(): the JAX dryrun's mesh and inputs (one random
    96x128 frame per data row, grid 3x4), one step, parity on rank 0."""
    n = dist.get_world_size()
    spatial = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n, spatial=spatial, device=device)
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    rng = np.random.default_rng(0)
    batch = mesh.data
    depth = rng.uniform(500.0, 4000.0, size=(batch, h, w)).astype(np.float32)
    color = rng.integers(0, 255, size=(batch, h, w, 3), dtype=np.uint8)

    d_local = multihost.local_batch_to_global(mesh, [depth[mesh.d]])
    c_local = multihost.local_batch_to_global(mesh, [color[mesh.d]], extra_dims=1)
    step = sharded_kde_step(mesh, intr, cfg)
    blocks = (mesh.width_tile(d_local.local), mesh.width_tile(c_local.local))
    before = cuda_bilateral.launches
    out = step(*blocks)
    if not torch.equal(step(*blocks), out):  # on the card a replay of the first call
        raise RuntimeError("dryrun: the step's second call differs from its first")
    launches = cuda_bilateral.launches - before
    route = getattr(step, "route", "data")
    full = gather_global(out, mesh)
    if tuple(full.shape) != (batch, h, w, 3):
        raise RuntimeError(f"dryrun: output {tuple(full.shape)}, want {(batch, h, w, 3)}")
    line = None
    if mesh.rank == 0:
        single = jit.jit(kde_pipeline)  # the JAX dryrun jits its unsharded reference
        want = single(torch.from_numpy(depth).to(mesh.device),
                      torch.from_numpy(color).to(mesh.device), intr, cfg).optimized_points
        if not torch.equal(full, want):
            bad = int((full != want).any(-1).sum())
            raise RuntimeError(f"dryrun: the sharded step differs from kde_pipeline on {bad} "
                               "pixels")
        line = (f"dryrun_multichip ok: mesh={mesh.shape} out={tuple(full.shape)} "
                f"route={route} backend={dist.get_backend()} device={mesh.device} "
                "parity=ok (bitwise)")
    return {"line": line, "jbf_launches": launches}


def dryrun(n_devices: int, device=None, backend: Optional[str] = None,
           store_dir: Optional[str] = None) -> dict:
    """The compiled sharded KDE step on `n_devices` spawned ranks
    (multihost.spawn) on tiny shapes, called twice (on the card a capture,
    then a replay) and held bitwise against an unsharded, compiled
    kde_pipeline on rank 0; prints rank 0's "dryrun_multichip ok: ...
    parity=ok" line and returns it with each rank's JBF launches over the
    two calls (on the card the warm-up's and the capture's: a replay
    launches nothing from Python).  The ranks run on the card by
    default (NCCL, one card a rank: more ranks than cards raise, no silent
    pass); backend="gloo" lets ranks share a card (rank r on card r modulo
    the count), device="cpu" runs them on the CPU under gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun on the card: no CUDA device is available")
        count = torch.cuda.device_count()
        if (backend or "nccl") == "nccl" and n_devices > count:
            raise RuntimeError(f"need {n_devices} devices, have {count} on backend nccl")
    ranks = multihost.spawn(_dryrun_rank, n_devices, args=(str(dev),), device=str(dev),
                            backend=backend, store_dir=store_dir)
    print(ranks[0]["line"])
    return {"line": ranks[0]["line"], "jbf_launches": [r["jbf_launches"] for r in ranks]}
