"""The ('data', 'x') process mesh: frames over 'data', image width over 'x'.

PyTorch counterpart of the JAX package's parallel/mesh.py.  A JAX Mesh
holds devices; here one process drives one device (one rank), so the mesh
holds this rank's place in the grid, its device and the process groups
its collectives run over.  Ranks are laid out as the JAX mesh lays out
devices, row-major over (data, x): rank = d * x + s.  The 'x' group of a
rank is its data row (the ranks that tile the same frames); its 'data'
group is its column (the ranks that hold the same width tile of the other
rows' frames).

Without torch.distributed initialised the mesh is 1 x 1, on the device the
caller names (the card by default).

Width tiles (the tiled KDE route, sharding.py): a rank's data tile is
columns [s * ws, (s + 1) * ws) of frames W = x * ws wide (width_tile).
Over a grid that divides the frame, a rank's cell-aligned tile holds the
cells whose first column lies in its data tile (Mesh.cell_tiles: uneven
where a data tile splits a cell); Mesh.tile_spans gives every rank's
(x0, width) of the data tiles, and the gathers here take uneven pieces
(padded to the widest, then cut in 'x' order).  gather_cells puts the
group's per-cell pieces back in cell order.  `collectives` counts the
collective calls over a process group (each exchange or gather here and
in halo.py).  Each collective is one host step of core/jit.py (its
transfer, under gloo through host memory; the padding, cutting and
concatenation around it are ordinary ops), so a compiled call replays its
graph pieces with the collectives run between them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.core import jit
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device

collectives = 0  # collective calls since the last reset (chip_smoke.py reads it)


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: `device` as given ("cpu", "cuda:1"); "cuda"
    without an index (and None, the card) takes the card of this rank's
    local rank (LOCAL_RANK, else `rank`, else the process group's rank)
    modulo the cards on the host.  Raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ('data', 'x') mesh."""

    data: int                 # extent of the 'data' axis
    x: int                    # extent of the 'x' axis (width tiles)
    rank: int
    d: int                    # this rank's 'data' coordinate
    s: int                    # this rank's 'x' coordinate
    device: torch.device
    x_ranks: Tuple[int, ...]  # the global ranks of this rank's data row
    x_group: Any = None       # ProcessGroup over x_ranks (None at world size 1)
    data_group: Any = None    # ProcessGroup over this rank's column

    @property
    def world_size(self) -> int:
        return self.data * self.x

    @property
    def shape(self):
        """{'data': ..., 'x': ...}, as a JAX Mesh's shape reads."""
        return {"data": self.data, "x": self.x}

    def width_tile(self, frames: torch.Tensor) -> torch.Tensor:
        """This rank's columns of full-width frames [B, H, W, ...]: the
        tile [B, H, W / x, ...] at 'x' coordinate s.  Raises when x does
        not divide W (the JAX sharding needs the same)."""
        w = frames.shape[2]
        if w % self.x:
            raise ValueError(f"width {w} is not divisible by the mesh's x = {self.x}")
        ws = w // self.x
        return frames[:, :, self.s * ws:(self.s + 1) * ws]

    def cell_tiles(self, w: int, grid_cols: int) -> Tuple[Tuple[int, int, int], ...]:
        """Every rank's (x0, c0, tile cols) of the 'x' group's cell-aligned
        tiles of frames w wide over a grid of grid_cols cell columns: rank s
        holds the cells whose first column lies in its data tile [s * ws,
        (s + 1) * ws), so a data tile at least one cell wide gives every rank
        at least one cell; x0 is the tile's first global column, c0 its first
        cell column.  Tiles of several ranks differ in width where a data
        tile splits a cell.  Raises unless x and the grid divide w and a data
        tile is at least one cell wide."""
        if w % self.x or w % grid_cols or w // self.x < w // grid_cols:
            raise ValueError(f"{self.x} width tiles of {w} columns do not hold whole cells "
                             f"of a {grid_cols}-column grid")
        ws, cell = w // self.x, w // grid_cols
        firsts = [-(-s * ws // cell) for s in range(self.x + 1)]  # ceil(s * ws / cell)
        return tuple((c0 * cell, c0, c1 - c0) for c0, c1 in zip(firsts, firsts[1:]))

    def tile_spans(self, w: int) -> Tuple[Tuple[int, int], ...]:
        """Every rank's (x0, width) of the 'x' group's data tiles of frames
        w wide (width_tile)."""
        if w % self.x:
            raise ValueError(f"width {w} is not divisible by the mesh's x = {self.x}")
        return tuple((s * (w // self.x), w // self.x) for s in range(self.x))

def wire(t: torch.Tensor, group) -> torch.Tensor:
    """t as `group`'s backend carries it: through host memory under gloo
    (its point-to-point ops take CPU tensors), on the device under NCCL.
    The transport follows the backend the caller initialised; the caller
    moves what arrives back with .to(mesh.device)."""
    return t.cpu() if dist.get_backend(group) == "gloo" else t


def note_collective() -> None:
    """Count one collective call (the module's `collectives`)."""
    global collectives
    collectives += 1


def all_gather_x(t: torch.Tensor, mesh: Mesh, dim: int = 2,
                 sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The 'x' group's pieces of t concatenated along `dim` in 'x' order
    (dist.all_gather over the group, one host step of core/jit.py); t
    itself at x == 1.  The pieces are of one shape, or `sizes` gives every
    rank's extent along `dim`: each piece is then padded to the largest and
    cut back after the gather."""
    if mesh.x == 1:
        return t
    if sizes is not None and sizes[mesh.s] != t.shape[dim]:
        raise ValueError(f"rank {mesh.s}'s piece is {t.shape[dim]} along dim {dim}, "
                         f"its size is {sizes[mesh.s]}")
    if sizes is not None and t.shape[dim] < max(sizes):
        pad = list(t.shape)
        pad[dim] = max(sizes) - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)

    def gather(mine):
        mine = wire(mine, mesh.x_group)
        parts = [torch.empty_like(mine) for _ in range(mesh.x)]
        dist.all_gather(parts, mine, group=mesh.x_group)
        return parts

    parts = jit.collective(gather, t.contiguous())
    note_collective()
    if sizes is not None:
        parts = [part.narrow(dim, 0, n) for part, n in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


def all_x(ok: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """0-dim bool: every element of ok holds on every rank of the 'x' group
    (ok.all() at x == 1).  One host step: each rank's ok.all() gathered
    over the group (dist.all_gather) and combined there, so under gloo the
    verdict is on the host, and a jit.cond on it reads it there."""
    if mesh.x == 1:
        return ok.all()
    mine = ok.all().reshape(1).to(torch.uint8)  # gloo carries no bool

    def verdict(mine):
        mine = wire(mine, mesh.x_group)
        parts = [torch.empty_like(mine) for _ in range(mesh.x)]
        dist.all_gather(parts, mine, group=mesh.x_group)
        return [torch.cat(parts).to(torch.bool).all()]

    (out,) = jit.collective(verdict, mine)
    note_collective()
    return out


def gather_cells(x: torch.Tensor, mesh: Mesh,
                 tile_cols: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Per-cell pieces [B, rows, tile cols, ...] of every rank of the 'x'
    group -> [B, rows, cols, ...], in global cell order (the tiles hold
    consecutive cell columns in 'x' order); tile_cols: every rank's count
    where they differ (cell-aligned tiles)."""
    return all_gather_x(x, mesh, dim=2, sizes=tile_cols)


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1, device=None) -> Mesh:
    """Mesh over ('data', 'x'): `spatial` ranks on the image width, the rest
    on the batch.  Under torch.distributed every rank calls it, in the same
    order as every other collective call (it creates the process groups);
    n_devices, when given, must be the world size.  Single-process it is
    the 1 x 1 mesh on `device` (the card by default)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the world has {n} ranks")
    if n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    data = n // spatial
    d, s = divmod(rank, spatial)
    x_group = data_group = None
    if n > 1:
        # dist.new_group must be called by every rank for every group, in
        # the same order, including the groups a rank is not in
        for row in range(data):
            g = dist.new_group([row * spatial + c for c in range(spatial)])
            x_group = g if row == d else x_group
        for col in range(spatial):
            g = dist.new_group([row * spatial + col for row in range(data)])
            data_group = g if col == s else data_group
    return Mesh(
        data=data, x=spatial, rank=rank, d=d, s=s,
        device=rank_device(device, rank),
        x_ranks=tuple(d * spatial + c for c in range(spatial)),
        x_group=x_group, data_group=data_group,
    )
