"""Halo exchange for stencil ops on width tiles, and the width gather.

PyTorch counterpart of the JAX package's parallel/halo.py.  The JAX
package ppermutes boundary strips around a ring of shards inside
shard_map and masks the wrapped-around ones at the global edges; here each
rank sends its strips to its real neighbours in its 'x' group only
(dist.batch_isend_irecv), and the halos at the global image edges are
zeros, the stencil modules' zero-padding convention.  So a local window
op over the padded tile is bitwise equal to the unsharded op.

Tiles carry a leading batch axis: [B, H, ws, ...], the width on axis 2.
Under NCCL the strips stay on the card; under gloo they go through host
memory (mesh.wire).  A stencil whose own edge rule is not a zero pad
takes a halo filled with its out-of-image value (exchange_width's
`fill`: -1 for labels) or none at the global edges (drop_global_edges:
the tile's edge is then the frame's, for replicate pads and +inf
borders).  retile moves columns between two tilings of the same frames
(the data tiles and the cell-aligned ones of the tiled KDE route).
Each exchange is one host step of core/jit.py (the strips' transfer; the
cutting and concatenation around it are ordinary ops).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.core import jit
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import (
    Mesh, all_gather_x, note_collective, wire,
)


def exchange_width(x: torch.Tensor, radius: int, mesh: Mesh, fill: float = 0) -> torch.Tensor:
    """x [B, H, ws, ...] padded to [B, H, ws + 2 * radius, ...] with its
    'x' neighbours' boundary columns, `fill` (zeros by default) at the
    global image edges.  Every rank of the 'x' group calls it with tiles of
    the same shape."""
    ws = x.shape[2]
    if ws < radius:
        raise ValueError(f"a tile {ws} wide cannot supply a halo of {radius} columns")
    zeros = torch.full_like(x[:, :, :radius], fill)
    from_left, from_right = zeros, zeros
    if mesh.x > 1:
        # my left strip becomes my left neighbour's right halo, my right
        # strip my right neighbour's left halo
        sides = [(side, mesh.x_ranks[peer_s], strip.contiguous())
                 for side, peer_s, strip in (("left", mesh.s - 1, x[:, :, :radius]),
                                             ("right", mesh.s + 1, x[:, :, ws - radius:]))
                 if 0 <= peer_s < mesh.x]

        def exchange(*strips):
            group = mesh.x_group
            ops, recv = [], []
            # one message each way per neighbour, posted in the same order
            # on both sides
            for (_, peer, _), strip in zip(sides, strips):
                send = wire(strip, group)
                recv.append(torch.empty_like(send))
                ops.append(dist.P2POp(dist.isend, send, peer, group))
                ops.append(dist.P2POp(dist.irecv, recv[-1], peer, group))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return recv

        got = dict(zip((side for side, _, _ in sides),
                       jit.collective(exchange, *(strip for _, _, strip in sides))))
        note_collective()
        from_left = got.get("left", zeros)
        from_right = got.get("right", zeros)
    return torch.cat([from_left, x, from_right], dim=2)


def reflect101_at_global_edges(padded: torch.Tensor, radius: int, mesh: Mesh) -> torch.Tensor:
    """Rewrite the zero halos that exchange_width leaves at the global image
    edges with reflect-101 values (col -k := col k, col W-1+k := col W-1-k),
    the border mode of the colour-guide pre-smoothing (ops/bilateral.py
    guide_bilateral).  Interior halos are untouched.

    padded: [B, H, radius + ws + radius, ...] as exchange_width returns it;
    the tile must be at least radius + 1 wide."""
    ws = padded.shape[2] - 2 * radius
    if ws < radius + 1:
        raise ValueError(f"reflect-101 of {radius} columns needs a tile at least "
                         f"{radius + 1} wide, got {ws}")
    left = padded[:, :, :radius]
    core = padded[:, :, radius:radius + ws]
    right = padded[:, :, radius + ws:]
    if mesh.s == 0:
        # left halo position p holds global col -(radius - p): core col
        # radius - p, padded col 2 * radius - p
        left = padded[:, :, radius + 1:2 * radius + 1].flip(2)
    if mesh.s == mesh.x - 1:
        # right halo position q holds col ws - 1 + (q + 1): core col
        # ws - 2 - q, padded col radius + ws - 2 - q
        right = padded[:, :, ws - 1:radius + ws - 1].flip(2)
    return torch.cat([left, core, right], dim=2)


def drop_global_edges(padded: torch.Tensor, radius: int, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """(tile, left): padded as exchange_width returns it without its halos
    at the global image edges, so the tile's edge there is the frame's;
    left is the halo columns it keeps on the left (0 on the first tile)."""
    lo = radius if mesh.s == 0 else 0
    hi = padded.shape[2] - (radius if mesh.s == mesh.x - 1 else 0)
    return padded[:, :, lo:hi], radius - lo


def gather_width(tile: torch.Tensor, mesh: Mesh,
                 widths: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The full-width frames [B, H, W, ...] from every rank's tile of this
    'x' group, in 'x' order (dist.all_gather over the group); widths: every
    rank's tile width where they differ (cell-aligned tiles)."""
    return all_gather_x(tile, mesh, dim=2, sizes=widths)


def retile(x: torch.Tensor, src: Sequence[Tuple[int, int]], dst: Sequence[Tuple[int, int]],
           mesh: Mesh) -> torch.Tensor:
    """This rank's columns src[s] of frames x [B, H, width, ...] -> its
    columns dst[s] [B, H, width', ...]: src and dst are every rank's (x0,
    width) of two tilings of the same frames (Mesh.tile_spans).  Each rank
    sends the columns of its tile that another rank's dst holds to that
    rank, one message a peer (dist.batch_isend_irecv; on the card under
    NCCL, through host memory under gloo), and keeps its own; a copy, so
    exact.  Every rank of the 'x' group calls it."""
    x0, width = src[mesh.s]
    y0, width_y = dst[mesh.s]
    if x.shape[2] != width:
        raise ValueError(f"a tile {x.shape[2]} wide; rank {mesh.s}'s source tile is {width}")
    if mesh.x == 1:
        return x
    # my columns that each peer holds in dst, and each peer's columns that
    # I hold: the pieces of my dst tile in column order, my own kept
    sends, recvs, pieces = [], [], []
    for peer_s in range(mesh.x):
        p0, pw = dst[peer_s]
        lo, hi = max(x0, p0), min(x0 + width, p0 + pw)
        if peer_s != mesh.s and hi > lo:
            sends.append((mesh.x_ranks[peer_s], x[:, :, lo - x0:hi - x0].contiguous()))
        q0, qw = src[peer_s]
        lo, hi = max(q0, y0), min(q0 + qw, y0 + width_y)
        if hi <= lo:
            continue
        if peer_s == mesh.s:
            pieces.append(x[:, :, lo - x0:hi - x0])
        else:
            shape = (x.shape[0], x.shape[1], hi - lo) + tuple(x.shape[3:])
            recvs.append((mesh.x_ranks[peer_s], shape))
            pieces.append(len(recvs) - 1)  # the step's output of that index

    def move(_, *send_tiles):
        group = mesh.x_group
        ops, got = [], []
        for (peer, _), tile in zip(sends, send_tiles):
            ops.append(dist.P2POp(dist.isend, wire(tile, group), peer, group))
        for peer, shape in recvs:
            got.append(wire(torch.empty(shape, dtype=x.dtype, device=x.device), group))
            ops.append(dist.P2POp(dist.irecv, got[-1], peer, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got

    # x first: the step's device, whatever this rank sends
    got = jit.collective(move, x, *(tile for _, tile in sends))
    note_collective()
    out = torch.cat([got[p] if isinstance(p, int) else p for p in pieces], dim=2)
    if out.shape[2] != width_y:
        raise ValueError(f"the source tiles cover {out.shape[2]} of the {width_y} columns of "
                         f"rank {mesh.s}'s destination tile")
    return out
