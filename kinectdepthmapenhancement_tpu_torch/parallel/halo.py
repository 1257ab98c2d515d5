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
memory (mesh.wire).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.parallel.mesh import Mesh, wire


def exchange_width(x: torch.Tensor, radius: int, mesh: Mesh) -> torch.Tensor:
    """x [B, H, ws, ...] padded to [B, H, ws + 2 * radius, ...] with its
    'x' neighbours' boundary columns, zeros at the global image edges.
    Every rank of the 'x' group calls it with tiles of the same shape."""
    ws = x.shape[2]
    if ws < radius:
        raise ValueError(f"a tile {ws} wide cannot supply a halo of {radius} columns")
    zeros = torch.zeros_like(x[:, :, :radius])
    from_left, from_right = zeros, zeros
    if mesh.x > 1:
        group = mesh.x_group
        ops, recv = [], {}
        # one message each way per neighbour, posted in the same order on
        # both sides: my right strip becomes my right neighbour's left
        # halo, my left strip my left neighbour's right halo
        for side, peer_s, strip in (("left", mesh.s - 1, x[:, :, :radius]),
                                    ("right", mesh.s + 1, x[:, :, ws - radius:])):
            if not 0 <= peer_s < mesh.x:
                continue
            peer = mesh.x_ranks[peer_s]
            send = wire(strip.contiguous(), group)
            recv[side] = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, peer, group))
            ops.append(dist.P2POp(dist.irecv, recv[side], peer, group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        from_left = recv["left"].to(x.device) if "left" in recv else zeros
        from_right = recv["right"].to(x.device) if "right" in recv else zeros
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


def gather_width(tile: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full-width frames [B, H, x * ws, ...] from every rank's tile of
    this 'x' group, in 'x' order (dist.all_gather over the group)."""
    if mesh.x == 1:
        return tile
    group = mesh.x_group
    mine = wire(tile.contiguous(), group)
    parts = [torch.empty_like(mine) for _ in range(mesh.x)]
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts, dim=2).to(tile.device)
