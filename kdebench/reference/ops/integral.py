"""Integral images (summed-area tables) for the SDC normals.

PyTorch counterpart of the JAX package's ops/integral.py: an exclusive
(H+1, W+1) 2-D prefix of mean-centred channels, an exact pixel-count prefix
and a valid-pixel-count prefix, read by box corners with the reference's
inclusive-integral convention (getSumFromIntegralImageD,
NormalMapGenerator.cu:20-27; see the JAX module's docstring).

Precision, a divergence by decision: the JAX package accumulates the
prefixes in f32, in XLA's order.  Neither that order nor f32 accumulation
can be reproduced here (torch.cumsum accumulates f32 in double on the CPU
and in an f32 parallel scan on CUDA), and the SDC normals built on these
tables are ill-conditioned at 640x480.  So the port sums the f32 centred
channels in float64 and rounds once to the f32 tables, on every device:
the CPU and the card then agree up to the rare f64 sum that lands next to
an f32 rounding boundary.  Counts are integers below 2^24, exact in f32.

Tables carry a leading batch dimension: [B, H+1, W+1, C] and [B, H+1, W+1].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.device import constant

Offset = Union[int, torch.Tensor]


class CenteredIntegral(NamedTuple):
    """Exclusive 2-D prefix of mean-centred channels + exact pixel count."""

    centered: torch.Tensor  # [B, H+1, W+1, C] f32 prefix of (c - mu)
    count: torch.Tensor     # [B, H+1, W+1] f32 prefix of all-ones (exact ints)
    valid: torch.Tensor     # [B, H+1, W+1] f32 prefix of (z != 0) (exact ints)
    mu: torch.Tensor        # [B, C] f32 channel means (over all pixels)


def _ex_prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive 2-D prefix sum over axes 1 and 2, summed in float64 and
    rounded once to f32: out[:, v, u] = sum_{r<v, c<u} x[:, r, c]."""
    s = torch.cumsum(torch.cumsum(x.to(torch.float64), dim=1), dim=2).to(torch.float32)
    pads = (0, 0) * (x.dim() - 3) + (1, 0, 1, 0)
    return F.pad(s, pads)


def build(channels: torch.Tensor, valid: torch.Tensor) -> CenteredIntegral:
    """channels: [B, H, W, C] f32 (invalid pixels already zeroed);
    valid: [B, H, W] bool."""
    b, h, w, _ = channels.shape
    mu = (channels.to(torch.float64).sum(dim=(1, 2)) / float(h * w)).to(torch.float32)
    centered = _ex_prefix(channels - mu[:, None, None, :])
    count = _ex_prefix(torch.ones((b, h, w), dtype=torch.float32, device=channels.device))
    vcount = _ex_prefix(valid.to(torch.float32))
    return CenteredIntegral(centered=centered, count=count, valid=vcount, mu=mu)


def _take(tbl: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor, batched: bool) -> torch.Tensor:
    """tbl[b, vi, ui] for every batch entry b -> [B, *S(, C)]: vi, ui of
    one shape S read every entry alike; batched, of shape [B, *S], each
    entry at its own indices."""
    b = tbl.shape[0]
    vi, ui = torch.broadcast_tensors(vi, ui)
    if not batched:
        vi, ui = vi.expand(b, *vi.shape), ui.expand(b, *ui.shape)
    bi = torch.arange(b, device=tbl.device).view(b, *([1] * (vi.dim() - 1)))
    return tbl[bi, vi, ui]


def _as_index(x: Offset, device) -> torch.Tensor:
    if isinstance(x, int):
        return constant(x, torch.int64, device)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _corners(ii: torch.Tensor, u: Offset, v: Offset, uu: Offset, vv: Offset) -> torch.Tensor:
    """I_incl[v+vv, u+uu] + I_incl[v, u] - I_incl[v+vv, u] - I_incl[v, u+uu]:
    the sum over rows (v, v+vv] x cols (u, u+uu] (JAX integral._corners).
    u, v, uu, vv are ints or index tensors (per-pixel windows); indices are
    clipped to the table."""
    dev = ii.device
    u, v, uu, vv = (_as_index(x, dev) for x in (u, v, uu, vv))
    hmax, wmax = ii.shape[1] - 1, ii.shape[2] - 1
    v0 = torch.clamp(v + 1, 0, hmax)
    u0 = torch.clamp(u + 1, 0, wmax)
    v1 = torch.clamp(v + vv + 1, 0, hmax)
    u1 = torch.clamp(u + uu + 1, 0, wmax)
    return (_take(ii, v1, u1, False) + _take(ii, v0, u0, False)
            - _take(ii, v1, u0, False) - _take(ii, v0, u1, False))


def box_count(ci: CenteredIntegral, u, v, uu, vv) -> torch.Tensor:
    """Valid-pixel count over the box (getFiniteElementsCount)."""
    return _corners(ci.valid, u, v, uu, vv)


def box_sum(ci: CenteredIntegral, channel: int, u, v, uu, vv) -> torch.Tensor:
    """Sum of `channel` over the box, de-centred."""
    c = _corners(ci.centered[..., channel], u, v, uu, vv)
    n = _corners(ci.count, u, v, uu, vv)
    mu = ci.mu[:, channel].view(-1, *([1] * (c.dim() - 1)))
    return c + mu * n


def box_sum_all(ci: CenteredIntegral, u, v, uu, vv) -> torch.Tensor:
    """All channels at once -> [B, ..., C]."""
    c = _corners(ci.centered, u, v, uu, vv)
    n = _corners(ci.count, u, v, uu, vv)
    mu = ci.mu.view(ci.mu.shape[0], *([1] * (c.dim() - 2)), -1)
    return c + mu * n[..., None]


class PaddedIntegral(NamedTuple):
    """Zero-padded prefix tables: a box at a fixed offset from every pixel
    is four slices of them; a box at a per-pixel offset, four gathers."""

    centered: torch.Tensor  # [B, H+1+2P, W+1+2P, C]
    count: torch.Tensor     # [B, H+1+2P, W+1+2P]
    valid: torch.Tensor
    mu: torch.Tensor        # [B, C]
    pad: int
    shape: Tuple[int, int]  # (H, W)


def pad_tables(ci: CenteredIntegral, pad: int, h: int, w: int) -> PaddedIntegral:
    def p2(x):
        return F.pad(x, (0, 0) * (x.dim() - 3) + (pad, pad, pad, pad))

    return PaddedIntegral(
        centered=p2(ci.centered), count=p2(ci.count), valid=p2(ci.valid),
        mu=ci.mu, pad=pad, shape=(h, w),
    )


def crop_width(pi: PaddedIntegral, x0: int, w: int) -> PaddedIntegral:
    """The padded tables of columns [x0, x0 + w) of pi's image: a box read at
    pixel x of the crop reads pi's tables at pixel x0 + x (a width tile
    reading the whole frame's tables).  Views, no copy."""
    p = pi.pad
    if x0 < 0 or x0 + w > pi.shape[1]:
        raise ValueError(f"columns [{x0}, {x0 + w}) are not in an image {pi.shape[1]} wide")

    def cols(t):
        return t[:, :, x0:x0 + w + 1 + 2 * p]

    return PaddedIntegral(centered=cols(pi.centered), count=cols(pi.count),
                          valid=cols(pi.valid), mu=pi.mu, pad=p, shape=(pi.shape[0], w))


def _corner_read(tbl: torch.Tensor, pi: PaddedIntegral, dv: Offset, du: Offset):
    """out[:, y, x] = tbl_unpadded[:, y + dv, x + du], 0 out of range: a
    slice for int offsets, a gather for per-pixel [B, H, W] offsets (the
    same table values either way)."""
    h, w = pi.shape
    p = pi.pad
    if isinstance(dv, int) and isinstance(du, int):
        return tbl[:, p + dv : p + dv + h, p + du : p + du + w]
    dev = tbl.device
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    shape = (tbl.shape[0], h, w)
    vi = (y + p + _as_index(dv, dev)).expand(shape)
    ui = (x + p + _as_index(du, dev)).expand(shape)
    return _take(tbl, vi, ui, True)


def _fixed_corners(tbl, pi: PaddedIntegral, u_off: Offset, v_off: Offset, uu: Offset, vv: Offset):
    """Box sum over rows (y+v_off, y+v_off+vv] x cols (x+u_off, x+u_off+uu]
    for every pixel (inclusive-integral convention: table index +1)."""
    v0, u0 = v_off + 1, u_off + 1
    return (
        _corner_read(tbl, pi, v0 + vv, u0 + uu)
        + _corner_read(tbl, pi, v0, u0)
        - _corner_read(tbl, pi, v0 + vv, u0)
        - _corner_read(tbl, pi, v0, u0 + uu)
    )


def fixed_box_count(pi: PaddedIntegral, u_off: Offset, v_off: Offset, uu: Offset, vv: Offset):
    return _fixed_corners(pi.valid, pi, u_off, v_off, uu, vv)


def fixed_box_sum_all(pi: PaddedIntegral, u_off: Offset, v_off: Offset, uu: Offset, vv: Offset):
    c = _fixed_corners(pi.centered, pi, u_off, v_off, uu, vv)
    n = _fixed_corners(pi.count, pi, u_off, v_off, uu, vv)
    return c + pi.mu[:, None, None, :] * n[..., None]


def fixed_box_sum(pi: PaddedIntegral, channel: int, u_off: Offset, v_off: Offset,
                  uu: Offset, vv: Offset):
    c = _fixed_corners(pi.centered[..., channel], pi, u_off, v_off, uu, vv)
    n = _fixed_corners(pi.count, pi, u_off, v_off, uu, vv)
    return c + pi.mu[:, channel, None, None] * n
