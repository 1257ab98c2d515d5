"""NASP cell kernels: CUDA kernel wrappers, their plain PyTorch versions,
and a launch counter per kernel.

Counterpart of the JAX package's ops/pallas_nasp.py.  Single-iteration NASP
labels are cell-local: a pixel of grid cell (cy, cx) carries -1 or one of the
n = (2r)^2 clusters (cy + dy, cx + dx), (dy, dx) in [-r, r)^2.  Every kernel
here works per (frame, cell) in that candidate space:

  label_cell_gather        table[label] per pixel, 0 outside the candidates;
  label_cell_sums          per-(cell, candidate) sums of pre-masked features;
  nasp_cell_sums           the NASP update sums ("analyze": 13 features,
                           "weighted": 14), features formed in the kernel;
  nasp_assign_and_analyze  the first NASP assignment fused with the analyze
                           sums of the labels it produces.

Candidate order is dy-major (slot j = (dy + r) * 2r + (dx + r)), -9 marks an
out-of-grid candidate; feature order is the JAX package's feats layout
(slic.py:1182-1190, :1272-1282).  Sums come back as [B, rows*cols*n, F]
partials; the caller folds them to clusters with the candidate one-hot
(_CellIndex.fold) on either route.

Width tiles (parallel/sharding.py's tiled route): every function takes
the tile's first cell column c0 and its cell columns tile_cols (default 0
and cols: the whole frame).  Its image arguments are then the tile's
columns, rows and cols stay the global grid's (candidates and cluster ids
are global, pixel u is the global column), and sums come back as the
tile's [B, rows*tile_cols*n, F] partials, which the caller gathers over
the tiles in cell order before the fold.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The plain versions are the port's one-hot-product route cut at the
kernel's output (every product through tables.exact_matmul).  Kernel
source: csrc/nasp.cu.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch import _build
from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.device import constant
from kinectdepthmapenhancement_tpu_torch.ops import stencil, tables
from kinectdepthmapenhancement_tpu_torch.utils import telemetry

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/nasp.cu"
_PALLAS_NASP = "kinectdepthmapenhancement_tpu/ops/pallas_nasp.py"
REPLACES = {
    "nasp_assign_analyze": f"{_PALLAS_NASP}:554",
    "nasp_cell_sums": f"{_PALLAS_NASP}:654",
    "label_cell_sums": f"{_PALLAS_NASP}:224",
    "label_cell_gather": f"{_PALLAS_NASP}:340",
}
# kernel launches since the last reset, by kernel (chip_smoke.py reads them),
# and by form: "<kernel>:r<r>" with ":<mode>" or ":F<features>" (the shapes
# a path runs; chip_smoke.py clears it with launches)
launches = {name: 0 for name in REPLACES}
launch_forms: Dict[str, int] = {}

INIT_DISTANCE = 999999.9  # the out-of-grid candidate cost (JAX slic.INIT_DISTANCE)
INVALID_NORMAL = -1.0
N_ANALYZE = 13   # color 3, u, v, 1, p*acc 3, n*acc 3, acc
N_WEIGHTED = 14  # color*w 3, u*w, v*w, w, p*acc 3, n*acc 3, dclamp*acc, acc
# integer-valued features: exact in any summation order (sums < 2^24)
INTEGER_FEATURES = {"analyze": (0, 1, 2, 3, 4, 5, 12), "weighted": (13,)}
MAX_SUM_FEATURES = 16  # features a sums kernel stages per pixel
_MODES = {"analyze": 0, "weighted": 1}


# ------------------------------------------------------------ cell layout


def candidate_offsets(r: int) -> List[Tuple[int, int]]:
    """The (dy, dx) candidate offsets of a cell, dy-major."""
    return [(dy, dx) for dy in range(-r, r) for dx in range(-r, r)]


def cand_grid(rows: int, cols: int, offs, device) -> torch.Tensor:
    """[rows, cols, len(offs)] i32 cluster ids of each cell's offset
    neighbours (-9 outside the grid)."""
    cy = torch.arange(rows, dtype=torch.int32, device=device)[:, None, None]
    cx = torch.arange(cols, dtype=torch.int32, device=device)[None, :, None]
    dy = constant(tuple(o[0] for o in offs), torch.int32, device)
    dx = constant(tuple(o[1] for o in offs), torch.int32, device)
    ny, nx = cy + dy, cx + dx
    in_grid = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
    return torch.where(in_grid, ny * cols + nx, torch.full_like(ny, -9))


def to_cells(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[B, H, W, F] -> [B, rows, cols, P, F]  (P = cell pixel count)."""
    b, h, w, f = x.shape
    bs_y, bs_x = h // rows, w // cols
    return (
        x.reshape(b, rows, bs_y, cols, bs_x, f)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, rows, cols, bs_y * bs_x, f)
    )


def from_cells(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, rows, cols, P, F] -> [B, H, W, F]."""
    b, rows, cols, _, f = x.shape
    return (
        x.reshape(b, rows, cols, h // rows, w // cols, f)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, h, w, f)
    )


def tile_cells(cols: int, c0: int = 0, tile_cols: Optional[int] = None) -> Tuple[int, int]:
    """(c0, tile columns) of a width tile of a grid with `cols` cell columns:
    the whole grid by default; raises when [c0, c0 + tile_cols) leaves it."""
    tc = cols - c0 if tile_cols is None else tile_cols
    if c0 < 0 or tc < 1 or c0 + tc > cols:
        raise ValueError(f"cell columns [{c0}, {c0 + tc}) are not a tile of {cols} columns")
    return c0, tc


def tile_cand_grid(rows: int, cols: int, offs, device, c0: int, tc: int) -> torch.Tensor:
    """cand_grid's [rows, tc, len(offs)] columns of the tile's cells."""
    return cand_grid(rows, cols, offs, device)[:, c0:c0 + tc]


def cell_onehot(
    labels: torch.Tensor, rows: int, cols: int, r: int, c0: int = 0,
    tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """[B, rows, tc, P, n] f32: pixel p of a cell carries candidate j
    (tc = tile_cols, the tile's cell columns: all cols by default)."""
    c0, tc = tile_cells(cols, c0, tile_cols)
    cand = tile_cand_grid(rows, cols, candidate_offsets(r), labels.device, c0, tc)
    lb = to_cells(labels[..., None], rows, tc)[..., 0]
    return (lb[..., None] == cand[:, :, None, :]).to(torch.float32)


def _check_cells(h: int, w: int, rows: int, cols: int) -> None:
    if h % rows or w % cols:
        raise ValueError(f"grid {rows}x{cols} does not divide {h}x{w}")


# --------------------------------------------------------- plain versions


def label_cell_gather_plain(
    labels: torch.Tensor, table: torch.Tensor, *, rows: int, cols: int, r: int,
    oh: Optional[torch.Tensor] = None, c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """labels [B, H, W] i32, table [B, K, F] -> [B, H, W, F]: each pixel's
    label row, 0 for labels outside the candidate set (-1 included).  A
    one-hot product, exact (one 1 per row).  `oh`: cell_onehot, if built."""
    b, h, w = labels.shape
    c0, tc = tile_cells(cols, c0, tile_cols)
    _check_cells(h, w, rows, tc)
    f = table.shape[-1]
    oh = cell_onehot(labels, rows, cols, r, c0, tc) if oh is None else oh
    n = oh.shape[-1]
    cand = tile_cand_grid(rows, cols, candidate_offsets(r), labels.device, c0, tc)
    ct = tables.gather(table.to(torch.float32), cand.reshape(1, -1).expand(b, -1))
    ct = ct.reshape(b * rows * tc, n, f)
    out = tables.exact_matmul(oh.reshape(b * rows * tc, -1, n), ct)
    return from_cells(out.reshape(b, rows, tc, -1, f), h, w)


def label_cell_sums_plain(
    labels: torch.Tensor, feats: torch.Tensor, *, rows: int, cols: int, r: int,
    oh: Optional[torch.Tensor] = None, c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """labels [B, H, W] i32, feats [B, H, W, F] (already masked) ->
    [B, rows*tc*n, F] per-(cell, candidate) sums: oh^T @ feats per cell."""
    b, h, w = labels.shape
    c0, tc = tile_cells(cols, c0, tile_cols)
    _check_cells(h, w, rows, tc)
    f = feats.shape[-1]
    oh = cell_onehot(labels, rows, cols, r, c0, tc) if oh is None else oh
    n = oh.shape[-1]
    fb = to_cells(feats.to(torch.float32), rows, tc).reshape(b * rows * tc, -1, f)
    part = tables.exact_matmul(oh.reshape(b * rows * tc, -1, n).transpose(1, 2), fb)
    return part.reshape(b, -1, f)


def nasp_features(
    mode: str, labels, sel, color_f, points, normals, lo, hi, color_sigma, spatial_sigma,
    x0: int = 0,
) -> torch.Tensor:
    """Per-pixel features [B, H, W, 13|14] of the NASP updates, zero outside
    the update window.  sel: the pixel's cluster fields, (x, y) for
    "analyze", (x, y, rgb, normal) for "weighted"; x0: the first global
    column of the image (a width tile's).

    A pixel counts when it lies within [lo, hi] of its cluster's mean pixel
    (both axes) and has a label.  "analyze" accepts a point / normal when
    z > 50 and the normal is valid; "weighted" weights colour and pixel by
    exp(-dc^2/2sc^2) * exp(-dpix^2/2ss^2) and also requires
    dot(n, n_cluster) in (0.5, 1]."""
    b, h, w = labels.shape
    dev = labels.device
    u = torch.arange(x0, x0 + w, dtype=torch.float32, device=dev)[None, None, :].expand(b, h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None].expand(b, h, w)
    dxp, dyp = u - sel[..., 0], v - sel[..., 1]
    mask = (dxp >= lo) & (dxp <= hi) & (dyp >= lo) & (dyp <= hi) & (labels >= 0)
    nvalid = (normals != INVALID_NORMAL).any(dim=-1)
    if mode == "analyze":
        acc = ((points[..., 2] > VALID_DEPTH_MM) & nvalid).to(torch.float32)[..., None]
        feats = torch.cat(
            [color_f, torch.stack([u, v, torch.ones_like(u)], dim=-1),
             points * acc, normals * acc, acc],
            dim=-1,
        )
    else:
        c_rgb, c_n = sel[..., 2:5], sel[..., 5:8]
        e = color_f - c_rgb
        # weights flush to zero below FLT_MIN, as XLA does (stencil.flush_subnormal)
        cfilt = stencil.flush_subnormal(
            torch.exp(stencil.div_const(-stencil.dot3(e, e), 2.0 * color_sigma**2))
        )
        sfilt = stencil.flush_subnormal(
            torch.exp(stencil.div_const(-(dxp * dxp + dyp * dyp), 2.0 * spatial_sigma**2))
        )
        wgt = stencil.flush_subnormal(cfilt * sfilt)[..., None]
        dclamp = torch.clamp_min(stencil.dot3(normals, c_n), 0.0)
        acc = (
            (points[..., 2] > VALID_DEPTH_MM) & nvalid & (dclamp > 0.5) & (dclamp <= 1.0)
        ).to(torch.float32)[..., None]
        feats = torch.cat(
            [color_f * wgt, torch.stack([u, v], dim=-1) * wgt, wgt,
             points * acc, normals * acc, dclamp[..., None] * acc, acc],
            dim=-1,
        )
    return feats * mask[..., None]


def nasp_cell_sums_plain(
    labels, color_f, points, normals, cand_fields, *, rows, cols, r, lo, hi, mode,
    color_sigma=1.0, spatial_sigma=1.0, oh: Optional[torch.Tensor] = None,
    abs_terms: bool = False, c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of nasp_cell_sums: gather the cluster fields, form the
    features, sum them per (cell, candidate).  abs_terms: sum |feature|
    instead, the scale of each sum for sums_close."""
    b, _, w = labels.shape
    c0, tc = tile_cells(cols, c0, tile_cols)
    kw = dict(rows=rows, cols=cols, r=r, oh=oh, c0=c0, tile_cols=tc)
    table = cand_fields.reshape(b, rows * cols, cand_fields.shape[-1])
    sel = label_cell_gather_plain(labels, table, **kw)
    feats = nasp_features(
        mode, labels, sel, color_f, points, normals, lo, hi, color_sigma, spatial_sigma,
        x0=c0 * (w // tc),
    )
    return label_cell_sums_plain(labels, feats.abs() if abs_terms else feats, **kw)


def sums_close(
    got: torch.Tensor, want: torch.Tensor, abs_sums: torch.Tensor, integer_cols=()
) -> bool:
    """The sums kernels' bar against their plain version (both [..., F]):
    integer-valued features exact, every sum within 1e-5 of the sum of its
    terms' magnitudes `abs_sums` (the plain version's cuBLAS order and the
    kernel's order differ; nothing else may)."""
    ints = list(integer_cols)
    if ints and not torch.equal(got[..., ints], want[..., ints]):
        return False
    return bool(((got - want).abs() <= 1e-5 * abs_sums).all())


def assign_plain(
    color_f, points, normals, cand_fields, *, rows, cols, r,
    w_col, w_spa, w_dep, w_nor, s_scale, apply_invalid, c0: int = 0,
    tile_cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First NASP assignment (calculateLD_NASP), band-space form: labels are
    the grid init, so a cell's pixels share their candidate clusters and the
    distance runs on [B, rows, H/rows, W] with per-offset candidate maps
    [B, rows, 1, W].  Offsets dy-major with a strict-< running argmin: the
    first candidate wins ties.  An out-of-grid candidate costs INIT_DISTANCE
    and keeps the grid-init label.  cand_fields [B, rows, cols, 9]: rgb 3,
    x, y, center z, normal 3 (the global grid; the image may be the tile of
    cell columns [c0, c0 + tile_cols))."""
    b, h, w, _ = color_f.shape
    dev = color_f.device
    c0, tc = tile_cells(cols, c0, tile_cols)
    bs_y, bs_x = h // rows, w // tc

    def tob(x):
        return x.reshape(b, rows, bs_y, w)

    cfc = [tob(color_f[..., i]) for i in range(3)]
    x0 = c0 * bs_x
    ub = torch.arange(x0, x0 + w, dtype=torch.float32, device=dev).reshape(1, 1, 1, w)
    vb = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, rows, bs_y, 1)
    zc = tob(points[..., 2])
    nmc = [tob(normals[..., i]) for i in range(3)]
    nv_pix = (nmc[0] != INVALID_NORMAL) | (nmc[1] != INVALID_NORMAL) | (nmc[2] != INVALID_NORMAL)
    bd = torch.full((b, rows, bs_y, w), float("inf"), dtype=torch.float32, device=dev)
    bl = torch.full((b, rows, bs_y, w), -1, dtype=torch.int32, device=dev)

    gf = torch.nn.functional.pad(cand_fields, (0, 0, r, r, r, r))
    cyg = torch.arange(rows, dtype=torch.int32, device=dev)
    cxg = torch.arange(c0, c0 + tc, dtype=torch.int32, device=dev)
    own = torch.repeat_interleave(cyg[:, None] * cols + cxg[None, :], bs_x, dim=1)
    own = own[None, :, None, :]  # [1, rows, 1, W] grid-init labels
    init_d = torch.full((), INIT_DISTANCE, dtype=torch.float32, device=dev)

    for dy, dx in candidate_offsets(r):
        # [B, rows, tc, nf]: the tile's cells' candidates
        cell = gf[:, r + dy : r + dy + rows, r + c0 + dx : r + c0 + dx + tc]
        cc = torch.repeat_interleave(cell, bs_x, dim=2)[:, :, None]  # [B, rows, 1, W, nf]
        ing_cell = ((cyg + dy >= 0) & (cyg + dy < rows))[:, None] & (
            (cxg + dx >= 0) & (cxg + dx < cols)
        )[None, :]
        rid_cell = (cyg + dy)[:, None] * cols + (cxg + dx)[None, :]
        ing = torch.repeat_interleave(ing_cell, bs_x, dim=1)[None, :, None, :]
        rid = torch.repeat_interleave(rid_cell, bs_x, dim=1)[None, :, None, :]
        c_rgb = [cc[..., i] for i in range(3)]
        c_x, c_y = cc[..., 3], cc[..., 4]
        d = [cfc[i] - c_rgb[i] for i in range(3)]
        cd = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        ex, ey = ub - c_x, vb - c_y
        pd = torch.sqrt(ex * ex + ey * ey) * (s_scale**2)
        c_cz = cc[..., 5]
        zpair = (zc > VALID_DEPTH_MM) & (c_cz > VALID_DEPTH_MM)
        dd = torch.where(zpair, (zc - c_cz).abs(), torch.zeros_like(zc))
        dist = cd * w_col + pd * w_spa + dd * w_dep
        c_n = [cc[..., 6 + i] for i in range(3)]
        nv_cand = (c_n[0] != INVALID_NORMAL) | (c_n[1] != INVALID_NORMAL) | (
            c_n[2] != INVALID_NORMAL
        )
        npair = zpair & nv_pix & nv_cand
        dot = (nmc[0] * c_n[0] + nmc[1] * c_n[1]) + nmc[2] * c_n[2]
        nd = torch.where(
            npair, 255.0**2 * (1.0 - torch.clamp_min(dot, 0.0)), torch.zeros_like(dot)
        )
        dist = dist + nd * w_nor
        cand_d = torch.where(ing, dist, init_d)
        cand_l = torch.where(ing, rid, own)
        take = cand_d < bd
        bd = torch.where(take, cand_d, bd)
        bl = torch.where(take, cand_l, bl)

    labels = bl.reshape(b, h, w)
    dist = bd.reshape(b, h, w)
    if apply_invalid:  # invalid-depth override (NormalAdaptiveSuperpixel.cu:346-352)
        invalid = points[..., 2] < VALID_DEPTH_MM
        labels = torch.where(invalid, torch.full_like(labels, -1), labels)
        dist = torch.where(invalid, torch.zeros_like(dist), dist)
    return labels, dist


def nasp_assign_and_analyze_plain(
    color_f, points, normals, cand_fields, *, rows, cols, r, lo, hi,
    w_col, w_spa, w_dep, w_nor, s_scale, apply_invalid, c0: int = 0,
    tile_cols: Optional[int] = None,
):
    """Plain version of nasp_assign_and_analyze: the band-space assignment,
    then the analyze sums over the labels it produced."""
    tile = dict(c0=c0, tile_cols=tile_cols)
    labels, dist = assign_plain(
        color_f, points, normals, cand_fields, rows=rows, cols=cols, r=r,
        w_col=w_col, w_spa=w_spa, w_dep=w_dep, w_nor=w_nor, s_scale=s_scale,
        apply_invalid=apply_invalid, **tile,
    )
    part = nasp_cell_sums_plain(
        labels, color_f, points, normals, cand_fields[..., 3:5], rows=rows, cols=cols,
        r=r, lo=lo, hi=hi, mode="analyze", **tile,
    )
    return labels, dist, part


# ----------------------------------------------------------------- kernels


def _call(name: str, form: str, argtypes: list, device, args) -> None:
    """Launch kde_<name> on the current stream of `device`, raise on a CUDA
    error, count the launch by kernel and by form."""
    _build.launch("kde_" + name, argtypes, device, args)
    telemetry.count_launch(globals(), f"{name}:{form}", kernel=name)


def _check_grid(
    labels_or_image: torch.Tensor, rows: int, cols: int, r: int, c0: int,
    tile_cols: Optional[int],
) -> Tuple[int, int]:
    """(c0, tile columns), checked: the grid divides the (tile's) image."""
    c0, tc = tile_cells(cols, c0, tile_cols)
    h, w = labels_or_image.shape[1:3]
    _check_cells(h, w, rows, tc)
    if r < 1:
        raise ValueError(f"candidate radius r={r} must be >= 1")
    return c0, tc


def _form(base: str, tc: int, cols: int) -> str:
    """A launch form's name: a width tile of the grid adds ":tile"."""
    return base + (":tile" if tc < cols else "")


def label_cell_gather(
    labels: torch.Tensor, table: torch.Tensor, *, rows: int, cols: int, r: int,
    c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """[B, H, W, F] = table[labels] over each cell's candidates, 0 outside
    them: the CUDA kernel for CUDA tensors, the plain version for CPU ones.
    labels [B, H, W] i32, table [B, rows*cols, F] f32.  On the card the
    staged table rows must fit a block's shared memory (csrc/nasp.cu
    label_gather_smem); the launch raises otherwise."""
    tile = dict(c0=c0, tile_cols=tile_cols)
    if labels.device.type == "cpu":
        return label_cell_gather_plain(labels, table, rows=rows, cols=cols, r=r, **tile)
    b, h, w = labels.shape
    c0, tc = _check_grid(labels, rows, cols, r, **tile)
    f = table.shape[-1]
    _build.check_tensor(labels, "label_cell_gather labels", torch.int32, (b, h, w))
    _build.check_tensor(table, "label_cell_gather table", torch.float32, (b, rows * cols, f))
    out = torch.empty((b, h, w, f), dtype=torch.float32, device=labels.device)
    _call(
        "label_cell_gather", _form(f"r{r}:F{f}", tc, cols), [_build.PTR] * 3 + [_build.INT] * 9,
        labels.device,
        (labels.data_ptr(), table.data_ptr(), out.data_ptr(), b, h, w, rows, cols, r, c0, tc,
         f),
    )
    return out


def label_cell_sums(
    labels: torch.Tensor, feats: torch.Tensor, *, rows: int, cols: int, r: int,
    c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """[B, rows*tc*n, F] per-(cell, candidate) sums of pre-masked feats
    [B, H, W, F] f32 grouped by labels [B, H, W] i32: the CUDA kernel for
    CUDA tensors, the plain version for CPU ones.  On the card F <= 16 and
    the warps' partials must fit a block's shared memory (csrc/nasp.cu
    label_sums_smem, ~173 KB at r = 5, F = 16); the launch raises
    otherwise."""
    tile = dict(c0=c0, tile_cols=tile_cols)
    if labels.device.type == "cpu":
        return label_cell_sums_plain(labels, feats, rows=rows, cols=cols, r=r, **tile)
    b, h, w = labels.shape
    c0, tc = _check_grid(labels, rows, cols, r, **tile)
    f = feats.shape[-1]
    if f > MAX_SUM_FEATURES:
        raise ValueError(f"label_cell_sums takes at most {MAX_SUM_FEATURES} features, got {f}")
    _build.check_tensor(labels, "label_cell_sums labels", torch.int32, (b, h, w))
    _build.check_tensor(feats, "label_cell_sums feats", torch.float32, (b, h, w, f))
    n = (2 * r) ** 2
    out = torch.empty((b, rows * tc * n, f), dtype=torch.float32, device=labels.device)
    _call(
        "label_cell_sums", _form(f"r{r}:F{f}", tc, cols), [_build.PTR] * 3 + [_build.INT] * 9,
        labels.device,
        (labels.data_ptr(), feats.data_ptr(), out.data_ptr(), b, h, w, rows, cols, r, c0, tc,
         f),
    )
    return out


def _check_planes(what: str, color_f, points, normals, b, h, w) -> None:
    for name, t in (("color_f", color_f), ("points", points), ("normals", normals)):
        _build.check_tensor(t, f"{what} {name}", torch.float32, (b, h, w, 3))


def nasp_cell_sums(
    labels, color_f, points, normals, cand_fields, *, rows, cols, r, lo, hi, mode,
    color_sigma=1.0, spatial_sigma=1.0, c0: int = 0, tile_cols: Optional[int] = None,
) -> torch.Tensor:
    """Per-(cell, candidate) NASP update sums [B, rows*tc*n, 13|14]:
    mode "analyze" (cand_fields [B, rows, cols, 2]: x, y) or "weighted"
    ([B, rows, cols, 8]: x, y, rgb, normal).  The CUDA kernel for CUDA
    tensors, the plain version for CPU ones.  On the card the warps'
    partials must fit a block's shared memory (csrc/nasp.cu nasp_sums_smem,
    ~94 KB at r = 5 weighted); the launch raises otherwise."""
    if mode not in _MODES:
        raise ValueError(f"nasp_cell_sums mode must be 'analyze' or 'weighted', got {mode!r}")
    kw = dict(rows=rows, cols=cols, r=r, lo=lo, hi=hi, mode=mode,
              color_sigma=color_sigma, spatial_sigma=spatial_sigma, c0=c0,
              tile_cols=tile_cols)
    if labels.device.type == "cpu":
        return nasp_cell_sums_plain(labels, color_f, points, normals, cand_fields, **kw)
    b, h, w = labels.shape
    c0, tc = _check_grid(labels, rows, cols, r, c0, tile_cols)
    nf = 2 if mode == "analyze" else 8
    nfeat = N_ANALYZE if mode == "analyze" else N_WEIGHTED
    _build.check_tensor(labels, "nasp_cell_sums labels", torch.int32, (b, h, w))
    _check_planes("nasp_cell_sums", color_f, points, normals, b, h, w)
    _build.check_tensor(cand_fields, "nasp_cell_sums cand_fields", torch.float32, (b, rows, cols, nf))
    n = (2 * r) ** 2
    out = torch.empty((b, rows * tc * n, nfeat), dtype=torch.float32, device=labels.device)
    _call(
        "nasp_cell_sums", _form(f"r{r}:{mode}", tc, cols),
        [_build.PTR] * 6 + [_build.INT] * 8 + [_build.FLOAT] * 2 + [_build.INT]
        + [_build.FLOAT] * 2,
        labels.device,
        (labels.data_ptr(), color_f.data_ptr(), points.data_ptr(), normals.data_ptr(),
         cand_fields.data_ptr(), out.data_ptr(), b, h, w, rows, cols, r, c0, tc, float(lo),
         float(hi), _MODES[mode], 2.0 * color_sigma**2, 2.0 * spatial_sigma**2),
    )
    return out


def nasp_assign_and_analyze(
    color_f, points, normals, cand_fields, *, rows, cols, r, lo, hi,
    w_col, w_spa, w_dep, w_nor, s_scale, apply_invalid, c0: int = 0,
    tile_cols: Optional[int] = None,
):
    """Fused first NASP assignment + analyze sums.  color_f, points, normals
    [B, H, W, 3] f32; cand_fields [B, rows, cols, 9] f32 (rgb, x, y,
    center z, normal).  Returns (labels [B, H, W] i32, distance [B, H, W]
    f32, part [B, rows*tc*n, 13]).  The CUDA kernel for CUDA tensors, the
    plain version for CPU ones.  On the card the warps' partials must fit a
    block's shared memory (csrc/nasp.cu assign_smem, ~93 KB at r = 5); the
    launch raises otherwise."""
    kw = dict(rows=rows, cols=cols, r=r, lo=lo, hi=hi, w_col=w_col, w_spa=w_spa,
              w_dep=w_dep, w_nor=w_nor, s_scale=s_scale, apply_invalid=apply_invalid,
              c0=c0, tile_cols=tile_cols)
    if color_f.device.type == "cpu":
        return nasp_assign_and_analyze_plain(color_f, points, normals, cand_fields, **kw)
    b, h, w, _ = color_f.shape
    c0, tc = _check_grid(color_f, rows, cols, r, c0, tile_cols)
    _check_planes("nasp_assign_and_analyze", color_f, points, normals, b, h, w)
    _build.check_tensor(
        cand_fields, "nasp_assign_and_analyze cand_fields", torch.float32, (b, rows, cols, 9)
    )
    dev = color_f.device
    n = (2 * r) ** 2
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    dist = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    part = torch.empty((b, rows * tc * n, N_ANALYZE), dtype=torch.float32, device=dev)
    # the weights as PyTorch rounds a Python scalar operand: to f32
    _call(
        "nasp_assign_analyze", _form(f"r{r}", tc, cols),
        [_build.PTR] * 7 + [_build.INT] * 8 + [_build.FLOAT] * 7 + [_build.INT],
        dev,
        (color_f.data_ptr(), points.data_ptr(), normals.data_ptr(), cand_fields.data_ptr(),
         labels.data_ptr(), dist.data_ptr(), part.data_ptr(), b, h, w, rows, cols, r, c0, tc,
         float(lo), float(hi), w_col, w_spa, w_dep, w_nor, s_scale**2, int(apply_invalid)),
    )
    return labels, dist, part
