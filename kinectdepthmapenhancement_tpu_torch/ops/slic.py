"""Normal-adaptive superpixels (NASP), single-iteration cell route.

PyTorch counterpart of the NASP subset of the JAX package's ops/slic.py
(NormalAdaptiveSuperpixel.cu in the reference), on the route the JAX package
takes under SLICParams.stats_impl="xla":

  * seeds: the 11x11 seed gradient on the per-cell seed sub-grid
    (ops/cuda_gradient.py: the CUDA kernel on the card, its plain version on
    the CPU), then a first-minimum argmin per cell;
  * assignment: the first-iteration `cell_fast` branch of _assign — labels
    are the grid init, so a pixel's 64 candidate clusters are a function of
    its grid cell and the sweep runs in band space [B, rows, H/rows, W]
    with a strict-< running argmin (first candidate wins ties);
  * cluster update: cell-local one-hot products (_CellIndex): per-cell
    [P, n] one-hots times features in f32, then a tiny candidate -> cluster
    fold.  No float atomics, so every sum is deterministic.

NASP distance (NormalAdaptiveSuperpixel.cu:223-258):
    cd*(sc/T)^2 + pd*(ss/T)^2 + |dz|*(sd/T)^2 + 255^2*(1-max(0,n.nc))*(sn/T)^2
with T = ss+sc+sd+sn.  The bug-fidelity decisions (a)-(d) are the JAX
package's (slic.py:39-49): (a) clamped gradient neighbours, (b) the real
blue channel, (c) the 2-D centroid as pixel centre, (d) normal distance 0
when either normal is invalid.

Not ported yet (they raise): later iterations and their global-index route,
the SP / DASP variants, and grids that do not divide the image.

Tensors carry a leading batch dimension; cluster tables are [B, K, ...].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, SLICParams
from kinectdepthmapenhancement_tpu_torch.ops import cuda_gradient, stencil, tables

INIT_DISTANCE = 999999.9
INVALID_NORMAL = -1.0

_GRAD_MARGIN = 5  # the seed gradient's 11x11 window half-width


class Clusters(NamedTuple):
    """Cluster table [B, K, ...]: the reference's `superpixel` struct + the
    NASP side tables (centers, normals, variance)."""

    rgb: torch.Tensor       # [B, K, 3] f32, integer-valued mean colour
    xy: torch.Tensor        # [B, K, 2] i32, mean pixel (x, y)
    size: torch.Tensor      # [B, K] i32
    center: torch.Tensor    # [B, K, 3] f32 — mean 3-D point (mm)
    normal: torch.Tensor    # [B, K, 3] f32 — mean normal (-1 sentinel)
    variance: torch.Tensor  # [B, K] f32 — normal coherence


class SLICResult(NamedTuple):
    labels: torch.Tensor    # [B, H, W] i32, cluster id or -1
    distance: torch.Tensor  # [B, H, W] f32
    clusters: Clusters


def _grid_geometry(grid: GridParams, height: int, width: int):
    ws_x = width // grid.cols
    ws_y = height // grid.rows
    return ws_x, ws_y


def init_labels(
    grid: GridParams, height: int, width: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """Grid initialisation [H, W] i32 (initLD, SuperpixelSegmentation.cu:3-14)."""
    ws_x, ws_y = _grid_geometry(grid, height, width)
    v = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    u = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    return (v // ws_y) * grid.cols + (u // ws_x)


def _normal_valid_or(n: torch.Tensor) -> torch.Tensor:
    """`n.x != -1 || n.y != -1 || n.z != -1` (assignment-style validity)."""
    return (n != INVALID_NORMAL).any(dim=-1)


# -------------------------------------------------------------- label index


class _CellIndex:
    """Cell-local label index.  Valid ONLY when every label is either -1 or
    drawn from its pixel's cell-grid (2r)^2 neighbourhood — which holds after
    the first assignment sweep (whose candidate set is exactly that).

    gather:      out = sum_n oh[b,r,c,p,n] * cand_table[b,r,c,n,:]
    segment sum: per-cell partials oh^T @ feats -> [b,r,c,n,F], then a tiny
                 [r*c*n, K] one-hot product folds candidates back to clusters.
    Every product is an f32 matmul with TF32 off (tables.exact_matmul): the
    gathers are exact (one 1 per row) and the sums are deterministic."""

    def __init__(self, labels: torch.Tensor, grid: GridParams, r: int, h: int, w: int):
        self.rows, self.cols = grid.rows, grid.cols
        self.k = grid.num_clusters
        self.h, self.w = h, w
        self.r = r
        self.labels = labels
        self.b = labels.shape[0]
        self.bs_y, self.bs_x = h // self.rows, w // self.cols
        offs = [(dy, dx) for dy in range(-r, r) for dx in range(-r, r)]
        self.n = len(offs)
        self.cand = self._cand_grid(offs)  # [rows, cols, n]
        lb = self._to_cells(labels[..., None])[..., 0]  # [B, rows, cols, P]
        self.oh = (lb[..., None] == self.cand[:, :, None, :]).to(torch.float32)
        self.cand_flat = self.cand.reshape(-1)
        self.oh_k = tables.one_hot(self.cand_flat, self.k)  # [rows*cols*n, K]

    def _to_cells(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, F] -> [B, rows, cols, P, F]  (P = cell pixel count)."""
        f = x.shape[-1]
        return (
            x.reshape(self.b, self.rows, self.bs_y, self.cols, self.bs_x, f)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(self.b, self.rows, self.cols, self.bs_y * self.bs_x, f)
        )

    def _from_cells(self, x: torch.Tensor) -> torch.Tensor:
        """[B, rows, cols, P, F] -> [B, H, W, F]."""
        f = x.shape[-1]
        return (
            x.reshape(self.b, self.rows, self.cols, self.bs_y, self.bs_x, f)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(self.b, self.h, self.w, f)
        )

    def _cand_grid(self, offs) -> torch.Tensor:
        """[rows, cols, len(offs)] cluster ids of each cell's offset
        neighbours (-9 outside the grid)."""
        dev = self.labels.device
        cy = torch.arange(self.rows, dtype=torch.int32, device=dev)[:, None, None]
        cx = torch.arange(self.cols, dtype=torch.int32, device=dev)[None, :, None]
        dy = torch.tensor([o[0] for o in offs], dtype=torch.int32, device=dev)
        dx = torch.tensor([o[1] for o in offs], dtype=torch.int32, device=dev)
        ny, nx = cy + dy, cx + dx
        in_grid = (ny >= 0) & (ny < self.rows) & (nx >= 0) & (nx < self.cols)
        return torch.where(in_grid, ny * self.cols + nx, torch.full_like(ny, -9))

    def _cells_flat(self, x: torch.Tensor) -> torch.Tensor:
        """[B, rows, cols, ...] -> [B*rows*cols, ...]."""
        return x.reshape((self.b * self.rows * self.cols,) + tuple(x.shape[3:]))

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """[B, K, F] -> [B, H, W, F]: each pixel's label row, 0 for labels
        outside the candidate set (-1 included)."""
        f = table.shape[-1]
        cand = self.cand_flat.expand(self.b, -1)
        ct = tables.gather(table.to(torch.float32), cand)  # [B, rows*cols*n, F]
        ct = ct.reshape(self.b * self.rows * self.cols, self.n, f)
        out = tables.exact_matmul(self._cells_flat(self.oh), ct)
        return self._from_cells(out.reshape(self.b, self.rows, self.cols, -1, f))

    def segment_sum(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, H, W, F] features summed per label over `mask` -> [B, K, F]."""
        f = feats.shape[-1]
        fb = self._to_cells((feats * mask[..., None]).to(torch.float32))
        part = tables.exact_matmul(
            self._cells_flat(self.oh).transpose(1, 2), self._cells_flat(fb)
        )  # [B*rows*cols, n, F]
        part_flat = part.reshape(self.b, -1, f)
        return tables.segment_sum(part_flat, self.cand_flat, self.k, onehot=self.oh_k)

    def counts(self) -> torch.Tensor:
        """Pixels per label [B, K] f32: per-cell candidate histograms folded
        to clusters by the tiny K one-hot."""
        per = self.oh.sum(dim=3)  # [B, rows, cols, n]
        return tables.segment_sum(
            per.reshape(self.b, -1, 1), self.cand_flat, self.k, onehot=self.oh_k
        )[..., 0]

    def pair_counts(self, labels_b: torch.Tensor) -> torch.Tensor:
        """[B, K, K] f32: POSITIVE where an (own label, labels_b) pixel pair
        exists, 0 elsewhere (existence indicators: intermediates are
        thresholded to 0/1; the CCL consumer only tests > 0).

        labels_b must be a <=1-pixel shift of cell-local labels, so its
        values lie in the enlarged (2r+1)^2 candidate set of each pixel's
        cell.  Pairs accumulate per cell in candidate coordinates, then fold
        to [K, K] through the candidate one-hots."""
        r, k = self.r, self.k
        rc = self.rows * self.cols
        offs_b = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
        nb = len(offs_b)
        cand_b = self._cand_grid(offs_b)  # [rows, cols, nb]
        lb_b = self._to_cells(labels_b[..., None])[..., 0]
        oh_b = (lb_b[..., None] == cand_b[:, :, None, :]).to(torch.float32)
        m = tables.exact_matmul(
            self._cells_flat(self.oh).transpose(1, 2), self._cells_flat(oh_b)
        )  # [B*rc, n, nb]
        m = (m > 0.0).to(torch.float32).reshape(self.b, rc, self.n, nb)
        oh_bk = tables.one_hot(cand_b, k).reshape(rc, nb, k)
        oh_ak = tables.one_hot(self.cand, k).reshape(rc * self.n, k)
        t = tables.exact_matmul(m, oh_bk)  # [B, rc, n, K]; counts <= nb, exact
        t = (t > 0.0).to(torch.float32).reshape(self.b, rc * self.n, k)
        # integer counts < 2^24, exact in f32
        return tables.exact_matmul(oh_ak.transpose(0, 1), t)


def _cell_ok(grid: GridParams, h: int, w: int) -> bool:
    return h % grid.rows == 0 and w % grid.cols == 0


def _require_cell_ok(grid: GridParams, h: int, w: int) -> None:
    if not _cell_ok(grid, h, w):
        raise NotImplementedError(
            f"grid {grid.rows}x{grid.cols} does not divide {h}x{w}: the "
            "global-index route is not ported yet"
        )


def cell_index(labels: torch.Tensor, grid: GridParams, neighborhood: int) -> _CellIndex:
    """Cell-local index for downstream ops (CCL, plane) over single-iteration
    SLIC labels [B, H, W].  The global-index route for grids that do not
    divide the image is not ported yet."""
    h, w = labels.shape[-2:]
    _require_cell_ok(grid, h, w)
    return _CellIndex(labels, grid, neighborhood // 2, h, w)


# ----------------------------------------------------------------- seeding


def _nasp_gradient(color_f: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """NASP seed gradient: colour term scaled by (1 - |n.n'|) when both
    normals are valid (AND-validity), NormalAdaptiveSuperpixel.cu:39-71."""
    return cuda_gradient.seed_gradient(color_f.contiguous(), normals.contiguous())


def _subgrid_ok(grid: GridParams, h: int, w: int, window: int) -> bool:
    """True when every seed window's gradient support stays inside its cell,
    so the gradient can be computed on the seed sub-grid alone."""
    if not _cell_ok(grid, h, w):
        return False
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = _GRAD_MARGIN
    return (
        ws_y // 2 - r - m >= 0
        and ws_y // 2 + r - 1 + m <= ws_y - 1
        and ws_x // 2 - r - m >= 0
        and ws_x // 2 + r - 1 + m <= ws_x - 1
    )


def _subgrid_extract(
    arr: torch.Tensor, grid: GridParams, h: int, w: int, window: int
) -> torch.Tensor:
    """Reshape/slice extraction of the per-cell seed bands:
    [B, H, W, C] -> [B, rows*(window+2m), cols*(window+2m), C]."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = _GRAD_MARGIN
    blk = window + 2 * m
    y0 = ws_y // 2 - r - m
    x0 = ws_x // 2 - r - m
    b, c = arr.shape[0], arr.shape[-1]
    sub = arr.reshape(b, grid.rows, ws_y, w, c)[:, :, y0 : y0 + blk]
    sub = sub.reshape(b, grid.rows * blk, grid.cols, ws_x, c)[:, :, :, x0 : x0 + blk]
    return sub.reshape(b, grid.rows * blk, grid.cols * blk, c)


def _seeds_from_best(best, grid: GridParams, h: int, w: int, window: int):
    """(x, y) seeds [B, K, 2] i32 from the per-cell argmin over the
    window x window block (row-major offsets -window/2 .. window/2 - 1)."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    dev = best.device
    offs = torch.arange(window, dtype=torch.int32, device=dev) - window // 2
    off_y = offs[best // window]
    off_x = offs[best % window]
    cy = torch.arange(grid.rows, dtype=torch.int32, device=dev)[:, None] * ws_y + ws_y // 2
    cx = torch.arange(grid.cols, dtype=torch.int32, device=dev)[None, :] * ws_x + ws_x // 2
    b = best.shape[0]
    seed_y = (cy + off_y).reshape(b, -1)
    seed_x = (cx + off_x).reshape(b, -1)
    return torch.stack([seed_x, seed_y], dim=-1).to(torch.int32)


def _sample_seeds_subgrid(
    gradient_sub: torch.Tensor, grid: GridParams, h: int, w: int, window: int
) -> torch.Tensor:
    """sample_seeds on the extracted sub-grid: the seed windows sit at the
    centre of each (window+2m) block; ties and ordering identical."""
    m = _GRAD_MARGIN
    blk = window + 2 * m
    b = gradient_sub.shape[0]
    g_blocks = (
        gradient_sub.reshape(b, grid.rows, blk, grid.cols, blk)[
            :, :, m : m + window, :, m : m + window
        ]
        .permute(0, 1, 3, 2, 4)
        .reshape(b, grid.rows, grid.cols, window * window)
    )
    # torch.argmin returns the first minimum, as jnp.argmin does
    return _seeds_from_best(torch.argmin(g_blocks, dim=-1), grid, h, w, window)


def sample_seeds(
    gradient: torch.Tensor, grid: GridParams, height: int, width: int, window: int
) -> torch.Tensor:
    """Per cluster, the (x, y) of the minimum-gradient pixel in a
    `window x window` block around the grid centre (clamped to the image),
    ties to the first pixel in row-major offset order.  -> [B, K, 2] i32."""
    ws_x, ws_y = _grid_geometry(grid, height, width)
    dev = gradient.device
    r = window // 2
    offs = torch.arange(window, device=dev) - r
    cy = torch.arange(grid.rows, device=dev) * ws_y + ws_y // 2
    cx = torch.arange(grid.cols, device=dev) * ws_x + ws_x // 2
    yy = (cy[:, None, None, None] + offs[None, None, :, None]).clamp(0, height - 1)
    xx = (cx[None, :, None, None] + offs[None, None, None, :]).clamp(0, width - 1)
    shape = (grid.rows, grid.cols, window, window)
    yy, xx = yy.expand(shape).reshape(-1), xx.expand(shape).reshape(-1)
    b = gradient.shape[0]
    g = gradient[:, yy, xx].reshape(b, grid.rows, grid.cols, -1)
    best = torch.argmin(g, dim=-1)
    yy = yy.reshape(grid.rows, grid.cols, -1).expand(b, -1, -1, -1)
    xx = xx.reshape(grid.rows, grid.cols, -1).expand(b, -1, -1, -1)
    seed_y = torch.gather(yy, -1, best[..., None])[..., 0].reshape(b, -1)
    seed_x = torch.gather(xx, -1, best[..., None])[..., 0].reshape(b, -1)
    return torch.stack([seed_x, seed_y], dim=-1).to(torch.int32)


def _compute_seeds(
    color_f: torch.Tensor,
    normals: torch.Tensor,
    grid: GridParams,
    h: int,
    w: int,
    window: int,
) -> torch.Tensor:
    """NASP seed sampling; on the sub-grid fast path the gradient is
    evaluated only where the seed windows can read it (same seeds)."""
    if _subgrid_ok(grid, h, w, window):
        csub = _subgrid_extract(color_f, grid, h, w, window)
        nsub = _subgrid_extract(normals, grid, h, w, window)
        return _sample_seeds_subgrid(_nasp_gradient(csub, nsub), grid, h, w, window)
    return sample_seeds(_nasp_gradient(color_f, normals), grid, h, w, window)


def _at_pixels(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img[b, y[b, k], x[b, k]] -> [B, K, ...]."""
    b, h, w = img.shape[:3]
    flat = img.reshape((b, h * w) + tuple(img.shape[3:]))
    idx = (y.long() * w + x.long())
    bi = torch.arange(b, device=img.device)[:, None]
    return flat[bi, idx]


def init_clusters(
    seeds: torch.Tensor, color: torch.Tensor, points: torch.Tensor, normals: torch.Tensor
) -> Clusters:
    """Seed the cluster table (store sections of sampleInitialClusters_NASP;
    bug (b) fixed: the real blue channel is stored).  seeds [B, K, 2] (x, y)."""
    b, k = seeds.shape[:2]
    sx, sy = seeds[..., 0], seeds[..., 1]
    dev = seeds.device
    return Clusters(
        rgb=_at_pixels(color, sx, sy).to(torch.float32),
        xy=seeds,
        size=torch.zeros((b, k), dtype=torch.int32, device=dev),
        center=_at_pixels(points, sx, sy),
        normal=_at_pixels(normals, sx, sy),
        variance=torch.zeros((b, k), dtype=torch.float32, device=dev),
    )


# -------------------------------------------------------------- assignment


def _assign(
    labels: torch.Tensor,
    distance: torch.Tensor,
    clusters: Clusters,
    color_f: torch.Tensor,
    points: torch.Tensor,
    normals: torch.Tensor,
    grid: GridParams,
    params: SLICParams,
    neighborhood: int,
    s_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First NASP label-assignment sweep (calculateLD_NASP), the `cell_fast`
    branch of the JAX package's _assign: labels are the grid init, so a
    cell's pixels share their candidate clusters and the distance runs in
    band space [B, rows, H/rows, W] with per-offset candidate maps
    [B, rows, 1, W].  Offsets in (dy, dx) order with a strict-< running
    argmin: the first candidate wins ties (the reference tree reduction)."""
    b, h, w = labels.shape
    dev = labels.device
    r = neighborhood // 2
    rows, cls = grid.rows, grid.cols
    bs_y, bs_x = h // rows, w // cls

    total = params.spatial_sigma + params.color_sigma + params.depth_sigma + params.normal_sigma
    w_col = (params.color_sigma / total) ** 2
    w_spa = (params.spatial_sigma / total) ** 2
    w_dep = (params.depth_sigma / total) ** 2
    w_nor = (params.normal_sigma / total) ** 2

    fields = torch.cat(
        [clusters.rgb, clusters.xy.to(torch.float32), clusters.center[..., 2:3], clusters.normal],
        dim=-1,
    )  # [B, K, 9]
    nf = fields.shape[-1]

    def tob(x):
        return x.reshape(b, rows, bs_y, w)

    cfc = [tob(color_f[..., i]) for i in range(3)]
    ub = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, 1, w)
    vb = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, rows, bs_y, 1)
    zc = tob(points[..., 2])
    nmc = [tob(normals[..., i]) for i in range(3)]
    nv_pix = (nmc[0] != INVALID_NORMAL) | (nmc[1] != INVALID_NORMAL) | (nmc[2] != INVALID_NORMAL)
    dist_b = tob(distance)
    lab_b = tob(labels)
    bd = torch.full((b, rows, bs_y, w), float("inf"), dtype=torch.float32, device=dev)
    bl = torch.full((b, rows, bs_y, w), -1, dtype=torch.int32, device=dev)

    gf = torch.nn.functional.pad(fields.reshape(b, rows, cls, nf), (0, 0, r, r, r, r))
    cyg = torch.arange(rows, dtype=torch.int32, device=dev)
    cxg = torch.arange(cls, dtype=torch.int32, device=dev)

    for dy in range(-r, r):
        for dx in range(-r, r):
            cell = gf[:, r + dy : r + dy + rows, r + dx : r + dx + cls]  # [B, rows, cols, nf]
            cc = torch.repeat_interleave(cell, bs_x, dim=2)[:, :, None]  # [B, rows, 1, W, nf]
            ing_cell = ((cyg + dy >= 0) & (cyg + dy < rows))[:, None] & (
                (cxg + dx >= 0) & (cxg + dx < cls)
            )[None, :]
            rid_cell = (cyg + dy)[:, None] * grid.cols + (cxg + dx)[None, :]
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
            cand_d = torch.where(ing, dist, dist_b)
            cand_l = torch.where(ing, rid, lab_b)
            take = cand_d < bd
            bd = torch.where(take, cand_d, bd)
            bl = torch.where(take, cand_l, bl)

    new_labels = bl.reshape(b, h, w)
    new_dist = bd.reshape(b, h, w)
    # invalid-depth override (NormalAdaptiveSuperpixel.cu:346-352)
    if params.depth_sigma != 0.0 or params.normal_sigma != 0.0:
        invalid = points[..., 2] < VALID_DEPTH_MM
        new_labels = torch.where(invalid, torch.full_like(new_labels, -1), new_labels)
        new_dist = torch.where(invalid, torch.zeros_like(new_dist), new_dist)
    return new_labels, new_dist


# ----------------------------------------------------------- cluster stats


def _pixel_grids(b: int, h: int, w: int, dev):
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(b, h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(b, h, w)
    return u, v


def _window_mask(
    idx: _CellIndex,
    labels: torch.Tensor,
    clusters: Clusters,
    lo: int,
    hi: int,
    cxy: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pixels within the reference's update window [lo, hi] (both dims)
    relative to their cluster's OLD mean pixel, and with a valid label.
    cxy: optionally the pre-gathered [B, H, W, 2] cluster-centre map."""
    b, h, w = labels.shape
    if cxy is None:
        cxy = idx.gather(clusters.xy.to(torch.float32))
    u, v = _pixel_grids(b, h, w, labels.device)
    dx = u - cxy[..., 0]
    dy = v - cxy[..., 1]
    inside = (dx >= lo) & (dx <= hi) & (dy >= lo) & (dy <= hi)
    return inside & (labels >= 0)


def _update_nasp_analyze(
    idx, labels, clusters, color_f, points, normals, window_range, h, w
) -> Clusters:
    """NASP plain stats (analyzeClusters_NASP, NormalAdaptiveSuperpixel.cu:356-685):
    a pixel's 3-D point / normal count when z > 50 and the normal is valid
    (OR-validity)."""
    lo, hi = window_range
    b = labels.shape[0]
    mask = _window_mask(idx, labels, clusters, lo, hi)
    u, v = _pixel_grids(b, h, w, labels.device)
    ones = torch.ones_like(u)
    accept = (points[..., 2] > VALID_DEPTH_MM) & _normal_valid_or(normals)
    acc = accept.to(torch.float32)[..., None]
    feats = torch.cat(
        [
            color_f,                                # 0:3
            torch.stack([u, v, ones], dim=-1),      # 3:6
            points * acc,                           # 6:9
            normals * acc,                          # 9:12
            acc,                                    # 12
        ],
        dim=-1,
    )
    sums = idx.segment_sum(feats, mask)
    return _nasp_analyze_post(sums, clusters, points, h, w)


def _centroid_center(sums_xyz, npts, xy, points, h, w):
    """Centre = the 3-D point AT the 2-D centroid pixel when that pixel has
    valid depth, else the mean of accepted points (bug (c) fallback)."""
    px = xy[..., 0].clamp(0, w - 1)
    py = xy[..., 1].clamp(0, h - 1)
    pt_at_centroid = _at_pixels(points, px, py)
    centroid_valid = pt_at_centroid[..., 2] > VALID_DEPTH_MM
    mean_pts = sums_xyz / torch.clamp_min(npts, 1.0)[..., None]
    return torch.where(centroid_valid[..., None], pt_at_centroid, mean_pts)


def _nasp_analyze_post(sums, clusters: Clusters, points, h, w) -> Clusters:
    """Post-processing of the analyze sums [B, K, 13]."""
    size = sums[..., 5]
    nz = size > 0
    safe = torch.clamp_min(size, 1.0)
    rgb = torch.clamp(torch.floor(sums[..., 0:3] / safe[..., None]), 0, 255)
    xy = torch.floor(sums[..., 3:5] / safe[..., None]).to(torch.int32)
    npts = sums[..., 12]
    has_pts = npts > 0

    center = _centroid_center(sums[..., 6:9], npts, xy, points, h, w)
    normal = sums[..., 9:12] / torch.clamp_min(npts, 1.0)[..., None]
    center = torch.where(has_pts[..., None], center, torch.zeros_like(center))
    normal = torch.where(has_pts[..., None], normal, torch.full_like(normal, INVALID_NORMAL))
    nz3 = nz[..., None]
    return Clusters(
        rgb=torch.where(nz3, rgb, clusters.rgb),
        xy=torch.where(nz3, xy, clusters.xy),
        size=torch.where(nz, size.to(torch.int32), clusters.size),
        center=torch.where(nz3, center, clusters.center),
        normal=torch.where(nz3, normal, clusters.normal),
        variance=clusters.variance,
    )


def _update_nasp_weighted(
    idx, labels, clusters, color_f, points, normals, params, window_range, h, w
) -> Clusters:
    """NASP bilateral-weighted stats (calculateWeightedAverage,
    NormalAdaptiveSuperpixel.cu:687-1068), on the analyze-updated table.
    Colour/pixel sums are weighted by exp(-dc^2/2sc^2)*exp(-dpix^2/2ss^2);
    3-D/normal sums accept z > 50, a valid normal and dot(n, n_cluster) in
    (0.5, 1]."""
    lo, hi = window_range
    b = labels.shape[0]
    u, v = _pixel_grids(b, h, w, labels.device)
    g = idx.gather(
        torch.cat([clusters.rgb, clusters.xy.to(torch.float32), clusters.normal], dim=-1)
    )
    c_rgb, c_xy, c_n = g[..., 0:3], g[..., 3:5], g[..., 5:8]
    mask = _window_mask(idx, labels, clusters, lo, hi, cxy=c_xy)

    e = color_f - c_rgb
    cdiff = stencil.dot3(e, e)
    cfilt = torch.exp(-cdiff / (2.0 * params.color_sigma**2))
    ex, ey = u - c_xy[..., 0], v - c_xy[..., 1]
    sdiff = ex * ex + ey * ey
    sfilt = torch.exp(-sdiff / (2.0 * params.spatial_sigma**2))
    wgt = (cfilt * sfilt)[..., None]

    dot = stencil.dot3(normals, c_n)
    dclamp = torch.clamp_min(dot, 0.0)
    accept = (
        (points[..., 2] > VALID_DEPTH_MM)
        & _normal_valid_or(normals)
        & (dclamp > 0.5)
        & (dclamp <= 1.0)
    )
    acc = accept.to(torch.float32)[..., None]
    feats = torch.cat(
        [
            color_f * wgt,                          # 0:3
            torch.stack([u, v], dim=-1) * wgt,      # 3:5
            wgt,                                    # 5 weight sum
            points * acc,                           # 6:9
            normals * acc,                          # 9:12
            dclamp[..., None] * acc,                # 12 variance sum
            acc,                                    # 13 num accepted
        ],
        dim=-1,
    )
    sums = idx.segment_sum(feats, mask)

    wsum = sums[..., 5]
    nz = wsum != 0.0
    safe = torch.where(nz, wsum, torch.ones_like(wsum))
    rgb = torch.clamp(torch.floor(sums[..., 0:3] / safe[..., None]), 0, 255)
    xy = torch.floor(sums[..., 3:5] / safe[..., None]).to(torch.int32)
    npts = sums[..., 13]
    has_pts = npts > 0

    center = _centroid_center(sums[..., 6:9], npts, xy, points, h, w)
    nmean = sums[..., 9:12] / torch.clamp_min(npts, 1.0)[..., None]
    nlen = torch.sqrt(stencil.dot3(nmean, nmean))
    normal = nmean / torch.clamp_min(nlen, 1e-30)[..., None]
    variance = sums[..., 12] / torch.clamp_min(npts, 1.0)

    center = torch.where(has_pts[..., None], center, torch.zeros_like(center))
    normal = torch.where(has_pts[..., None], normal, torch.full_like(normal, INVALID_NORMAL))
    variance = torch.where(has_pts, variance, torch.zeros_like(variance))
    nz3 = nz[..., None]
    return Clusters(
        rgb=torch.where(nz3, rgb, clusters.rgb),
        xy=torch.where(nz3, xy, clusters.xy),
        size=torch.where(nz, wsum.to(torch.int32), clusters.size),
        center=torch.where(nz3, center, clusters.center),
        normal=torch.where(nz3, normal, clusters.normal),
        variance=torch.where(nz, variance, clusters.variance),
    )


# ------------------------------------------------------------- entry point


def segment(
    color: torch.Tensor,
    points: torch.Tensor,
    normals: torch.Tensor,
    *,
    grid: GridParams = GridParams(),
    params: SLICParams,
    variant: str = "nasp",
    seeds: Optional[torch.Tensor] = None,
) -> SLICResult:
    """NASP segmentation (NormalAdaptiveSuperpixel::Segmentation): seed +
    one (assign, analyze update, weighted update) iteration.

    color u8 [B, H, W, 3]; points f32 [B, H, W, 3] mm; normals f32
    [B, H, W, 3].  seeds: optional [K, 2] or [B, K, 2] (x, y) override of the
    sampled seeds — the gradient argmin has near-ties whose winner depends on
    float rounding, so tests inject the JAX package's seeds to compare
    everything downstream exactly."""
    if variant != "nasp":
        raise NotImplementedError(f"SLIC variant {variant!r} is not ported yet")
    if params.iterations != 1:
        raise NotImplementedError("only single-iteration NASP is ported yet")
    b, h, w = color.shape[:3]
    _require_cell_ok(grid, h, w)
    ws_x, ws_y = _grid_geometry(grid, h, w)
    s_scale = (ws_x + ws_y) / 2.0
    color_f = color.to(torch.float32)
    seed_window, neighborhood = 8, 8
    rp = ws_x * 2 // 16 + 1
    window_range = (-8 * rp, 8 * rp - 1)

    if seeds is None:
        seeds = _compute_seeds(color_f, normals, grid, h, w, seed_window)
    else:
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=color.device)
        if seeds.dim() == 2:
            seeds = seeds.expand(b, -1, -1)
    clusters = init_clusters(seeds, color, points, normals)
    labels = init_labels(grid, h, w, color.device).expand(b, h, w).contiguous()
    distance = torch.full((b, h, w), INIT_DISTANCE, dtype=torch.float32, device=color.device)

    labels, distance = _assign(
        labels, distance, clusters, color_f, points, normals, grid, params,
        neighborhood, s_scale,
    )
    # after the first sweep labels come from the cell's candidate set, so
    # one cell-local index serves every gather / segment sum of the update
    idx = _CellIndex(labels, grid, neighborhood // 2, h, w)
    clusters = _update_nasp_analyze(
        idx, labels, clusters, color_f, points, normals, window_range, h, w
    )
    clusters = _update_nasp_weighted(
        idx, labels, clusters, color_f, points, normals, params, window_range, h, w
    )
    return SLICResult(labels=labels, distance=distance, clusters=clusters)
