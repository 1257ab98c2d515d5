"""Normal-adaptive superpixels (NASP), single-iteration cell route.

PyTorch counterpart of the NASP subset of the JAX package's ops/slic.py
(NormalAdaptiveSuperpixel.cu in the reference):

  * seeds: the 11x11 seed gradient on the per-cell seed sub-grid
    (ops/cuda_gradient.py: the CUDA kernel on the card, its plain version on
    the CPU), then a first-minimum argmin per cell;
  * assignment: the first-iteration `cell_fast` branch of _assign — labels
    are the grid init, so a pixel's 64 candidate clusters are a function of
    its grid cell; strict-< running argmin (first candidate wins ties);
  * cluster update: per-(cell, candidate) sums over the cell-local labels
    (_CellIndex), then a tiny candidate -> cluster fold.  No float atomics,
    so every sum is deterministic.

SLICParams.stats_impl picks the route, with the JAX package's meaning:
"auto" / "pallas" run the first iteration through ops/cuda_nasp.py's fused
assignment + analyze kernel and its weighted-sums kernel, and the cell
index's gathers and sums through its label-cell kernels (each wrapper takes
its plain version for CPU tensors); "xla" runs the plain route (band-space
assignment, one-hot products) on every device.

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

from typing import NamedTuple, Optional

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, SLICParams
from kinectdepthmapenhancement_tpu_torch.ops import cuda_gradient, cuda_nasp, stencil, tables

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


# -------------------------------------------------------------- label index


class _CellIndex:
    """Cell-local label index.  Valid ONLY when every label is either -1 or
    drawn from its pixel's cell-grid (2r)^2 neighbourhood — which holds after
    the first assignment sweep (whose candidate set is exactly that).

    gather:      out = table[label] over the pixel's cell candidates;
    segment sum: per-(cell, candidate) partials [B, rows*cols*n, F], then a
                 tiny [r*c*n, K] one-hot product folds candidates back to
                 clusters (fold).
    kernel_sums (the "auto" / "pallas" stats route) sends gathers and
    partials through ops/cuda_nasp.py's wrappers (the CUDA kernels on the
    card, their plain versions on the CPU); False (the "xla" route) runs the
    plain one-hot products on every device.  Every product is an f32 matmul
    with TF32 off (tables.exact_matmul): gathers are exact and sums
    deterministic on both routes."""

    def __init__(
        self, labels: torch.Tensor, grid: GridParams, r: int, h: int, w: int,
        *, kernel_sums: bool = True,
    ):
        self.rows, self.cols = grid.rows, grid.cols
        self.k = grid.num_clusters
        self.h, self.w = h, w
        self.r = r
        self.labels = labels.contiguous()
        self.b = labels.shape[0]
        self.kernel_sums = kernel_sums
        self.cand = cuda_nasp.cand_grid(
            self.rows, self.cols, cuda_nasp.candidate_offsets(r), labels.device
        )  # [rows, cols, n]
        self.n = self.cand.shape[-1]
        self._oh: Optional[torch.Tensor] = None
        self.cand_flat = self.cand.reshape(-1)
        self.oh_k = tables.one_hot(self.cand_flat, self.k)  # [rows*cols*n, K]

    @property
    def oh(self) -> torch.Tensor:
        """[B, rows, cols, P, n] f32 cell one-hot, built on first use: the
        kernel route reads it only for counts() and pair_counts()."""
        if self._oh is None:
            self._oh = cuda_nasp.cell_onehot(self.labels, self.rows, self.cols, self.r)
        return self._oh

    def _cells_flat(self, x: torch.Tensor) -> torch.Tensor:
        """[B, rows, cols, ...] -> [B*rows*cols, ...]."""
        return x.reshape((self.b * self.rows * self.cols,) + tuple(x.shape[3:]))

    def _geometry(self) -> dict:
        return dict(rows=self.rows, cols=self.cols, r=self.r)

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """[B, K, F] -> [B, H, W, F]: each pixel's label row, 0 for labels
        outside the candidate set (-1 included)."""
        table = table.to(torch.float32).contiguous()
        if self.kernel_sums:
            return cuda_nasp.label_cell_gather(self.labels, table, **self._geometry())
        return cuda_nasp.label_cell_gather_plain(
            self.labels, table, oh=self.oh, **self._geometry()
        )

    def fold(self, part: torch.Tensor) -> torch.Tensor:
        """Per-(cell, candidate) partials [B, rows*cols*n, F] -> [B, K, F]."""
        return tables.segment_sum(part, self.cand_flat, self.k, onehot=self.oh_k)

    def segment_sum(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, H, W, F] features summed per label over `mask` -> [B, K, F]."""
        fm = (feats * mask[..., None]).to(torch.float32).contiguous()
        if self.kernel_sums:
            part = cuda_nasp.label_cell_sums(self.labels, fm, **self._geometry())
        else:
            part = cuda_nasp.label_cell_sums_plain(
                self.labels, fm, oh=self.oh, **self._geometry()
            )
        return self.fold(part)

    def counts(self) -> torch.Tensor:
        """Pixels per label [B, K] f32: per-cell candidate histograms folded
        to clusters by the tiny K one-hot (no kernel on either route, as in
        the JAX package)."""
        per = self.oh.sum(dim=3)  # [B, rows, cols, n]
        return self.fold(per.reshape(self.b, -1, 1))[..., 0]

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
        cand_b = cuda_nasp.cand_grid(self.rows, self.cols, offs_b, labels_b.device)
        lb_b = cuda_nasp.to_cells(labels_b[..., None], self.rows, self.cols)[..., 0]
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


def _stats_impl_on(stats_impl: str) -> bool:
    """SLICParams.stats_impl as a route: "auto" and "pallas" take the NASP
    kernel wrappers of ops/cuda_nasp.py (the CUDA kernels for CUDA tensors,
    their plain versions for CPU ones), "xla" the plain one-hot-product
    route on every device.  Anything else raises."""
    if stats_impl in ("auto", "pallas"):
        return True
    if stats_impl == "xla":
        return False
    raise ValueError(f"stats_impl must be 'auto', 'pallas' or 'xla', got {stats_impl!r}")


def cell_index(
    labels: torch.Tensor, grid: GridParams, neighborhood: int, stats_impl: str = "auto"
) -> _CellIndex:
    """Cell-local index for downstream ops (CCL, plane) over single-iteration
    SLIC labels [B, H, W]; `stats_impl` picks the route of its gathers and
    segment sums (_stats_impl_on).  The global-index route for grids that
    do not divide the image is not ported yet."""
    h, w = labels.shape[-2:]
    _require_cell_ok(grid, h, w)
    return _CellIndex(
        labels, grid, neighborhood // 2, h, w, kernel_sums=_stats_impl_on(stats_impl)
    )


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


def _assign_args(clusters: Clusters, grid: GridParams, params: SLICParams, s_scale: float):
    """The candidate fields [B, rows, cols, 9] (rgb, x, y, center z,
    normal) and the distance constants of the first NASP assignment."""
    b = clusters.rgb.shape[0]
    total = params.spatial_sigma + params.color_sigma + params.depth_sigma + params.normal_sigma
    cand_fields = torch.cat(
        [clusters.rgb, clusters.xy.to(torch.float32), clusters.center[..., 2:3], clusters.normal],
        dim=-1,
    ).reshape(b, grid.rows, grid.cols, 9)
    kw = dict(
        rows=grid.rows, cols=grid.cols, r=4,
        w_col=(params.color_sigma / total) ** 2,
        w_spa=(params.spatial_sigma / total) ** 2,
        w_dep=(params.depth_sigma / total) ** 2,
        w_nor=(params.normal_sigma / total) ** 2,
        s_scale=s_scale,
        apply_invalid=params.depth_sigma != 0.0 or params.normal_sigma != 0.0,
    )
    return cand_fields.contiguous(), kw


# ----------------------------------------------------------- cluster stats


def _nasp_sums(idx: _CellIndex, clusters, color_f, points, normals, window_range, params, mode):
    """[B, K, 13|14] cluster sums of the NASP update `mode` over idx.labels:
    per-(cell, candidate) partials from cuda_nasp.nasp_cell_sums (when
    idx.kernel_sums, the "auto"/"pallas" route) or its plain version (the
    "xla" route), folded to clusters by the same candidate one-hot."""
    lo, hi = window_range
    xy = clusters.xy.to(torch.float32)
    fields = xy if mode == "analyze" else torch.cat([xy, clusters.rgb, clusters.normal], dim=-1)
    fields = fields.reshape(idx.b, idx.rows, idx.cols, -1).contiguous()
    kw = dict(
        rows=idx.rows, cols=idx.cols, r=idx.r, lo=lo, hi=hi, mode=mode,
        color_sigma=params.color_sigma, spatial_sigma=params.spatial_sigma,
    )
    args = (idx.labels, color_f, points, normals, fields)
    if idx.kernel_sums:
        part = cuda_nasp.nasp_cell_sums(*args, **kw)
    else:
        part = cuda_nasp.nasp_cell_sums_plain(*args, oh=idx.oh, **kw)
    return idx.fold(part)


def _nasp_fused_first_iteration(
    clusters, color_f, points, normals, grid, params, window_range, s_scale, h, w, *, kernel
):
    """First NASP iteration's assignment (calculateLD_NASP) and analyze
    update (analyzeClusters_NASP, NormalAdaptiveSuperpixel.cu:356-685): a
    pixel's 3-D point / normal count when z > 50 and the normal is valid
    (OR-validity).  `kernel` (the "auto"/"pallas" route) runs both in one
    call of cuda_nasp.nasp_assign_and_analyze (JAX slic.py:1010-1064);
    otherwise ("xla") its plain version runs on every device.  Returns
    (labels, distance, analyze-updated clusters, idx)."""
    lo, hi = window_range
    cand_fields, kw = _assign_args(clusters, grid, params, s_scale)
    fused = (
        cuda_nasp.nasp_assign_and_analyze if kernel
        else cuda_nasp.nasp_assign_and_analyze_plain
    )
    labels, distance, part = fused(color_f, points, normals, cand_fields, lo=lo, hi=hi, **kw)
    # after the first sweep labels come from the cell's candidate set, so
    # one cell-local index serves every gather / segment sum of the update
    idx = _CellIndex(labels, grid, kw["r"], h, w, kernel_sums=kernel)
    clusters = _nasp_analyze_post(idx.fold(part), clusters, points, h, w)
    return labels, distance, clusters, idx


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


def _update_nasp_weighted(idx, clusters, color_f, points, normals, params, window_range, h, w) -> Clusters:
    """NASP bilateral-weighted stats (calculateWeightedAverage,
    NormalAdaptiveSuperpixel.cu:687-1068), on the analyze-updated table.
    Colour/pixel sums are weighted by exp(-dc^2/2sc^2)*exp(-dpix^2/2ss^2);
    3-D/normal sums accept z > 50, a valid normal and dot(n, n_cluster) in
    (0.5, 1]."""
    sums = _nasp_sums(idx, clusters, color_f, points, normals, window_range, params, "weighted")
    return _nasp_weighted_post(sums, clusters, points, h, w)


def _nasp_weighted_post(sums, clusters: Clusters, points, h, w) -> Clusters:
    """Post-processing of the weighted sums [B, K, 14].  A cluster whose
    weights sum to 0 keeps its row (subnormal weights are flushed, so a sum
    of them is 0, as in XLA)."""
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
    color_f = color.to(torch.float32).contiguous()
    points, normals = points.contiguous(), normals.contiguous()
    seed_window = 8
    rp = ws_x * 2 // 16 + 1
    window_range = (-8 * rp, 8 * rp - 1)

    if seeds is None:
        seeds = _compute_seeds(color_f, normals, grid, h, w, seed_window)
    else:
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=color.device)
        if seeds.dim() == 2:
            seeds = seeds.expand(b, -1, -1)
    clusters = init_clusters(seeds, color, points, normals)
    # assignment + analyze sums in one call, weighted sums in a second
    # (JAX slic.py:1377-1393)
    labels, distance, clusters, idx = _nasp_fused_first_iteration(
        clusters, color_f, points, normals, grid, params, window_range, s_scale, h, w,
        kernel=_stats_impl_on(params.stats_impl),
    )
    clusters = _update_nasp_weighted(
        idx, clusters, color_f, points, normals, params, window_range, h, w
    )
    return SLICResult(labels=labels, distance=distance, clusters=clusters)
