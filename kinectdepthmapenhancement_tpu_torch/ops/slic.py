"""SLIC superpixels: base (SP), depth-adaptive (DASP), normal-adaptive (NASP).

PyTorch counterpart of the JAX package's ops/slic.py
(SuperpixelSegmentation / DepthAdaptiveSuperpixel /
NormalAdaptiveSuperpixel in the reference).  NASP:

  * seeds: the 11x11 seed gradient (ops/cuda_gradient.py: the CUDA kernel
    on the card, its plain version on the CPU) on the per-cell seed
    sub-grid, or on the whole frame when the grid does not divide it, then
    a first-minimum argmin per cell;
  * first assignment: the `cell_fast` branch of _assign when the grid
    divides the frame — labels are the grid init, so a pixel's 64 candidate
    clusters are a function of its grid cell; else the global route, whose
    candidates are the cells around each pixel's current label;
    strict-< running argmin (first candidate wins ties) on every route;
  * later iterations (SLICParams.iterations > 1): the global route's
    assignment, then the update on the capped route (cell-local at r = 5)
    when every label lies in its pixel's [-5, 4]^2 cell neighbourhood
    (labels_within_cap, checked on the device, branched on the host, or
    in a jit call on the device: with_label_index), on the global index
    otherwise or with locality="global".  The JAX
    package's capped assignment (a band-space sweep over 289 enlarged
    offsets) gives the global sweep's labels; on an H100 it took 1.8x
    the global sweep's time, so the port sweeps the global way;
  * cluster update: per-(cell, candidate) sums over cell-local labels
    (_CellIndex) or per-label sums over the whole [K] id space
    (_GlobalIndex), then the analyze and weighted post-processing.  No
    float atomics, so every sum is deterministic.

Every gather, sum and count of a label index, the first NASP iteration's
fused assignment and every sweep of the global route (the later
iterations' assignments too) go through the wrappers of ops/cuda_nasp.py,
which alone pick the device's version: the CUDA kernel for a CUDA tensor
(the fused assignment + analyze kernel, the NASP sums kernel at r = 4
and, on the capped route, r = 5, the label-cell kernels, the global
index's label-sums and label-counts kernels and the global sweep's
kernel), the plain version for a CPU one.  SLICParams.stats_impl is
checked ("auto", "pallas" or "xla", as in the JAX package) and not read.

On a width tile (parallel/sharding.py's tiled route, segment_tile and a
label index with a `tile`), NASP runs on the tile's pixels with the cluster
tables replicated over the tile group.  Seeds: the seed gradient on the
tile's own sub-grid blocks where each seed window's support lies in its
cell, else on the tile with a GRAD_MARGIN-column halo, each window's
values read from the tile that holds each pixel.  Over a grid that divides
the frame (tiles of whole cells) the fused assignment and the update sums
run on the tile's cells, every per-cell partial gathered in cell order
before the fold (CellTile.gather_cells), so each sum is the unsharded one
bitwise; over one that does not, the first assignment is the global sweep
at the tile's global columns and every update takes the global index,
whose float sums run on the group's gathered features as one whole-frame
product (CellTile.gather_width).  Later iterations sweep the tile's pixels
at their global columns; the cap check's per-frame verdicts are combined
over the group by a host step before the host reads them (every rank
takes the same branch; in a jit call a host branch), and off the cap the
global index takes over as above.

SP and DASP (the colour and depth SLICs of RGBF, SPDSP and TOF) seed from
the colour form of the seed gradient (window 16 / 4) and run every
assignment on the global route's sweep at r = 2 (16 candidates): the first
one from the grid-init labels, where its candidates are the JAX cell_fast
set, so the labels are equal; each update then runs on the cell-local
index at r = 2 after the first sweep and at the variant's cap r = 3 after
later ones (labels_within_cap, read on the host), on the global index
otherwise.  The DASP update's sums (10 features) and its window gather of
the old centres (2) go through _CellIndex, so through the label-cell
kernels on the card.

Distances (JAX slic.py:30-36), with T the sum of the variant's sigmas:
    SP   cd*sc/(ss+sc) + pd*ss/(ss+sc)                (weights NOT squared)
    DASP cd*(sc/T)^2 + pd*(ss/T)^2 + |dz|*(sd/T)^2
    NASP DASP's + 255^2*(1-max(0,n.nc))*(sn/T)^2
Invalid depth (z < 50) is labelled -1 after the sweep by DASP when
depth_sigma != 0 and by NASP when depth_sigma or normal_sigma != 0; SP
never overrides.  The bug-fidelity decisions (a)-(d) are the JAX
package's (slic.py:39-49): (a) clamped gradient neighbours, (b) the real
blue channel, (c) the 2-D centroid as pixel centre, (d) normal distance 0
when either normal is invalid.

Tensors carry a leading batch dimension; cluster tables are [B, K, ...].
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Protocol, Union

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, SLICParams
from kinectdepthmapenhancement_tpu_torch.core import jit
from kinectdepthmapenhancement_tpu_torch.core.device import constant
from kinectdepthmapenhancement_tpu_torch.ops import cuda_gradient, cuda_nasp, stencil, tables
from kinectdepthmapenhancement_tpu_torch.utils import telemetry

INVALID_NORMAL = -1.0
INIT_DISTANCE = cuda_nasp.INIT_DISTANCE

GRAD_MARGIN = 5  # the seed gradient's 11x11 window half-width
# per variant: seed window, candidate neighbourhood ((2r)^2 cells, r =
# neighbourhood / 2) and the update window's rp numerator (JAX
# slic.py:1349-1358); later iterations' locality cap is r + 1 (:1430)
_VARIANTS = {"sp": (16, 4, 4), "dasp": (4, 4, 2), "nasp": (8, 8, 2)}
_NEIGHBORHOOD = _VARIANTS["nasp"][1]


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


def _variant(variant: str):
    """(seed window, neighbourhood, later iterations' cap) of a variant."""
    if variant not in _VARIANTS:
        raise ValueError(f"SLIC variant must be 'sp', 'dasp' or 'nasp', got {variant!r}")
    seed_window, neighborhood, _ = _VARIANTS[variant]
    return seed_window, neighborhood, neighborhood // 2 + 1


def _update_geometry(grid: GridParams, h: int, w: int, variant: str):
    """(s_scale, update window range [lo, hi]) of a variant's iteration."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    rp = ws_x * _VARIANTS[variant][2] // 16 + 1
    return (ws_x + ws_y) / 2.0, (-8 * rp, 8 * rp - 1)


# -------------------------------------------------------------- label index


class CellTile(Protocol):
    """A width tile and its tile group's collectives, as
    parallel/sharding.py's tiled route hands it to NASP, CCL and the plane
    stage: pixel columns [x0, x0 + ws) of a frame `width` wide and, over a
    grid that divides the frame, cell columns [c0, c0 + cols) of the grid
    (the tile holds them whole; c0 and cols are None on a tile of pixels
    only)."""

    c0: Optional[int]
    cols: Optional[int]
    x0: int
    ws: int
    width: int
    # [B, rows, cols, ...] pieces of every tile -> [B, rows, grid cols, ...],
    # in cell order
    gather_cells: Callable[[torch.Tensor], torch.Tensor]
    # (img [B, H, ws, ...] tile, global x, y [B, K]) -> img at those pixels
    # [B, K, ...], each from the tile that holds it
    pixels_at: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    # labels [B, H, ws] -> [B, H, 1]: the column right of the tile, -1 past
    # the frame
    right_labels: Callable[[torch.Tensor], torch.Tensor]
    # integer-valued f32 counts (< 2^24) of every tile -> their sum (exact,
    # so the same in any order)
    sum_counts: Callable[[torch.Tensor], torch.Tensor]
    # bool [B] of every tile -> 0-dim bool: every element holds on every
    # tile (a host step, whose verdict a jit.cond reads on the host)
    all_true: Callable[[torch.Tensor], torch.Tensor]
    # [B, H, ws, ...] of every tile -> the frames [B, H, width, ...]
    gather_width: Callable[[torch.Tensor], torch.Tensor]
    # (x [B, H, ws, ...], radius) -> (x with radius columns of the
    # neighbouring tiles each side and none past the frame, the columns kept
    # on the left)
    haloed: Callable[[torch.Tensor, int], tuple]


class _IndexBase:
    """What both label indices do alike over their labels (the tile's, on
    a tile): pixel lookups at global pixels, and the pixel and pixel-pair
    counts keyed by the whole [K] id space through cuda_nasp.label_counts /
    label_pair_counts.  The counts are integers below 2^24, exact in f32 in
    any order, so on a tile each tile counts its own pixels and the group
    sums the tables (CellTile.sum_counts): bitwise the unsharded counts."""

    labels: torch.Tensor
    k: int
    tile: Optional[CellTile]

    def pixels_at(self, img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """img[b, y[b, k], x[b, k]] -> [B, K, ...] at global pixels (from the
        tile that holds each, on a tile)."""
        if self.tile is None:
            return _at_pixels(img, x, y)
        return self.tile.pixels_at(img, x, y)

    def _summed(self, counts: torch.Tensor) -> torch.Tensor:
        return counts if self.tile is None else self.tile.sum_counts(counts)

    def counts(self) -> torch.Tensor:
        """Pixels per label [B, K] f32 (labels < 0 dropped)."""
        return self._summed(cuda_nasp.label_counts(self.labels, self.k))

    def pair_counts(self, labels_b: torch.Tensor) -> torch.Tensor:
        """[B, K, K] f32: occurrences of (own label, labels_b) pixel pairs;
        pairs with either side < 0 are dropped."""
        return self._summed(
            cuda_nasp.label_pair_counts(self.labels, labels_b.contiguous(), self.k))


class _CellIndex(_IndexBase):
    """Cell-local label index.  Valid ONLY when every label is either -1 or
    drawn from its pixel's cell-grid (2r)^2 neighbourhood — which holds after
    the first assignment sweep (whose candidate set is exactly that).

    gather:      out = table[label] over the pixel's cell candidates
                 (cuda_nasp.label_cell_gather);
    segment sum: per-(cell, candidate) partials [B, rows*cols*n, F]
                 (cuda_nasp.label_cell_sums), then a tiny [r*c*n, K]
                 one-hot product folds candidates back to clusters (fold).
    Every product is an f32 matmul with TF32 off (tables.exact_matmul):
    gathers are exact and sums deterministic.

    tile (a CellTile): labels are the tile's [B, H, ws]; gathers stay on
    the tile, and the per-cell partials of every sum are gathered over the
    tile group (_gathered) before their last product, which then runs on
    the unsharded run's input."""

    def __init__(
        self, labels: torch.Tensor, grid: GridParams, r: int, h: int, w: int,
        *, tile: Optional[CellTile] = None,
    ):
        self.rows, self.cols = grid.rows, grid.cols
        self.k = grid.num_clusters
        self.h, self.w = h, w
        self.r = r
        self.labels = labels.contiguous()
        self.b = labels.shape[0]
        self.tile = tile
        # the cell columns this index's labels cover
        self.c0, self.tc = (0, self.cols) if tile is None else (tile.c0, tile.cols)
        self.cand = cuda_nasp.cand_grid(
            self.rows, self.cols, cuda_nasp.candidate_offsets(r), labels.device
        )  # [rows, cols, n]
        self.n = self.cand.shape[-1]
        self.cand_flat = self.cand.reshape(-1)
        self.oh_k = tables.one_hot(self.cand_flat, self.k)  # [rows*cols*n, K]

    def _geometry(self) -> dict:
        return dict(rows=self.rows, cols=self.cols, r=self.r, c0=self.c0, tile_cols=self.tc)

    def _gathered(self, part: torch.Tensor) -> torch.Tensor:
        """The labels' per-(cell, candidate) partials [B, rows*tc*n, F] ->
        the whole grid's [B, rows*cols*n, F]: gathered over the tile group
        in cell order on a tile, as they are otherwise."""
        if self.tile is None:
            return part
        f = part.shape[-1]
        cells = self.tile.gather_cells(part.reshape(self.b, self.rows, self.tc, self.n, f))
        return cells.reshape(self.b, -1, f)

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """[B, K, F] -> [B, H, W, F]: each pixel's label row, 0 for labels
        outside the candidate set (-1 included)."""
        table = table.to(torch.float32).contiguous()
        return cuda_nasp.label_cell_gather(self.labels, table, **self._geometry())

    def fold(self, part: torch.Tensor) -> torch.Tensor:
        """Per-(cell, candidate) partials [B, rows*tc*n, F] of the labels'
        cells -> [B, K, F]."""
        return tables.segment_sum(self._gathered(part), self.cand_flat, self.k, onehot=self.oh_k)

    def segment_sum(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, H, W, F] features summed per label over `mask` -> [B, K, F]."""
        fm = (feats * mask[..., None]).to(torch.float32).contiguous()
        return self.fold(cuda_nasp.label_cell_sums(self.labels, fm, **self._geometry()))


class _GlobalIndex(_IndexBase):
    """Per-pixel gathers and segment sums keyed by the whole [K] cluster id
    space (the JAX package's slic._GlobalIndex), for labels with no
    locality guarantee: grids that do not divide the frame, and later
    iterations whose labels left the cap.  Gathers are exact index ops.
    segment_sum goes through cuda_nasp.label_sums: on the card csrc/nasp.cu's
    label-sums kernel (double sums in a fixed order rounded once, no float
    atomics, so bitwise the same from run to run and within 1 ulp of the
    exact sums unless the terms cancel (the bound in the kernel's header),
    not bitwise the one-hot product); on the CPU its plain version, the
    product with the [B, H*W, K] f32 one-hot through tables.exact_matmul.

    tile (a CellTile): labels are the tile's [B, H, ws] at global columns
    [tile.x0, tile.x0 + ws); gathers and pixel lookups stay on the tile,
    counts and pair counts are the tile's own (its labels and, for CCL's
    right neighbours, its right_labels column) summed over the group
    (_IndexBase), and each float segment sum gathers the group's masked
    features and sums the whole frame on every rank (the unsharded call on
    the unsharded input, so bitwise; the frame's labels are gathered once,
    on first use)."""

    def __init__(self, labels: torch.Tensor, k: int, tile: Optional[CellTile] = None):
        self.labels = labels.contiguous()
        self.k = k
        self.b = labels.shape[0]
        self.tile = tile
        self.x0 = 0 if tile is None else tile.x0
        self._frame: Optional[torch.Tensor] = None

    def _frame_labels(self) -> torch.Tensor:
        """The whole frames' labels (gathered on a tile)."""
        if self.tile is None:
            return self.labels
        if self._frame is None:
            self._frame = self.tile.gather_width(self.labels).contiguous()
        return self._frame

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """[B, K, F] -> [B, H, W, F]: each pixel's label row, 0 for -1."""
        return tables.gather(table.to(torch.float32), self.labels)

    def segment_sum(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, H, W, F] features summed per label over `mask` -> [B, K, F]."""
        feats = feats.to(torch.float32)
        if self.tile is not None:
            feats = self.tile.gather_width(torch.where(mask[..., None], feats, 0.0))
            mask = None
        else:
            mask = mask.contiguous()
        return cuda_nasp.label_sums(self._frame_labels(), feats.contiguous(), mask, self.k)


def grid_divides(grid: GridParams, h: int, w: int) -> bool:
    """Whether the grid cuts h x w frames into whole cells (the fused cell
    route and the cell-aligned tiles need it)."""
    return h % grid.rows == 0 and w % grid.cols == 0


def init_labels(grid: GridParams, height: int, width: int, device=None) -> torch.Tensor:
    """Grid initialisation [H, W] i32 (initLD, SuperpixelSegmentation.cu:3-14).
    Where the grid does not divide the frame, the last rows / columns carry
    ids past the grid: the first assignment replaces them."""
    ws_x, ws_y = _grid_geometry(grid, height, width)
    v = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    u = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    return (v // ws_y) * grid.cols + (u // ws_x)


def labels_within_cap(
    labels: torch.Tensor, grid: GridParams, cap: int, h: int, w: int, x0: int = 0
) -> torch.Tensor:
    """[B] bool, on the labels' device: every label >= 0 of the frame lies in
    its pixel's [-cap, cap-1]^2 cell-grid neighbourhood — the invariant that
    lets later iterations and downstream gathers run cell-local (JAX
    slic.py:371-391, per frame here).  One reduction; the caller reads it
    on the host to pick a route.  The labels may be columns [x0, x0 + ws)
    of the h x w frame (a width tile): the cells are read at global
    columns."""
    ws_x, ws_y = _grid_geometry(grid, h, w)
    dev = labels.device
    cols = labels.shape[-1]
    lab0 = labels.clamp_min(0)
    dyl = lab0 // grid.cols - (torch.arange(h, dtype=labels.dtype, device=dev) // ws_y)[:, None]
    dxl = lab0 % grid.cols - (torch.arange(x0, x0 + cols, dtype=labels.dtype, device=dev)
                              // ws_x)[None, :]
    ok = (labels < 0) | ((dyl >= -cap) & (dyl <= cap - 1) & (dxl >= -cap) & (dxl <= cap - 1))
    return ok.reshape(labels.shape[0], -1).all(dim=1)


def _cap_verdict(labels: torch.Tensor, grid: GridParams, cap: int, h: int, w: int,
                 tile: Optional[CellTile] = None) -> torch.Tensor:
    """0-dim bool on the labels' device: every frame of the batch holds
    labels_within_cap's invariant.  On a tile the frames' verdicts are the
    tiles' combined over the group (a frame fails when any tile of it
    fails: CellTile.all_true, a host step), so every rank of the group
    reads the same verdict, the one of the whole frames, and takes the
    same branch."""
    ok = labels_within_cap(labels, grid, cap, h, w, x0=0 if tile is None else tile.x0)
    return ok.all() if tile is None else tile.all_true(ok)


def _within_cap(labels: torch.Tensor, grid: GridParams, cap: int, h: int, w: int) -> bool:
    """The eager call's host branch on _cap_verdict (a host sync) off a
    tile (on a tile the verdict comes out of a host step: jit.cond)."""
    return bool(_cap_verdict(labels, grid, cap, h, w))


def _check_stats_impl(stats_impl: str) -> None:
    """SLICParams.stats_impl, checked and not read: "auto", "pallas" and
    "xla" (the JAX package's values) all take the cuda_nasp wrappers, which
    pick the device's version themselves.  Anything else raises."""
    if stats_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"stats_impl must be 'auto', 'pallas' or 'xla', got {stats_impl!r}")


LabelIndex = Union[_CellIndex, _GlobalIndex]


def cell_index(
    labels: torch.Tensor, grid: GridParams, neighborhood: int, stats_impl: str = "auto",
    tile: Optional[CellTile] = None,
) -> LabelIndex:
    """Index for downstream ops (CCL, plane) over single-iteration SLIC
    labels [B, H, W]: cell-local, or the global one when the grid does not
    divide the frame (the JAX package's cell_index gives None there and its
    callers take the global route); `stats_impl` is checked
    (_check_stats_impl).  With a tile the labels are the tile's, the frame
    tile.width wide."""
    h, w = labels.shape[-2:]
    w = w if tile is None else tile.width
    _check_stats_impl(stats_impl)
    if not grid_divides(grid, h, w):
        return _GlobalIndex(labels, grid.num_clusters, tile=tile)
    return _CellIndex(labels, grid, neighborhood // 2, h, w, tile=tile)


def with_capped_index(
    fn: Callable[[LabelIndex], object], labels: torch.Tensor, grid: GridParams, cap: int, *,
    stats_impl: str = "auto", locality: str = "auto", tile: Optional[CellTile] = None,
):
    """fn(index) on the cell-local index at r = cap when every label lies in
    its pixel's [-cap, cap-1]^2 cell neighbourhood (unchecked with
    locality="cell"), on the global one otherwise, with locality="global",
    or when the grid does not divide the frame: the JAX package's lax.cond
    (slic.py:1436-1478, pipelines.py:232-260).  An eager call reads the
    verdict (_cap_verdict) on the host, one sync; inside a jit call
    (core/jit.py) jit.cond takes it on the device, a conditional node with
    fn on each index as its branches, so fn must then return tensors.
    Labels agree exactly on either route; sums differ in order only.  With
    a tile the labels are the tile's, the frame tile.width wide, and the
    verdict the group's, made by a host step that the jit.cond reads on
    the host (a host branch inside a jit call: the branches gather over the
    group).  Under jit.cond each branch is a stage of its own (utils/
    telemetry.py), slic.cell_index and slic.global_index, whose stamps fire
    only when the device takes it; a direct call is no stage."""
    h, w = labels.shape[-2:]
    w = w if tile is None else tile.width
    _check_stats_impl(stats_impl)

    def cell():
        return fn(_CellIndex(labels, grid, cap, h, w, tile=tile))

    def whole():
        return fn(_GlobalIndex(labels, grid.num_clusters, tile=tile))

    if not grid_divides(grid, h, w) or locality == "global":
        return whole()
    if locality == "cell":
        return cell()
    if jit.tracing() or tile is not None:
        return jit.cond(_cap_verdict(labels, grid, cap, h, w, tile),
                        _staged("slic.cell_index", cell, labels),
                        _staged("slic.global_index", whole, labels))
    return cell() if _within_cap(labels, grid, cap, h, w) else whole()


def _staged(name: str, branch: Callable[[], object], on: torch.Tensor):
    """branch() inside telemetry stage `name`."""
    def run():
        with telemetry.stage(name, on):
            return branch()

    return run


def capped_index(
    labels: torch.Tensor, grid: GridParams, cap: int, *, stats_impl: str = "auto",
    locality: str = "auto", tile: Optional[CellTile] = None,
) -> LabelIndex:
    """with_capped_index's index itself, for an eager call (an index is no
    tensor, so inside a jit call a checked route raises)."""
    return with_capped_index(lambda index: index, labels, grid, cap, stats_impl=stats_impl,
                             locality=locality, tile=tile)


def with_label_index(
    fn: Callable[[LabelIndex], object], labels: torch.Tensor, grid: GridParams,
    params: SLICParams, variant: str = "nasp", tile: Optional[CellTile] = None,
):
    """fn(index) on the index over SLIC labels of `params` that an update,
    CCL or the plane stage takes: after one iteration cell_index's (r = 4
    for NASP, 2 for SP / DASP); after later iterations with_capped_index's
    at the variant's cap (5 for NASP, 3 for SP / DASP), whose route a jit
    call takes on the device.  KDE's CCL and plane stage take it as the JAX
    package's _with_local_index does for its multi-iteration pipelines.
    With a tile (a CellTile) the labels are the tile's and every rank of
    its group calls it."""
    _, neighborhood, cap = _variant(variant)
    if params.iterations == 1:
        return fn(cell_index(labels, grid, neighborhood, params.stats_impl, tile))
    return with_capped_index(fn, labels, grid, cap, stats_impl=params.stats_impl,
                             locality=params.locality, tile=tile)


def label_index(
    labels: torch.Tensor, grid: GridParams, params: SLICParams, variant: str = "nasp",
    tile: Optional[CellTile] = None,
) -> LabelIndex:
    """with_label_index's index itself, for an eager call."""
    return with_label_index(lambda index: index, labels, grid, params, variant, tile)


# ----------------------------------------------------------------- seeding


def _gradient(color_f: torch.Tensor, normals: Optional[torch.Tensor],
              form: Optional[str] = None) -> torch.Tensor:
    """Seed gradient: the colour form (SuperpixelSegmentation.cu:16-46) for
    SP / DASP (normals None); the NASP form scales the colour term by
    (1 - |n.n'|) where both normals are valid (AND-validity),
    NormalAdaptiveSuperpixel.cu:39-71.  form: the launch form's name
    (cuda_gradient.seed_gradient)."""
    return cuda_gradient.seed_gradient(
        color_f.contiguous(), None if normals is None else normals.contiguous(), form)


def _subgrid_ok(grid: GridParams, h: int, w: int, window: int) -> bool:
    """True when every seed window's gradient support stays inside its cell,
    so the gradient can be computed on the seed sub-grid alone."""
    if not grid_divides(grid, h, w):
        return False
    ws_x, ws_y = _grid_geometry(grid, h, w)
    r = window // 2
    m = GRAD_MARGIN
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
    m = GRAD_MARGIN
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
    m = GRAD_MARGIN
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


def _seed_windows(grid: GridParams, height: int, width: int, window: int, device):
    """(yy, xx) [K * window^2] of every cluster's `window x window` block
    around its grid centre, clamped to the image, row-major offsets within
    each block."""
    ws_x, ws_y = _grid_geometry(grid, height, width)
    r = window // 2
    offs = torch.arange(window, device=device) - r
    cy = torch.arange(grid.rows, device=device) * ws_y + ws_y // 2
    cx = torch.arange(grid.cols, device=device) * ws_x + ws_x // 2
    yy = (cy[:, None, None, None] + offs[None, None, :, None]).clamp(0, height - 1)
    xx = (cx[None, :, None, None] + offs[None, None, None, :]).clamp(0, width - 1)
    shape = (grid.rows, grid.cols, window, window)
    return yy.expand(shape).reshape(-1), xx.expand(shape).reshape(-1)


def _window_argmin(g: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, k: int) -> torch.Tensor:
    """(x, y) seeds [B, K, 2] i32 from the gradient g [B, K * window^2] at
    _seed_windows' pixels (yy, xx): each block's first minimum (torch.argmin
    returns the first, as jnp.argmin does)."""
    b = g.shape[0]
    best = torch.argmin(g.reshape(b, k, -1), dim=-1)
    yy = yy.reshape(k, -1).expand(b, -1, -1)
    xx = xx.reshape(k, -1).expand(b, -1, -1)
    seed_y = torch.gather(yy, -1, best[..., None])[..., 0]
    seed_x = torch.gather(xx, -1, best[..., None])[..., 0]
    return torch.stack([seed_x, seed_y], dim=-1).to(torch.int32)


def sample_seeds(
    gradient: torch.Tensor, grid: GridParams, height: int, width: int, window: int
) -> torch.Tensor:
    """Per cluster, the (x, y) of the minimum-gradient pixel in a
    `window x window` block around the grid centre (clamped to the image),
    ties to the first pixel in row-major offset order.  -> [B, K, 2] i32."""
    yy, xx = _seed_windows(grid, height, width, window, gradient.device)
    return _window_argmin(gradient[:, yy, xx], yy, xx, grid.num_clusters)


def _compute_seeds(
    color_f: torch.Tensor,
    normals: Optional[torch.Tensor],
    grid: GridParams,
    h: int,
    w: int,
    window: int,
) -> torch.Tensor:
    """Seed sampling (the NASP gradient with normals, the colour one
    without); on the sub-grid fast path the gradient is evaluated only
    where the seed windows can read it (same seeds)."""
    if _subgrid_ok(grid, h, w, window):
        csub = _subgrid_extract(color_f, grid, h, w, window)
        nsub = None if normals is None else _subgrid_extract(normals, grid, h, w, window)
        return _sample_seeds_subgrid(_gradient(csub, nsub), grid, h, w, window)
    return sample_seeds(_gradient(color_f, normals), grid, h, w, window)


def _at_pixels(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img[b, y[b, k], x[b, k]] -> [B, K, ...]."""
    b, h, w = img.shape[:3]
    flat = img.reshape((b, h * w) + tuple(img.shape[3:]))
    idx = (y.long() * w + x.long())
    bi = torch.arange(b, device=img.device)[:, None]
    return flat[bi, idx]


def init_clusters(
    seeds: torch.Tensor,
    color: torch.Tensor,
    points: Optional[torch.Tensor],
    normals: Optional[torch.Tensor],
) -> Clusters:
    """Seed the cluster table (store sections of sampleInitialClusters*;
    bug (b) fixed: the real blue channel is stored).  seeds [B, K, 2] (x, y).
    Without points (SP) the centres are 0, without normals (SP, DASP) the
    normals are the -1 sentinel."""
    b, k = seeds.shape[:2]
    sx, sy = seeds[..., 0], seeds[..., 1]
    dev = seeds.device
    f32 = torch.float32
    return Clusters(
        rgb=_at_pixels(color, sx, sy).to(f32),
        xy=seeds,
        size=torch.zeros((b, k), dtype=torch.int32, device=dev),
        center=(torch.zeros((b, k, 3), dtype=f32, device=dev) if points is None
                else _at_pixels(points, sx, sy)),
        normal=(torch.full((b, k, 3), INVALID_NORMAL, dtype=f32, device=dev)
                if normals is None else _at_pixels(normals, sx, sy)),
        variance=torch.zeros((b, k), dtype=f32, device=dev),
    )


# -------------------------------------------------------------- assignment


def _weights(params: SLICParams, variant: str = "nasp"):
    """The distance weights (w_col, w_spa, w_dep, w_nor) of a variant: SP
    each sigma over ss + sc, unsquared; DASP / NASP each sigma over the sum
    of the variant's sigmas, squared (JAX slic.py:694-706)."""
    sc, ss, sd, sn = (params.color_sigma, params.spatial_sigma, params.depth_sigma,
                      params.normal_sigma)
    if variant == "sp":
        denom = ss + sc
        return sc / denom, ss / denom, 0.0, 0.0
    total = ss + sc + sd
    if variant == "nasp":
        total = total + sn
    w_nor = (sn / total) ** 2 if variant == "nasp" else 0.0
    return (sc / total) ** 2, (ss / total) ** 2, (sd / total) ** 2, w_nor


def _cluster_fields(clusters: Clusters, variant: str = "nasp") -> torch.Tensor:
    """[B, K, 5|6|9] candidate fields: rgb, x, y (SP), then center z (DASP),
    then normal (NASP)."""
    cols = [clusters.rgb, clusters.xy.to(torch.float32)]
    if variant != "sp":
        cols.append(clusters.center[..., 2:3])
    if variant == "nasp":
        cols.append(clusters.normal)
    return torch.cat(cols, dim=-1)


def _overrides(params: SLICParams, variant: str) -> bool:
    """Whether a variant's sweep applies the invalid-depth override
    (DepthAdaptiveSuperpixel.cu:306-312 when depth_sigma != 0,
    NormalAdaptiveSuperpixel.cu:346-352 when depth_sigma or normal_sigma !=
    0; SP has none)."""
    if variant == "sp":
        return False
    return params.depth_sigma != 0.0 or (variant == "nasp" and params.normal_sigma != 0.0)


def _assign_args(clusters: Clusters, grid: GridParams, params: SLICParams, s_scale: float):
    """The candidate fields [B, rows, cols, 9] (rgb, x, y, center z,
    normal) and the distance constants of the first NASP assignment."""
    b = clusters.rgb.shape[0]
    cand_fields = _cluster_fields(clusters).reshape(b, grid.rows, grid.cols, 9)
    w_col, w_spa, w_dep, w_nor = _weights(params)
    kw = dict(
        rows=grid.rows, cols=grid.cols, r=_NEIGHBORHOOD // 2,
        w_col=w_col, w_spa=w_spa, w_dep=w_dep, w_nor=w_nor,
        s_scale=s_scale,
        apply_invalid=_overrides(params, "nasp"),
    )
    return cand_fields.contiguous(), kw


def _assign_global(
    labels, distance, clusters, color_f, points, normals, grid, params, s_scale,
    variant: str = "nasp", x0: int = 0,
):
    """A variant's assignment sweep on the global route (JAX slic.py:_assign
    with cell_fast=False, cell_capped=0) through cuda_nasp.assign_global:
    the sweep kernel on CUDA tensors, on CPU ones assign_global_plain,
    whose docstring states the rules.  From the grid-init labels a pixel's
    candidates are the JAX cell_fast ones, so the first SP / DASP sweep
    runs here too.  The pixels may be columns [x0, x0 + W) of a wider
    frame (a width tile).  Telemetry stage slic.assign."""
    w_col, w_spa, w_dep, w_nor = _weights(params, variant)
    with telemetry.stage("slic.assign", labels):
        return cuda_nasp.assign_global(
            labels, distance, _cluster_fields(clusters, variant), color_f, points, normals,
            rows=grid.rows, cols=grid.cols, r=_variant(variant)[1] // 2, variant=variant,
            w_col=w_col, w_spa=w_spa, w_dep=w_dep, w_nor=w_nor, s_scale=s_scale,
            apply_invalid=_overrides(params, variant), x0=x0,
        )


# ----------------------------------------------------------- cluster stats


def _nasp_sums(idx, clusters, color_f, points, normals, window_range, params, mode):
    """[B, K, 13|14] cluster sums of the NASP update `mode` over idx.labels.
    On a _CellIndex: per-(cell, candidate) partials from
    cuda_nasp.nasp_cell_sums, folded to clusters by the candidate one-hot.
    On a _GlobalIndex: the same features (cuda_nasp.nasp_features) from a
    per-pixel gather of the cluster fields, summed by its segment_sum."""
    lo, hi = window_range
    xy = clusters.xy.to(torch.float32)
    fields = xy if mode == "analyze" else torch.cat([xy, clusters.rgb, clusters.normal], dim=-1)
    if isinstance(idx, _GlobalIndex):
        feats = cuda_nasp.nasp_features(
            mode, idx.labels, idx.gather(fields), color_f, points, normals, lo, hi,
            params.color_sigma, params.spatial_sigma, x0=idx.x0,
        )
        return idx.segment_sum(feats, idx.labels >= 0)
    fields = fields.reshape(idx.b, idx.rows, idx.cols, -1).contiguous()
    kw = dict(
        rows=idx.rows, cols=idx.cols, r=idx.r, lo=lo, hi=hi, mode=mode,
        color_sigma=params.color_sigma, spatial_sigma=params.spatial_sigma, c0=idx.c0,
        tile_cols=idx.tc,
    )
    return idx.fold(cuda_nasp.nasp_cell_sums(idx.labels, color_f, points, normals, fields, **kw))


def _nasp_fused_first_iteration(
    clusters, color_f, points, normals, grid, params, window_range, s_scale, h, w, *,
    tile: Optional[CellTile] = None,
):
    """First NASP iteration's assignment (calculateLD_NASP) and analyze
    update (analyzeClusters_NASP, NormalAdaptiveSuperpixel.cu:356-685): a
    pixel's 3-D point / normal count when z > 50 and the normal is valid
    (OR-validity), both in one call of cuda_nasp.nasp_assign_and_analyze
    (JAX slic.py:1010-1064).  On a tile the frame is the tile's and h, w
    the whole frame's.  Returns (labels, distance, analyze-updated
    clusters, idx)."""
    lo, hi = window_range
    cand_fields, kw = _assign_args(clusters, grid, params, s_scale)
    if tile is not None:
        kw.update(c0=tile.c0, tile_cols=tile.cols)
    labels, distance, part = cuda_nasp.nasp_assign_and_analyze(
        color_f, points, normals, cand_fields, lo=lo, hi=hi, **kw)
    # after the first sweep labels come from the cell's candidate set, so
    # one cell-local index serves every gather / segment sum of the update
    idx = _CellIndex(labels, grid, kw["r"], h, w, tile=tile)
    clusters = _nasp_analyze_post(idx.fold(part), clusters, points, h, w, idx.pixels_at)
    return labels, distance, clusters, idx


def _window_mask(idx, clusters: Clusters, lo: int, hi: int, h: int, w: int) -> torch.Tensor:
    """Labelled pixels within the reference's update window [lo, hi] (both
    axes) of their cluster's OLD mean pixel (JAX slic.py:1067-1084); the
    centres come through idx.gather (2 features)."""
    cxy = idx.gather(clusters.xy.to(torch.float32))
    dev = cxy.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    dx = u - cxy[..., 0]
    dy = v - cxy[..., 1]
    inside = (dx >= lo) & (dx <= hi) & (dy >= lo) & (dy <= hi)
    return inside & (idx.labels >= 0)


def _pixel_uv1(b: int, h: int, w: int, device) -> torch.Tensor:
    """[B, H, W, 3] f32 planes (u, v, 1) of the SP / DASP update features."""
    u = torch.arange(w, dtype=torch.float32, device=device)[None, None, :].expand(b, h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[None, :, None].expand(b, h, w)
    return torch.stack([u, v, torch.ones_like(u)], dim=-1)


def _mean_rgb_xy(sums, clusters: Clusters):
    """(nonzero, rgb, xy, size) of the SP / DASP sums (size in column 5)."""
    size = sums[..., 5]
    nz = size > 0
    safe = torch.clamp_min(size, 1.0)
    rgb = torch.clamp(torch.floor(sums[..., 0:3] / safe[..., None]), 0, 255)
    xy = torch.floor(sums[..., 3:5] / safe[..., None]).to(torch.int32)
    nz3 = nz[..., None]
    return (nz, torch.where(nz3, rgb, clusters.rgb), torch.where(nz3, xy, clusters.xy),
            torch.where(nz, size.to(torch.int32), clusters.size))


def _update_sp(idx, clusters: Clusters, color_f, window_range, h, w) -> Clusters:
    """Base-SLIC cluster update (analyzeClusters,
    SuperpixelSegmentation.cu:297-487): mean colour and pixel of the
    window-masked members, 6 features."""
    lo, hi = window_range
    mask = _window_mask(idx, clusters, lo, hi, h, w)
    feats = torch.cat([color_f, _pixel_uv1(idx.b, h, w, color_f.device)], dim=-1)
    _, rgb, xy, size = _mean_rgb_xy(idx.segment_sum(feats, mask), clusters)
    return clusters._replace(rgb=rgb, xy=xy, size=size)


def _update_dasp(idx, clusters: Clusters, color_f, points, window_range, h, w) -> Clusters:
    """DASP cluster update (analyzeClusters, DepthAdaptiveSuperpixel.cu:
    315-568), 10 features: 3-D centre = the sum of ALL window-masked
    members' points over the count of valid (z > 50) ones; pixel centre =
    the 2-D centroid (reprojection branch dead, bug (c))."""
    lo, hi = window_range
    mask = _window_mask(idx, clusters, lo, hi, h, w)
    validz = (points[..., 2] > VALID_DEPTH_MM).to(torch.float32)[..., None]
    feats = torch.cat(
        [color_f, _pixel_uv1(idx.b, h, w, color_f.device), points, validz], dim=-1)
    sums = idx.segment_sum(feats, mask)
    nz, rgb, xy, size = _mean_rgb_xy(sums, clusters)
    npts = sums[..., 9]
    center = sums[..., 6:9] / torch.clamp_min(npts, 1.0)[..., None]
    keep = (nz & (npts > 0))[..., None]
    return clusters._replace(rgb=rgb, xy=xy, size=size,
                             center=torch.where(keep, center, clusters.center))


def _update(variant, idx, clusters, color_f, points, normals, params, window_range, h, w):
    """One iteration's cluster update of a variant on the label index."""
    if variant == "sp":
        return _update_sp(idx, clusters, color_f, window_range, h, w)
    if variant == "dasp":
        return _update_dasp(idx, clusters, color_f, points, window_range, h, w)
    frame = (color_f, points, normals)
    clusters = _update_nasp_analyze(idx, clusters, *frame, params, window_range, h, w)
    return _update_nasp_weighted(idx, clusters, *frame, params, window_range, h, w)


def _centroid_center(sums_xyz, npts, xy, points, h, w, at=_at_pixels):
    """Centre = the 3-D point AT the 2-D centroid pixel when that pixel has
    valid depth, else the mean of accepted points (bug (c) fallback).
    `at`: the pixel lookup (an index's pixels_at on a tile)."""
    px = xy[..., 0].clamp(0, w - 1)
    py = xy[..., 1].clamp(0, h - 1)
    pt_at_centroid = at(points, px, py)
    centroid_valid = pt_at_centroid[..., 2] > VALID_DEPTH_MM
    mean_pts = sums_xyz / torch.clamp_min(npts, 1.0)[..., None]
    return torch.where(centroid_valid[..., None], pt_at_centroid, mean_pts)


def _nasp_analyze_post(sums, clusters: Clusters, points, h, w, at=_at_pixels) -> Clusters:
    """Post-processing of the analyze sums [B, K, 13]."""
    size = sums[..., 5]
    nz = size > 0
    safe = torch.clamp_min(size, 1.0)
    rgb = torch.clamp(torch.floor(sums[..., 0:3] / safe[..., None]), 0, 255)
    xy = torch.floor(sums[..., 3:5] / safe[..., None]).to(torch.int32)
    npts = sums[..., 12]
    has_pts = npts > 0

    center = _centroid_center(sums[..., 6:9], npts, xy, points, h, w, at)
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


def _update_nasp_analyze(idx, clusters, color_f, points, normals, params, window_range, h, w) -> Clusters:
    """NASP plain stats (analyzeClusters_NASP, NormalAdaptiveSuperpixel.cu:
    356-685) on any index: the capped iterations' _CellIndex (r = 5) or the
    _GlobalIndex (JAX slic.py:1159-1228)."""
    sums = _nasp_sums(idx, clusters, color_f, points, normals, window_range, params, "analyze")
    return _nasp_analyze_post(sums, clusters, points, h, w, idx.pixels_at)


def _update_nasp_weighted(idx, clusters, color_f, points, normals, params, window_range, h, w) -> Clusters:
    """NASP bilateral-weighted stats (calculateWeightedAverage,
    NormalAdaptiveSuperpixel.cu:687-1068), on the analyze-updated table.
    Colour/pixel sums are weighted by exp(-dc^2/2sc^2)*exp(-dpix^2/2ss^2);
    3-D/normal sums accept z > 50, a valid normal and dot(n, n_cluster) in
    (0.5, 1]."""
    sums = _nasp_sums(idx, clusters, color_f, points, normals, window_range, params, "weighted")
    return _nasp_weighted_post(sums, clusters, points, h, w, idx.pixels_at)


def _nasp_weighted_post(sums, clusters: Clusters, points, h, w, at=_at_pixels) -> Clusters:
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

    center = _centroid_center(sums[..., 6:9], npts, xy, points, h, w, at)
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
    points: Optional[torch.Tensor] = None,
    normals: Optional[torch.Tensor] = None,
    *,
    grid: GridParams = GridParams(),
    params: SLICParams,
    variant: str = "nasp",
    seeds: Optional[torch.Tensor] = None,
) -> SLICResult:
    """SLIC segmentation: seed + `params.iterations` x (assign, update).

    variant: "sp" (colour SLIC, SuperpixelSegmentation::Process; points and
    normals unused), "dasp" (DepthAdaptiveSuperpixel::Segmentation; normals
    unused), "nasp" (NormalAdaptiveSuperpixel::Segmentation).

    NASP's first iteration runs the fused cell route when the grid divides
    the frame (JAX slic.py:1377-1393); SP's and DASP's run the global
    route's sweep from the grid-init labels (the JAX cell_fast candidates,
    so the same labels), then update on the cell-local index; without a
    dividing grid every update takes the global index.  Each later
    iteration (JAX slic.py:1395-1488) assigns by the global route's sweep,
    which gives the JAX capped sweep's labels wherever that one applies, and
    updates on the capped route (cell-local sums at r = 5 for NASP, 3 for SP
    / DASP) while every label lies in its pixel's [-cap, cap-1]^2 cell
    neighbourhood, on the global index otherwise: the JAX lax.cond becomes
    labels_within_cap on the device and a host branch, or in a jit call a
    conditional node (with_label_index), for the whole batch (one frame off the cap sends the batch to the global
    route).  The two updates sum in another order, so a later sweep can move
    a pixel at a distance near-tie.  locality="cell" skips the check,
    "global" takes the global index.  A single-iteration call makes no host
    sync.

    color u8 [B, H, W, 3]; points f32 [B, H, W, 3] mm; normals f32
    [B, H, W, 3].  seeds: optional [K, 2] or [B, K, 2] (x, y) override of the
    sampled seeds — the gradient argmin has near-ties whose winner depends on
    float rounding, so tests inject the JAX package's seeds to compare
    everything downstream exactly; inside a jit call (core/jit.py) they
    must be a tensor on the frames' device."""
    seed_window, neighborhood, _ = _variant(variant)
    if params.locality not in ("auto", "cell", "global"):
        raise ValueError(f"locality must be 'auto', 'cell' or 'global', got {params.locality!r}")
    _check_stats_impl(params.stats_impl)
    b, h, w = color.shape[:3]
    k = grid.num_clusters
    s_scale, window_range = _update_geometry(grid, h, w, variant)
    color_f = color.to(torch.float32).contiguous()
    points = None if variant == "sp" else points.contiguous()
    normals = normals.contiguous() if variant == "nasp" else None
    frame = (color_f, points, normals)

    if seeds is None:
        seeds = _compute_seeds(color_f, normals, grid, h, w, seed_window)
    else:
        if jit.tracing() and not (isinstance(seeds, torch.Tensor)
                                  and seeds.device == color.device):
            raise TypeError("segment: inside a jit call the seeds must be a tensor on the "
                            f"frames' device ({color.device}); host data cannot be captured, "
                            "so pass a device tensor")
        seeds = torch.as_tensor(seeds, dtype=torch.int32, device=color.device)
        if seeds.dim() == 2:
            seeds = seeds.expand(b, -1, -1)
    clusters = init_clusters(seeds, color, points, normals)
    cell_ok = grid_divides(grid, h, w)
    if variant == "nasp" and cell_ok:
        # assignment + analyze sums in one call, weighted sums in a second
        labels, distance, clusters, idx = _nasp_fused_first_iteration(
            clusters, color_f, points, normals, grid, params, window_range, s_scale, h, w)
        clusters = _update_nasp_weighted(idx, clusters, *frame, params, window_range, h, w)
    else:
        labels = init_labels(grid, h, w, color.device).expand(b, h, w)
        distance = torch.full((b, h, w), INIT_DISTANCE, dtype=torch.float32, device=color.device)
        labels, distance = _assign_global(
            labels, distance, clusters, *frame, grid, params, s_scale, variant)
        # after the first sweep labels come from the cell's candidate set
        idx = (_CellIndex(labels, grid, neighborhood // 2, h, w) if cell_ok
               else _GlobalIndex(labels, k))
        clusters = _update(variant, idx, clusters, *frame, params, window_range, h, w)

    for _ in range(1, params.iterations):
        labels, distance, clusters = later_iteration(
            labels, distance, clusters, *frame, grid=grid, params=params, variant=variant)
    return SLICResult(labels=labels, distance=distance, clusters=clusters)


def _tile_clusters(color_f, points, normals, grid: GridParams, h: int, w: int,
                   tile: CellTile) -> Clusters:
    """The initial NASP cluster table [B, K, ...] on every rank of the tile
    group from the tile's frames (color_f, points, normals [B, H, ws, 3]):
    _compute_seeds' seeds on the whole frames and init_clusters' rows.
    Where each seed window's support lies in its cell (_subgrid_ok on a
    tile of whole cells) the gradient runs on the tile's own sub-grid
    blocks and the tile's rows are gathered in cell order; otherwise it
    runs on the tile with a GRAD_MARGIN-column halo (none past the frame:
    the gradient's edge clamp is then the frame's), each seed window's
    values are read from the tile that holds each pixel (clamped to the
    image, as sample_seeds reads them), the first minimum is taken on every
    rank, and the rows are read at the seeds."""
    window = _VARIANTS["nasp"][0]
    b, _, ws = color_f.shape[:3]
    k = grid.num_clusters
    planes = torch.cat([color_f, points, normals], dim=-1)  # rgb, centre, normal
    if tile.c0 is not None and _subgrid_ok(grid, h, w, window):
        grid_t = GridParams(rows=grid.rows, cols=tile.cols)  # the tile's cells
        csub = _subgrid_extract(color_f, grid_t, h, ws, window)
        nsub = _subgrid_extract(normals, grid_t, h, ws, window)
        seeds = _sample_seeds_subgrid(_gradient(csub, nsub, "tile"), grid_t, h, ws, window)
        shift = constant((tile.x0, 0), torch.int32, seeds.device)
        # one gather of the tile's rows: rgb, centre, normal, global (x, y)
        rows_t = torch.cat([_at_pixels(planes, seeds[..., 0], seeds[..., 1]),
                            (seeds + shift).to(torch.float32)], dim=-1)
        table = tile.gather_cells(rows_t.reshape(b, grid.rows, tile.cols, -1)).reshape(b, k, -1)
        seeds = table[..., 9:11].to(torch.int32)
    else:
        padded, left = tile.haloed(torch.cat([color_f, normals], dim=-1), GRAD_MARGIN)
        g = _gradient(padded[..., :3], padded[..., 3:], "halo")[:, :, left:left + ws]
        yy, xx = _seed_windows(grid, h, w, window, color_f.device)
        vals = tile.pixels_at(g, xx.expand(b, -1), yy.expand(b, -1))
        seeds = _window_argmin(vals, yy, xx, k)
        table = tile.pixels_at(planes, seeds[..., 0], seeds[..., 1])
    zeros = torch.zeros((b, k), dtype=torch.float32, device=color_f.device)
    return Clusters(
        rgb=table[..., 0:3].contiguous(), xy=seeds, size=zeros.to(torch.int32),
        center=table[..., 3:6].contiguous(), normal=table[..., 6:9].contiguous(),
        variance=zeros,
    )


def segment_tile(
    color: torch.Tensor,
    points: torch.Tensor,
    normals: torch.Tensor,
    *,
    grid: GridParams,
    params: SLICParams,
    tile: CellTile,
) -> SLICResult:
    """NASP on a width tile: segment's NASP route on the tile's frames color
    u8 [B, H, ws, 3], points and normals f32 [B, H, ws, 3] (columns
    [tile.x0, tile.x0 + ws) of a frame tile.width wide), every rank of the
    tile group calling it.  The initial table from the tile's seeds
    (_tile_clusters), replicated; over a grid that divides the frame (the
    tile then holds whole cells) the fused first iteration and the weighted
    update on the tile's cells, over one that does not the global sweep from
    the grid-init labels at the tile's global columns and the update on the
    global index's tile form; each later iteration as later_iteration with
    the tile.  Returns the tile's labels and distance and the global cluster
    table, each bitwise the matching part of segment's result on the whole
    frames."""
    if params.locality not in ("auto", "cell", "global"):
        raise ValueError(f"locality must be 'auto', 'cell' or 'global', got {params.locality!r}")
    b, h, ws = color.shape[:3]
    w = tile.width
    cell_ok = grid_divides(grid, h, w)
    if ws != tile.ws or (cell_ok and (tile.c0 is None or ws != tile.cols * (w // grid.cols))):
        raise ValueError(f"a {ws}-px tile is not the tile {tile.ws} wide at {tile.x0} "
                         f"(of whole cells of grid {grid.rows}x{grid.cols} on {h}x{w})")
    _check_stats_impl(params.stats_impl)
    s_scale, window_range = _update_geometry(grid, h, w, "nasp")
    color_f = color.to(torch.float32).contiguous()
    frame = (color_f, points.contiguous(), normals.contiguous())
    clusters = _tile_clusters(*frame, grid, h, w, tile)
    if cell_ok:
        labels, distance, clusters, idx = _nasp_fused_first_iteration(
            clusters, *frame, grid, params, window_range, s_scale, h, w, tile=tile)
        clusters = _update_nasp_weighted(idx, clusters, *frame, params, window_range, h, w)
    else:
        labels = init_labels(grid, h, w, color.device)[:, tile.x0:tile.x0 + ws].expand(b, h, ws)
        distance = torch.full((b, h, ws), INIT_DISTANCE, dtype=torch.float32, device=color.device)
        labels, distance = _assign_global(
            labels, distance, clusters, *frame, grid, params, s_scale, x0=tile.x0)
        idx = _GlobalIndex(labels, grid.num_clusters, tile=tile)
        clusters = _update("nasp", idx, clusters, *frame, params, window_range, h, w)
    for _ in range(1, params.iterations):
        labels, distance, clusters = later_iteration(
            labels, distance, clusters, *frame, grid=grid, params=params, tile=tile)
    return SLICResult(labels=labels, distance=distance, clusters=clusters)


def later_iteration(
    labels, distance, clusters, color_f, points, normals, *, grid: GridParams,
    params: SLICParams, variant: str = "nasp", tile: Optional[CellTile] = None,
):
    """One later iteration (assign, update) of a variant from the state
    (labels, distance, clusters): the global route's sweep, then the update
    on with_label_index's index (see segment).  color_f f32 [B, H, W, 3].  With
    a tile (NASP only) the frames are the tile's, the sweep reads global
    columns and the index is the tile group's (label_index)."""
    b, h, w = labels.shape
    x0 = 0
    if tile is not None:
        if variant != "nasp":
            raise ValueError(f"a width tile runs NASP's later iterations, not {variant!r}'s")
        w, x0 = tile.width, tile.x0
    s_scale, window_range = _update_geometry(grid, h, w, variant)
    frame = (color_f, points, normals)
    labels, distance = _assign_global(
        labels, distance, clusters, *frame, grid, params, s_scale, variant, x0=x0)
    clusters = with_label_index(
        lambda idx: _update(variant, idx, clusters, *frame, params, window_range, h, w),
        labels, grid, params, variant, tile=tile)
    return labels, distance, clusters
