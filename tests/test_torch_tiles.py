"""PyTorch port: the pieces of the tiled KDE route (parallel/sharding.py,
spatial_route "tiled") in one process, without a process group; the
multi-rank route itself is held in tests/test_torch_parallel.py.

Bars, each bitwise, on make_noisy_scene(96, 128, seed=0, 1) with grid 3x4
(32-px cells): the plain versions of the four NASP cell functions at a
width tile's cells (c0 > 0, and the first tile) equal the matching cell
columns of the full-frame call (labels, distance, gathers and the per-cell
partials); the CM normals from a tile padded as exchange_width pads it
(stencil_shard.haloed_normals: 27 columns, none kept at the global edges)
equal the tile's columns of generate_normal_map, at x = 2 and 4 and on
every tile, and so do the bilateral normals (a 1-column halo) and the
SDC normals (27 columns, the summed-area tables from the whole frame's
depth); so does the depth bilateral from a 3-column halo, and the plane
hole fill from a 4-column halo of (labels, planes, trust, holes), holes
filled across the tile edges; the cap check on a tile's labels (global
columns) equals the frame's verdict over the tile's pixels, and the
global sweep on a tile the frame's columns; the global index's tile form
at world 1 equals the untiled index; the label halo is -1 past the
frame; the tile geometry (cell-aligned tiles where a data tile splits a
cell) and spatial_route's choice for every config; the seed gradient of
5-column haloed tiles and the seeds read from them (grid 5x6, which does
not divide the frame) equal the whole frame's; the plain cell functions
at the uneven cell-aligned tiles of grid 4x5 on 96x160 frames equal the
full frame's cells; and the whole tiled stage list at world 1 (a
WidthTile of every cell) equals kde_pipeline.  The card runs the kernels at the same tiles
(tests/test_torch_cuda.py); tests/test_torch_tiled_configs.py runs the
other configs' tiled steps on gloo ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models.pipelines import _kde_from_jbf, kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, cuda_nasp, normals, plane, slic
from kinectdepthmapenhancement_tpu_torch.parallel import halo, sharding, stencil_shard
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
CELL_W = W // GRID.cols
# (c0, tile cols): x = 2's second tile, x = 4's second and last, x = 2's first
TILES = [(2, 2), (1, 1), (3, 1), (0, 2)]
TILE_IDS = ["x2s1", "x4s1", "x4s3", "x2s0"]


def _mesh(x, s):
    """This process's 1 x 1 mesh posing as rank s of x width tiles (no
    collective is made)."""
    return dataclasses.replace(make_mesh(device="cpu"), x=x, s=s)


def _halo(full, s, ws, r, fill=0):
    """What exchange_width returns on tile s of `full` [B, H, W, ...]: the
    tile with r neighbour columns each side, `fill` past the frame."""
    tail = (0, 0) * (full.dim() - 3)
    padded = F.pad(full, tail + (r, r), value=fill)
    return padded[:, :, s * ws:s * ws + ws + 2 * r]


@pytest.fixture(scope="module")
def frames():
    """The first NASP iteration's inputs and its plain full-frame results."""
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 1)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes]))
    depth = torch.from_numpy(np.stack([s[1] for s in scenes]))
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    points = projective_to_real(bilateral.joint_bilateral_filter(depth, color, cfg.jbf), intr)
    nmap = normals.generate_normal_map(points, cfg.normals)
    cf = color.float()
    seeds = slic._compute_seeds(cf, nmap, GRID, H, W, 8)
    cl = slic.init_clusters(seeds, color, points, nmap)
    s_scale, (lo, hi) = slic._update_geometry(GRID, H, W, "nasp")
    cand, akw = slic._assign_args(cl, GRID, cfg.nasp, s_scale)
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze_plain(
        cf, points, nmap, cand, lo=lo, hi=hi, **akw)
    return dict(intr=intr, color=color, depth=depth, cfg=cfg, points=points, nmap=nmap,
                cf=cf, cand=cand, akw=akw, lo=lo, hi=hi, labels=labels, dist=dist, part=part)


def _cols(t, c0, tc):
    """Pixel columns of cells [c0, c0 + tc) of [B, H, W, ...]."""
    return t[:, :, c0 * CELL_W:(c0 + tc) * CELL_W]


def _cell_part(part, c0, tc, n):
    """Cells [c0, c0 + tc) of per-cell partials [B, rows*cols*n, F]."""
    b, _, f = part.shape
    return part.reshape(b, GRID.rows, GRID.cols, n, f)[:, :, c0:c0 + tc].reshape(b, -1, f)


@pytest.mark.parametrize("c0, tc", TILES, ids=TILE_IDS)
def test_assign_and_analyze_plain_on_a_tile(frames, c0, tc):
    """nasp_assign_and_analyze_plain on a tile: the labels and distances of
    the full-frame call's columns, its cells' analyze partials."""
    x = frames
    t = lambda a: _cols(a, c0, tc).contiguous()  # noqa: E731
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze_plain(
        t(x["cf"]), t(x["points"]), t(x["nmap"]), x["cand"], lo=x["lo"], hi=x["hi"], c0=c0,
        tile_cols=tc, **x["akw"])
    assert torch.equal(labels, _cols(x["labels"], c0, tc))
    assert torch.equal(dist, _cols(x["dist"], c0, tc))
    assert torch.equal(part, _cell_part(x["part"], c0, tc, 64))


@pytest.mark.parametrize("mode", ["analyze", "weighted"])
@pytest.mark.parametrize("c0, tc", TILES[:2], ids=TILE_IDS[:2])
def test_nasp_cell_sums_plain_on_a_tile(frames, c0, tc, mode):
    """nasp_cell_sums_plain on a tile (global fields, the tile's pixels at
    global u) equals the full-frame call's cells."""
    x = frames
    b = x["cf"].shape[0]
    fields = torch.cat([x["cand"][..., 3:5], x["cand"][..., 0:3], x["cand"][..., 6:9]], -1)
    fields = (fields[..., :2] if mode == "analyze" else fields).contiguous()
    kw = dict(rows=GRID.rows, cols=GRID.cols, r=4, lo=x["lo"], hi=x["hi"], mode=mode,
              color_sigma=10.0, spatial_sigma=50.0)
    full = cuda_nasp.nasp_cell_sums_plain(x["labels"], x["cf"], x["points"], x["nmap"], fields,
                                          **kw)
    tile = [_cols(a, c0, tc).contiguous() for a in (x["labels"], x["cf"], x["points"],
                                                    x["nmap"])]
    got = cuda_nasp.nasp_cell_sums_plain(*tile, fields, c0=c0, tile_cols=tc, **kw)
    assert got.shape == (b, GRID.rows * tc * 64, 13 if mode == "analyze" else 14)
    assert torch.equal(got, _cell_part(full, c0, tc, 64))


@pytest.mark.parametrize("c0, tc", TILES[:2], ids=TILE_IDS[:2])
def test_label_cell_sums_and_gather_plain_on_a_tile(frames, c0, tc):
    """label_cell_sums_plain (F = 2, the plane residual's features) and
    label_cell_gather_plain (F = 6, 1, 3) on a tile equal the full-frame
    calls' cells and columns."""
    x = frames
    labels = x["labels"]
    z = x["points"][..., 2]
    ok = ((z > 50.0) & (labels >= 0)).float()
    feats = torch.stack([(z * 1e-3) ** 2 * ok, ok], -1)
    kw = dict(rows=GRID.rows, cols=GRID.cols, r=4)
    full = cuda_nasp.label_cell_sums_plain(labels, feats, **kw)
    got = cuda_nasp.label_cell_sums_plain(_cols(labels, c0, tc).contiguous(),
                                          _cols(feats, c0, tc).contiguous(), c0=c0,
                                          tile_cols=tc, **kw)
    assert torch.equal(got, _cell_part(full, c0, tc, 64))
    table6 = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, GRID.num_clusters, 6)).astype(np.float32))
    for table in (table6, table6[..., 2:3], table6[..., :3]):
        full = cuda_nasp.label_cell_gather_plain(labels, table, **kw)
        got = cuda_nasp.label_cell_gather_plain(_cols(labels, c0, tc).contiguous(), table,
                                                c0=c0, tile_cols=tc, **kw)
        assert torch.equal(got, _cols(full, c0, tc))


def test_cell_functions_refuse_a_tile_outside_the_grid(frames):
    """A tile's cell columns must lie in the grid, and the tile's image must
    hold them whole."""
    x = frames
    with pytest.raises(ValueError, match="not a tile"):
        cuda_nasp.label_cell_gather_plain(x["labels"], x["cand"][..., :1].reshape(2, 12, 1),
                                          rows=3, cols=4, r=4, c0=3, tile_cols=2)
    with pytest.raises(ValueError, match="does not divide"):
        cuda_nasp.label_cell_sums_plain(x["labels"][:, :, :41].contiguous(),
                                        torch.zeros(2, H, 41, 1), rows=3, cols=4, r=4,
                                        c0=1, tile_cols=2)


@pytest.mark.parametrize("x", [2, 4])
def test_normals_from_haloed_tiles(frames, x):
    """stencil_shard.haloed_normals on every tile, padded as exchange_width
    pads it (normals_halo = 27 columns, zeros past the frame): the tile's
    columns of generate_normal_map on the whole frames."""
    p = frames["cfg"].normals
    r = stencil_shard.normals_halo(p)
    assert r == p.dt_iterations + 1 == 27
    ws = W // x
    want = frames["nmap"]
    for s in range(x):
        got = stencil_shard.haloed_normals(_halo(frames["points"], s, ws, r), _mesh(x, s), p,
                                           s * ws, W)
        assert torch.equal(got, want[:, :, s * ws:(s + 1) * ws]), s


def test_depth_bilateral_from_haloed_tiles(frames):
    """stencil_shard.haloed_depth_bilateral from a 3-column halo (zeros past
    the frame) on each of 4 tiles: the tile's columns of depth_bilateral."""
    x = frames
    rays = x["points"][0] / x["points"][0][..., 2:3].clamp_min(1.0)
    opt = x["points"]
    p = x["cfg"].projection
    want = plane.depth_bilateral(opt, rays, p)
    ws = W // 4
    for s in range(4):
        zpad = _halo(opt[..., 2], s, ws, p.window // 2)
        got = stencil_shard.haloed_depth_bilateral(zpad, rays[:, s * ws:(s + 1) * ws], p)
        assert torch.equal(got, want[:, :, s * ws:(s + 1) * ws]), s


def test_label_halo_and_global_edges():
    """exchange_width's fill: the label halo is -1 past the frame (at world
    1, both edges); drop_global_edges keeps only interior halos and says
    how many columns it kept on the left."""
    mesh = make_mesh(device="cpu")
    labels = torch.arange(2 * 3 * 5, dtype=torch.int32).reshape(2, 3, 5)
    got = halo.exchange_width(labels, 1, mesh, fill=-1)
    assert torch.equal(got, F.pad(labels, (1, 1), value=-1))
    tile = sharding.WidthTile(mesh, GridParams(rows=3, cols=5), 3, 5)
    assert torch.equal(tile.right_labels(labels), torch.full((2, 3, 1), -1, dtype=torch.int32))
    padded = torch.arange(10)[None, None].expand(1, 1, 10)  # radius 2 each side of 6
    for s, want_left, cols in ((0, 0, (2, 10)), (1, 2, (0, 10)), (3, 2, (0, 8))):
        kept, left = halo.drop_global_edges(padded, 2, _mesh(4, s))
        assert left == want_left and torch.equal(kept, padded[:, :, cols[0]:cols[1]]), s


def test_tile_cells_geometry():
    """Mesh.cell_tiles: (x0, c0, tile cols) of each rank's
    cell-aligned tile, the cells whose first column lies in its data tile:
    whole-cell data tiles unchanged; x = 8 at 640 (80-px data tiles of
    32-px cells) gives tiles of 3 and 2 cells, every rank at least one, x0
    and c0 in order and the tiles covering the frame; sharding.tile_spans
    gives every rank's (x0, width) of the cell-aligned tiles where the grid
    divides the frame, else of the data tiles (Mesh.tile_spans).  A grid that does not divide
    the frame, or a data tile narrower than a cell, raises."""
    assert _mesh(2, 1).cell_tiles(640, 20)[1] == (320, 10, 10)
    assert _mesh(4, 3).cell_tiles(640, 20)[3] == (480, 15, 5)
    assert _mesh(4, 1).cell_tiles(128, 4)[1] == (32, 1, 1)
    tiles = _mesh(8, 0).cell_tiles(640, 20)
    assert [cols for _, _, cols in tiles] == [3, 2] * 4
    assert all(_mesh(8, s).cell_tiles(640, 20) == tiles for s in range(8))
    for cols, (x0, c0, tc) in zip((160, 96, 120), (_mesh(x, 0).cell_tiles(160, 5)[1]
                                                    for x in (2, 4, 5))):
        assert x0 == c0 * 32 and tc >= 1, (cols, x0, c0, tc)
    for x, w, cols in ((8, 640, 20), (4, 640, 10), (2, 160, 5), (4, 160, 5), (4, 120, 5)):
        tiles = _mesh(x, 0).cell_tiles(w, cols)
        cell = w // cols
        assert tiles[0][:2] == (0, 0) and all(t[2] >= 1 for t in tiles), (x, w)
        for (x0, c0, tc), (x1, c1, _) in zip(tiles, tiles[1:]):
            assert x1 == x0 + tc * cell and c1 == c0 + tc, (x, w)
        assert sum(t[2] for t in tiles) == cols
        spans, tile_cols = sharding.tile_spans(_mesh(x, 0), GridParams(rows=4, cols=cols), 96, w)
        assert spans == tuple((x0, tc * cell) for x0, _, tc in tiles)
        assert tile_cols == tuple(tc for _, _, tc in tiles)
    assert sharding.tile_spans(_mesh(4, 0), GridParams(rows=15, cols=10), 480, 640) == (
        ((0, 192), (192, 128), (320, 192), (512, 128)), (3, 2, 3, 2))
    assert sharding.tile_spans(_mesh(4, 0), GridParams(rows=4, cols=5), 96, 160)[0] == (
        (0, 64), (64, 32), (96, 32), (128, 32))
    crop = ((0, 157), (157, 157), (314, 157), (471, 157))
    assert _mesh(4, 0).tile_spans(628) == crop
    assert sharding.tile_spans(_mesh(4, 0), KDEConfig().grid, 480, 628) == (crop, None)
    with pytest.raises(ValueError, match="whole cells"):
        _mesh(4, 0).cell_tiles(628, 20)
    with pytest.raises(ValueError, match="whole cells"):
        _mesh(8, 0).cell_tiles(128, 4)  # 16-px data tiles of 32-px cells


def _tiled_configs(cfg):
    """The configs beyond the default that the tiled route takes: the
    bilateral and SDC normals, plane merge with the hole fill, three NASP
    iterations (capped and global), and all of them at once."""
    def normals(method):
        return dataclasses.replace(cfg.normals, method=method)

    iter3 = dataclasses.replace(cfg, nasp=dataclasses.replace(cfg.nasp, iterations=3))
    glob = dataclasses.replace(iter3, nasp=dataclasses.replace(iter3.nasp, locality="global"))
    return [dataclasses.replace(cfg, normals=normals("bilateral")),
            dataclasses.replace(cfg, normals=normals("sdc")),
            dataclasses.replace(cfg, plane_merge=True, fill_holes=4), iter3, glob,
            dataclasses.replace(glob, normals=normals("sdc"), plane_merge=True, fill_holes=4)]


def test_spatial_route():
    """"tiled" for every KDEConfig whose tiles are at least as wide as their
    halos and a data tile at least one cell wide: tiles of whole cells (the
    default and the six configs of tests/test_torch_tiled_configs.py:
    640x480 at x = 2 and 4, the 96x128 test frames with grid 3x4 at x = 2
    and 4); grids that do not divide the frame (5x6 at 96x128 at x = 2 and
    4, a 126-column frame at x = 2, the 628 crop at x = 4, Kinect v2's
    424x512 at x = 2 and 4); data tiles that split a cell (x = 8 and 16 at
    640, grid 15x10 at x = 4, grid 4x5 on 96x160 at x = 2 and 4).  "replicated"
    for a tile narrower than a halo (a hole fill wider than a tile; the
    24-px cell-aligned tiles of grid 4x5 on 96x120 at x = 4, narrower than
    the normals' 27 columns), a data tile narrower than a cell, and at
    x = 1."""
    cfg = KDEConfig()
    route = sharding.spatial_route
    small = dataclasses.replace(cfg, grid=GRID)
    for c in [cfg] + _tiled_configs(cfg):
        for x in (2, 4):
            assert route(_mesh(x, 0), c, 480, 640) == "tiled", (x, c)
    for c in [small] + _tiled_configs(small):
        for x in (2, 4):
            assert route(_mesh(x, x - 1), c, H, W) == "tiled", (x, c)
    for c in _tiled_configs(dataclasses.replace(cfg, grid=GridParams(rows=5, cols=6))):
        for x in (2, 4):
            assert route(_mesh(x, 0), c, H, W) == "tiled", (x, c)
    grid45 = dataclasses.replace(cfg, grid=GridParams(rows=4, cols=5))
    grid1510 = dataclasses.replace(cfg, grid=GridParams(rows=15, cols=10))
    for x, c, h, w in ((2, small, H, 126), (4, cfg, 480, 628), (2, cfg, 424, 512),
                       (4, cfg, 424, 512), (8, cfg, 480, 640), (16, cfg, 480, 640),
                       (4, grid1510, 480, 640), (2, grid45, 96, 160), (4, grid45, 96, 160)):
        assert route(_mesh(x, 0), c, h, w) == "tiled", (x, h, w)
    assert route(_mesh(1, 0), cfg, 480, 640) == "replicated"
    assert route(_mesh(4, 0), grid45, 96, 120) == "replicated"  # 24-px cell-aligned tiles
    assert route(_mesh(8, 0), small, H, W) == "replicated"  # 16-px data tiles, 32-px cells
    assert route(_mesh(32, 0), cfg, 480, 640) == "replicated"  # 20-px data tiles
    assert route(_mesh(4, 0), dataclasses.replace(small, fill_holes=40), H, W) == "replicated"
    with pytest.raises(ValueError, match="route"):
        sharding.spatial_kde(None, None, _mesh(2, 0), None, cfg, route="halo")


@pytest.mark.parametrize("x", [2, 4])
def test_seeds_from_haloed_tiles(frames, x):
    """Grid 5x6 (it does not divide 96x128): the seed gradient of each tile
    from its colour and normals padded with GRAD_MARGIN = 5 columns as
    exchange_width pads them, the halos at the frame's edges dropped
    (CellTile.haloed), cropped to the tile, equals the tile's columns of
    the whole frame's gradient; and the seed windows read from those tiles
    (slic._window_argmin) give _compute_seeds' seeds."""
    grid = GridParams(rows=5, cols=6)
    cf, nmap = frames["cf"], frames["nmap"]
    ws = W // x
    tiles = []
    for s in range(x):
        padded, left = halo.drop_global_edges(
            _halo(torch.cat([cf, nmap], -1), s, ws, slic.GRAD_MARGIN), slic.GRAD_MARGIN,
            _mesh(x, s))
        tiles.append(slic._gradient(padded[..., :3], padded[..., 3:])[:, :, left:left + ws])
    g = torch.cat(tiles, dim=2)
    assert torch.equal(g, slic._gradient(cf, nmap))
    yy, xx = slic._seed_windows(grid, H, W, 8, cf.device)
    assert torch.equal(slic._window_argmin(g[:, yy, xx], yy, xx, grid.num_clusters),
                       slic._compute_seeds(cf, nmap, grid, H, W, 8))


SPLIT_W = 160  # grid 4x5 on 96x160: 24x32-px cells
SPLIT_GRID = GridParams(rows=4, cols=5)
# the cell-aligned tiles (c0, tile cols) of x = 2 and x = 4
SPLIT_TILES = [(0, 3), (3, 2), (0, 2), (2, 1), (3, 1), (4, 1)]
SPLIT_IDS = ["x2s0", "x2s1", "x4s0", "x4s1", "x4s2", "x4s3"]


@pytest.fixture(scope="module")
def split_frames():
    """frames()' first NASP iteration on make_noisy_scene(96, 160, seed=0,
    1) over grid 4x5, and the full frame's weighted sums."""
    intr = default_kinect_intrinsics(SPLIT_W, H)
    scenes = [make_noisy_scene(H, SPLIT_W, intr, seed=s) for s in (0, 1)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes]))
    depth = torch.from_numpy(np.stack([s[1] for s in scenes]))
    cfg = dataclasses.replace(KDEConfig(), grid=SPLIT_GRID)
    points = projective_to_real(bilateral.joint_bilateral_filter(depth, color, cfg.jbf), intr)
    nmap = normals.generate_normal_map(points, cfg.normals)
    cf = color.float()
    cl = slic.init_clusters(slic._compute_seeds(cf, nmap, SPLIT_GRID, H, SPLIT_W, 8), color,
                            points, nmap)
    s_scale, (lo, hi) = slic._update_geometry(SPLIT_GRID, H, SPLIT_W, "nasp")
    cand, akw = slic._assign_args(cl, SPLIT_GRID, cfg.nasp, s_scale)
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze_plain(
        cf, points, nmap, cand, lo=lo, hi=hi, **akw)
    fields = torch.cat([cand[..., 3:5], cand[..., 0:3], cand[..., 6:9]], -1).contiguous()
    kw = dict(rows=4, cols=5, r=4, lo=lo, hi=hi, mode="weighted", color_sigma=10.0,
              spatial_sigma=50.0)
    weighted = cuda_nasp.nasp_cell_sums_plain(labels, cf, points, nmap, fields, **kw)
    return dict(cf=cf, points=points, nmap=nmap, cand=cand, akw=akw, lo=lo, hi=hi,
                labels=labels, dist=dist, part=part, fields=fields, kw=kw, weighted=weighted)


@pytest.mark.parametrize("c0, tc", SPLIT_TILES, ids=SPLIT_IDS)
def test_cell_plain_functions_at_uneven_tiles(split_frames, c0, tc):
    """The four cell functions' plain versions on the cell-aligned tiles of
    grid 4x5 on 96x160 at x = 2 and 4 (3 / 2 and 2 / 1 / 1 / 1 cells): the
    fused assignment's labels, distance and partials, the weighted sums,
    the label sums (F = 2) and the gathers (F = 6, 1, 3) equal the full
    frame's cells and columns."""
    x = split_frames
    cols = slice(c0 * 32, (c0 + tc) * 32)
    t = [a[:, :, cols].contiguous() for a in (x["cf"], x["points"], x["nmap"])]
    tile = dict(c0=c0, tile_cols=tc)
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze_plain(
        *t, x["cand"], lo=x["lo"], hi=x["hi"], **x["akw"], **tile)

    def cells(p, n=64):
        b, _, f = p.shape
        return p.reshape(b, 4, 5, n, f)[:, :, c0:c0 + tc].reshape(b, -1, f)

    assert torch.equal(labels, x["labels"][:, :, cols])
    assert torch.equal(dist, x["dist"][:, :, cols])
    assert torch.equal(part, cells(x["part"]))
    got = cuda_nasp.nasp_cell_sums_plain(labels, *t, x["fields"], **x["kw"], **tile)
    assert torch.equal(got, cells(x["weighted"]))
    z = x["points"][..., 2]
    ok = ((z > 50.0) & (x["labels"] >= 0)).float()
    feats = torch.stack([(z * 1e-3) ** 2 * ok, ok], -1)
    kw = dict(rows=4, cols=5, r=4)
    full = cuda_nasp.label_cell_sums_plain(x["labels"], feats, **kw)
    got = cuda_nasp.label_cell_sums_plain(labels, feats[:, :, cols].contiguous(), **kw, **tile)
    assert torch.equal(got, cells(full))
    table6 = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 20, 6)).astype(np.float32))
    for table in (table6, table6[..., 2:3], table6[..., :3]):
        full = cuda_nasp.label_cell_gather_plain(x["labels"], table, **kw)
        got = cuda_nasp.label_cell_gather_plain(labels, table, **kw, **tile)
        assert torch.equal(got, full[:, :, cols])


@pytest.mark.parametrize("x", [2, 4])
@pytest.mark.parametrize("method", ["bilateral", "sdc"])
def test_bilateral_and_sdc_normals_from_haloed_tiles(frames, method, x):
    """stencil_shard.haloed_normals under the bilateral (a 1-column halo)
    and SDC normals (27 columns; the summed-area tables from the whole
    frame's depth, as normals_sharded gathers it) on every tile: the
    tile's columns of generate_normal_map on the whole frames."""
    p = dataclasses.replace(frames["cfg"].normals, method=method)
    r = stencil_shard.normals_halo(p)
    assert r == (1 if method == "bilateral" else 27)
    points = frames["points"]
    want = normals.generate_normal_map(points, p)
    frame_z = points[..., 2].contiguous() if method == "sdc" else None
    ws = W // x
    for s in range(x):
        got = stencil_shard.haloed_normals(_halo(points, s, ws, r), _mesh(x, s), p, s * ws, W,
                                           frame_z=frame_z)
        assert torch.equal(got, want[:, :, s * ws:(s + 1) * ws]), s
    with pytest.raises(ValueError, match="frame's z"):
        normals.sdc_normals(points[:, :, :ws] * 1e-3, torch.full((2, H, ws), 5.0), 20, x0=ws,
                            width=W)


def _fill_inputs():
    """Inputs of plane.plane_hole_fill on 2 frames: 16x16 blocks of labels
    with per-label planes, trusted on 3 of 4 labels, and rectangular holes
    (label -1) across the tile edges at 32, 64 and 96 columns."""
    rng = np.random.default_rng(4)
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    labels = ((yy // 16) * (W // 16) + xx // 16).to(torch.int32).expand(2, H, W).clone()
    k = int(labels.max()) + 1
    planes = torch.from_numpy(rng.normal(size=(2, k, 4)).astype(np.float32))
    planes[..., 2] = planes[..., 2].abs() + 1.0
    planes[..., 3] = planes[..., 3].abs() * 1000.0 + 500.0
    nd_map = torch.gather(planes, 1, labels.reshape(2, -1, 1).long().expand(-1, -1, 4)).reshape(
        2, H, W, 4)
    trust = (labels % 4) != 3
    invalid = torch.zeros(2, H, W, dtype=torch.bool)
    for edge in (32, 64, 96):
        invalid[:, 4:10, edge - 3:edge + 3] = True
    for _ in range(12):
        y0, x0 = int(rng.integers(0, H - 8)), int(rng.integers(20, W - 24))
        invalid[:, y0:y0 + int(rng.integers(2, 9)), x0:x0 + int(rng.integers(2, 14))] = True
    labels = torch.where(invalid, -1, labels)
    rays = torch.from_numpy(rng.uniform(-0.5, 0.5, (H, W, 3)).astype(np.float32))
    rays[..., 2] = 1.0
    optimized = torch.from_numpy(rng.uniform(500.0, 4000.0, (2, H, W, 3)).astype(np.float32))
    optimized = torch.where(invalid[..., None], 0.0, optimized)
    return optimized, rays, labels, nd_map, trust, invalid


@pytest.mark.parametrize("x", [2, 4])
def test_plane_hole_fill_from_haloed_tiles(x):
    """stencil_shard.haloed_plane_hole_fill on every tile, its (labels + 1,
    planes, trust, invalid) padded with 4 columns as exchange_width pads
    them (zeros past the frame): the tile's columns of plane_hole_fill on
    the whole frames, holes filled within 4 columns of a tile edge among
    them."""
    steps = 4
    optimized, rays, labels, nd_map, trust, invalid = _fill_inputs()
    want = plane.plane_hole_fill(optimized, rays, labels, nd_map, trust, invalid, steps)
    filled = (want != optimized).any(-1)
    packed = torch.cat([(labels + 1).float()[..., None], nd_map, trust.float()[..., None],
                        invalid.float()[..., None]], -1)
    ws = W // x
    for s in range(x):
        cols = slice(s * ws, (s + 1) * ws)
        got = stencil_shard.haloed_plane_hole_fill(
            _halo(packed, s, ws, steps), optimized[:, :, cols], rays[:, cols], steps)
        assert torch.equal(got, want[:, :, cols]), s
        if s:
            assert int(filled[:, :, s * ws - steps:s * ws + steps].sum()) > 0, s


@pytest.mark.parametrize("c0, tc", TILES, ids=TILE_IDS)
def test_cap_check_and_global_sweep_on_a_tile(frames, c0, tc):
    """labels_within_cap on a tile's labels (global columns) equals the
    verdict of the whole frame with every label off the tile dropped, at
    caps 1, 2 and 5 (the frame's verdict is every tile's); _assign_global
    from the first iteration's state on the tile's pixels (x0) equals the
    frame's sweep's columns."""
    x = frames
    labels = x["labels"]
    cols = slice(c0 * CELL_W, (c0 + tc) * CELL_W)
    off_tile = torch.ones(W, dtype=torch.bool)
    off_tile[cols] = False
    for cap in (1, 2, 5):
        got = slic.labels_within_cap(labels[:, :, cols], GRID, cap, H, W, x0=c0 * CELL_W)
        want = slic.labels_within_cap(torch.where(off_tile, -1, labels), GRID, cap, H, W)
        assert torch.equal(got, want), cap
    assert not bool(slic.labels_within_cap(labels, GRID, 1, H, W).all())
    cl = slic.init_clusters(slic._compute_seeds(x["cf"], x["nmap"], GRID, H, W, 8), x["color"],
                            x["points"], x["nmap"])
    s_scale, _ = slic._update_geometry(GRID, H, W, "nasp")
    params = x["cfg"].nasp
    planes = (x["cf"], x["points"], x["nmap"])
    full = slic._assign_global(labels, x["dist"], cl, *planes, GRID, params, s_scale)
    tile = slic._assign_global(labels[:, :, cols], x["dist"][:, :, cols], cl,
                               *(t[:, :, cols] for t in planes), GRID, params, s_scale,
                               x0=c0 * CELL_W)
    for g, w in zip(tile, full):
        assert torch.equal(g, w[:, :, cols])


def test_global_index_tile_form_at_world_one(frames):
    """_GlobalIndex with a WidthTile of the whole frame (world 1: the width
    gather and the count sum pass through) equals the untiled index: its
    gather, pixel lookup, segment sum, counts and pair counts."""
    x = frames
    labels = x["labels"]
    k = GRID.num_clusters
    tiled = slic._GlobalIndex(labels, k, tile=sharding.WidthTile(make_mesh(device="cpu"), GRID,
                                                                  H, W))
    plain = slic._GlobalIndex(labels, k)
    table = torch.from_numpy(np.random.default_rng(5).normal(size=(2, k, 3)).astype(np.float32))
    xs = torch.tensor([[0, 40, 127], [5, 64, 100]])
    ys = torch.tensor([[0, 50, 95], [7, 33, 80]])
    mask = x["points"][..., 2] > 50.0
    right = torch.cat([labels[:, :, 1:], torch.full((2, H, 1), -1, dtype=labels.dtype)], 2)
    for a, b in ((tiled.gather(table), plain.gather(table)),
                 (tiled.pixels_at(x["points"], xs, ys), plain.pixels_at(x["points"], xs, ys)),
                 (tiled.segment_sum(x["points"], mask), plain.segment_sum(x["points"], mask)),
                 (tiled.counts(), plain.counts()),
                 (tiled.pair_counts(right), plain.pair_counts(right))):
        assert torch.equal(a, b)


def test_tiled_stages_at_world_one(frames):
    """_kde_from_jbf with a WidthTile of every cell (world 1: the gathers
    and lookups pass through) equals kde_pipeline field by field."""
    x = frames
    mesh = make_mesh(device="cpu")
    d, c = x["depth"][:1], x["color"][:1]
    want = kde_pipeline(d, c, x["intr"], x["cfg"])
    jbf = bilateral.joint_bilateral_filter(d, c, x["cfg"].jbf)
    got = _kde_from_jbf(jbf, c, x["intr"], x["cfg"],
                        tile=sharding.WidthTile(mesh, GRID, H, W))
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
