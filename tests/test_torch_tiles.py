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
every tile; so does the depth bilateral from a 3-column halo; the label
halo is -1 past the frame; the tile geometry and spatial_route's choice;
and the whole tiled stage list at world 1 (a WidthTile of every cell)
equals kde_pipeline.  The card runs the kernels at the same tiles
(tests/test_torch_cuda.py).
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
        got = stencil_shard.haloed_normals(_halo(frames["points"], s, ws, r), _mesh(x, s), p)
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
    tile = sharding.WidthTile(mesh, GridParams(rows=3, cols=5), 5)
    assert torch.equal(tile.right_labels(labels), torch.full((2, 3, 1), -1, dtype=torch.int32))
    padded = torch.arange(10)[None, None].expand(1, 1, 10)  # radius 2 each side of 6
    for s, want_left, cols in ((0, 0, (2, 10)), (1, 2, (0, 10)), (3, 2, (0, 8))):
        kept, left = halo.drop_global_edges(padded, 2, _mesh(4, s))
        assert left == want_left and torch.equal(kept, padded[:, :, cols[0]:cols[1]]), s


def test_tile_cells_geometry():
    """Mesh.tile_cells: (x0, c0, tile cols) of each rank's tile of whole
    cells; tiles that split a cell raise."""
    assert _mesh(2, 1).tile_cells(640, 20) == (320, 10, 10)
    assert _mesh(4, 3).tile_cells(640, 20) == (480, 15, 5)
    assert _mesh(4, 1).tile_cells(128, 4) == (32, 1, 1)
    with pytest.raises(ValueError, match="whole cells"):
        _mesh(4, 0).tile_cells(628, 20)
    with pytest.raises(ValueError, match="whole cells"):
        _mesh(8, 0).tile_cells(640, 20)  # 80-px tiles of 32-px cells


def test_spatial_route():
    """"tiled" for the default KDEConfig() on tiles of whole cells (640x480
    at x = 2 and 4, the 96x128 test frames at x = 2 and 4), "replicated"
    for every config or tiling without a tiled form, and at x = 1."""
    cfg = KDEConfig()
    route = sharding.spatial_route
    assert route(_mesh(2, 0), cfg, 480, 640) == "tiled"
    assert route(_mesh(4, 2), cfg, 480, 640) == "tiled"
    small = dataclasses.replace(cfg, grid=GRID)
    assert route(_mesh(2, 0), small, H, W) == route(_mesh(4, 0), small, H, W) == "tiled"
    assert route(_mesh(4, 0), cfg, 480, 628) == "replicated"  # 157-px tiles, grid 20
    assert route(_mesh(1, 0), cfg, 480, 640) == "replicated"
    assert route(_mesh(8, 0), cfg, 480, 640) == "replicated"  # 80-px tiles split cells
    assert route(_mesh(2, 0), small, H, 126) == "replicated"
    off = [dataclasses.replace(cfg, plane_merge=True), dataclasses.replace(cfg, fill_holes=4),
           dataclasses.replace(cfg, nasp=dataclasses.replace(cfg.nasp, iterations=3))]
    off += [dataclasses.replace(cfg, normals=dataclasses.replace(cfg.normals, method=m))
            for m in ("sdc", "bilateral")]
    for c in off:
        assert route(_mesh(2, 0), c, 480, 640) == "replicated"
    with pytest.raises(ValueError, match="route"):
        sharding.spatial_kde(None, None, _mesh(2, 0), None, cfg, route="halo")


def test_tiled_stages_at_world_one(frames):
    """_kde_from_jbf with a WidthTile of every cell (world 1: the gathers
    and lookups pass through) equals kde_pipeline field by field."""
    x = frames
    mesh = make_mesh(device="cpu")
    d, c = x["depth"][:1], x["color"][:1]
    want = kde_pipeline(d, c, x["intr"], x["cfg"])
    jbf = bilateral.joint_bilateral_filter(d, c, x["cfg"].jbf)
    got = _kde_from_jbf(jbf, c, x["intr"], x["cfg"],
                        tile=sharding.WidthTile(mesh, GRID, W))
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
