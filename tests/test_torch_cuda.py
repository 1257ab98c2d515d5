"""PyTorch port: the CUDA kernels against their plain PyTorch versions on
the card.  Marked `cuda`; each test skips without a CUDA device (decided in
a fixture, never at import).  Run on the card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(tests/conftest.py configures JAX, which the card's machine need not have;
this file imports only the port.)

Bars: chamfer DT, covariance sweep, seed gradient and JBF bitwise.  NASP
cell kernels (ops/cuda_nasp.py):
assignment labels and distance bitwise, gathers bitwise, sums with
integer-valued features exact and the rest within 1e-5 of the sum of the
terms' magnitudes (cuda_nasp.sums_close), at 96x128 with 32x32 cells (grid
3x4) and with 24x32 cells (grid 4x4).  The label-cell sums and gather are
also held on adversarial label maps over three cell shapes (24x24 cells at
96x120 among them), r in {2, 4, 5} and F up to 16, and must give bitwise
identical results on two launches; so must the NASP sums (both modes, r in
{1, 2, 4, 5}, and label maps whose slot changes at every pixel) and the
fused assignment (r in {1, 2, 4}: ties, an all-invalid-depth cell, invalid
normals, out-of-grid candidates).  The covariance sweep and the chamfer
DT are also held bit for bit (sign of zero included) on adversarial inputs
at 77x101 (B=3, ragged tiles) and 480x640 (B=1): the covariance with rect
drawn from -3..25 (below 2, every size, above 21) and 30% invalid
vertices; the DT at zero densities 0, 0.2%, 5% and 50% and on a lattice of
zeros 48 px apart, for 0, 1, 25, 26, 27 and 53 rounds (the fused init, one
launch and the chunks), each launch counted and two launches identical.
So are the JBF (windows 1, 3, 5, 7 and 17: the radii whose pass-1
weights stay in registers and one that recomputes them; each sigma gate
off; weights driven into the subnormal range by guide steps of 255 and a
depth step; regions with no valid depth, 50.0 mm exactly among them) and
the seed gradient (both forms; normals invalid on one, two and three
channels, on the edge rows and columns too; a constant colour patch, +inf
inside) at 77x101 (B=3) and at the path's shapes, 480x640 and the
270x360 seed sub-grid.  At the 640x480 frame the NASP sums also run at
r = 5 on three-iteration labels, the label sums at F = 4 and 6
(merge_planes) and at r = 5, the gather at F = 2 (the trust table) and at
r = 5; and the DASP / ERS paths' forms: the colour gradient on DASP's
window-4 sub-grid, the label sums at F = 10 at r = 2 and 3, the gather at
F = 2 at r = 2 and 3 and at F = 1, 4 and 7 over ERS labels at r = 4.
rgbf_pipeline, spdsp_pipeline and tof_pipeline run at 640x480 against the
JAX package's output (tests/golden/dasp_jax_640x480_seed0.npz) and ground
truth.  The 640x480 main path is held against the JAX package's output
(tests/golden/kde_jax_640x480_seed0.npz, golden.kde_gates) and against
ground truth (tests/test_pipelines.py:31-51), and the far-range gate of
tests/test_oracle_pipeline.py:230-287 runs on make_banded_scene.
The tiled route's forms: the seed gradient on 5-column haloed width tiles
of a 424x512 Kinect v2 frame (x = 2 and 4) bitwise its plain version and
the whole frame's columns, and the four cell kernels on the uneven
cell-aligned tiles of x = 8 at 640x480 (3 and 2 cells) against their plain
versions and the full frame's cells.  The compiled call (core/jit.py):
every KDE config, RGBF, SPDSP and TOF (at 96x128 and 640x480) replayed
twice, bitwise the eager call, no output shared; NASP's and the ERS
labels' cap checks taken both ways as conditional nodes; a host read and
a host-data seed override under jit raising.  chip_smoke.py runs the
same checks at the 640x480 path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch import _build
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import (
    bilateral,
    cuda_bilateral,
    cuda_cov,
    cuda_dt,
    cuda_gradient,
    cuda_nasp,
    normals,
    slic,
)

pytestmark = pytest.mark.cuda
H, W = 96, 128
GRID = GridParams(rows=3, cols=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(dev):
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    cfg = KDEConfig()
    guide = bilateral.guide_bilateral(color, cfg.jbf).float().contiguous()
    points = projective_to_real(depth, intr)
    vm = (points / 1000.0).contiguous()
    nmap = normals.generate_normal_map(points, cfg.normals)
    cf = color.float()
    return dict(
        intr=intr, color=color, depth=depth, guide=guide, vm=vm,
        dci=normals.dci_map(vm, 0.05).contiguous(),
        rect=normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous(),
        csub=slic._subgrid_extract(cf, GRID, H, W, 8).contiguous(),
        nsub=slic._subgrid_extract(nmap, GRID, H, W, 8).contiguous(),
    )


def test_jbf_kernel_matches_plain(inputs):
    p = KDEConfig().jbf
    kw = dict(window=p.window, spatial_sigma=p.spatial_sigma,
              color_sigma=p.color_sigma, depth_sigma=p.depth_sigma)
    got = cuda_bilateral.jbf(inputs["depth"], inputs["guide"], **kw)
    want = cuda_bilateral.jbf_plain(inputs["depth"], inputs["guide"], **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("iters", [26, 40])
def test_dt_kernel_bitwise(inputs, iters):
    got = cuda_dt.distance_transform(inputs["dci"], iters)
    assert torch.equal(got, cuda_dt.distance_transform_plain(inputs["dci"], iters))


def test_cov_kernel_bitwise(inputs):
    cnt, cov = cuda_cov.cm_covariances(inputs["vm"], inputs["rect"])
    pc, pv = cuda_cov.cm_covariances_plain(inputs["vm"], inputs["rect"])
    assert torch.equal(cnt, pc) and torch.equal(cov, pv)


@pytest.mark.parametrize("nasp", [True, False], ids=["nasp", "color_only"])
def test_seed_gradient_kernel_bitwise(inputs, nasp):
    n = inputs["nsub"] if nasp else None
    got = cuda_gradient.seed_gradient(inputs["csub"], n)
    assert torch.equal(got, cuda_gradient.seed_gradient_plain(inputs["csub"], n))


# (B, H, W): ragged tiles in both kernels, and the path's frame
ADV_SHAPES = [(3, 77, 101), (1, 480, 640)]
ADV_SHAPE_IDS = ["77x101_b3", "480x640_b1"]


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("shape", ADV_SHAPES, ids=ADV_SHAPE_IDS)
def test_cov_kernel_adversarial(dev, shape):
    b, h, w = shape
    rng = np.random.default_rng(40)
    v = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    z = rng.uniform(0.4, 6.0, (b, h, w)).astype(np.float32)
    z[rng.random((b, h, w)) < 0.3] = 0.0
    v[..., 2] = z
    rect = rng.integers(-3, 26, (b, h, w)).astype(np.int32)
    tv, tr = torch.tensor(v, device=dev), torch.tensor(rect, device=dev)
    before = cuda_cov.launches
    got = cuda_cov.cm_covariances(tv, tr)
    again = cuda_cov.cm_covariances(tv, tr)
    torch.cuda.synchronize()
    assert cuda_cov.launches == before + 2
    want = cuda_cov.cm_covariances_plain(tv, tr)
    for g, a, p in zip(got, again, want):
        assert _same_bits(g, p) and _same_bits(g, a)


def _dci(zeros, shape, seed):
    """i32 depth-change map: 0 with probability `zeros`, 255 elsewhere, or
    the lattice (0 where y % 48 == 24 and x % 48 == 24)."""
    b, h, w = shape
    if zeros == "lattice":
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        lattice = np.where((yy % 48 == 24) & (xx % 48 == 24), 0, 255)
        return np.repeat(lattice[None], b, 0).astype(np.int32)
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < zeros, 0, 255).astype(np.int32)


@pytest.mark.parametrize("iters", [0, 1, 25, 26, 27, 53])
@pytest.mark.parametrize("zeros", [0.0, 0.002, 0.05, 0.5, "lattice"],
                         ids=["none", "0.2pct", "5pct", "50pct", "lattice"])
@pytest.mark.parametrize("shape", ADV_SHAPES, ids=ADV_SHAPE_IDS)
def test_dt_kernel_adversarial(dev, shape, zeros, iters):
    dci = torch.tensor(_dci(zeros, shape, seed=50 + iters), device=dev)
    max_rounds = _build.load().kde_dt_max_rounds()  # rounds one launch runs
    before = cuda_dt.launches
    got = cuda_dt.distance_transform(dci, iters)
    again = cuda_dt.distance_transform(dci, iters)
    torch.cuda.synchronize()
    assert cuda_dt.launches == before + 2 * max(1, -(-iters // max_rounds))
    want = cuda_dt.distance_transform_plain(dci, iters)
    assert _same_bits(got, want) and _same_bits(got, again)


# window 1, 3, 5, 7: pass 1's weights kept in registers; 17: recomputed
JBF_WINDOWS = [1, 3, 5, 7, 17]
JBF_CASES = ["default", "no_color", "no_depth", "subnormal", "no_support"]


def _jbf_case(case, shape, seed):
    """(depth [B, H, W] mm, guide [B, H, W, 3], sigmas) for one case.
    "default": a wavy surface with noise and 30% holes, a guide of random
    8x8 blocks with noise, the default sigmas; "no_color" / "no_depth": the
    same with that sigma 0 (its term gated off); "subnormal": guide steps of
    ~255 on every channel and depth steps of ~300 mm between random 4x4
    blocks, with sigmas (spatial 1, colour 32, depth 22) that put the
    colour and depth factors across a step, and their products with the
    spatial weights, around FLT_MIN, where they flush to 0; "no_support":
    the default depth with its left third at 0..50 mm and its middle third
    at exactly 50.0 mm (both invalid: the test is depth > 50)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    p = KDEConfig().jbf
    sig = dict(spatial_sigma=p.spatial_sigma, color_sigma=p.color_sigma,
               depth_sigma=p.depth_sigma)
    if case == "subnormal":
        gbit = rng.random((b, h // 4 + 1, w // 4 + 1)) < 0.5
        gbit = gbit[:, yy // 4, xx // 4][..., None]
        u = rng.uniform(0.0, 12.0, (b, h, w, 3))
        guide = np.where(gbit, 255.0 - u, u)
        dbit = rng.random((b, h // 4 + 1, w // 4 + 1)) < 0.5
        depth = 1000.0 + 300.0 * dbit[:, yy // 4, xx // 4] + rng.uniform(-5.0, 5.0, (b, h, w))
        depth[rng.random((b, h, w)) < 0.05] = 0.0
        sig = dict(spatial_sigma=1.0, color_sigma=32.0, depth_sigma=22.0)
    else:
        blocks = rng.integers(0, 256, (b, h // 8 + 1, w // 8 + 1, 3))
        guide = np.clip(blocks[:, yy // 8, xx // 8] + rng.integers(-6, 7, (b, h, w, 3)), 0, 255)
        depth = (2000.0 + 400.0 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
                 + rng.normal(0.0, 15.0, (b, h, w)))
        depth[rng.random((b, h, w)) < 0.3] = 0.0
        if case == "no_color":
            sig["color_sigma"] = 0.0
        elif case == "no_depth":
            sig["depth_sigma"] = 0.0
        elif case == "no_support":
            depth[:, :, : w // 3] = rng.uniform(0.0, 50.0, (b, h, w // 3))
            depth[:, :, w // 3 : 2 * w // 3] = 50.0
    return depth.astype(np.float32), guide.astype(np.float32), sig


@pytest.mark.parametrize("case", JBF_CASES)
@pytest.mark.parametrize("window", JBF_WINDOWS)
@pytest.mark.parametrize("shape", ADV_SHAPES, ids=ADV_SHAPE_IDS)
def test_jbf_kernel_adversarial(dev, shape, window, case):
    depth, guide, sig = _jbf_case(case, shape, seed=60 + window)
    td, tg = torch.tensor(depth, device=dev), torch.tensor(guide, device=dev)
    kw = dict(window=window, **sig)
    before = cuda_bilateral.launches
    got = cuda_bilateral.jbf(td, tg, **kw)
    again = cuda_bilateral.jbf(td, tg, **kw)
    torch.cuda.synchronize()
    assert cuda_bilateral.launches == before + 2
    want = cuda_bilateral.jbf_plain(td, tg, **kw)
    assert _same_bits(got, want) and _same_bits(got, again)
    if case == "no_support":
        assert not bool(got[:, :, : shape[2] // 3 - window].any())


# the gradient's own path shape: the 270x360 seed sub-grid of a 640x480 frame
GRAD_SHAPES = [(3, 77, 101), (1, 270, 360)]
GRAD_SHAPE_IDS = ["77x101_b3", "270x360_b1"]


def _gradient_case(case, shape, seed):
    """(colour [B, H, W, 3] integer-valued f32, unit normals [B, H, W, 3]).
    Colours come in random 3x3 blocks with noise on a quarter of the pixels,
    so many taps see equal colours (g = 0).  "invalid_normals": 30% of the
    normals have one, two or all three channels at -1, and so do runs of
    the first and last rows and columns; "constant_patch": one colour over
    a 24x24 patch (every tap of its inner 14x14 has g = 0: +inf there)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    color = rng.integers(0, 256, (b, h // 3 + 1, w // 3 + 1, 3))[:, yy // 3, xx // 3]
    noisy = rng.random((b, h, w)) < 0.25
    color = np.where(noisy[..., None], rng.integers(0, 256, (b, h, w, 3)), color)
    n = rng.normal(size=(b, h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if case == "invalid_normals":
        # each of the 7 non-empty sets of channels at -1
        chans = rng.integers(1, 8, (b, h, w))
        hit = rng.random((b, h, w)) < 0.3
        hit[:, [0, -1], :] |= (np.arange(w) % 7 < 4)[None, None, :]
        hit[:, :, [0, -1]] |= (np.arange(h) % 5 < 3)[None, :, None]
        for c in range(3):
            n[..., c] = np.where(hit & ((chans >> c) & 1 == 1), -1.0, n[..., c])
    elif case == "constant_patch":
        y0, x0 = h // 3, w // 3
        color[:, y0 : y0 + 24, x0 : x0 + 24] = (120, 60, 200)
    return color.astype(np.float32), n.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "invalid_normals", "constant_patch"])
@pytest.mark.parametrize("nasp", [True, False], ids=["nasp", "color_only"])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=GRAD_SHAPE_IDS)
def test_seed_gradient_kernel_adversarial(dev, shape, nasp, case):
    color, nrm = _gradient_case(case, shape, seed=70)
    tc = torch.tensor(color, device=dev)
    tn = torch.tensor(nrm, device=dev) if nasp else None
    before = cuda_gradient.launches
    got = cuda_gradient.seed_gradient(tc, tn)
    again = cuda_gradient.seed_gradient(tc, tn)
    torch.cuda.synchronize()
    assert cuda_gradient.launches == before + 2
    want = cuda_gradient.seed_gradient_plain(tc, tn)
    assert _same_bits(got, want) and _same_bits(got, again)
    if case == "constant_patch":
        y0, x0 = shape[1] // 3, shape[2] // 3
        assert bool(torch.isinf(got[:, y0 + 5 : y0 + 19, x0 + 5 : x0 + 19]).all())


def test_wrappers_reject_bad_tensors(inputs):
    with pytest.raises(TypeError):
        cuda_dt.distance_transform(inputs["dci"].float(), 26)
    strided = inputs["vm"].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    with pytest.raises(ValueError):  # same shape, not contiguous
        cuda_cov.cm_covariances(strided, inputs["rect"])


def test_pipeline_launches_every_kernel(inputs):
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    mods = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)
    before = [m.launches for m in mods]
    before_nasp = dict(cuda_nasp.launches)
    res = kde_pipeline(inputs["depth"], inputs["color"], inputs["intr"], cfg)
    torch.cuda.synchronize()
    assert all(m.launches > b for m, b in zip(mods, before))
    assert all(cuda_nasp.launches[k] > v for k, v in before_nasp.items())
    assert bool(torch.isfinite(res.optimized_points).all())


NASP_GRIDS = [GRID, GridParams(rows=4, cols=4)]


@pytest.fixture(scope="module", params=NASP_GRIDS, ids=["cells32x32", "cells24x32"])
def nasp(request, inputs):
    """The first NASP iteration's inputs on the card: seeds, candidate
    fields, labels of the plain assignment and the analyze-updated table."""
    grid = request.param
    params = KDEConfig().nasp
    color = inputs["color"]
    points = projective_to_real(inputs["depth"], inputs["intr"]).contiguous()
    nmap = normals.generate_normal_map(points, KDEConfig().normals).contiguous()
    cf = color.float().contiguous()
    rng = np.random.default_rng(7)
    seeds = np.stack(
        [rng.integers(0, W, (2, grid.num_clusters)), rng.integers(0, H, (2, grid.num_clusters))], -1
    )
    cl = slic.init_clusters(torch.tensor(seeds, dtype=torch.int32, device=cf.device),
                            color, points, nmap)
    s_scale = (W // grid.cols + H // grid.rows) / 2.0
    cand, akw = slic._assign_args(cl, grid, params, s_scale)
    rp = (W // grid.cols) * 2 // 16 + 1
    lo, hi = -8 * rp, 8 * rp - 1
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze_plain(
        cf, points, nmap, cand, lo=lo, hi=hi, **akw
    )
    idx = slic._CellIndex(labels, grid, 4, H, W, kernel_sums=False)
    cl = slic._nasp_analyze_post(idx.fold(part), cl, points, H, W)
    return dict(grid=grid, params=params, cf=cf, points=points, nmap=nmap, cand=cand,
                akw=akw, lo=lo, hi=hi, labels=labels, dist=dist, clusters=cl,
                cell=dict(rows=grid.rows, cols=grid.cols, r=4))


def test_nasp_assign_analyze_kernel_matches_plain(nasp):
    x = nasp
    args = (x["cf"], x["points"], x["nmap"], x["cand"])
    labels, dist, part = cuda_nasp.nasp_assign_and_analyze(*args, lo=x["lo"], hi=x["hi"], **x["akw"])
    torch.cuda.synchronize()
    assert torch.equal(labels, x["labels"]) and torch.equal(dist, x["dist"])
    kw = dict(x["cell"], lo=x["lo"], hi=x["hi"], mode="analyze")
    xy = x["cand"][..., 3:5]
    want = cuda_nasp.nasp_cell_sums_plain(x["labels"], *args[:3], xy, **kw)
    scale = cuda_nasp.nasp_cell_sums_plain(x["labels"], *args[:3], xy, abs_terms=True, **kw)
    assert cuda_nasp.sums_close(part, want, scale, cuda_nasp.INTEGER_FEATURES["analyze"])


@pytest.mark.parametrize("mode", ["analyze", "weighted"])
def test_nasp_cell_sums_kernel_matches_plain(nasp, mode):
    x, cl = nasp, nasp["clusters"]
    xy = cl.xy.float()
    fields = xy if mode == "analyze" else torch.cat([xy, cl.rgb, cl.normal], -1)
    fields = fields.reshape(2, x["grid"].rows, x["grid"].cols, -1).contiguous()
    args = (x["labels"], x["cf"], x["points"], x["nmap"], fields)
    kw = dict(x["cell"], lo=x["lo"], hi=x["hi"], mode=mode,
              color_sigma=x["params"].color_sigma, spatial_sigma=x["params"].spatial_sigma)
    got = cuda_nasp.nasp_cell_sums(*args, **kw)
    want = cuda_nasp.nasp_cell_sums_plain(*args, **kw)
    scale = cuda_nasp.nasp_cell_sums_plain(*args, abs_terms=True, **kw)
    torch.cuda.synchronize()
    assert cuda_nasp.sums_close(got, want, scale, cuda_nasp.INTEGER_FEATURES[mode])


def test_label_cell_sums_kernel_matches_plain(nasp):
    x = nasp
    rng = np.random.default_rng(8)
    feats = torch.tensor(rng.normal(size=(2, H, W, 2)).astype(np.float32), device=x["cf"].device)
    feats = feats * (x["labels"] >= 0)[..., None]
    got = cuda_nasp.label_cell_sums(x["labels"], feats, **x["cell"])
    want = cuda_nasp.label_cell_sums_plain(x["labels"], feats, **x["cell"])
    scale = cuda_nasp.label_cell_sums_plain(x["labels"], feats.abs(), **x["cell"])
    torch.cuda.synchronize()
    assert cuda_nasp.sums_close(got, want, scale)


def test_label_cell_gather_kernel_bitwise(nasp):
    x = nasp
    k = x["grid"].num_clusters
    rng = np.random.default_rng(9)
    table = torch.tensor(rng.normal(size=(2, k, 6)).astype(np.float32) * 1000.0, device=x["cf"].device)
    got = cuda_nasp.label_cell_gather(x["labels"], table, **x["cell"])
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_nasp.label_cell_gather_plain(x["labels"], table, **x["cell"]))


# (H, W, grid): 32x32 cells, 24x32 cells, and 24x24 cells (a cell width
# that is not a multiple of 32, 576 pixels a cell: not a multiple of 256)
LABEL_SHAPES = [(96, 128, GRID), (96, 128, GridParams(rows=4, cols=4)),
                (96, 120, GridParams(rows=4, cols=5))]
LABEL_SHAPE_IDS = ["cells32x32", "cells24x32", "cells24x24"]


def _adversarial_labels(h, w, grid, r, seed):
    """[2, H, W] i32 cell-local labels that hit every case of the kernels:
    every candidate offset (random (dy, dx) per pixel), -1 (7% and where
    the offset leaves the grid), labels outside the candidates (3%: any id
    in [-1, K + 5), far cells and ids >= K included), cell (0, 0) all one
    slot (its own id), the last cell with no label at all."""
    rng = np.random.default_rng(seed)
    bs_y, bs_x = h // grid.rows, w // grid.cols
    k = grid.num_clusters
    cy = np.arange(h)[None, :, None] // bs_y
    cx = np.arange(w)[None, None, :] // bs_x
    ny = cy + rng.integers(-r, r, (2, h, w))
    nx = cx + rng.integers(-r, r, (2, h, w))
    inside = (ny >= 0) & (ny < grid.rows) & (nx >= 0) & (nx < grid.cols)
    labels = np.where(inside, ny * grid.cols + nx, -1)
    labels[rng.random(labels.shape) < 0.07] = -1
    stray = rng.random(labels.shape) < 0.03
    labels[stray] = rng.integers(-1, k + 5, int(stray.sum()))
    labels[:, :bs_y, :bs_x] = 0
    labels[:, -bs_y:, -bs_x:] = -1
    return labels.astype(np.int32)


def _label_case(dev, shape, r, seed):
    h, w, grid = shape
    labels = torch.tensor(_adversarial_labels(h, w, grid, r, seed), device=dev)
    return labels, dict(rows=grid.rows, cols=grid.cols, r=r), grid.num_clusters


@pytest.mark.parametrize("r", [2, 4, 5])
@pytest.mark.parametrize("f", [1, 2, 3, 6, 16])
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=LABEL_SHAPE_IDS)
def test_label_cell_sums_kernel_adversarial(dev, shape, f, r):
    """Even feature columns integer-valued (exact on both sides), odd ones
    real (cuda_nasp.sums_close); two launches bitwise identical; one launch
    counted per call."""
    labels, cell, _ = _label_case(dev, shape, r, seed=10 + f)
    rng = np.random.default_rng(f)
    b, h, w = labels.shape
    feats = rng.normal(size=(b, h, w, f)) * 100.0
    feats[..., ::2] = rng.integers(0, 256, (b, h, w, (f + 1) // 2))
    feats = torch.tensor(feats.astype(np.float32), device=dev)
    feats = feats * (labels >= 0)[..., None]
    before = cuda_nasp.launches["label_cell_sums"]
    got = cuda_nasp.label_cell_sums(labels, feats, **cell)
    again = cuda_nasp.label_cell_sums(labels, feats, **cell)
    torch.cuda.synchronize()
    assert cuda_nasp.launches["label_cell_sums"] == before + 2
    assert torch.equal(got, again)
    want = cuda_nasp.label_cell_sums_plain(labels, feats, **cell)
    scale = cuda_nasp.label_cell_sums_plain(labels, feats.abs(), **cell)
    assert got.shape == want.shape
    assert cuda_nasp.sums_close(got, want, scale, integer_cols=range(0, f, 2))


@pytest.mark.parametrize("r", [2, 4, 5])
@pytest.mark.parametrize("f", [1, 3, 6, 7])
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=LABEL_SHAPE_IDS)
def test_label_cell_gather_kernel_adversarial(dev, shape, f, r):
    """Bitwise against the plain version and across two launches; one
    launch counted per call; labels outside the candidates gather 0."""
    labels, cell, k = _label_case(dev, shape, r, seed=20 + f)
    rng = np.random.default_rng(30 + f)
    table = torch.tensor(rng.normal(size=(2, k, f)).astype(np.float32) * 1000.0, device=dev)
    before = cuda_nasp.launches["label_cell_gather"]
    got = cuda_nasp.label_cell_gather(labels, table, **cell)
    again = cuda_nasp.label_cell_gather(labels, table, **cell)
    torch.cuda.synchronize()
    assert cuda_nasp.launches["label_cell_gather"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, cuda_nasp.label_cell_gather_plain(labels, table, **cell))
    assert bool((got[labels < 0] == 0.0).all())


def test_label_kernels_reject_what_they_do_not_take(dev):
    labels, cell, k = _label_case(dev, LABEL_SHAPES[0], 4, seed=1)
    feats = torch.zeros(labels.shape + (2,), device=dev)
    table = torch.zeros((2, k, 3), device=dev)
    with pytest.raises(ValueError):  # more features than a sums block stages
        cuda_nasp.label_cell_sums(labels, torch.zeros(labels.shape + (17,), device=dev), **cell)
    # beyond a block's shared memory the C entry point refuses the launch
    before = dict(cuda_nasp.launches)
    with pytest.raises(RuntimeError, match="invalid argument"):  # r=8, F=16: partials
        cuda_nasp.label_cell_sums(
            labels, torch.zeros(labels.shape + (16,), device=dev), **dict(cell, r=8))
    with pytest.raises(RuntimeError, match="invalid argument"):  # a staged table
        cuda_nasp.label_cell_gather(labels, torch.zeros((2, k, 5000), device=dev), **cell)
    assert cuda_nasp.launches == before
    with pytest.raises(TypeError):
        cuda_nasp.label_cell_sums(labels.long(), feats, **cell)
    with pytest.raises(TypeError):
        cuda_nasp.label_cell_gather(labels, table.double(), **cell)
    with pytest.raises(ValueError):  # same shape, not contiguous
        cuda_nasp.label_cell_sums(labels, feats.transpose(1, 2).contiguous().transpose(1, 2), **cell)
    with pytest.raises(ValueError):  # the table must have K rows
        cuda_nasp.label_cell_gather(labels, table[:, :-1].contiguous(), **cell)
    with pytest.raises(ValueError):  # cells must divide the image
        cuda_nasp.label_cell_sums(labels, feats, rows=5, cols=cell["cols"], r=4)


def test_nasp_subnormal_window_weights_keep_the_old_row(dev):
    """The planted cluster of test_torch_nasp.py on the card: cluster 5's
    pixels all sit |drgb| = 140 from its colour, so every window weight is
    exp(-98), subnormal.  The kernel flushes them: its weight sum (feature
    5) is exactly 0 in every slot of cluster 5, and the weighted update
    keeps the old row, as the JAX package does."""
    rng = np.random.default_rng(9)
    r, k0 = 4, 5  # cluster 5: cell (1, 1) of the 3x4 grid
    cy = np.arange(H)[:, None] // (H // GRID.rows)
    cx = np.arange(W)[None, :] // (W // GRID.cols)
    ny = np.clip(cy + rng.integers(-r, r, (H, W)), 0, GRID.rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (H, W)), 0, GRID.cols - 1)
    labels = (ny * GRID.cols + nx).astype(np.int32)
    labels[rng.random((H, W)) < 0.07] = -1
    color_f = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    color_f[labels == k0] = (200.0, 60.0, 60.0)
    points = rng.uniform(100.0, 4000.0, (H, W, 3)).astype(np.float32)
    nmap = rng.normal(size=(H, W, 3)).astype(np.float32)
    nmap /= np.linalg.norm(nmap, axis=-1, keepdims=True)
    k = GRID.num_clusters
    rgb = rng.integers(0, 255, (k, 3)).astype(np.float32)
    rgb[k0] = 60.0
    xy = np.stack([rng.integers(0, W, k), rng.integers(0, H, k)], -1).astype(np.int32)
    xy[k0] = (48, 48)
    cl = slic.Clusters(
        rgb=torch.tensor(rgb[None], device=dev), xy=torch.tensor(xy[None], device=dev),
        size=torch.zeros((1, k), dtype=torch.int32, device=dev),
        center=torch.tensor(rng.uniform(100, 4000, (1, k, 3)).astype(np.float32), device=dev),
        normal=torch.tensor(rng.normal(size=(1, k, 3)).astype(np.float32), device=dev),
        variance=torch.zeros((1, k), dtype=torch.float32, device=dev),
    )
    tl, tc, tp, tn = (torch.tensor(a[None], device=dev) for a in (labels, color_f, points, nmap))
    params = KDEConfig().nasp
    window = (-24, 23)
    fields = torch.cat([cl.xy.float(), cl.rgb, cl.normal], -1).reshape(1, GRID.rows, GRID.cols, 8)
    part = cuda_nasp.nasp_cell_sums(
        tl, tc, tp, tn, fields.contiguous(), rows=GRID.rows, cols=GRID.cols, r=r,
        lo=window[0], hi=window[1], mode="weighted",
        color_sigma=params.color_sigma, spatial_sigma=params.spatial_sigma,
    )
    slots = cuda_nasp.cand_grid(GRID.rows, GRID.cols, cuda_nasp.candidate_offsets(r), dev)
    mine = slots.reshape(-1) == k0
    counted = cuda_nasp.nasp_cell_sums(
        tl, tc, tp, tn, fields[..., :2].contiguous(), rows=GRID.rows, cols=GRID.cols, r=r,
        lo=window[0], hi=window[1], mode="analyze",
    )
    assert float(counted[0, mine, 5].sum()) > 0  # cluster 5 has pixels in its window
    assert bool((part[0, mine, 5] == 0.0).all())
    idx = slic.cell_index(tl, GRID, 2 * r, stats_impl="auto")
    got = slic._update_nasp_weighted(idx, cl, tc, tp, tn, params, window, H, W)
    torch.cuda.synchronize()
    for new, old in zip(got, cl):
        assert torch.equal(new[0, k0], old[0, k0])


def test_nasp_wrappers_reject_bad_tensors(nasp):
    x = nasp
    table = torch.zeros((2, x["grid"].num_clusters, 3), device=x["cf"].device)
    with pytest.raises(TypeError):
        cuda_nasp.label_cell_gather(x["labels"].long(), table, **x["cell"])
    with pytest.raises(ValueError):  # cells must divide the image
        cuda_nasp.label_cell_gather(x["labels"], table, rows=5, cols=x["grid"].cols, r=4)


def _nasp_planes(dev, h, w, grid, seed):
    """[2, H, W, 3] f32 colour (integers 0..255), points (z < 50 on 10% of
    pixels and on all of cell (1, 0)) and unit normals ((-1, -1, -1) on
    15%)."""
    rng = np.random.default_rng(seed)
    color = rng.integers(0, 256, (2, h, w, 3)).astype(np.float32)
    points = rng.uniform(100.0, 4000.0, (2, h, w, 3)).astype(np.float32)
    low = rng.random((2, h, w)) < 0.1
    points[..., 2][low] = rng.uniform(0.0, 50.0, int(low.sum()))
    bs_y, bs_x = h // grid.rows, w // grid.cols
    points[:, bs_y:2 * bs_y, :bs_x, 2] = 30.0
    nmap = rng.normal(size=(2, h, w, 3))
    nmap /= np.linalg.norm(nmap, axis=-1, keepdims=True)
    nmap[rng.random((2, h, w)) < 0.15] = -1.0
    return tuple(torch.tensor(a.astype(np.float32), device=dev) for a in (color, points, nmap))


def _nasp_cand(dev, h, w, grid, seed):
    """[2, rows, cols, 9] f32 cluster fields (rgb, x, y, centre z, normal):
    each cluster within 8 px of its cell's centre, centre z < 50 on 20% and
    normal (-1, -1, -1) on 20% of clusters; cell column 1 repeats column 0
    (equal fields: ties, which the first candidate dy-major must win)."""
    rng = np.random.default_rng(seed)
    rows, cols = grid.rows, grid.cols
    bs_y, bs_x = h // rows, w // cols
    cand = np.zeros((2, rows, cols, 9), np.float32)
    cand[..., :3] = rng.integers(0, 256, (2, rows, cols, 3))
    cand[..., 3] = (np.arange(cols) * bs_x + bs_x // 2)[None, None, :] + rng.integers(-8, 9, (2, rows, cols))
    cand[..., 4] = (np.arange(rows) * bs_y + bs_y // 2)[None, :, None] + rng.integers(-8, 9, (2, rows, cols))
    cand[..., 5] = np.where(rng.random((2, rows, cols)) < 0.2, 20.0, rng.uniform(100, 4000, (2, rows, cols)))
    nrm = rng.normal(size=(2, rows, cols, 3))
    cand[..., 6:] = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    cand[..., 6:][rng.random((2, rows, cols)) < 0.2] = -1.0
    cand[:, :, 1] = cand[:, :, 0]
    return torch.tensor(cand, device=dev)


def _slot_labels(h, w, grid, r, pattern):
    """[2, H, W] i32 labels whose candidate slot is y % n ("rows") or
    (y + x) % n ("diagonal"), n = (2r)^2, -1 where the slot's cell leaves
    the grid: a lane's next pixel (32 on, the row below at 32-wide cells)
    always has another slot, so every lane flushes every round."""
    n, bs_y, bs_x = (2 * r) ** 2, h // grid.rows, w // grid.cols
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    slot = y % n + 0 * x if pattern == "rows" else (y + x) % n
    ny = y // bs_y + slot // (2 * r) - r
    nx = x // bs_x + slot % (2 * r) - r
    inside = (ny >= 0) & (ny < grid.rows) & (nx >= 0) & (nx < grid.cols)
    labels = np.where(inside, ny * grid.cols + nx, -1).astype(np.int32)
    return np.repeat(labels[None], 2, 0)


def _check_nasp_cell_sums(dev, labels, grid, r, mode, window, seed):
    """Two launches bitwise identical and counted; the sums at the bar of
    cuda_nasp.sums_close (integer-valued features exact) and not all 0."""
    b, h, w = labels.shape
    color, points, nmap = _nasp_planes(dev, h, w, grid, seed)
    cand = _nasp_cand(dev, h, w, grid, seed + 1)
    fields = cand[..., 3:5] if mode == "analyze" else cand[..., [3, 4, 0, 1, 2, 6, 7, 8]]
    params = KDEConfig().nasp
    args = (labels, color, points, nmap, fields.contiguous())
    kw = dict(rows=grid.rows, cols=grid.cols, r=r, lo=window[0], hi=window[1], mode=mode,
              color_sigma=params.color_sigma, spatial_sigma=params.spatial_sigma)
    before = cuda_nasp.launches["nasp_cell_sums"]
    got = cuda_nasp.nasp_cell_sums(*args, **kw)
    again = cuda_nasp.nasp_cell_sums(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_nasp.launches["nasp_cell_sums"] == before + 2
    assert torch.equal(got, again)
    want = cuda_nasp.nasp_cell_sums_plain(*args, **kw)
    scale = cuda_nasp.nasp_cell_sums_plain(*args, abs_terms=True, **kw)
    assert got.shape == want.shape and float(scale.sum()) > 0
    assert cuda_nasp.sums_close(got, want, scale, cuda_nasp.INTEGER_FEATURES[mode])


@pytest.mark.parametrize("r", [1, 2, 4, 5])
@pytest.mark.parametrize("mode", ["analyze", "weighted"])
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=LABEL_SHAPE_IDS)
def test_nasp_cell_sums_kernel_adversarial(dev, shape, mode, r):
    """The adversarial label maps (every offset, -1, ids outside the
    candidates, a one-slot cell, an empty cell) with the path's update
    window (+-40 px)."""
    labels, cell, _ = _label_case(dev, shape, r, seed=40 + r)
    _check_nasp_cell_sums(dev, labels, shape[2], r, mode, (-40, 39), seed=r)


@pytest.mark.parametrize("pattern", ["rows", "diagonal"])
@pytest.mark.parametrize("mode", ["analyze", "weighted"])
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=LABEL_SHAPE_IDS)
def test_nasp_cell_sums_kernel_slot_changes_every_pixel(dev, shape, mode, pattern):
    """The flush's worst case: every lane's slot changes every round, in one
    group a round ("rows" at 32-wide cells: a full 5-level tree) or in as
    many groups as lanes ("diagonal"); a window wide enough that every
    labeled pixel counts."""
    h, w, grid = shape
    labels = torch.tensor(_slot_labels(h, w, grid, 4, pattern), device=dev)
    _check_nasp_cell_sums(dev, labels, grid, 4, mode, (-4096, 4095), seed=7)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=LABEL_SHAPE_IDS)
def test_nasp_assign_analyze_kernel_adversarial(dev, shape, r):
    """Duplicate candidate fields (ties), a cell whose depth is all < 50,
    invalid normals on pixels and candidates, candidate centres below 50 mm
    and out-of-grid candidates (every r here reaches past the grid); the
    invalid-depth override off at r = 2.  Labels and distances bitwise,
    two launches identical and counted, the sums at the bar."""
    h, w, grid = shape
    color, points, nmap = _nasp_planes(dev, h, w, grid, seed=60 + r)
    cand = _nasp_cand(dev, h, w, grid, seed=70 + r)
    p = KDEConfig().nasp
    total = p.spatial_sigma + p.color_sigma + p.depth_sigma + p.normal_sigma
    bs_y, bs_x = h // grid.rows, w // grid.cols
    rp = bs_x * 2 // 16 + 1
    kw = dict(rows=grid.rows, cols=grid.cols, r=r, lo=-8 * rp, hi=8 * rp - 1,
              w_col=(p.color_sigma / total) ** 2, w_spa=(p.spatial_sigma / total) ** 2,
              w_dep=(p.depth_sigma / total) ** 2, w_nor=(p.normal_sigma / total) ** 2,
              s_scale=(bs_x + bs_y) / 2.0, apply_invalid=r != 2)
    args = (color, points, nmap, cand)
    before = cuda_nasp.launches["nasp_assign_analyze"]
    got = cuda_nasp.nasp_assign_and_analyze(*args, **kw)
    again = cuda_nasp.nasp_assign_and_analyze(*args, **kw)
    torch.cuda.synchronize()
    assert cuda_nasp.launches["nasp_assign_analyze"] == before + 2
    assert all(_same_bits(g, a) for g, a in zip(got, again))
    akw = {k: v for k, v in kw.items() if k not in ("lo", "hi")}
    labels, dist = cuda_nasp.assign_plain(*args, **akw)
    assert torch.equal(got[0], labels) and _same_bits(got[1], dist)
    if kw["apply_invalid"]:
        assert bool((labels[:, bs_y:2 * bs_y, :bs_x] == -1).all())
    skw = dict(rows=grid.rows, cols=grid.cols, r=r, lo=kw["lo"], hi=kw["hi"], mode="analyze")
    xy = cand[..., 3:5].contiguous()
    want = cuda_nasp.nasp_cell_sums_plain(labels, color, points, nmap, xy, **skw)
    scale = cuda_nasp.nasp_cell_sums_plain(labels, color, points, nmap, xy, abs_terms=True, **skw)
    assert cuda_nasp.sums_close(got[2], want, scale, cuda_nasp.INTEGER_FEATURES["analyze"])


def test_nasp_kernels_reject_partials_beyond_shared_memory(dev):
    """r = 9: the warps' partials (8 x 324 x 13 doubles, 270 KB) exceed a
    block's shared memory, so both C entry points refuse the launch, the
    wrappers raise and no counter moves."""
    labels, cell, _ = _label_case(dev, LABEL_SHAPES[0], 4, seed=3)
    b, h, w = labels.shape
    plane = torch.zeros((b, h, w, 3), device=dev)
    cell = dict(cell, r=9)
    before = dict(cuda_nasp.launches)
    for mode, nf in (("analyze", 2), ("weighted", 8)):
        fields = torch.zeros((b, cell["rows"], cell["cols"], nf), device=dev)
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_nasp.nasp_cell_sums(labels, plane, plane, plane, fields, lo=-40, hi=39,
                                     mode=mode, **cell)
    cand = torch.zeros((b, cell["rows"], cell["cols"], 9), device=dev)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cuda_nasp.nasp_assign_and_analyze(plane, plane, plane, cand, lo=-40, hi=39, w_col=0.1,
                                          w_spa=0.1, w_dep=0.1, w_nor=0.1, s_scale=32.0,
                                          apply_invalid=True, **cell)
    assert cuda_nasp.launches == before


# ---- the shapes the multi-iteration, plane-merge and hole-fill paths add,
# at the 640x480 path's frame, and the 640x480 gates of the main path

FULL = dict(h=480, w=640)


@pytest.fixture(scope="module")
def frame640(dev):
    """make_noisy_scene(480, 640, seed=0) on the card: the frame, its JBF
    points and normals, and the NASP labels after one iteration (r = 4
    cell-local) and after three (within the cap of 5), on the plain route."""
    from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

    h, w = FULL["h"], FULL["w"]
    intr = default_kinect_intrinsics(w, h)
    color, noisy, gt = make_noisy_scene(h, w, intr, seed=0)
    cfg = KDEConfig()
    c = torch.from_numpy(color).to(dev)[None]
    d = torch.from_numpy(noisy).to(dev)[None]
    points = projective_to_real(bilateral.joint_bilateral_filter(d, c, cfg.jbf), intr)
    nmap = normals.generate_normal_map(points, cfg.normals)
    plain = dataclasses.replace(cfg.nasp, stats_impl="xla")
    one = ts.segment(c, points, nmap, grid=cfg.grid, params=plain)
    three = ts.segment(c, points, nmap, grid=cfg.grid,
                       params=dataclasses.replace(plain, iterations=3))
    assert bool(ts.labels_within_cap(three.labels, cfg.grid, 5, h, w).all())
    return dict(intr=intr, color=c, depth=d, gt=gt, noisy=noisy, points=points.contiguous(),
                nmap=nmap.contiguous(), cf=c.float().contiguous(), cfg=cfg,
                labels={4: one.labels, 5: three.labels}, clusters={4: one.clusters,
                                                                   5: three.clusters})


@pytest.mark.parametrize("mode", ["analyze", "weighted"])
def test_nasp_cell_sums_r5_at_the_path_frame(frame640, mode):
    """nasp_cell_sums at r = 5 (the capped iterations) on three-iteration
    labels at 640x480: integer features exact, the rest within 1e-5 of the
    sum of the terms' magnitudes."""
    x, grid = frame640, frame640["cfg"].grid
    cl = x["clusters"][5]
    xy = cl.xy.float()
    fields = xy if mode == "analyze" else torch.cat([xy, cl.rgb, cl.normal], -1)
    fields = fields.reshape(1, grid.rows, grid.cols, -1).contiguous()
    p = x["cfg"].nasp
    kw = dict(rows=grid.rows, cols=grid.cols, r=5, lo=-40, hi=39, mode=mode,
              color_sigma=p.color_sigma, spatial_sigma=p.spatial_sigma)
    args = (x["labels"][5], x["cf"], x["points"], x["nmap"], fields)
    got = cuda_nasp.nasp_cell_sums(*args, **kw)
    want = cuda_nasp.nasp_cell_sums_plain(*args, **kw)
    scale = cuda_nasp.nasp_cell_sums_plain(*args, abs_terms=True, **kw)
    assert cuda_nasp.sums_close(got, want, scale, cuda_nasp.INTEGER_FEATURES[mode])
    assert torch.equal(got, cuda_nasp.nasp_cell_sums(*args, **kw))


@pytest.mark.parametrize("r, f", [(4, 4), (4, 6), (5, 2), (5, 4), (5, 6)])
def test_label_cell_sums_new_shapes_at_the_path_frame(frame640, r, f):
    """label_cell_sums at merge_planes' feature counts (4: points and a
    count; 6: the centred scatter) and at r = 5, within 1e-5 of the sum
    of the terms' magnitudes; two launches identical."""
    x, grid = frame640, frame640["cfg"].grid
    labels = x["labels"][r]
    g = torch.Generator(device=labels.device).manual_seed(f)
    feats = torch.randn((1, FULL["h"], FULL["w"], f), device=labels.device, generator=g)
    feats = (feats * (x["points"][..., 2:3] > 50.0)).contiguous()
    kw = dict(rows=grid.rows, cols=grid.cols, r=r)
    got = cuda_nasp.label_cell_sums(labels, feats, **kw)
    want = cuda_nasp.label_cell_sums_plain(labels, feats, **kw)
    scale = cuda_nasp.label_cell_sums_plain(labels, feats.abs(), **kw)
    assert cuda_nasp.sums_close(got, want, scale)
    assert torch.equal(got, cuda_nasp.label_cell_sums(labels, feats, **kw))


@pytest.mark.parametrize("r, f", [(4, 2), (5, 1), (5, 2), (5, 3), (5, 6)])
def test_label_cell_gather_new_shapes_at_the_path_frame(frame640, r, f):
    """label_cell_gather of the trust table (F = 2 without the residual) and
    at r = 5, bitwise."""
    x, grid = frame640, frame640["cfg"].grid
    labels = x["labels"][r]
    g = torch.Generator(device=labels.device).manual_seed(10 + f)
    table = torch.randn((1, grid.num_clusters, f), device=labels.device, generator=g) * 1e3
    kw = dict(rows=grid.rows, cols=grid.cols, r=r)
    got = cuda_nasp.label_cell_gather(labels, table, **kw)
    assert torch.equal(got, cuda_nasp.label_cell_gather_plain(labels, table, **kw))


def _kde640(x, cfg=None):
    return kde_pipeline(x["depth"][0], x["color"][0], x["intr"], cfg or x["cfg"])


def test_kde_640x480_matches_jax_fixture(frame640):
    """kde_pipeline(KDEConfig()) on the card at 640x480 against the JAX
    package's run of the same frame (tests/golden/kde_jax_640x480_seed0.npz)
    at golden.kde_gates."""
    from kinectdepthmapenhancement_tpu_torch.utils import golden

    res = _kde640(frame640)
    got = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    gates = golden.kde_gates(got, golden.load_jax_640x480())
    assert not golden.failures(gates), gates


def test_kde_640x480_quality(frame640):
    """tests/test_pipelines.py:31-51 on the card: > 200000 valid points, the
    mean 3-D error below the input's, depth RMSE under 10 mm."""
    from kinectdepthmapenhancement_tpu_torch.utils import metrics

    x = frame640
    res = _kde640(x)
    gt = torch.from_numpy(x["gt"]).to(res.optimized_points.device)
    gt_pts = projective_to_real(gt, x["intr"])
    in_pts = projective_to_real(torch.from_numpy(x["noisy"]).to(gt.device), x["intr"])
    err_in, _ = metrics.mean_3d_error(in_pts, gt_pts)
    err_out, n = metrics.mean_3d_error(res.optimized_points, gt_pts)
    assert int(n) > 200000
    assert float(err_out) < float(err_in)
    assert float(metrics.depth_rmse(res.optimized_points[..., 2], gt)) < 10.0


def test_far_range_gate(dev):
    """tests/test_oracle_pipeline.py:230-287 on the card, on
    make_banded_scene(480, 640, seed=0): KDE RMSE < 0.9 x the JBF's; with
    plane_merge < 0.98 x the KDE's; the dominant merged component > 100000
    px with an interior RMSE < 1.5 mm (golden.far_range_gates)."""
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_banded_scene
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import jbf_pipeline
    from kinectdepthmapenhancement_tpu_torch.utils import golden

    h, w = FULL["h"], FULL["w"]
    intr = default_kinect_intrinsics(w, h)
    color, sensor, gt = make_banded_scene(h, w, intr, seed=0)
    d, c = torch.from_numpy(sensor).to(dev), torch.from_numpy(color).to(dev)
    cfg = KDEConfig()
    pm = kde_pipeline(d, c, intr, dataclasses.replace(cfg, plane_merge=True))
    gates, _ = golden.far_range_gates(
        jbf_pipeline(d, c).cpu().numpy(),
        kde_pipeline(d, c, intr, cfg).optimized_points[..., 2].cpu().numpy(),
        pm.optimized_points[..., 2].cpu().numpy(), pm.merged_labels.cpu().numpy(), gt,
        cfg.grid.num_clusters)
    assert not golden.failures(gates), gates


# ---- the DASP / ERS pipelines (RGBF, SPDSP, TOF) at the 640x480 frame:
# the forms of the colour gradient and the label-cell kernels they add, and
# the pipelines against the JAX package's output and ground truth


@pytest.fixture(scope="module")
def dasp640(dev):
    """make_noisy_scene(480, 640, seed=0) on the card with its raw points,
    and on the plain route (SPDSPConfig()): the depth SLIC's labels after
    one iteration (r = 2) and after five (within the cap of 3) with their
    clusters, and the ERS labels (within the cap of 4)."""
    from kinectdepthmapenhancement_tpu_torch.core.config import SPDSPConfig
    from kinectdepthmapenhancement_tpu_torch.ops import ers

    h, w = FULL["h"], FULL["w"]
    intr = default_kinect_intrinsics(w, h)
    color, noisy, gt = make_noisy_scene(h, w, intr, seed=0)
    cfg = SPDSPConfig()
    c = torch.from_numpy(color).to(dev)[None]
    d = torch.from_numpy(noisy).to(dev)[None]
    raw = projective_to_real(d, intr).contiguous()
    seg = {}
    for it in (1, 5):
        p = dataclasses.replace(cfg.depth_slic, iterations=it, stats_impl="xla")
        seg[it] = slic.segment(c, raw, grid=cfg.grid, params=p, variant="dasp")
    colour = slic.segment(c, raw, grid=cfg.grid, variant="dasp",
                          params=dataclasses.replace(cfg.color_slic, stats_impl="xla"))
    refined = ers.edge_refine(colour.labels, seg[5].labels, d, cfg.ers).labels
    assert bool(slic.labels_within_cap(seg[5].labels, cfg.grid, 3, h, w).all())
    assert bool(slic.labels_within_cap(refined, cfg.grid, 4, h, w).all())
    return dict(intr=intr, color=c, depth=d, raw=raw, gt=gt, noisy=noisy, cfg=cfg,
                labels={2: seg[1].labels, 3: seg[5].labels, 4: refined},
                clusters={2: seg[1].clusters, 3: seg[5].clusters})


def test_seed_gradient_color_at_the_dasp_subgrid(dasp640):
    """The colour seed gradient on DASP's window-4 seed sub-grid (210x280
    at 640x480): bitwise, the seeds identical."""
    x, grid = dasp640, dasp640["cfg"].grid
    csub = slic._subgrid_extract(x["color"].float(), grid, FULL["h"], FULL["w"], 4).contiguous()
    assert tuple(csub.shape) == (1, 210, 280, 3)
    got = cuda_gradient.seed_gradient(csub)
    want = cuda_gradient.seed_gradient_plain(csub)
    assert torch.equal(got, want)
    assert torch.equal(slic._sample_seeds_subgrid(got, grid, FULL["h"], FULL["w"], 4),
                       slic._sample_seeds_subgrid(want, grid, FULL["h"], FULL["w"], 4))


@pytest.mark.parametrize("r", [2, 3])
def test_label_cell_sums_dasp_update_at_the_path_frame(dasp640, r):
    """label_cell_sums at F = 10 (the DASP update: colour, u, v, 1, point,
    valid depth) at r = 2 and 3 on DASP labels: the integer-valued features
    exact, the rest within 1e-5 of the sum of the terms' magnitudes; two
    launches identical."""
    x, grid = dasp640, dasp640["cfg"].grid
    labels = x["labels"][r]
    uv1 = slic._pixel_uv1(1, FULL["h"], FULL["w"], labels.device)
    validz = (x["raw"][..., 2:3] > 50.0).float()
    feats = (torch.cat([x["color"].float(), uv1, x["raw"], validz], -1)
             * (labels >= 0)[..., None]).contiguous()
    kw = dict(rows=grid.rows, cols=grid.cols, r=r)
    got = cuda_nasp.label_cell_sums(labels, feats, **kw)
    want = cuda_nasp.label_cell_sums_plain(labels, feats, **kw)
    scale = cuda_nasp.label_cell_sums_plain(labels, feats.abs(), **kw)
    assert cuda_nasp.sums_close(got, want, scale, (0, 1, 2, 3, 4, 5, 9))
    assert torch.equal(got, cuda_nasp.label_cell_sums(labels, feats, **kw))


@pytest.mark.parametrize("r, f", [(2, 2), (3, 2), (4, 1), (4, 4), (4, 7)])
def test_label_cell_gather_dasp_shapes_at_the_path_frame(dasp640, r, f):
    """label_cell_gather of the DASP window's centres (F = 2) at r = 2 and
    3, and over ERS labels at r = 4 of the SPDSP gate (F = 1), the PCA
    planes (F = 4) and the PCA merge's table (F = 7), bitwise."""
    x, grid = dasp640, dasp640["cfg"].grid
    labels = x["labels"][r]
    g = torch.Generator(device=labels.device).manual_seed(40 + f)
    table = torch.randn((1, grid.num_clusters, f), device=labels.device, generator=g) * 1e3
    kw = dict(rows=grid.rows, cols=grid.cols, r=r)
    got = cuda_nasp.label_cell_gather(labels, table, **kw)
    assert torch.equal(got, cuda_nasp.label_cell_gather_plain(labels, table, **kw))


@pytest.mark.parametrize("name", ["rgbf", "spdsp", "tof"])
def test_dasp_pipelines_640x480(dasp640, name):
    """rgbf_pipeline, spdsp_pipeline and tof_pipeline (default configs) on
    the card at 640x480: each launches the colour gradient, the label sums
    and the gather; the output against the JAX package's run of the frame
    (tests/golden/dasp_jax_640x480_seed0.npz, golden.dasp_jax_gates) and
    ground truth (tests/test_pipelines.py:68-80, :108-157)."""
    from kinectdepthmapenhancement_tpu_torch.models import pipelines
    from kinectdepthmapenhancement_tpu_torch.utils import golden, metrics

    x = dasp640
    d, p, c = x["depth"][0], x["raw"][0], x["color"][0]
    before = (cuda_gradient.launch_forms.get("seed_gradient:color", 0),
              cuda_nasp.launches["label_cell_sums"], cuda_nasp.launches["label_cell_gather"])
    res = (pipelines.rgbf_pipeline(d, p, c) if name == "rgbf"
           else getattr(pipelines, f"{name}_pipeline")(d, p, c, x["intr"]))
    torch.cuda.synchronize()
    after = (cuda_gradient.launch_forms.get("seed_gradient:color", 0),
             cuda_nasp.launches["label_cell_sums"], cuda_nasp.launches["label_cell_gather"])
    assert all(a > b for a, b in zip(after, before))
    got = {f: getattr(res, f).cpu().numpy() for f in res._fields}
    gates = golden.dasp_jax_gates(name, got, golden.load_dasp("640x480"))
    gt = x["gt"]
    if name == "rgbf":
        gates.update(golden.rgbf_quality_gates(got["refined_depth"], gt))
    elif name == "spdsp":
        gt_pts = projective_to_real(torch.from_numpy(gt).to(p.device), x["intr"])
        err_in, _ = metrics.mean_3d_error(p, gt_pts)
        err_ers, n = metrics.mean_3d_error(projective_to_real(res.refined_depth, x["intr"]),
                                           gt_pts)
        err_out, _ = metrics.mean_3d_error(res.optimized_points, gt_pts)
        gates.update(golden.spdsp_quality_gates(float(err_in), float(err_ers), float(err_out),
                                                int(n)))
    else:
        gates.update(golden.tof_quality_gates(got["plane_fitted"][..., 2], gt))
    assert not golden.failures(gates), gates


def test_registration_card_equals_cpu_and_jax(dev):
    """register_depth_to_color at 640x480 (a 2 degree rotation, a 25 mm
    baseline): the card's output bitwise equal to the CPU's (no float
    atomics: a scatter "amin"), and held against the JAX function's output
    of the same input (golden.registration_gates)."""
    from kinectdepthmapenhancement_tpu_torch.core.registration import (
        Extrinsics, register_depth_to_color,
    )
    from kinectdepthmapenhancement_tpu_torch.utils import golden

    intr = default_kinect_intrinsics(640, 480)
    _, noisy, _ = make_noisy_scene(480, 640, intr, seed=0)
    rot, t = (torch.from_numpy(a) for a in golden.registration_extrinsics())
    cpu = register_depth_to_color(torch.from_numpy(noisy), intr, intr, Extrinsics(rot, t))
    card = register_depth_to_color(torch.from_numpy(noisy).to(dev), intr, intr,
                                   Extrinsics(rot.to(dev), t.to(dev)))
    assert card.is_cuda and torch.equal(card.cpu(), cpu)
    gates = golden.registration_gates(card.cpu().numpy(), golden.load_jax_registration())
    assert not golden.failures(gates), gates


def test_evaluate_rows_card_against_cpu(dev):
    """utils/evaluate.py at 96x128 (grid 3x4) on the card: every row's
    mean 3-D error and RMSE within 1e-4 (relative) of the CPU's, valid
    pixels within 0.1%; the kde row launches every kernel."""
    from kinectdepthmapenhancement_tpu_torch.utils import evaluate

    intr = default_kinect_intrinsics(W, H)
    color, noisy, gt = make_noisy_scene(H, W, intr, seed=6)
    kw = dict(include_sp_methods=True, grid=GRID, timing_iters=1)
    before = cuda_cov.launches
    card = evaluate.evaluate(noisy, color, gt, device=dev, **kw)
    assert cuda_cov.launches > before
    cpu = evaluate.evaluate(noisy, color, gt, device="cpu", **kw)
    assert list(card) == list(cpu) == ["input", "jbf", "mrf", "rgbf", "kde", "spdsp", "tof"]
    for name in card:
        for k in ("mean_3d_error_mm", "rmse_mm"):
            assert card[name][k] == pytest.approx(cpu[name][k], rel=1e-4), (name, k)
        assert abs(card[name]["valid_px"] - cpu[name]["valid_px"]) <= 1e-3 * H * W, name


def _parallel_world1():
    """One NCCL rank on the card (multihost.spawn): the data-parallel step on
    two 96x128 frames and jbf_sharded at world 1, with their JBF launches."""
    from kinectdepthmapenhancement_tpu_torch.parallel import multihost, sharding
    from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import jbf_sharded

    mesh = multihost.global_mesh()
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    depth = multihost.local_batch_to_global(mesh, [s[1] for s in scenes]).local
    color = multihost.local_batch_to_global(mesh, [s[0] for s in scenes], extra_dims=1).local
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    before = cuda_bilateral.launches
    compiled = sharding.sharded_kde_step(mesh, intr, cfg)
    step = compiled(depth, color)  # its warm-up and capture: two JBF launches
    again = compiled(depth, color)  # a replay: none from Python
    mid = cuda_bilateral.launches
    jbf = jbf_sharded(depth, color, mesh, cfg.jbf)
    return {"backend": torch.distributed.get_backend(), "device": str(mesh.device),
            "step": step.cpu(), "again": again.cpu(), "jbf": jbf.cpu(),
            "launches": (mid - before, cuda_bilateral.launches - mid)}


def test_parallel_world1_nccl_on_the_card(dev, tmp_path):
    """World size 1 over NCCL (one spawned rank on the card): the compiled
    data-parallel step bitwise kde_pipeline at B=2 on its first call and on
    a replay (two JBF launches from Python: the warm-up's and the
    capture's), jbf_sharded bitwise the unsharded JBF with one launch."""
    from kinectdepthmapenhancement_tpu_torch.parallel import multihost

    (got,) = multihost.spawn(_parallel_world1, 1, store_dir=str(tmp_path), timeout_s=120)
    assert (got["backend"], got["device"], got["launches"]) == ("nccl", "cuda:0", (2, 1))
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    want = kde_pipeline(depth, color, intr, cfg).optimized_points
    assert torch.equal(got["step"], want.cpu()) and torch.equal(got["again"], want.cpu())
    assert torch.equal(got["jbf"], bilateral.joint_bilateral_filter(depth, color).cpu())


ODD_TILE = 77  # a tile width that is not a multiple of 4


def _parallel_odd_tiles():
    """Two gloo ranks sharing the card: jbf_sharded on 77-px tiles of two
    96x154 frames, gathered."""
    from kinectdepthmapenhancement_tpu_torch.parallel import halo
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh
    from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import jbf_sharded

    mesh = make_mesh(2, spatial=2, device="cuda")
    depth, color = _odd_frames(mesh.device)
    before = cuda_bilateral.launches
    tile = jbf_sharded(mesh.width_tile(depth), mesh.width_tile(color), mesh)
    return {"shape": tuple(tile.shape), "launches": cuda_bilateral.launches - before,
            "jbf": halo.gather_width(tile, mesh).cpu()}


def _odd_frames(device):
    intr = default_kinect_intrinsics(2 * ODD_TILE, H)
    scenes = [make_noisy_scene(H, 2 * ODD_TILE, intr, seed=s) for s in (0, 3)]
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(device)
    return depth, torch.from_numpy(np.stack([s[0] for s in scenes])).to(device)


def test_jbf_sharded_gloo_ranks_share_the_card_at_an_odd_tile_width(dev, tmp_path):
    """Two gloo ranks on the one card (strips staged through the host):
    jbf_sharded on 77-px tiles bitwise equal to the unsharded JBF, one
    kernel launch a rank."""
    from kinectdepthmapenhancement_tpu_torch.parallel import multihost

    ranks = multihost.spawn(_parallel_odd_tiles, 2, device="cuda", backend="gloo",
                            store_dir=str(tmp_path), timeout_s=120)
    assert [(r["shape"], r["launches"]) for r in ranks] == [((2, H, ODD_TILE), 1)] * 2
    depth, color = _odd_frames(dev)
    assert torch.equal(ranks[0]["jbf"], bilateral.joint_bilateral_filter(depth, color).cpu())


def _never_reached():
    raise AssertionError("a rank ran past initialize")


def test_nccl_with_more_ranks_than_cards_raises(dev, tmp_path):
    """NCCL refuses two ranks on one card: initialize raises on every rank
    before init_process_group, so the run fails at once instead of hanging;
    dryrun refuses in the parent."""
    import time

    from kinectdepthmapenhancement_tpu_torch.parallel import multihost, sharding

    n = torch.cuda.device_count() + 1
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        multihost.spawn(_never_reached, n, store_dir=str(tmp_path), timeout_s=120)
    assert time.monotonic() - t0 < 90
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        sharding.dryrun(n)


# width tiles of the tiled KDE route (parallel/sharding.py): (c0, tile
# cols) of a 4-column grid at x = 2 (the second tile) and x = 4 (the
# second, the last), and x = 2's first tile
CELL_TILES = [(2, 2), (1, 1), (3, 1), (0, 2)]
CELL_TILE_IDS = ["x2s1", "x4s1", "x4s3", "x2s0"]


def _tile_cols(t, c0, tc, cell_w):
    return t[:, :, c0 * cell_w:(c0 + tc) * cell_w].contiguous()


def _tile_part(part, grid, c0, tc, n=64):
    b, _, f = part.shape
    return part.reshape(b, grid.rows, grid.cols, n, f)[:, :, c0:c0 + tc].reshape(b, -1, f)


@pytest.mark.parametrize("c0, tc", CELL_TILES, ids=CELL_TILE_IDS)
def test_nasp_kernels_on_a_width_tile(nasp, c0, tc):
    """The four NASP cell kernels on a width tile of whole cells (c0, tile
    cols; the global grid's candidates, global u): the fused assignment's
    labels and distance and the gather bitwise their plain versions on the
    tile, the sums to sums_close; and each bitwise the full-frame kernel's
    cells and columns (a cell reads only its own pixels and the global
    tables, so the tile form keeps the c0 = 0 bits)."""
    x, cl, grid = nasp, nasp["clusters"], nasp["grid"]
    cw = W // grid.cols
    tile = dict(c0=c0, tile_cols=tc)
    t = [_tile_cols(a, c0, tc, cw) for a in (x["cf"], x["points"], x["nmap"])]
    akw = dict(lo=x["lo"], hi=x["hi"], **x["akw"])
    full = cuda_nasp.nasp_assign_and_analyze(x["cf"], x["points"], x["nmap"], x["cand"], **akw)
    got = cuda_nasp.nasp_assign_and_analyze(*t, x["cand"], **akw, **tile)
    want = cuda_nasp.nasp_assign_and_analyze_plain(*t, x["cand"], **akw, **tile)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lab_t = got[0]
    xy = x["cand"][..., 3:5].contiguous()
    kw = dict(x["cell"], lo=x["lo"], hi=x["hi"], mode="analyze", **tile)
    scale = cuda_nasp.nasp_cell_sums_plain(lab_t, *t, xy, abs_terms=True, **kw)
    assert cuda_nasp.sums_close(got[2], want[2], scale, cuda_nasp.INTEGER_FEATURES["analyze"])
    assert torch.equal(got[0], _tile_cols(full[0], c0, tc, cw))
    assert torch.equal(got[2], _tile_part(full[2], grid, c0, tc))

    p = x["params"]
    for mode in ("analyze", "weighted"):
        fields = cl.xy.float() if mode == "analyze" else torch.cat(
            [cl.xy.float(), cl.rgb, cl.normal], -1)
        fields = fields.reshape(2, grid.rows, grid.cols, -1).contiguous()
        kw = dict(x["cell"], lo=x["lo"], hi=x["hi"], mode=mode, color_sigma=p.color_sigma,
                  spatial_sigma=p.spatial_sigma)
        g = cuda_nasp.nasp_cell_sums(lab_t, *t, fields, **kw, **tile)
        w_ = cuda_nasp.nasp_cell_sums_plain(lab_t, *t, fields, **kw, **tile)
        s_ = cuda_nasp.nasp_cell_sums_plain(lab_t, *t, fields, abs_terms=True, **kw, **tile)
        f_ = cuda_nasp.nasp_cell_sums(x["labels"], x["cf"], x["points"], x["nmap"], fields, **kw)
        torch.cuda.synchronize()
        assert cuda_nasp.sums_close(g, w_, s_, cuda_nasp.INTEGER_FEATURES[mode]), mode
        assert torch.equal(g, _tile_part(f_, grid, c0, tc)), mode

    rng = np.random.default_rng(8)
    feats = torch.tensor(rng.normal(size=(2, H, W, 2)).astype(np.float32), device=x["cf"].device)
    feats = (feats * (x["labels"] >= 0)[..., None]).contiguous()
    f_t = _tile_cols(feats, c0, tc, cw)
    g = cuda_nasp.label_cell_sums(lab_t, f_t, **x["cell"], **tile)
    w_ = cuda_nasp.label_cell_sums_plain(lab_t, f_t, **x["cell"], **tile)
    s_ = cuda_nasp.label_cell_sums_plain(lab_t, f_t.abs(), **x["cell"], **tile)
    f_ = cuda_nasp.label_cell_sums(x["labels"], feats, **x["cell"])
    torch.cuda.synchronize()
    assert cuda_nasp.sums_close(g, w_, s_)
    assert torch.equal(g, _tile_part(f_, grid, c0, tc))
    table = torch.tensor(rng.normal(size=(2, grid.num_clusters, 6)).astype(np.float32) * 1e3,
                         device=x["cf"].device)
    for tab in (table, table[..., 2:3].contiguous(), table[..., :3].contiguous()):
        g = cuda_nasp.label_cell_gather(lab_t, tab, **x["cell"], **tile)
        torch.cuda.synchronize()
        assert torch.equal(g, cuda_nasp.label_cell_gather_plain(lab_t, tab, **x["cell"], **tile))
        assert torch.equal(g, _tile_cols(cuda_nasp.label_cell_gather(x["labels"], tab,
                                                                     **x["cell"]), c0, tc, cw))


@pytest.mark.parametrize("x", [2, 4])
def test_dt_and_cov_kernels_on_haloed_tiles(inputs, x):
    """The DT and covariance kernels on each haloed width tile that
    parallel/stencil_shard.haloed_normals hands them (27 columns of points
    each side, none past the frame): bitwise their plain versions; and the
    tile's CM normals on the card bitwise the full frame's columns."""
    from kinectdepthmapenhancement_tpu_torch.parallel import stencil_shard
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh

    p = KDEConfig().normals
    r = stencil_shard.normals_halo(p)
    points = inputs["vm"] * 1000.0
    want = normals.generate_normal_map(points, p)
    ws = W // x
    for s in range(x):
        lo, hi = max(0, s * ws - r), min(W, (s + 1) * ws + r)
        vm = inputs["vm"][:, :, lo:hi].contiguous()
        dci = normals.dci_map(vm, p.max_depth_change_factor).contiguous()
        got = cuda_dt.distance_transform(dci, p.dt_iterations)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_dt.distance_transform_plain(dci, p.dt_iterations)), s
        rect = normals.smoothing_map(vm, p).to(torch.int32).contiguous()
        cnt, cov = cuda_cov.cm_covariances(vm, rect)
        cnt_p, cov_p = cuda_cov.cm_covariances_plain(vm, rect)
        torch.cuda.synchronize()
        assert torch.equal(cnt, cnt_p) and _same_bits(cov, cov_p), s
        padded = torch.nn.functional.pad(points, (0, 0, r, r))[:, :, s * ws:s * ws + ws + 2 * r]
        mesh = dataclasses.replace(make_mesh(device=str(points.device)), x=x, s=s)
        got = stencil_shard.haloed_normals(padded, mesh, p, s * ws, W)
        assert torch.equal(got, want[:, :, s * ws:(s + 1) * ws]), s


# width tiles of the 640x480 path's 20-column grid: x = 2's second tile,
# x = 4's second and last
TILES_640 = [(10, 10), (5, 5), (15, 5)]
TILE_640_IDS = ["x2s1", "x4s1", "x4s3"]


@pytest.mark.parametrize("c0, tc", TILES_640, ids=TILE_640_IDS)
def test_other_configs_cell_forms_on_a_width_tile(frame640, c0, tc):
    """The cell-kernel forms the other configs' tiled steps add, at 640x480
    on a width tile of whole 32-px cells: the NASP sums at r = 5 (both
    modes) on three-iteration labels, the label sums at F = 4 and 6 (r = 4,
    merge_planes) and F = 2 at r = 5 (the residual), the gathers at
    F = 6, 3, 1 at r = 5 and F = 2 at r = 4 (the trust table): each
    against its plain version on the tile (sums to sums_close, gathers
    bitwise) and bitwise the full frame's kernel's cells and columns."""
    x, grid = frame640, frame640["cfg"].grid
    cw = FULL["w"] // grid.cols
    tile = dict(c0=c0, tile_cols=tc)
    t = [_tile_cols(a, c0, tc, cw) for a in (x["cf"], x["points"], x["nmap"])]
    p = x["cfg"].nasp
    lab5 = x["labels"][5]
    lab5_t = _tile_cols(lab5, c0, tc, cw)
    cl = x["clusters"][5]
    for mode in ("analyze", "weighted"):
        fields = cl.xy.float() if mode == "analyze" else torch.cat(
            [cl.xy.float(), cl.rgb, cl.normal], -1)
        fields = fields.reshape(1, grid.rows, grid.cols, -1).contiguous()
        kw = dict(rows=grid.rows, cols=grid.cols, r=5, lo=-40, hi=39, mode=mode,
                  color_sigma=p.color_sigma, spatial_sigma=p.spatial_sigma)
        g = cuda_nasp.nasp_cell_sums(lab5_t, *t, fields, **kw, **tile)
        w_ = cuda_nasp.nasp_cell_sums_plain(lab5_t, *t, fields, **kw, **tile)
        s_ = cuda_nasp.nasp_cell_sums_plain(lab5_t, *t, fields, abs_terms=True, **kw, **tile)
        f_ = cuda_nasp.nasp_cell_sums(lab5, x["cf"], x["points"], x["nmap"], fields, **kw)
        torch.cuda.synchronize()
        assert cuda_nasp.sums_close(g, w_, s_, cuda_nasp.INTEGER_FEATURES[mode]), mode
        assert torch.equal(g, _tile_part(f_, grid, c0, tc, n=100)), mode
    for r, f in ((4, 4), (4, 6), (5, 2)):
        labels = x["labels"][r]
        g_ = torch.Generator(device=labels.device).manual_seed(20 + f)
        feats = torch.randn((1, FULL["h"], FULL["w"], f), device=labels.device, generator=g_)
        feats = (feats * (x["points"][..., 2:3] > 50.0)).contiguous()
        lab_t, f_t = _tile_cols(labels, c0, tc, cw), _tile_cols(feats, c0, tc, cw)
        kw = dict(rows=grid.rows, cols=grid.cols, r=r)
        got = cuda_nasp.label_cell_sums(lab_t, f_t, **kw, **tile)
        want = cuda_nasp.label_cell_sums_plain(lab_t, f_t, **kw, **tile)
        scale = cuda_nasp.label_cell_sums_plain(lab_t, f_t.abs(), **kw, **tile)
        full = cuda_nasp.label_cell_sums(labels, feats, **kw)
        torch.cuda.synchronize()
        assert cuda_nasp.sums_close(got, want, scale), (r, f)
        assert torch.equal(got, _tile_part(full, grid, c0, tc, n=(2 * r) ** 2)), (r, f)
    for r, f in ((5, 6), (5, 3), (5, 1), (4, 2)):
        labels = x["labels"][r]
        lab_t = _tile_cols(labels, c0, tc, cw)
        g_ = torch.Generator(device=labels.device).manual_seed(30 + f)
        table = torch.randn((1, grid.num_clusters, f), device=labels.device, generator=g_) * 1e3
        kw = dict(rows=grid.rows, cols=grid.cols, r=r)
        got = cuda_nasp.label_cell_gather(lab_t, table, **kw, **tile)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_nasp.label_cell_gather_plain(lab_t, table, **kw, **tile))
        assert torch.equal(got, _tile_cols(cuda_nasp.label_cell_gather(labels, table, **kw),
                                           c0, tc, cw)), (r, f)


@pytest.mark.parametrize("method", ["bilateral", "sdc"])
def test_bilateral_and_sdc_normals_on_haloed_tiles(inputs, method):
    """stencil_shard.haloed_normals on the card under the bilateral and SDC
    normals (SDC's DT kernel on the 27-column haloed tile, its tables from
    the whole frame's depth): bitwise the full frame's columns, at x = 2
    and 4."""
    from kinectdepthmapenhancement_tpu_torch.parallel import stencil_shard
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh

    p = dataclasses.replace(KDEConfig().normals, method=method)
    r = stencil_shard.normals_halo(p)
    points = inputs["vm"] * 1000.0
    want = normals.generate_normal_map(points, p)
    frame_z = points[..., 2].contiguous() if method == "sdc" else None
    for x in (2, 4):
        ws = W // x
        for s in range(x):
            padded = torch.nn.functional.pad(points, (0, 0, r, r))[:, :, s * ws:s * ws + ws + 2 * r]
            mesh = dataclasses.replace(make_mesh(device=str(points.device)), x=x, s=s)
            got = stencil_shard.haloed_normals(padded, mesh, p, s * ws, W, frame_z=frame_z)
            assert torch.equal(got, want[:, :, s * ws:(s + 1) * ws]), (x, s)


@pytest.mark.parametrize("x", [2, 4])
def test_seed_gradient_on_haloed_tiles_at_kinect_v2(dev, x):
    """The seed gradient kernel on each width tile of a 424x512 Kinect v2
    frame (grid 15x20 does not divide it: the tiled route's haloed form),
    its colour and normals padded with GRAD_MARGIN = 5 columns of the
    neighbouring tiles and none past the frame (CellTile.haloed): bitwise
    its plain version on the haloed tile, the tile's columns bitwise the
    whole frame's kernel, and the seed windows read from the tiles give
    the whole frame's seeds."""
    from kinectdepthmapenhancement_tpu_torch.parallel import halo
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh

    h, w = 424, 512
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    cfg = KDEConfig()
    c = torch.from_numpy(color).to(dev)[None]
    d = torch.from_numpy(noisy).to(dev)[None]
    points = projective_to_real(bilateral.joint_bilateral_filter(d, c, cfg.jbf), intr)
    nmap = normals.generate_normal_map(points, cfg.normals).contiguous()
    cf = c.float().contiguous()
    full = cuda_gradient.seed_gradient(cf, nmap)
    m = slic.GRAD_MARGIN
    padded_frame = torch.nn.functional.pad(torch.cat([cf, nmap], -1), (0, 0, m, m))
    ws = w // x
    tiles = []
    for s in range(x):
        mesh = dataclasses.replace(make_mesh(device=str(dev)), x=x, s=s)
        padded, left = halo.drop_global_edges(padded_frame[:, :, s * ws:s * ws + ws + 2 * m],
                                              m, mesh)
        cpad, npad = padded[..., :3].contiguous(), padded[..., 3:].contiguous()
        got = cuda_gradient.seed_gradient(cpad, npad, "halo")
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_gradient.seed_gradient_plain(cpad, npad)), s
        tiles.append(got[:, :, left:left + ws])
        assert torch.equal(tiles[-1], full[:, :, s * ws:(s + 1) * ws]), s
    g = torch.cat(tiles, dim=2)
    yy, xx = slic._seed_windows(cfg.grid, h, w, 8, dev)
    assert torch.equal(slic._window_argmin(g[:, yy, xx], yy, xx, cfg.grid.num_clusters),
                       slic.sample_seeds(full, cfg.grid, h, w, 8))


# cell-aligned tiles (c0, tile cols) of the 640x480 path's 20-column grid at
# x = 8, whose 80-px data tiles split the 32-px cells: the first, second and
# last
UNEVEN_640 = [(0, 3), (3, 2), (18, 2)]
UNEVEN_640_IDS = ["x8s0", "x8s1", "x8s7"]


@pytest.mark.parametrize("c0, tc", UNEVEN_640, ids=UNEVEN_640_IDS)
def test_nasp_kernels_on_uneven_cell_aligned_tiles(frame640, c0, tc):
    """The four NASP cell kernels on the uneven cell-aligned tiles of x = 8
    at 640x480 (3 and 2 cells): the fused assignment's labels and distance
    and the gathers (F = 6, 1, 3) bitwise their plain versions on the
    tile, the sums (the analyze partials, the weighted sums, the label sums
    at F = 2) to sums_close; and each bitwise the full frame's kernel's
    cells and columns."""
    x, grid = frame640, frame640["cfg"].grid
    h, w = FULL["h"], FULL["w"]
    cw = w // grid.cols
    tile = dict(c0=c0, tile_cols=tc)
    t = [_tile_cols(a, c0, tc, cw) for a in (x["cf"], x["points"], x["nmap"])]
    p = x["cfg"].nasp
    seeds = slic._compute_seeds(x["cf"], x["nmap"], grid, h, w, 8)
    cl = slic.init_clusters(seeds, x["color"], x["points"], x["nmap"])
    s_scale, (lo, hi) = slic._update_geometry(grid, h, w, "nasp")
    cand, akw = slic._assign_args(cl, grid, p, s_scale)
    full = cuda_nasp.nasp_assign_and_analyze(x["cf"], x["points"], x["nmap"], cand, lo=lo,
                                             hi=hi, **akw)
    got = cuda_nasp.nasp_assign_and_analyze(*t, cand, lo=lo, hi=hi, **akw, **tile)
    want = cuda_nasp.nasp_assign_and_analyze_plain(*t, cand, lo=lo, hi=hi, **akw, **tile)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cell = dict(rows=grid.rows, cols=grid.cols, r=4)
    kw = dict(cell, lo=lo, hi=hi, mode="analyze", **tile)
    scale = cuda_nasp.nasp_cell_sums_plain(got[0], *t, cand[..., 3:5].contiguous(),
                                           abs_terms=True, **kw)
    assert cuda_nasp.sums_close(got[2], want[2], scale, cuda_nasp.INTEGER_FEATURES["analyze"])
    assert torch.equal(got[0], _tile_cols(full[0], c0, tc, cw))
    assert torch.equal(got[1], _tile_cols(full[1], c0, tc, cw))
    assert torch.equal(got[2], _tile_part(full[2], grid, c0, tc))

    labels, one = x["labels"][4], x["clusters"][4]
    lab_t = _tile_cols(labels, c0, tc, cw)
    fields = torch.cat([one.xy.float(), one.rgb, one.normal], -1).reshape(
        1, grid.rows, grid.cols, -1).contiguous()
    kw = dict(cell, lo=lo, hi=hi, mode="weighted", color_sigma=p.color_sigma,
              spatial_sigma=p.spatial_sigma)
    g = cuda_nasp.nasp_cell_sums(lab_t, *t, fields, **kw, **tile)
    w_ = cuda_nasp.nasp_cell_sums_plain(lab_t, *t, fields, **kw, **tile)
    s_ = cuda_nasp.nasp_cell_sums_plain(lab_t, *t, fields, abs_terms=True, **kw, **tile)
    f_ = cuda_nasp.nasp_cell_sums(labels, x["cf"], x["points"], x["nmap"], fields, **kw)
    torch.cuda.synchronize()
    assert cuda_nasp.sums_close(g, w_, s_, cuda_nasp.INTEGER_FEATURES["weighted"])
    assert torch.equal(g, _tile_part(f_, grid, c0, tc))

    z = x["points"][..., 2]
    ok = ((z > 50.0) & (labels >= 0)).float()
    feats = torch.stack([(z * 1e-3) ** 2 * ok, ok], -1).contiguous()
    f_t = _tile_cols(feats, c0, tc, cw)
    g = cuda_nasp.label_cell_sums(lab_t, f_t, **cell, **tile)
    w_ = cuda_nasp.label_cell_sums_plain(lab_t, f_t, **cell, **tile)
    s_ = cuda_nasp.label_cell_sums_plain(lab_t, f_t.abs(), **cell, **tile)
    f_ = cuda_nasp.label_cell_sums(labels, feats, **cell)
    torch.cuda.synchronize()
    assert cuda_nasp.sums_close(g, w_, s_)
    assert torch.equal(g, _tile_part(f_, grid, c0, tc))
    table = torch.cat([one.center, one.normal], -1).contiguous()
    for tab in (table, table[..., 2:3].contiguous(), table[..., :3].contiguous()):
        g = cuda_nasp.label_cell_gather(lab_t, tab, **cell, **tile)
        torch.cuda.synchronize()
        assert torch.equal(g, cuda_nasp.label_cell_gather_plain(lab_t, tab, **cell, **tile))
        assert torch.equal(g, _tile_cols(cuda_nasp.label_cell_gather(labels, tab, **cell),
                                         c0, tc, cw))


# ---- the compiled call (core/jit.py): replays bitwise the eager call

def _iter3(cfg, locality):
    return dataclasses.replace(cfg, nasp=dataclasses.replace(
        cfg.nasp, iterations=3, locality=locality))


def _jit_configs():
    base = dataclasses.replace(KDEConfig(), grid=GRID)

    def nm(method):
        return dataclasses.replace(base, normals=dataclasses.replace(base.normals, method=method))

    return {
        "default": base, "sdc": nm("sdc"), "bilateral": nm("bilateral"),
        "plane_merge_fill": dataclasses.replace(base, plane_merge=True, fill_holes=4),
        "iter3_auto": _iter3(base, "auto"), "iter3_global": _iter3(base, "global"),
        "grid5x6": dataclasses.replace(base, grid=GridParams(5, 6)),
    }


JIT_CONFIGS = _jit_configs()


def _replays_equal_eager(fn, args):
    """fn through jit twice against the eager fn(*args): each replay's every
    field bitwise the eager call's, and the two replays' outputs other
    tensors (no later replay overwrites an earlier output)."""
    from kinectdepthmapenhancement_tpu_torch.core import jit

    jit.clear()
    try:
        eager = fn(*args)
        f = jit.jit(fn)
        a, b = f(*args), f(*args)
        torch.cuda.synchronize()
        (key,) = jit.keys()  # reads the conds' branches taken into kernels_replayed
        assert jit.stats == {"captures": 1, "replays": 2, "host_steps": 0,
                             "kernels_replayed": key["kernels_replayed"]}
        if not key["conds"]:
            assert key["kernels_replayed"] == 2 * key["kernels"]
        for k in eager._fields:
            want, ga, gb = getattr(eager, k), getattr(a, k), getattr(b, k)
            assert torch.equal(ga, want) and torch.equal(gb, want), k
            assert ga.data_ptr() != gb.data_ptr(), k
        return jit.keys()[0]
    finally:
        jit.clear()


@pytest.mark.parametrize("name", list(JIT_CONFIGS))
def test_jit_replay_equals_eager(inputs, name):
    key = _replays_equal_eager(
        kde_pipeline, (inputs["depth"], inputs["color"], inputs["intr"], JIT_CONFIGS[name]))
    assert key["conds"] == (3 if name == "iter3_auto" else 0)


@pytest.mark.parametrize("bsz", [1, 4])
def test_jit_replay_equals_eager_at_640x480(dev, bsz):
    h, w = FULL["h"], FULL["w"]
    intr = default_kinect_intrinsics(w, h)
    scenes = [make_noisy_scene(h, w, intr, seed=s) for s in range(bsz)]
    c = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    d = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    if bsz == 1:
        c, d = c[0], d[0]
    _replays_equal_eager(kde_pipeline, (d, c, intr, KDEConfig()))


def test_capped_index_device_branch_both_ways(dev):
    """A jitted with_capped_index takes the conditional node's IF branch on
    labels that hold the cap and its ELSE branch on labels that break it,
    each bitwise the eager host branch, each counted on the device."""
    from kinectdepthmapenhancement_tpu_torch.core import jit

    grid = GridParams(12, 16)  # 8-px cells: a 64-px move breaks the cap of 5
    labels = slic.init_labels(grid, H, W, dev).expand(2, H, W).contiguous()
    broken = labels.clone()
    broken[:, : H // 2] = torch.roll(labels[:, : H // 2], shifts=W // 2, dims=-1)
    feats = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    table = torch.rand((2, grid.num_clusters, 2), generator=torch.Generator().manual_seed(1))
    table = table.to(dev)

    def capped(lab, x):
        return slic.with_capped_index(
            lambda idx: (idx.segment_sum(x, lab >= 0), idx.gather(table), idx.counts()),
            lab, grid, 5)

    assert slic._within_cap(labels, grid, 5, H, W) and not slic._within_cap(broken, grid, 5, H, W)
    jit.clear()
    try:
        f = jit.jit(capped)
        for lab in (labels, broken, labels):
            got, want = f(lab, feats), capped(lab, feats)
            assert all(torch.equal(g, e) for g, e in zip(got, want))
        assert jit.keys()[0]["taken"] == [[2, 1]]
    finally:
        jit.clear()


def test_jit_of_a_host_read_raises(dev):
    from kinectdepthmapenhancement_tpu_torch.core import jit

    def host_read(x):
        return x * x.sum().item()

    x = torch.ones(8, device=dev)
    jit.clear()
    with pytest.raises(Exception):
        jit.jit(host_read)(x)
    assert jit.stats["captures"] == 0
    assert torch.equal(jit.jit(lambda y: y * 2.0)(x), x * 2.0)  # the card runs on
    jit.clear()


def _dasp_case(name, h, w, dev):
    """(fn, args) of rgbf / spdsp / tof_pipeline on make_noisy_scene(h, w,
    seed=0) on the card with its raw points: grid 3x4 at 96x128, the
    default config at 640x480."""
    from kinectdepthmapenhancement_tpu_torch.core.config import (
        RGBFConfig, SPDSPConfig, TOFConfig,
    )
    from kinectdepthmapenhancement_tpu_torch.models import pipelines

    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    c, d = torch.from_numpy(color).to(dev), torch.from_numpy(noisy).to(dev)
    cfg = {"rgbf": RGBFConfig(), "spdsp": SPDSPConfig(), "tof": TOFConfig()}[name]
    if h == H:
        cfg = dataclasses.replace(cfg, grid=GRID)
    rest = (cfg,) if name == "rgbf" else (intr, cfg)
    return getattr(pipelines, f"{name}_pipeline"), (d, projective_to_real(d, intr), c) + rest


@pytest.mark.parametrize("size", ["96x128", "640x480"])
@pytest.mark.parametrize("name", ["rgbf", "spdsp", "tof"])
def test_jit_dasp_pipelines_replay_equals_eager(dev, name, size):
    """RGBF, SPDSP and TOF through jit, replayed twice, bitwise the eager
    call with no output shared: RGBF holds no cond, SPDSP and TOF nine
    (four later iterations of each SLIC and the ERS labels' index)."""
    h, w = (H, W) if size == "96x128" else (FULL["h"], FULL["w"])
    key = _replays_equal_eager(*_dasp_case(name, h, w, dev))
    assert key["conds"] == (0 if name == "rgbf" else 9)


def test_ers_index_device_branch_both_ways(dev):
    """SPDSP's ERS-index cond (pipelines._with_local_index) under jit takes
    IF on labels within cap 4 and ELSE on labels that break it, each
    bitwise the eager host branch, each counted on the device."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.core.config import SPDSPConfig
    from kinectdepthmapenhancement_tpu_torch.models import pipelines
    from kinectdepthmapenhancement_tpu_torch.ops import plane

    grid = GridParams(12, 16)  # 8-px cells: a 64-px move breaks the cap of 4
    cfg = dataclasses.replace(SPDSPConfig(), grid=grid)
    labels = slic.init_labels(grid, H, W, dev).expand(2, H, W).contiguous()
    broken = labels.clone()
    broken[:, : H // 2] = torch.roll(labels[:, : H // 2], shifts=W // 2, dims=-1)
    intr = default_kinect_intrinsics(W, H)
    depth = torch.stack([torch.from_numpy(make_noisy_scene(H, W, intr, seed=s)[1])
                         for s in (0, 3)]).to(dev)
    points = projective_to_real(depth, intr)

    def planes(lab, pts):
        return pipelines._with_local_index(
            lambda idx: plane.pca_planes(pts, lab, grid.num_clusters, index=idx), lab, cfg)

    jit.clear()
    try:
        f = jit.jit(planes)
        for lab in (labels, broken, labels):
            got, want = f(lab, points), planes(lab, points)
            assert all(torch.equal(g, e) for g, e in zip(got, want))
        assert jit.keys()[0]["conds"] == 1 and jit.keys()[0]["taken"] == [[2, 1]]
    finally:
        jit.clear()


def test_jit_of_a_host_seed_override_raises(dev):
    """slic.segment's seed override of host data raises inside a jit call;
    the same seeds as a tensor on the card replay bitwise the eager call."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.core.config import RGBFConfig

    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=0)
    c = torch.from_numpy(color).to(dev)[None]
    p = projective_to_real(torch.from_numpy(noisy).to(dev)[None], intr)
    params = RGBFConfig().color_slic
    seeds = slic.segment(c, p, grid=GRID, params=params, variant="dasp").clusters.xy[0]

    def seg(s):
        return lambda cc, pp: slic.segment(cc, pp, grid=GRID, params=params, variant="dasp",
                                           seeds=s).labels

    jit.clear()
    try:
        with pytest.raises(TypeError, match="device tensor"):
            jit.jit(seg(seeds.tolist()))(c, p)
        assert torch.equal(jit.jit(seg(seeds))(c, p), seg(seeds)(c, p))
    finally:
        jit.clear()


def _through_host(x):
    """A host step's function: x read on the host, doubled there."""
    return [x.cpu() * 2.0]


def test_jit_host_steps_between_graph_pieces(dev):
    """Two host steps (jit.collective) moving tensors through the CPU split
    a jit call into three graph pieces: two replays on new inputs are
    bitwise the eager call, each runs both steps, and the eager call counts
    its steps too."""
    from kinectdepthmapenhancement_tpu_torch.core import jit

    def fn(x):
        (z,) = jit.collective(_through_host, x + 1.0)
        (y,) = jit.collective(_through_host, z * 3.0)
        return y - x, z

    x = torch.rand(3, 1000, generator=torch.Generator().manual_seed(0)).to(dev)
    jit.clear()
    try:
        f = jit.jit(fn)
        for arg in (x, x * 2.0, x - 5.0):
            before = jit.stats["host_steps"]
            want = fn(arg)
            eager_steps = jit.stats["host_steps"] - before
            got = f(arg)
            torch.cuda.synchronize()
            assert all(torch.equal(g, e) for g, e in zip(got, want))
            assert eager_steps == 2
        (key,) = jit.keys()
        assert (key["pieces"], key["host_steps"], key["conds"], key["host_branches"]) == (3, 2, 0, 0)
        # 3 eager calls, the warm-up's 2 and 3 replays: none in the capture
        assert jit.stats == {"captures": 1, "replays": 3, "host_steps": 3 * 2 + 2 + 3 * 2,
                             "kernels_replayed": 3 * key["kernels"]}
    finally:
        jit.clear()


@pytest.mark.parametrize("verdict", ["host_step", "device"])
def test_jit_cond_with_host_steps_is_a_host_branch(dev, verdict):
    """A jit.cond whose IF branch makes a host step is a host branch: taken
    both ways, bitwise the eager call each way, its branches counted on the
    host, one host step more on the IF way.  The pred comes out of a host
    step (the host keeps its value) or off the card (read at replay)."""
    from kinectdepthmapenhancement_tpu_torch.core import jit

    def fn(x, t):
        if verdict == "host_step":
            (pred,) = jit.collective(lambda p: [(p.cpu() > 0).all()], t)
        else:
            pred = (t > 0).all()
        return jit.cond(pred, lambda a: jit.collective(_through_host, a + 1.0)[0],
                        lambda a: a - 1.0, x)

    x = torch.rand(2, 500, generator=torch.Generator().manual_seed(1)).to(dev)
    pos, neg = torch.ones(4, device=dev), -torch.ones(4, device=dev)
    jit.clear()
    try:
        f = jit.jit(fn)
        steps = []
        for t in (pos, neg, pos):
            want = fn(x, t)
            before = jit.stats["host_steps"]
            got = f(x, t)
            torch.cuda.synchronize()
            steps.append(jit.stats["host_steps"] - before)
            assert torch.equal(got, want)
        (key,) = jit.keys()
        assert key["host_branches"] == 1 and key["conds"] == 0
        assert key["host_taken"] == [[2, 1]]
        own = int(verdict == "host_step")  # the verdict's own step
        # the first call warms up (the verdict's step and both branches')
        # and replays; the capture runs none
        assert steps == [2 * own + 2, own, own + 1]
    finally:
        jit.clear()


def test_jit_cond_without_host_step_stays_a_conditional_node(dev):
    """In a call with a host step, a cond whose branches make none is still
    a conditional node, taken on the device both ways."""
    from kinectdepthmapenhancement_tpu_torch.core import jit

    def fn(x, t):
        (y,) = jit.collective(_through_host, x)
        return jit.cond((t > 0).all(), lambda a: a + 1.0, lambda a: a - 1.0, y)

    x = torch.rand(2, 500, generator=torch.Generator().manual_seed(2)).to(dev)
    pos, neg = torch.ones(4, device=dev), -torch.ones(4, device=dev)
    jit.clear()
    try:
        f = jit.jit(fn)
        for t in (pos, neg, pos):
            assert torch.equal(f(x, t), fn(x, t))
        (key,) = jit.keys()
        assert (key["conds"], key["host_branches"], key["pieces"]) == (1, 0, 2)
        assert key["taken"] == [[2, 1]]
    finally:
        jit.clear()


# ---- telemetry (utils/telemetry.py): stamps inside the graphs, replays' kernels

def _kernels_profiled(fn):
    """The kernels fn runs on the card, as the profiler sees them: copies
    and fills left out, CUDA's own copy kernels among them (a copy
    node inside a conditional body runs as memcpy32_post)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation()
               and not ev.name().lower().startswith(("memcpy", "memset")))


def _replay_stages(rec):
    """Each replay's stamped stages, in order, from collected records."""
    out, cur = [], None
    for st in rec.stamps:
        if st.stage == "jit.graph":
            if not st.exit:
                cur = []
            else:
                out.append(cur)
                cur = None
        elif cur is not None and not st.exit:
            cur.append(st.stage)
    return out


def _b1_kde(inputs):
    return (inputs["depth"][:1].contiguous(), inputs["color"][:1].contiguous(), inputs["intr"],
            JIT_CONFIGS["default"])


def test_telemetry_off_capture_holds_no_stamp(inputs):
    """A B=1 kde_pipeline captured with telemetry off holds no kde_stamp
    node, and its kernel nodes are what a replay of its graph runs."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.utils import telemetry

    args = _b1_kde(inputs)
    telemetry.disable()
    telemetry.collect()
    jit.clear()
    try:
        f = jit.jit(kde_pipeline)
        f(*args)
        graph = next(iter(f.cache.values()))
        replay = _kernels_profiled(lambda: [item.run(graph.dev) for item in graph.items])
        (key,) = jit.keys()
        assert key["stamps"] == 0 and telemetry.stamps_launched == 0
        assert key["kernels"] == replay
        # one call replayed through the jit (the profiled run bypasses it)
        assert key["kernels_replayed"] == jit.stats["kernels_replayed"] == key["kernels"]
        assert telemetry.collect().stamps == []
    finally:
        jit.clear()


def test_telemetry_on_stamps_each_stage_on_the_shared_clock(inputs):
    """Captured with telemetry on, the same call holds two stamps a stage
    (the six kde.* stages and jit.graph) and the same kernels otherwise; a
    replay runs them all; each replay's first stamp lies after its
    jit.launch span opens, on the host's clock within the fit's error."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.utils import telemetry

    args = _b1_kde(inputs)
    jit.clear()
    telemetry.disable()
    try:
        f = jit.jit(kde_pipeline)
        f(*args)
        (off,) = jit.keys()
        jit.clear()
        telemetry.collect()
        telemetry.enable()
        f = jit.jit(kde_pipeline)
        for _ in range(3):
            f(*args)
        graph = next(iter(f.cache.values()))
        replay = _kernels_profiled(lambda: [item.run(graph.dev) for item in graph.items])
        (key,) = jit.keys()
        rec = telemetry.collect()
        stages = ["kde.jbf", "kde.jbf", "kde.normals", "kde.nasp", "kde.ccl_merge",
                  "kde.projection"]
        assert key["stamps"] == 2 * (len(stages) + 1)
        assert key["kernels"] == off["kernels"] and replay == key["kernels"] + key["stamps"]
        assert _replay_stages(rec) == [stages] * 4
        assert rec.stamps_lost == 0 and 0 < rec.clock_error_ns < 20_000
        launches = [s for s in rec.spans if s.name == "jit.launch"]
        entries = [s for s in rec.stamps if s.stage == "jit.graph" and not s.exit]
        assert len(launches) == 3 and len(entries) == 4
        for span, stamp in zip(launches, entries):
            assert stamp.t_ns >= span.start_ns - rec.clock_error_ns
        assert all(a.t_ns <= b.t_ns for a, b in zip(rec.stamps, rec.stamps[1:]))
    finally:
        telemetry.disable()
        telemetry.collect()
        jit.clear()


def test_telemetry_stamp_in_a_cond_body_fires_on_the_branch_taken(dev):
    """Stamps inside a conditional node's bodies fire only on the branch the
    device takes; kernels_replayed counts each body by the branch taken, as
    the profiler sees the replays' kernels."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.utils import telemetry

    def up(v):
        with telemetry.stage("test.if", v):
            return v * 2.0 + 1.0

    def down(v):
        with telemetry.stage("test.else", v):
            return v - 1.0

    def fn(x, t):
        return jit.cond((t > 0).all(), up, down, x)

    x = torch.rand(4, 300, generator=torch.Generator().manual_seed(3)).to(dev)
    pos, neg = torch.ones(4, device=dev), -torch.ones(4, device=dev)
    jit.clear()
    telemetry.collect()
    telemetry.enable()
    try:
        f = jit.jit(fn)
        assert torch.equal(f(x, pos), fn(x, pos))
        before = jit.keys()[0]["kernels_replayed"]
        ran = _kernels_profiled(lambda: [f(x, t) for t in (neg, pos)])
        (key,) = jit.keys()
        rec = telemetry.collect()
        assert key["conds"] == 1 and key["taken"] == [[2, 1]] and key["stamps"] == 6
        # each replay: the jit.graph pair and its branch's pair
        assert ran == key["kernels_replayed"] - before + 2 * 4
        assert [s for s in _replay_stages(rec)] == [["test.if"], ["test.else"], ["test.if"]]
    finally:
        telemetry.disable()
        telemetry.collect()
        jit.clear()


def _compiled_step_ranks():
    """Two gloo ranks sharing the card: the compiled sharded KDE step at
    data 1 x x 2 (the tiled route) and data 2 x x 1 on two 96x128 frames,
    each against its eager step (step.fn): bits of the capture's call and a
    replay, the replay's host steps and the eager step's collectives, and
    the replay gathered."""
    from kinectdepthmapenhancement_tpu_torch.core import jit
    from kinectdepthmapenhancement_tpu_torch.parallel import mesh as mesh_mod
    from kinectdepthmapenhancement_tpu_torch.parallel import sharding
    from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh

    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    out = {}
    for name, spatial in (("x2", 2), ("data2", 1)):
        mesh = make_mesh(2, spatial=spatial, device="cuda")
        depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(mesh.device)
        color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(mesh.device)
        b = depth.shape[0] // mesh.data
        rows = slice(mesh.d * b, (mesh.d + 1) * b)
        blocks = (mesh.width_tile(depth[rows]), mesh.width_tile(color[rows]))
        step = sharding.sharded_kde_step(mesh, intr, cfg)
        mesh_mod.collectives = 0
        eager = step.fn(*blocks)
        collectives = mesh_mod.collectives
        first = step(*blocks)
        before = jit.stats["host_steps"]
        again = step(*blocks)
        torch.cuda.synchronize()
        out[name] = {"bitwise": torch.equal(first, eager) and torch.equal(again, eager),
                     "host_steps": jit.stats["host_steps"] - before, "collectives": collectives,
                     "jitted": isinstance(step, jit._Jitted),
                     "gathered": sharding.gather_global(again, mesh).cpu()}
        jit.clear()
    return out


def test_compiled_step_on_gloo_ranks_sharing_the_card(dev, tmp_path):
    """sharded_kde_step compiled on two gloo ranks sharing the card, at
    96x128 (grid 3x4): at x = 2 (the tiled route: 14 collectives, each a
    host step of the replay) and at data 2 x x 1 (none), the capture's call
    and a replay bitwise the eager step on every rank, the replay gathered
    bitwise kde_pipeline on the card."""
    from kinectdepthmapenhancement_tpu_torch.parallel import multihost

    ranks = multihost.spawn(_compiled_step_ranks, 2, device="cuda", backend="gloo",
                            store_dir=str(tmp_path), timeout_s=240)
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    want = kde_pipeline(depth, color, intr, cfg).optimized_points.cpu()
    for r in ranks:
        for name, steps in (("x2", 14), ("data2", 0)):
            got = r[name]
            assert got["jitted"] and got["bitwise"], (name, got)
            assert got["host_steps"] == got["collectives"] == steps, (name, got)
            assert torch.equal(got["gathered"], want), name
