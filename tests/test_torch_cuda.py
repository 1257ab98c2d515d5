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
chip_smoke.py runs the same checks at the 640x480 path's shapes.
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
