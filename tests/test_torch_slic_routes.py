"""PyTorch port: the global and capped NASP routes (later iterations, grids
that do not divide the frame) on the CPU at 96x128.  Every later iteration
assigns by the global sweep; the routes differ in the update's index
(cell-local at r = 5 on the capped route, global otherwise).

Tolerances:
  * labels_within_cap: EQUAL to the JAX function's answer;
  * the capped route against the global route over 3 iterations: labels and
    cluster xy / size EXACT, rgb atol 1e-3, centres rtol 1e-5 / atol 1e-3,
    normals rtol 1e-5 / atol 1e-5 — the tolerances of the JAX package's own
    route test (tests/test_slic.py:179-212), sums differing in order only;
    the last sweep's distances rtol 1e-5 / atol 1e-2 (to cluster tables
    summed in two orders: the centres' 1e-3 mm through the distance);
  * the global index against the cell index on cell-local labels: gathers,
    counts and pair counts EXACT, segment sums rtol 1e-6;
  * the label counts (cuda_nasp.label_counts / label_pair_counts and the
    global index's counts and pair counts, through those wrappers): EXACT
    against a histogram of the labels counted in numpy (integers);
  * the label sums (cuda_nasp.label_sums on CPU tensors and the global
    index's segment sums, through that wrapper): EXACT against the one-hot
    product (the plain version is that product).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.ops import slic as js
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.ops import bilateral, cuda_nasp, normals, tables
from kinectdepthmapenhancement_tpu_torch.ops import slic as ts

torch.set_num_threads(2)

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
NASP = KDEConfig().nasp


@pytest.fixture(scope="module")
def frame():
    """The port's own JBF points and CM normals of the 96x128 scene."""
    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=0)
    cfg = KDEConfig()
    c = torch.from_numpy(color)[None]
    points = projective_to_real(
        bilateral.joint_bilateral_filter(torch.from_numpy(noisy)[None], c, cfg.jbf), intr)
    return c, points, normals.generate_normal_map(points, cfg.normals)


def _segment(frame, grid=GRID, **kw):
    return ts.segment(*frame, grid=grid, params=dataclasses.replace(NASP, **kw))


def _clusters_close(got, want):
    assert torch.equal(got.xy, want.xy) and torch.equal(got.size, want.size)
    np.testing.assert_allclose(got.rgb.numpy(), want.rgb.numpy(), atol=1e-3)
    np.testing.assert_allclose(got.center.numpy(), want.center.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.normal.numpy(), want.normal.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def global_3(frame):
    """Three iterations on the global route, by stats_impl."""
    return {impl: _segment(frame, iterations=3, locality="global", stats_impl=impl)
            for impl in ("auto", "xla")}


@pytest.mark.parametrize("locality, stats_impl", [("auto", "auto"), ("cell", "auto"),
                                                  ("auto", "xla")])
def test_capped_route_matches_global_3_iterations(frame, global_3, locality, stats_impl):
    """Iterations 2-3 on the capped route (r = 5 cell sums) against the
    global route (one-hot sums)."""
    want = global_3[stats_impl]
    got = _segment(frame, iterations=3, locality=locality, stats_impl=stats_impl)
    assert torch.equal(got.labels, want.labels)
    # the last sweep's distances are to cluster tables summed in two orders
    np.testing.assert_allclose(got.distance.numpy(), want.distance.numpy(), rtol=1e-5, atol=1e-2)
    _clusters_close(got.clusters, want.clusters)
    # the later iterations move labels, so the routes are exercised
    assert (_segment(frame).labels != got.labels).any()
    assert bool(ts.labels_within_cap(got.labels, GRID, 5, H, W).all())


def test_capped_fallback_on_drifted_labels(frame):
    """The locality guard (tests/test_slic.py:220): labels_within_cap
    rejects a label state whose block in the last cell claims cluster 0 and
    accepts the grid init, as the JAX function does; a later iteration fed
    labels far off the cap takes the global route ("auto") and equals it."""
    labels = ts.init_labels(GRID, H, W).clone()
    labels[-8:, -8:] = 0  # cell offset (-2, -3) from the last cell
    for lab, cap, want in ((labels, 1, False), (ts.init_labels(GRID, H, W), 1, True),
                           (labels, 3, True)):
        got = bool(ts.labels_within_cap(lab[None], GRID, cap, H, W)[0])
        assert got == want == bool(js.labels_within_cap(jnp.asarray(lab.numpy()), GRID, cap, H, W))
    # the batch answer is per frame; one frame off the cap sends the batch
    # to the global route
    both = torch.stack([ts.init_labels(GRID, H, W), labels])
    assert ts.labels_within_cap(both, GRID, 1, H, W).tolist() == [True, False]
    # a later iteration from a state with a label far outside the cap, on
    # a 12x16 grid (at 3x4 every label lies within the cap of 5)
    grid = GridParams(rows=12, cols=16)
    seg = _segment(frame, grid=grid)
    far = seg.labels.clone()
    far[0, -4:, -4:] = 0
    assert ts._within_cap(seg.labels, grid, 5, H, W) and not ts._within_cap(far, grid, 5, H, W)
    args = (seg.clusters, frame[0].float(), *frame[1:], grid, NASP, 8.0)
    lab_g, _ = ts._assign_global(far, seg.distance, *args)
    assert not ts._within_cap(lab_g, grid, 5, H, W)
    # off the cap the r = 5 cell index's sums drop labels outside its
    # candidates (its counts, keyed by the whole id space, do not)
    cell = ts._CellIndex(lab_g, grid, 5, H, W)
    glob = ts._GlobalIndex(lab_g, grid.num_clusters)
    ones, member = torch.ones(lab_g.shape + (1,)), lab_g >= 0
    assert not torch.equal(cell.segment_sum(ones, member), glob.segment_sum(ones, member))
    assert torch.equal(cell.counts(), glob.counts())
    assert isinstance(ts.label_index(lab_g, grid, dataclasses.replace(NASP, iterations=2)),
                      ts._GlobalIndex)
    state = (far, seg.distance, seg.clusters, frame[0].float(), *frame[1:])
    out = {
        locality: ts.later_iteration(*state, grid=grid, params=dataclasses.replace(
            NASP, iterations=2, locality=locality))
        for locality in ("auto", "global")
    }
    assert torch.equal(out["auto"][0], lab_g)
    assert torch.equal(out["auto"][0], out["global"][0])
    assert torch.equal(out["auto"][1], out["global"][1])
    _clusters_close(out["auto"][2], out["global"][2])


def test_non_dividing_grid_global_route(frame):
    """A 5x6 grid leaves 96x128 a remainder: the grid init carries ids past
    the grid in the last rows and columns, the first sweep replaces them,
    and the global index serves the updates."""
    grid = GridParams(rows=5, cols=6)
    init = ts.init_labels(grid, H, W)
    assert int(init.max()) >= grid.num_clusters
    seg = _segment(frame, grid=grid)
    assert int(seg.labels.min()) >= -1 and int(seg.labels.max()) < grid.num_clusters
    assert isinstance(ts.cell_index(seg.labels, grid, 8), ts._GlobalIndex)
    assert isinstance(ts.label_index(seg.labels, grid, NASP), ts._GlobalIndex)
    # stats_impl is checked, not read: "xla" segments alike
    other = _segment(frame, grid=grid, stats_impl="xla")
    assert torch.equal(seg.labels, other.labels)
    _clusters_close(seg.clusters, other.clusters)


def test_global_index_matches_cell_index():
    """_GlobalIndex on cell-local labels (invalids, every candidate offset)
    against _CellIndex: the same gathers, counts, sums and pairs."""
    rng = np.random.default_rng(9)
    h, w, rows, cols, r = 48, 64, 3, 4, 4
    cy = np.arange(h)[:, None] // (h // rows)
    cx = np.arange(w)[None, :] // (w // cols)
    ny = np.clip(cy + rng.integers(-r, r, (2, h, w)), 0, rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (2, h, w)), 0, cols - 1)
    labels = (ny * cols + nx).astype(np.int32)
    labels[rng.random((2, h, w)) < 0.07] = -1
    k = rows * cols
    lab = torch.from_numpy(labels)
    cell = ts._CellIndex(lab, GridParams(rows, cols), r, h, w)
    glob = ts._GlobalIndex(lab, k)
    table = torch.from_numpy(rng.normal(size=(2, k, 5)).astype(np.float32) * 1000.0)
    assert torch.equal(glob.gather(table), cell.gather(table))
    feats = torch.from_numpy(rng.normal(size=(2, h, w, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, h, w)) < 0.8)
    np.testing.assert_allclose(glob.segment_sum(feats, mask).numpy(),
                               cell.segment_sum(feats, mask).numpy(), rtol=1e-6, atol=1e-4)
    assert torch.equal(glob.counts(), cell.counts())
    right = torch.cat([lab[:, :, 1:], torch.full((2, h, 1), -1, dtype=torch.int32)], dim=2)
    assert torch.equal(glob.pair_counts(right), cell.pair_counts(right))


def _run_labels(rng, b, h, w, k, ends):
    """[B, H, W] i32 labels in runs along each row, as superpixels give
    them: ids in [0, K), runs of -1 and a few ids at K (outside the id
    space, dropped as -1 is).  ends: ids 0 and K - 1 at every frame's first
    and last pixels and in runs of their own."""
    flat = np.empty((b, h * w), np.int64)
    for i in range(b):
        pos = 0
        while pos < h * w:
            n = int(rng.integers(1, 40))
            u = rng.random()
            flat[i, pos:pos + n] = -1 if u < 0.15 else k if u < 0.18 else rng.integers(0, k)
            pos += n
    labels = flat.reshape(b, h, w)
    if ends:
        labels[:, 0, :5], labels[:, -1, -5:] = 0, k - 1
        labels[:, h // 2, 10:20], labels[:, h // 2 + 1, 10:20] = k - 1, 0
    return torch.from_numpy(labels.astype(np.int32))


def _histogram(a, c=None, k=1):
    """numpy's counts of labels a (and pairs (a, c)) with every label in
    [0, K) -> [B, K] (or [B, K, K]) f32."""
    a = a.reshape(a.shape[0], -1).numpy().astype(np.int64)
    ok = (a >= 0) & (a < k)
    if c is not None:
        c = c.reshape(c.shape[0], -1).numpy().astype(np.int64)
        ok &= (c >= 0) & (c < k)
    keys, shape = (a, (k,)) if c is None else (a * k + c, (k, k))
    out = np.stack([np.bincount(kf[m], minlength=math.prod(shape)) for kf, m in zip(keys, ok)])
    return torch.from_numpy(out.astype(np.float32).reshape((a.shape[0],) + shape))


def _recorded(monkeypatch, *names):
    """The list that each call of the named cuda_nasp functions appends
    its name to, from now on."""
    calls = []
    for name in names:
        fn = getattr(cuda_nasp, name)
        monkeypatch.setattr(cuda_nasp, name,
                            lambda *a, _n=name, _fn=fn, **kw: calls.append(_n) or _fn(*a, **kw))
    return calls


@pytest.mark.parametrize("b, grid, ends", [(1, GRID, False), (3, GRID, False),
                                           (3, GridParams(rows=15, cols=20), True)])
def test_label_counts_wrappers_and_global_index_routes(b, grid, ends, monkeypatch):
    """cuda_nasp.label_counts / label_pair_counts and the global index's
    counts and pair counts on a 50x70 frame, which neither grid divides:
    every count bitwise numpy's histogram, over the right and the down
    neighbours (-1 borders) as CCL pairs them.  The index counts through
    the wrappers, which take their plain versions for CPU tensors."""
    rng = np.random.default_rng(21 + b)
    h, w = 50, 70
    k = grid.num_clusters
    assert not ts.grid_divides(grid, h, w)
    lab = _run_labels(rng, b, h, w, k, ends)
    if ends:
        assert bool((lab == 0).any()) and bool((lab == k - 1).any())
    right = torch.cat([lab[:, :, 1:], torch.full((b, h, 1), -1, dtype=torch.int32)], dim=2)
    down = torch.cat([lab[:, 1:], torch.full((b, 1, w), -1, dtype=torch.int32)], dim=1)
    counts = _histogram(lab, k=k)
    assert torch.equal(cuda_nasp.label_counts(lab, k), counts)
    assert torch.equal(cuda_nasp.label_counts_plain(lab, k), counts)
    pairs = [_histogram(lab, nb, k) for nb in (right, down)]
    for nb, want in zip((right, down), pairs):
        assert torch.equal(cuda_nasp.label_pair_counts(lab, nb, k), want)
        assert torch.equal(cuda_nasp.label_pair_counts_plain(lab, nb, k), want)
    calls = _recorded(monkeypatch, "label_counts", "label_pair_counts", "label_counts_plain",
                      "label_pair_counts_plain")
    index = ts._GlobalIndex(lab, k)
    for nb, want in zip((right, down), pairs):
        assert torch.equal(index.pair_counts(nb), want)
    assert torch.equal(index.counts(), counts)
    assert calls == ["label_pair_counts", "label_pair_counts_plain"] * 2 + [
        "label_counts", "label_counts_plain"]


@pytest.mark.parametrize("b, grid, f", [(1, GRID, 2), (3, GRID, 13),
                                         (3, GridParams(rows=15, cols=20), 14)])
def test_label_sums_wrapper_and_global_index_segment_sum(b, grid, f, monkeypatch):
    """cuda_nasp.label_sums on CPU tensors is bitwise the one-hot product of
    the masked features (the global index's product before the label-sums
    kernel); the global index's segment_sum on a 50x70 frame takes
    label_sums, which takes its plain version for CPU tensors, bitwise
    alike."""
    rng = np.random.default_rng(31 + b)
    h, w = 50, 70
    k = grid.num_clusters
    lab = _run_labels(rng, b, h, w, k, ends=True)
    feats = torch.from_numpy(rng.standard_normal((b, h, w, f)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, h, w)) < 0.7)
    oh = tables.one_hot(lab.reshape(b, -1), k).transpose(1, 2)
    want = tables.exact_matmul(oh, torch.where(mask[..., None], feats, 0.0).reshape(b, -1, f))
    assert torch.equal(cuda_nasp.label_sums(lab, feats, mask, k), want)
    assert torch.equal(cuda_nasp.label_sums_plain(lab, feats, mask, k), want)
    assert torch.equal(cuda_nasp.label_sums(lab, feats, None, k),
                       tables.exact_matmul(oh, feats.reshape(b, -1, f)))
    calls = _recorded(monkeypatch, "label_sums", "label_sums_plain")
    assert torch.equal(ts._GlobalIndex(lab, k).segment_sum(feats, mask), want)
    assert calls == ["label_sums", "label_sums_plain"]


@pytest.mark.parametrize("stats_impl", ["auto", "pallas", "xla"])
def test_global_index_takes_the_stats_route(stats_impl):
    """cell_index and with_capped_index's global index over labels whose
    grid does not divide the frame (or with locality="global"): every
    accepted stats_impl gives the same global index, and the same counts."""
    lab = ts.init_labels(GRID, 50, 70)[None].contiguous()
    index = ts.cell_index(lab, GRID, 8, stats_impl)
    assert isinstance(index, ts._GlobalIndex) and torch.equal(index.labels, lab)
    assert torch.equal(index.counts(), _histogram(lab, k=GRID.num_clusters))
    lab96 = ts.init_labels(GRID, H, W)[None].contiguous()
    index = ts.capped_index(lab96, GRID, 5, stats_impl=stats_impl, locality="global")
    assert isinstance(index, ts._GlobalIndex) and torch.equal(index.labels, lab96)
    assert torch.equal(index.counts(), _histogram(lab96, k=GRID.num_clusters))


def _sweep_frame(rng, b, h, w, grid, variant):
    """Random pixel planes and a cluster table for one sweep: integer
    colours and cluster positions (exact distance ties), a third of the
    clusters duplicating their neighbour's fields (ties between
    candidates), depths at and below 50 mm, normals invalid on every or on
    one channel, pixels and centres alike."""
    k = grid.num_clusters
    f32 = np.float32
    color = rng.integers(0, 256, (b, h, w, 3)).astype(f32)
    z = rng.uniform(300.0, 4000.0, (b, h, w)).astype(f32)
    u = rng.random((b, h, w))
    z[u < 0.1], z[(u >= 0.1) & (u < 0.13)] = 0.0, 50.0
    points = np.stack([rng.uniform(-900, 900, (b, h, w)), rng.uniform(-700, 700, (b, h, w)),
                       z], axis=-1).astype(f32)

    def unit_normals(shape):
        n = rng.standard_normal(shape + (3,))
        n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(f32)
        u = rng.random(shape)
        n[u < 0.1] = -1.0
        n[(u >= 0.1) & (u < 0.15), 1] = -1.0
        return n

    rgb = rng.integers(0, 256, (b, k, 3)).astype(f32)
    xy = np.stack([rng.integers(0, w + 24, (b, k)), rng.integers(0, h, (b, k))], axis=-1)
    center = np.stack([np.zeros((b, k)), np.zeros((b, k)),
                       rng.uniform(300.0, 4000.0, (b, k))], axis=-1).astype(f32)
    center[rng.random((b, k)) < 0.15, 2] = 40.0
    normal = unit_normals((b, k))
    dup = np.arange(1, k, 3)
    for t in (rgb, xy, center, normal):
        t[:, dup] = t[:, dup - 1]
    t = torch.from_numpy
    clusters = ts.Clusters(rgb=t(rgb), xy=t(xy.astype(np.int32)),
                           size=torch.zeros((b, k), dtype=torch.int32), center=t(center),
                           normal=t(normal), variance=torch.zeros((b, k)))
    frame = [t(color), None if variant == "sp" else t(points),
             t(unit_normals((b, h, w))) if variant == "nasp" else None]
    return clusters, frame


def _sweep_states(rng, b, h, w, x0, grid):
    """Two states to sweep from: the grid-init labels of columns [x0, x0 +
    W) of a frame x0 + W wide at INIT_DISTANCE (ids past the grid in its
    last rows and columns); a later one with labels -1 at distance 0,
    labels in the grid's edge cells (out-of-grid candidates first in
    dy-major order) and labels whose cell lies far from the pixel."""
    k = grid.num_clusters
    init = ts.init_labels(grid, h, x0 + w)[:, x0:].expand(b, h, w)
    yield init, torch.full((b, h, w), ts.INIT_DISTANCE, dtype=torch.float32)
    lab = init.clone().numpy()
    u = rng.random((b, h, w))
    edge = np.concatenate([np.arange(grid.cols), np.arange(k - grid.cols, k),
                           np.arange(0, k, grid.cols), np.arange(grid.cols - 1, k, grid.cols)])
    lab[u < 0.15] = -1
    pick = (u >= 0.15) & (u < 0.4)
    lab[pick] = rng.choice(edge, int(pick.sum()))
    pick = (u >= 0.4) & (u < 0.55)
    lab[pick] = rng.integers(0, k, int(pick.sum()))
    dist = rng.uniform(0.0, 3000.0, (b, h, w)).astype(np.float32)
    dist[lab == -1] = 0.0
    yield torch.from_numpy(lab), torch.from_numpy(dist)


def _torch_sqrt(a: np.ndarray) -> np.ndarray:
    """torch's f32 square root: on the CPU it is not always the correctly
    rounded one that numpy (and the card's IEEE sqrtf and torch's CUDA sqrt)
    give (~0.5% of integers below 20,000 round the other way), and the
    plain sweep runs torch's."""
    return torch.sqrt(torch.from_numpy(a)).numpy()


def _sweep_numpy(labels, distance, fields, frame, grid, r, variant, weights, s_scale,
                 apply_invalid, x0):
    """The sweep's rules in f32 numpy: each pixel's candidates are the
    (2r)^2 cells (dy, dx) in [-r, r)^2, dy-major, around the cell of its
    label (-1 taken as cluster 0); an in-grid one costs the variant's
    distance (colour, then pixel distance times s_scale^2, then depth where
    both z > 50, then normal where the normals are valid too; torch's
    square root, _torch_sqrt), an out-of-grid one the pixel's current
    distance under its current label; then, pixel by pixel, the best
    starts at (+inf, -1) and a candidate replaces it only when strictly
    smaller; then, where asked, label -1 and distance 0 where z < 50."""
    f32 = np.float32
    rows, cols = grid.rows, grid.cols
    w_col, w_spa, w_dep, w_nor = (f32(x) for x in weights)
    s2 = f32(s_scale**2)
    lab, dist = labels.numpy().reshape(-1), distance.numpy().reshape(-1)
    fields = fields.numpy()
    color, points, normals = (None if p is None else p.numpy() for p in frame)
    bi, y, x = (i.reshape(-1) for i in np.indices(labels.shape))
    offs = np.array([(dy, dx) for dy in range(-r, r) for dx in range(-r, r)])
    cy, cx = np.divmod(np.maximum(lab, 0), cols)
    ny, nx = cy[:, None] + offs[:, 0], cx[:, None] + offs[:, 1]
    in_grid = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
    ids = np.where(in_grid, ny * cols + nx, 0)
    c = fields[bi[:, None], ids]
    col = color[bi, y, x][:, None]
    d = [col[..., i] - c[..., i] for i in range(3)]
    cost = ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) * w_col
    ex, ey = (x0 + x).astype(f32)[:, None] - c[..., 3], y.astype(f32)[:, None] - c[..., 4]
    cost = cost + _torch_sqrt(ex * ex + ey * ey) * s2 * w_spa
    if variant != "sp":
        z = points[bi, y, x, 2][:, None]
        zpair = (z > 50.0) & (c[..., 5] > 50.0)
        cost = cost + np.where(zpair, np.abs(z - c[..., 5]), f32(0.0)) * w_dep
    if variant == "nasp":
        nm = normals[bi, y, x][:, None]
        npair = zpair & (nm != -1.0).any(-1) & (c[..., 6:9] != -1.0).any(-1)
        dot = (nm[..., 0] * c[..., 6] + nm[..., 1] * c[..., 7]) + nm[..., 2] * c[..., 8]
        nd = f32(65025.0) * (f32(1.0) - np.maximum(dot, f32(0.0)))
        cost = cost + np.where(npair, nd, f32(0.0)) * w_nor
    cand_d = np.where(in_grid, cost, dist[:, None]).tolist()
    cand_l = np.where(in_grid, ids, lab[:, None]).tolist()
    out_l, out_d = np.empty_like(lab), np.empty_like(dist)
    for p in range(lab.size):
        best_d, best_l = float("inf"), -1
        for cd, cl in zip(cand_d[p], cand_l[p]):
            if cd < best_d:
                best_d, best_l = cd, cl
        if apply_invalid and points[bi[p], y[p], x[p], 2] < 50.0:
            best_d, best_l = 0.0, -1
        out_l[p], out_d[p] = best_l, best_d
    return (torch.from_numpy(out_l.reshape(labels.shape)),
            torch.from_numpy(out_d.reshape(labels.shape)))


@pytest.mark.parametrize("x0", [0, 24])
@pytest.mark.parametrize("variant", ["nasp", "dasp", "sp"])
def test_global_sweep_plain_against_the_rules(variant, x0, monkeypatch):
    """The global route's assignment sweep (slic._assign_global) calls
    cuda_nasp.assign_global, which takes assign_global_plain on CPU tensors;
    that gives bitwise the labels and distances of a per-pixel numpy loop
    that states the sweep's rules (_sweep_numpy), from the grid-init state
    and from a later one with -1 labels, edge cells and far labels, on a
    50x70 frame that grid 15x20 does not divide, as columns [x0, x0 + 70)
    of a wider frame, with the offsets in one chunk and in chunks of three.
    At x0 = 0 the invalid-depth override applies (DASP, NASP), at x0 = 24
    its sigmas are 0 and it does not (SP never has it)."""
    rng = np.random.default_rng(41 + x0 + len(variant))
    b, h, w = 2, 50, 70
    grid = GridParams(rows=15, cols=20)
    assert not ts.grid_divides(grid, h, w)
    sigmas = dict(depth_sigma=0.0, normal_sigma=0.0) if x0 else {}
    params = dataclasses.replace(NASP, **sigmas)
    apply_invalid = ts._overrides(params, variant)
    assert apply_invalid == (variant != "sp" and x0 == 0)
    r = ts._variant(variant)[1] // 2
    clusters, frame = _sweep_frame(rng, b, h, w, grid, variant)
    fields = ts._cluster_fields(clusters, variant)
    s_scale = 3.25
    calls = _recorded(monkeypatch, "assign_global", "assign_global_plain")
    for labels, distance in _sweep_states(rng, b, h, w, x0, grid):
        got = ts._assign_global(labels, distance, clusters, *frame, grid, params, s_scale,
                                variant, x0=x0)
        want = _sweep_numpy(labels, distance, fields, frame, grid, r, variant,
                            ts._weights(params, variant), s_scale, apply_invalid, x0)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        # the sweep meets every rule: ties, out-of-grid winners, overrides
        assert bool((got[0] == labels).any()) and bool((got[0] != labels).any())
        # offsets in chunks of three: the first minimum across chunks too
        with monkeypatch.context() as m:
            m.setattr(cuda_nasp, "_CHUNK_ELEMENTS", 3 * b * h * w)
            small = ts._assign_global(labels, distance, clusters, *frame, grid, params,
                                      s_scale, variant, x0=x0)
        assert torch.equal(small[0], want[0]) and torch.equal(small[1], want[1])
    assert calls == ["assign_global", "assign_global_plain"] * 4
