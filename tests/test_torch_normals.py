"""PyTorch port: CM normals (depth-change map, chamfer DT, covariance sweep,
eigensolver, rest-normal fill) against the JAX package (ops/normals.py) on
the CPU.

Tolerances:
  * depth-change map and chamfer DT: bitwise (integer tests; min-plus is
    exact and order-free in f32);
  * covariance count: exact; entries: |d| <= 2e-6 x the pixel's largest
    entry magnitude (each entry is s2 - s1^2/n, an f32 cancellation, and XLA
    contracts the products into FMAs — measured 5.9e-7);
  * normals: validity flags equal, and |n.n'| > 0.9999 on >= 99.9% of the
    pixels valid on both sides (pixels where both sides are the zero vector
    agree by construction, as in tests/test_oracle_pipeline.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu.core.config import NormalParams
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import normals as jn
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.ops import cuda_cov, cuda_dt
from kinectdepthmapenhancement_tpu_torch.ops import normals as tn

torch.set_num_threads(2)

# the JAX side's XLA routes (the Pallas routes are what the port's kernels
# replace; interpret mode is used only for the covariance entries below)
JP = NormalParams(cov_impl="xla", dt_impl="xla")


def _t(a):
    return torch.tensor(np.asarray(a))[None]


@pytest.fixture(scope="module")
def scene():
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    _, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    points = np.asarray(projective_to_real(jnp.asarray(noisy), intr))
    vm = points / 1000.0
    return dict(points=points, vm=vm)


def _normals_agree(got, want, frac=0.999):
    gv, wv = (got != -1.0).any(-1), (want != -1.0).any(-1)
    assert (gv == wv).all()
    both_zero = (np.linalg.norm(got, axis=-1) < 1e-6) & (np.linalg.norm(want, axis=-1) < 1e-6)
    ok = both_zero | (np.abs(np.sum(got * want, axis=-1)) > 0.9999)
    assert ok[gv & wv].mean() >= frac


def test_dci_and_smoothing_map_exact(scene):
    vm = scene["vm"]
    want = np.asarray(jn.dci_map(jnp.asarray(vm), JP.max_depth_change_factor))
    got = tn.dci_map(_t(vm), JP.max_depth_change_factor)[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    sm_want = np.asarray(jn.smoothing_map(jnp.asarray(vm), JP))
    sm_got = tn.smoothing_map(_t(vm), convert.config_from_jax(JP))[0].numpy()
    np.testing.assert_array_equal(sm_got, sm_want)


@pytest.mark.parametrize("source", ["scene", "random"])
def test_distance_transform_bitwise(scene, source):
    if source == "scene":
        dci = np.asarray(jn.dci_map(jnp.asarray(scene["vm"]), 0.05))
        iters = 26
    else:  # sparse zeros: distances exceed the horizon, and two chunks of rounds
        rng = np.random.default_rng(2)
        dci = np.where(rng.random((40, 70)) < 0.004, 0, 255).astype(np.int32)
        iters = 30
    want = np.asarray(jn.distance_transform(jnp.asarray(dci), iters))
    got = cuda_dt.distance_transform(_t(dci), iters)[0].numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("s", range(2, cuda_cov.MAX_RECT + 1))
def test_ring_walk_is_ring_order(s):
    """csrc/cov.cu walks each size's ring as one row and one column (and
    size 2's centre last): that is the accumulation order of ring_taps()."""
    assert cuda_cov.ring_walk(s) == cuda_cov.ring_taps()[s]


@pytest.mark.parametrize("tile,k", [((16, 32, 20, 44), 1), ((16, 32, 20, 44), 7),
                                    ((16, 32, 20, 44), 12), ((0, 16, 40, 64), 12)],
                         ids=["interior_k1", "interior_k7", "interior_k12", "corner_k12"])
def test_dt_tile_needs_only_a_halo_of_k(tile, k):
    """csrc/dt.cu's region: after k rounds a tile depends only on the cells
    within k of it.  The plain DT of the crop tile + k (+inf beyond it, and
    beyond the image) equals the full image's on the tile, once the crop's
    init w' + h' is read as the image's w + h (every value after k rounds is
    either the init or a distance <= 1.4 k, far below both).  The only
    zeros lie exactly k from the tile, beside each side and corner inside
    the image, and reach it only in the k-th round: a halo one short fails."""
    dci = torch.full((1, 48, 64), 255, dtype=torch.int32)
    y0, y1, x0, x1 = tile
    for y, x in ((y0 - k, x0 + 3), (y1 - 1 + k, x1 - 4), (y0 + 3, x0 - k),
                 (y1 - 4, x1 - 1 + k), (y0 - k, x0 - k), (y1 - 1 + k, x1 - 1 + k)):
        if 0 <= y < 48 and 0 <= x < 64:
            dci[0, y, x] = 0
    full = cuda_dt.distance_transform_plain(dci, k)
    cy0, cx0 = max(y0 - k, 0), max(x0 - k, 0)
    crop = dci[:, cy0 : y1 + k, cx0 : x1 + k]
    part = cuda_dt.distance_transform_plain(crop, k)
    far_crop, far_full = float(crop.shape[1] + crop.shape[2]), float(48 + 64)
    assert 1.4 * k < min(far_crop, far_full)
    part = torch.where(part == far_crop, far_full, part)
    got = part[:, y0 - cy0 : y1 - cy0, x0 - cx0 : x1 - cx0]
    assert got.numpy().tobytes() == full[:, y0:y1, x0:x1].numpy().tobytes()


@pytest.mark.parametrize("case", ["no_zero", "settled"])
def test_dt_fixed_point_stays(case):
    """csrc/dt.cu stops a block after a round that changed nothing: such a
    state is a fixed point of every later round.  A map with no zero never
    leaves its init; a map that settles stays settled."""
    if case == "no_zero":
        dci = torch.full((1, 48, 64), 255, dtype=torch.int32)
        start = 0
    else:
        rng = np.random.default_rng(4)
        dci = torch.tensor(np.where(rng.random((1, 48, 64)) < 0.01, 0, 255).astype(np.int32))
        start = next(t for t in range(200) if torch.equal(
            cuda_dt.distance_transform_plain(dci, t), cuda_dt.distance_transform_plain(dci, t + 1)))
    fixed = cuda_dt.distance_transform_plain(dci, start)
    for extra in (1, 26, 27):
        assert torch.equal(cuda_dt.distance_transform_plain(dci, start + extra), fixed)


@pytest.mark.parametrize("kernel", ["cov", "dt", "jbf", "seed_gradient"])
def test_kernel_variants_rewrite_the_sources(kernel):
    """utils/kernel_variants.py rewrites the tile and unroll constants of
    csrc/cov.cu, dt.cu, jbf.cu and seed_gradient.cu: its first variant of
    each kernel is the source as committed, and every variant finds each of
    its constants."""
    from kinectdepthmapenhancement_tpu_torch import _build
    from kinectdepthmapenhancement_tpu_torch.utils import kernel_variants as kv

    variants = kv.VARIANTS[kernel]
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    values = list(variants.values())
    assert kv.variant_source(text, values[0]) == text
    rewritten = {kv.variant_source(text, v) for v in values}
    assert len(rewritten) == len(values)  # each variant differs from the others
    with pytest.raises(ValueError):
        kv.variant_source(text, {"NO_SUCH_CONSTANT": 1})


def test_cov_count_exact_entries_close():
    """Against the JAX package's covariance kernel (pallas_cov, interpret
    mode, which tests/test_pallas.py holds against the XLA sweep) on a 48x64
    crop of the scene's vertex map: its inputs and outputs are committed by
    tests/gen_torch_fixtures.py stages (the interpreter takes ~20 s)."""
    path = os.path.join(os.path.dirname(__file__), "golden", "torch_stages_96x128_seed0.npz")
    with np.load(path) as z:
        v, rect, jc, je = (z[k] for k in ("cov_vm", "cov_rect", "cov_count", "cov_entries"))
    tc, te = cuda_cov.cm_covariances(_t(v), _t(rect))
    tc, te = tc[0].numpy(), te[0].numpy()
    np.testing.assert_array_equal(tc, jc)
    scale = np.abs(je).max(-1, keepdims=True)
    assert (np.abs(te - je) <= 2e-6 * scale).all()


def test_cm_normals_match_jax(scene):
    vm = scene["vm"]
    sm = np.asarray(jn.smoothing_map(jnp.asarray(vm), JP))
    want = np.asarray(jn.cm_normals(jnp.asarray(vm), jnp.asarray(sm), 20, cov_impl="xla"))
    got = tn.cm_normals(_t(vm), _t(sm), 20)[0].numpy()
    _normals_agree(got, want)


def test_generate_normal_map_matches_jax(scene):
    points = scene["points"]
    want = np.asarray(jn.generate_normal_map(jnp.asarray(points), JP))
    got = tn.generate_normal_map(_t(points), convert.config_from_jax(JP))[0].numpy()
    _normals_agree(got, want)


def test_smallest_eigenvector_matches_jax():
    """Random symmetric PSD 3x3 covariances, plus degenerate (rank-1, zero)
    ones: eigenvalue within 1e-5 of the largest entry, |v.v'| > 0.9999 where
    the smallest eigenvalue is simple."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    a[:, 2] *= rng.uniform(0.01, 1.0, (500, 1)).astype(np.float32)
    cov = np.einsum("nij,nkj->nik", a, a).astype(np.float32)
    cov[0] = 0.0
    cov[1] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    jval, jvec = (np.asarray(x) for x in jn.smallest_eigenvector(jnp.asarray(cov)))
    tval, tvec = (x.numpy() for x in tn.smallest_eigenvector(torch.from_numpy(cov)))
    scale = np.abs(cov).reshape(-1, 9).max(-1)
    assert (np.abs(tval - jval) <= 1e-5 * np.maximum(scale, 1.0)).all()
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    simple = (ev[:, 1] - ev[:, 0]) > 1e-2 * np.maximum(ev[:, 2], 1e-12)
    dots = np.abs(np.sum(tvec * jvec, axis=-1))
    assert (dots[simple] > 0.9999).all()


def test_unported_methods_raise(scene):
    """sdc and bilateral are ported (tests/test_torch_normal_methods.py); an
    unknown method raises ValueError in both packages."""
    for method in ("pca", ""):
        with pytest.raises(ValueError, match="unknown normal method"):
            tn.generate_normal_map(_t(scene["points"]), convert.config_from_jax(
                NormalParams(method=method)))
        with pytest.raises(ValueError, match="unknown normal method"):
            jn.generate_normal_map(jnp.asarray(scene["points"]), NormalParams(method=method))
