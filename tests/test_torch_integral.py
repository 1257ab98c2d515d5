"""PyTorch port: the integral images of ops/integral.py against the JAX
package's ops/integral.py on seeded inputs.

Tolerances, and why:
  * counts (the all-ones and valid prefixes, every box count) EXACT:
    integers below 2^24;
  * the centred prefix: the port sums in float64 and rounds once, the JAX
    package sums in f32 (ops/integral.py's docstring), so each entry is
    held to 1e-5 of the running sum of the magnitudes it accumulates
    (measured: 2.0e-6 of it at most);
  * box sums against a direct float64 sum and against the JAX package: the
    bar of tests/test_normals.py:32 (1e-3 + 1e-5 |sum|);
  * the two readings of a box at a fixed offset, four slices of the padded
    table or four per-pixel gathers, EQUAL (the same table values in the
    same additions): the SDC normals take the gather form;
  * a batch of two frames equals each frame built alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.ops import integral as ji
from kinectdepthmapenhancement_tpu_torch.ops import integral as ti

torch.set_num_threads(2)

H, W = 40, 56


def _inputs(seed=0, c=2):
    """Vertex-like channels in metres with ~10% invalid (zeroed) pixels."""
    rng = np.random.default_rng(seed)
    chans = rng.normal(2.0, 0.7, (H, W, c)).astype(np.float32)
    valid = rng.random((H, W)) > 0.1
    chans[~valid] = 0.0
    return chans, valid


def _pair(seed=0, c=2):
    chans, valid = _inputs(seed, c)
    return (ji.build(jnp.asarray(chans), jnp.asarray(valid)),
            ti.build(torch.from_numpy(chans)[None], torch.from_numpy(valid)[None]),
            chans, valid)


def test_build_matches_jax():
    jci, tci, chans, _ = _pair()
    np.testing.assert_array_equal(tci.count[0].numpy(), np.asarray(jci.count))
    np.testing.assert_array_equal(tci.valid[0].numpy(), np.asarray(jci.valid))
    np.testing.assert_allclose(tci.mu[0].numpy(), np.asarray(jci.mu), rtol=1e-6)
    mags = np.pad(np.cumsum(np.cumsum(np.abs(chans - chans.mean((0, 1))), 0), 1),
                  [(1, 0), (1, 0), (0, 0)])
    err = np.abs(tci.centered[0].numpy() - np.asarray(jci.centered))
    assert (err <= 1e-5 * mags + 1e-6).all()


def test_batch_equals_single_frames():
    a, va = _inputs(1)
    b, vb = _inputs(2)
    both = ti.build(torch.from_numpy(np.stack([a, b])), torch.from_numpy(np.stack([va, vb])))
    for i, (x, v) in enumerate(((a, va), (b, vb))):
        one = ti.build(torch.from_numpy(x)[None], torch.from_numpy(v)[None])
        for f in ti.CenteredIntegral._fields:
            assert torch.equal(getattr(both, f)[i], getattr(one, f)[0]), f


@pytest.mark.parametrize("per_pixel", [False, True], ids=["scalar", "per_pixel"])
def test_box_sums_match_direct_and_jax(per_pixel):
    """Random boxes (tests/test_normals.py:17-33 on the port), read one at a
    time or all at once as per-pixel index arrays."""
    jci, tci, chans, valid = _pair(3)
    rng = np.random.default_rng(0)
    n = 20
    u, v = rng.integers(0, W - 8, n), rng.integers(0, H - 8, n)
    uu, vv = rng.integers(1, 8, n), rng.integers(1, 8, n)
    want = np.array([chans[v[i] + 1: v[i] + vv[i] + 1, u[i] + 1: u[i] + uu[i] + 1]
                     .astype(np.float64).sum((0, 1)) for i in range(n)])
    wantc = np.array([valid[v[i] + 1: v[i] + vv[i] + 1, u[i] + 1: u[i] + uu[i] + 1].sum()
                      for i in range(n)])
    if per_pixel:
        args = [torch.from_numpy(a) for a in (u, v, uu, vv)]
        got_all = ti.box_sum_all(tci, *args)[0].numpy()
        got0 = ti.box_sum(tci, 0, *args)[0].numpy()
        gotc = ti.box_count(tci, *args)[0].numpy()
        jargs = [jnp.asarray(a) for a in (u, v, uu, vv)]
        jall = np.asarray(ji.box_sum_all(jci, *jargs))
        jc = np.asarray(ji.box_count(jci, *jargs))
    else:
        got_all = np.stack([ti.box_sum_all(tci, *map(int, a))[0].numpy()
                            for a in zip(u, v, uu, vv)])
        got0 = np.stack([ti.box_sum(tci, 0, *map(int, a))[0].numpy() for a in zip(u, v, uu, vv)])
        gotc = np.stack([ti.box_count(tci, *map(int, a))[0].numpy() for a in zip(u, v, uu, vv)])
        jall = np.stack([np.asarray(ji.box_sum_all(jci, *map(int, a))) for a in zip(u, v, uu, vv)])
        jc = np.stack([np.asarray(ji.box_count(jci, *map(int, a))) for a in zip(u, v, uu, vv)])
    for ref in (want, jall):
        assert (np.abs(got_all - ref) < 1e-3 + 1e-5 * np.abs(ref)).all()
    np.testing.assert_array_equal(got0, got_all[:, 0])
    np.testing.assert_array_equal(gotc, wantc)
    np.testing.assert_array_equal(gotc, jc)


# (u_off, v_off, uu, vv): the SDC normals' boxes at window size 9, and
# boxes that reach the pad (zeros) on each side
FIXED = [(-5, -5, 9, 9), (-5, -3, 4, 4), (0, -3, 4, 4), (-3, 0, 4, 4), (-12, 8, 11, 14),
         (10, -9, 13, 3)]


@pytest.mark.parametrize("box", FIXED, ids=[str(b) for b in FIXED])
def test_fixed_boxes_match_jax(box):
    jci, tci, _, _ = _pair(4)
    pad = 24
    jpi = ji.pad_tables(jci, pad, H, W)
    tpi = ti.pad_tables(tci, pad, H, W)
    np.testing.assert_array_equal(ti.fixed_box_count(tpi, *box)[0].numpy(),
                                  np.asarray(ji.fixed_box_count(jpi, *box)))
    want = np.asarray(ji.fixed_box_sum_all(jpi, *box))
    got = ti.fixed_box_sum_all(tpi, *box)[0].numpy()
    assert (np.abs(got - want) < 1e-3 + 1e-5 * np.abs(want)).all()
    np.testing.assert_array_equal(ti.fixed_box_sum(tpi, 1, *box)[0].numpy(), got[..., 1])


def test_slice_and_gather_forms_equal():
    """Every window size of the SDC normals (2..21): the per-pixel form
    (offset tensors, as sdc_normals passes them) equals the fixed-offset
    slices bitwise, on a batch of two."""
    a, va = _inputs(5, 1)
    b, vb = _inputs(6, 1)
    ci = ti.build(torch.from_numpy(np.stack([a, b])), torch.from_numpy(np.stack([va, vb])))
    pi = ti.pad_tables(ci, 24, H, W)
    for s in range(2, 22):
        r2, r4 = s >> 1, s >> 2
        full = torch.full((2, H, W), s, dtype=torch.int64)
        t2, t4 = full >> 1, full >> 2
        pairs = [
            (ti.fixed_box_count(pi, -r2 - 1, -r2 - 1, s, s),
             ti.fixed_box_count(pi, -t2 - 1, -t2 - 1, full, full)),
            (ti.fixed_box_count(pi, 0, -r4 - 1, r2, r2),
             ti.fixed_box_count(pi, 0, -t4 - 1, t2, t2)),
            (ti.fixed_box_sum(pi, 0, -r4 - 1, -r2 - 1, r2, r2),
             ti.fixed_box_sum(pi, 0, -t4 - 1, -t2 - 1, t2, t2)),
            (ti.fixed_box_sum_all(pi, -r4 - 1, 0, r2, r2),
             ti.fixed_box_sum_all(pi, -t4 - 1, 0, t2, t2)),
        ]
        for sliced, gathered in pairs:
            assert torch.equal(sliced, gathered), s
