"""PyTorch port: the dataset loaders (core/datasets.py, a copy of the JAX
package's NumPy code) against the JAX package's.

Each case of tests/test_datasets.py:20-86 runs once on each package's
functions (parametrised: the two copies must behave alike), and the two
copies are held to each other: write_tum_sequence writes the same bytes,
and each package's TUMSequence and PairedPNGDataset read the other's files
to the same arrays.  Bars are those of tests/test_datasets.py (the 16-bit
PNG quantization: 0.1 mm in TUM units, 0.5 mm in mm units); between the
two packages, every array EQUAL.
"""

import os

import numpy as np
import pytest
from PIL import Image

from kinectdepthmapenhancement_tpu.core import datasets as jds
from kinectdepthmapenhancement_tpu.core.camera import (
    default_kinect_intrinsics as jax_default_intrinsics,
)
from kinectdepthmapenhancement_tpu_torch.core import datasets as tds
from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene

PACKAGES = {"jax": jds, "torch": tds}


def _frames(n=4, h=32, w=40, seed=5):
    """tests/test_datasets.py:14-22's frames (the port's scene and sensor
    model, copies of the JAX package's)."""
    intr = default_kinect_intrinsics(w, h)
    color, _, gt = make_noisy_scene(h, w, intr, seed=seed)
    rng = np.random.default_rng(seed)
    return [(1234.5 + 0.033 * i, color, tds.kinect_v1_sensor_model(gt, rng)) for i in range(n)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_depth_png_roundtrip(tmp_path, pkg):
    ds = PACKAGES[pkg]
    rng = np.random.default_rng(0)
    depth = rng.uniform(400.0, 9000.0, (24, 32)).astype(np.float32)
    depth[0, :5] = 0.0
    p = str(tmp_path / "d.png")
    ds.write_depth_png(p, depth)
    back = ds.read_depth_png(p)
    assert back.dtype == np.float32
    assert np.abs(back - depth).max() <= 0.1 + 1e-2
    assert (back[0, :5] == 0.0).all()
    np.testing.assert_array_equal(back, PACKAGES["jax" if pkg == "torch" else "torch"]
                                  .read_depth_png(p))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tum_sequence_roundtrip(tmp_path, pkg):
    ds = PACKAGES[pkg]
    frames = _frames()
    root = str(tmp_path / "rgbd_dataset_freiburg1_synth")
    ds.write_tum_sequence(root, frames)
    seq = ds.TUMSequence(root)
    assert len(seq) == len(frames)
    assert seq.intrinsics == ds.TUM_INTRINSICS["fr1"]
    for got, (ts, color, depth) in zip(seq, frames):
        assert got.timestamp == pytest.approx(ts, abs=1e-6)
        np.testing.assert_array_equal(got.color, color)
        assert np.abs(got.depth - depth).max() <= 0.1 + 1e-5


@pytest.mark.parametrize("pkg", PACKAGES)
def test_associate_greedy_nearest(pkg):
    ds = PACKAGES[pkg]
    a = [(0.00, "a0"), (0.10, "a1"), (0.50, "a2")]
    b = [(0.005, "b0"), (0.115, "b1"), (0.90, "b2")]
    assert ds.associate(a, b, max_difference=0.02) == [(0, 0), (1, 1)]
    assert (2, 2) in ds.associate(a, b, max_difference=0.02, offset=-0.4)
    # unsorted, colliding timestamps: the two copies pair them alike
    rng = np.random.default_rng(1)
    ta = [(float(t), f"a{i}") for i, t in enumerate(rng.uniform(0, 1, 60).round(3))]
    tb = [(float(t), f"b{i}") for i, t in enumerate(rng.uniform(0, 1, 50).round(3))]
    assert ds.associate(ta, tb, max_difference=0.01) == jds.associate(
        ta, tb, max_difference=0.01)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_paired_png_dataset(tmp_path, pkg):
    ds = PACKAGES[pkg]
    frames = _frames(n=3)
    os.makedirs(tmp_path / "rgb")
    os.makedirs(tmp_path / "depth")
    for i, (_, color, depth) in enumerate(frames):
        Image.fromarray(color).save(tmp_path / "rgb" / f"{i:04d}.png")
        ds.write_depth_png(str(tmp_path / "depth" / f"{i:04d}.png"), depth, scale_to_mm=1.0)
    got = ds.PairedPNGDataset(str(tmp_path))
    other = PACKAGES["jax" if pkg == "torch" else "torch"].PairedPNGDataset(str(tmp_path))
    assert len(got) == len(other) == 3
    fr = got[1]
    np.testing.assert_array_equal(fr.color, frames[1][1])
    assert np.abs(fr.depth - frames[1][2]).max() <= 0.5 + 1e-5
    for i in range(3):
        np.testing.assert_array_equal(got[i].depth, other[i].depth)
        np.testing.assert_array_equal(got[i].color, other[i].color)


def test_write_tum_sequence_same_bytes_and_cross_read(tmp_path):
    frames = _frames(n=3)
    roots = {pkg: str(tmp_path / pkg / "rgbd_dataset_freiburg3_x") for pkg in PACKAGES}
    for pkg, ds in PACKAGES.items():
        ds.write_tum_sequence(roots[pkg], frames)
    names = _files(roots["jax"])
    assert names == _files(roots["torch"]) and len(names) == 2 + 2 * len(frames)
    for name in names:
        with open(os.path.join(roots["jax"], name), "rb") as a, \
                open(os.path.join(roots["torch"], name), "rb") as b:
            assert a.read() == b.read(), name
    # each package reads the other's sequence to the same frames
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        got = PACKAGES[reader].TUMSequence(roots[writer])
        want = PACKAGES[writer].TUMSequence(roots[writer])
        assert tuple(got.intrinsics) == tuple(want.intrinsics) == tuple(jds.TUM_INTRINSICS["fr3"])
        assert got.pairs == want.pairs
        for g, w in zip(got, want):
            assert g.timestamp == w.timestamp
            np.testing.assert_array_equal(g.depth, w.depth)
            np.testing.assert_array_equal(g.color, w.color)


def test_sensor_model_and_tables_are_copies():
    intr = jax_default_intrinsics(40, 32)
    _, _, gt = make_noisy_scene(32, 40, intr, seed=2)
    a = tds.kinect_v1_sensor_model(gt, np.random.default_rng(3))
    b = jds.kinect_v1_sensor_model(gt, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    assert tds.TUM_DEPTH_SCALE == jds.TUM_DEPTH_SCALE
    assert {k: tuple(v) for k, v in tds.TUM_INTRINSICS.items()} == {
        k: tuple(v) for k, v in jds.TUM_INTRINSICS.items()}
