"""PyTorch port: the native frame source (native/, framesource.cpp built with
g++ under build/native/) against the port's core/io.py.

The three cases of tests/test_native.py, and the frame source feeding
models/streaming.py::run_stream at 96x128 (grid 3x4, 6 frames, batch 4):
the stream's state EQUAL to the run over the same frames read by
core/io.py.  The XML holds each f32 as %.9g, which the C++ parser reads
back exactly, so every frame is EQUAL to the array written; raw .bin
frames are bytes.  Skipped where no C++ compiler exists (as
tests/test_native.py:8-11), with the compiler's message.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch import native
from kinectdepthmapenhancement_tpu_torch.core import io
from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import streaming

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")


def test_library_builds_under_build_native(lib_ok):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.BUILD_DIR == type(native.BUILD_DIR)(repo) / "build" / "native"
    assert (native.BUILD_DIR / "libframesource.so").exists()
    with open(native._SRC.parent.parent.parent / "kinectdepthmapenhancement_tpu" / "native"
              / "framesource.cpp") as a, open(native._SRC) as b:
        assert a.read() == b.read()


def test_native_xml_read_matches_python(tmp_path, lib_ok):
    p = str(tmp_path / "depth.xml")
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 5000, (12, 16)).astype(np.float32)
    io.write_filestorage_xml(p, {"averaged_depth": depth * 0.5, "depth": depth})
    mats = io.read_filestorage_xml(p)
    np.testing.assert_array_equal(native.read_depth_xml(p, "depth", 16, 12), mats["depth"])
    np.testing.assert_array_equal(native.read_depth_xml(p, "averaged_depth", 16, 12),
                                  mats["averaged_depth"])
    with pytest.raises(IOError):
        native.read_depth_xml(p, "missing", 16, 12)


def test_framesource_streams_round_robin(tmp_path, lib_ok):
    frames, paths = [], []
    rng = np.random.default_rng(1)
    for i in range(3):
        f = rng.uniform(0, 4000, (8, 10)).astype(np.float32)
        p = str(tmp_path / f"frame{i}.bin")
        f.tofile(p)
        frames.append(f)
        paths.append(p)
    with native.FrameSource(paths, width=10, height=8, capacity=2) as src:
        seen = list(native.iter_frames(src, 6))
        assert src.io_errors() == 0
    for i, s in enumerate(seen):
        np.testing.assert_array_equal(s, frames[i % 3])


def test_framesource_xml_frames(tmp_path, lib_ok):
    depth = np.arange(48, dtype=np.float32).reshape(6, 8) * 10.0
    p = str(tmp_path / "d.xml")
    io.write_filestorage_xml(p, {"depth": depth})
    with native.FrameSource([p], width=8, height=6) as src:
        got = src.next()
    np.testing.assert_array_equal(got, io.read_filestorage_xml(p)["depth"])


def test_framesource_feeds_run_stream(tmp_path, lib_ok):
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, _, gt = make_noisy_scene(h, w, intr, seed=0)
    rng = np.random.default_rng(0)
    var = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    paths = []
    for i in range(6):
        p = str(tmp_path / f"d{i:02d}.xml")
        io.write_filestorage_xml(p, {"depth": (gt + rng.uniform(-1, 1, gt.shape) * var)
                                     .astype(np.float32)})
        paths.append(p)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(3, 4))
    run = dict(color=color, intr=intr, cfg=cfg, batch=4, device="cpu")
    with native.FrameSource(paths, width=w, height=h) as src:
        got = streaming.run_stream(native.iter_frames(src, len(paths)), **run)
    want = streaming.run_stream((io.read_filestorage_xml(p)["depth"] for p in paths), **run)
    assert got.frame_index == want.frame_index == 6
    assert got.metric_sums == want.metric_sums and got.metric_counts == want.metric_counts
    assert torch.equal(got.buffer.depth, want.buffer.depth)
    assert torch.equal(got.buffer.weight, want.buffer.weight)
