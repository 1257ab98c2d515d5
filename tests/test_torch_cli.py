"""PyTorch port: the `enhance` command (cli.py, python -m
kinectdepthmapenhancement_tpu_torch), the file IO copy (core/io.py) and
the debug renders (utils/visualize.py) on the CPU, against the JAX
package's.

Bars, and why:
  * `enhance --device cpu` through files at 48x64 (jbf, mrf): the refined
    depth read back EQUALS the pipeline's output on the same arrays (the
    XML holds each f32 as %.9g, which round-trips exactly), and the JAX
    package's reader reads the port's file to the same values;
  * the IO module is a copy: the same bytes written, the same arrays read;
  * every render EQUAL to the JAX package's on the same inputs (u8 images,
    the point cloud, the PLY text, the debug PNGs);
  * the default device, "cuda", raises without a card, for `enhance` and
    for `evaluate` (tests/test_torch_evaluate.py holds the `evaluate`
    command itself).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core import io as jio
from kinectdepthmapenhancement_tpu.core.camera import projective_to_real as jreal
from kinectdepthmapenhancement_tpu.utils import visualize as jvis
from kinectdepthmapenhancement_tpu_torch import cli
from kinectdepthmapenhancement_tpu_torch.core import io
from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.models.pipelines import KDEResult
from kinectdepthmapenhancement_tpu_torch.utils import visualize

torch.set_num_threads(2)

H, W = 48, 64


def _files(tmp_path, seed=4):
    intr = default_kinect_intrinsics(W, H)
    color, noisy, _ = make_noisy_scene(H, W, intr, seed=seed)
    depth_xml, color_png = str(tmp_path / "depth.xml"), str(tmp_path / "color.png")
    io.write_filestorage_xml(depth_xml, {"depth": noisy})
    Image.fromarray(color).save(color_png)
    return color, noisy, depth_xml, color_png


@pytest.mark.parametrize("name", ["jbf", "mrf"])
def test_enhance_through_files(tmp_path, name):
    color, noisy, depth_xml, color_png = _files(tmp_path)
    out_xml, ply, png = (str(tmp_path / f) for f in ("refined.xml", "cloud.ply", "depth.png"))
    rc = cli.main(["enhance", "--depth", depth_xml, "--color", color_png, "--pipeline", name,
                   "--out", out_xml, "--ply", ply, "--png", png, "--device", "cpu"])
    assert rc == 0
    fn = pipelines.jbf_pipeline if name == "jbf" else pipelines.mrf_pipeline
    want = fn(torch.from_numpy(noisy), torch.from_numpy(color)).numpy()
    got = io.read_filestorage_xml(out_xml)["depth"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jio.read_filestorage_xml(out_xml)["depth"], want)
    assert not np.array_equal(got, noisy)
    assert open(ply).readline().strip() == "ply"
    with Image.open(png) as im:
        assert im.size == (W, H)


def test_io_is_the_jax_modules_copy(tmp_path):
    rng = np.random.default_rng(0)
    mats = {"depth": rng.uniform(0, 4000, (5, 7)).astype(np.float32),
            "averaged_depth": rng.normal(size=(3, 4))}
    a, b = str(tmp_path / "a.xml"), str(tmp_path / "b.xml")
    io.write_filestorage_xml(a, mats)
    jio.write_filestorage_xml(b, mats)
    assert open(a).read() == open(b).read()
    back = io.read_filestorage_xml(b)
    for k, v in mats.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    png = str(tmp_path / "c.png")
    img = rng.integers(0, 255, (6, 9, 3), dtype=np.uint8)
    Image.fromarray(img).save(png)
    np.testing.assert_array_equal(io.imread_rgb(png), jio.imread_rgb(png))


def test_evaluate_and_default_device_raise(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["evaluate", str(tmp_path / "out.txt")])
        _, _, depth_xml, color_png = _files(tmp_path)
        with pytest.raises(RuntimeError):
            cli.main(["enhance", "--depth", depth_xml, "--color", color_png,
                      "--pipeline", "jbf", "--out", str(tmp_path / "r.xml")])


def _render_inputs(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 12, (H, W)).astype(np.int32)
    color = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    normals = rng.normal(size=(H, W, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    normals[rng.random((H, W)) < 0.1] = -1.0
    depth = rng.uniform(0, 9000, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    depth[:2] = np.round(depth[:2])  # ties in the histogram
    return labels, color, normals, depth


def test_renders_match_jax():
    labels, color, normals, depth = _render_inputs()
    t = torch.from_numpy
    pairs = [
        (visualize.random_color_labels(t(labels), 12), jvis.random_color_labels(jnp.asarray(labels), 12)),
        (visualize.label_boundaries(t(color), t(labels)),
         jvis.label_boundaries(jnp.asarray(color), jnp.asarray(labels))),
        (visualize.normal_image(t(normals)), jvis.normal_image(jnp.asarray(normals))),
        (visualize.depth_rgb(t(depth)), jvis.depth_rgb(jnp.asarray(depth))),
        (visualize.depth_histogram_image(t(depth)), jvis.depth_histogram_image(jnp.asarray(depth))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_point_cloud_and_ply_match_jax(tmp_path):
    _, color, _, depth = _render_inputs(1)
    intr = default_kinect_intrinsics(W, H)
    pts = np.array(jreal(jnp.asarray(depth), intr))
    for flip in (False, True):
        got = visualize.point_cloud(torch.from_numpy(pts), torch.from_numpy(color), flip_z=flip)
        want = jvis.point_cloud(pts, color, flip_z=flip)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(visualize.point_cloud(torch.from_numpy(pts)),
                                  jvis.point_cloud(pts))
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    visualize.save_ply(a, got[:50])
    jvis.save_ply(b, want[:50])
    assert open(a).read() == open(b).read()


def test_dump_kde_debug_matches_jax(tmp_path):
    labels, color, normals, depth = _render_inputs(2)
    pts = np.concatenate([np.zeros((H, W, 2), np.float32), depth[..., None]], -1)
    arrays = dict(optimized_points=pts, plane_fitted=pts, jbf_depth=depth, normals=normals,
                  nasp_labels=labels, merged_labels=np.roll(labels, 3, 1),
                  merged_variance=np.zeros(12, np.float32), merged_sizes=np.zeros(12, np.int32))
    got = visualize.dump_kde_debug(str(tmp_path / "port"), KDEResult(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}), torch.from_numpy(color), 12)
    want = jvis.dump_kde_debug(str(tmp_path / "jax"), KDEResult(
        **{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(color), 12)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with Image.open(a) as ia, Image.open(b) as ib:
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
