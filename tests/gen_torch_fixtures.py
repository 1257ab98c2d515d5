"""Generate the JAX-package fixtures the PyTorch port is held against.

    python tests/gen_torch_fixtures.py [full] [ext] [stages] [dasp]

Not a test module (pytest collects test_*.py only).  Runs the JAX package
on the CPU and writes, with np.savez_compressed, under tests/golden/:

  full    kde_jax_640x480_seed0.npz — kde_pipeline(KDEConfig()) on
          make_noisy_scene(480, 640, seed=0) (~4 min of XLA compile):
          nasp_labels and merged_labels (int16), jbf_depth and the
          optimized depth optimized_z (f32), the NASP seeds (int16), and
          the normals as f16 only while the file stays within 3 MB.
  ext     kde_jax_96x128_ext_seed0.npz — kde_pipeline at 96x128 (the
          oracle scene, grid 3x4) under four configs: plane_merge=True,
          fill_holes=4, grid 5x6 (does not divide 96x128) and
          nasp.iterations=3; per config "<name>__nasp_labels",
          "__merged_labels", "__merged_sizes" and "__optimized_z", and the
          config-independent jbf_depth and normals once, and the seeds
          the JAX package samples from those normals on each grid
          ("<name>__seeds").
  stages  torch_stages_96x128_seed0.npz — the JAX JBF points and NASP
          result at 96x128 (grid 3x4) that tests/test_torch_ccl_plane.py
          feeds both packages' merge and plane stages, and the covariance
          kernel's inputs and outputs (pallas_cov in interpret mode) on a
          48x64 crop for tests/test_torch_normals.py.

  dasp    dasp_jax_96x128_seed0.npz — rgbf_pipeline, spdsp_pipeline and
          tof_pipeline at 96x128 (the oracle scene, grid 3x4) from the raw
          depth's points: the seeds both DASP segmentations sample
          ("seeds"), and for RGBF and SPDSP "<name>__color_labels",
          "__depth_labels" (the two SLICs'), "__refined_labels" (int16)
          and "__refined_depth" (TOF's front end is SPDSP's);
          SPDSP's "__planes_nd", "__plane_fitted_z" and "__optimized_z";
          TOF's "__plane_fitted_z", "__merged_labels" (int16) and
          "__merged_eigenvalues" (TOF's optimized points are its refined
          points; every point map is rays * z, so z is stored).
          dasp_jax_640x480_seed0.npz — the same three pipelines with their
          default configs on make_noisy_scene(480, 640, seed=0): the seeds,
          the int16 label maps, TOF's merged labels, and the two f32 maps
          chip_smoke.py holds the card's output against, SPDSP's optimized
          z and TOF's plane-fitted z (RGBF's refined depth would take the
          two files past 2 MB together: RGBF is held by its labels there).

The fixtures are read with np.load only (tests/golden.py::cached would
rewrite a fixture whose key differs).  Rerun a part after a change to the
JAX package's code it runs; the port's tests then read the new arrays.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FULL = os.path.join(GOLDEN, "kde_jax_640x480_seed0.npz")
EXT = os.path.join(GOLDEN, "kde_jax_96x128_ext_seed0.npz")
STAGES = os.path.join(GOLDEN, "torch_stages_96x128_seed0.npz")
DASP_SMALL = os.path.join(GOLDEN, "dasp_jax_96x128_seed0.npz")
DASP_FULL = os.path.join(GOLDEN, "dasp_jax_640x480_seed0.npz")
FULL_MAX_BYTES = 3 * 2**20


def _jax():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def ext_configs():
    """The four 96x128 configs of the ext fixture, by name (JAX KDEConfig)."""
    from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig

    base = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    return {
        "plane_merge": dataclasses.replace(base, plane_merge=True),
        "fill_holes": dataclasses.replace(base, fill_holes=4),
        "grid5x6": dataclasses.replace(base, grid=GridParams(rows=5, cols=6)),
        "iter3": dataclasses.replace(base, nasp=dataclasses.replace(base.nasp, iterations=3)),
    }


def _save(path, arrays):
    np.savez_compressed(path, **arrays)
    print(f"wrote {path}: {os.path.getsize(path)} bytes")


def gen_full():
    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import slic

    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    cfg = KDEConfig()
    t0 = time.time()
    res = jax.jit(lambda d, c: pipelines.kde_pipeline(d, c, intr, cfg))(
        jnp.asarray(noisy), jnp.asarray(color))
    res = jax.tree_util.tree_map(np.asarray, res)
    print(f"kde_pipeline 640x480: {time.time() - t0:.1f} s")
    color_f = jnp.asarray(color, jnp.float32)
    seeds = jax.jit(lambda c, n: slic._compute_seeds(
        c, n, cfg.grid, h, w, 8, "nasp", grad_impl=cfg.nasp.grad_impl))(
        color_f, jnp.asarray(res.normals))
    arrays = dict(
        nasp_labels=res.nasp_labels.astype(np.int16),
        merged_labels=res.merged_labels.astype(np.int16),
        jbf_depth=res.jbf_depth.astype(np.float32),
        optimized_z=res.optimized_points[..., 2].astype(np.float32),
        seeds=np.asarray(seeds).astype(np.int16),
    )
    _save(FULL, dict(arrays, normals=res.normals.astype(np.float16)))
    if os.path.getsize(FULL) > FULL_MAX_BYTES:
        print("normals take the file past 3 MB: left out")
        _save(FULL, arrays)


def gen_ext():
    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import slic

    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    arrays = {}
    for name, cfg in ext_configs().items():
        t0 = time.time()
        res = jax.jit(lambda d, c, cfg=cfg: pipelines.kde_pipeline(d, c, intr, cfg))(
            jnp.asarray(noisy), jnp.asarray(color))
        res = jax.tree_util.tree_map(np.asarray, res)
        print(f"{name}: {time.time() - t0:.1f} s")
        arrays[f"{name}__nasp_labels"] = res.nasp_labels.astype(np.int16)
        arrays[f"{name}__merged_labels"] = res.merged_labels.astype(np.int16)
        arrays[f"{name}__merged_sizes"] = res.merged_sizes.astype(np.int32)
        arrays[f"{name}__optimized_z"] = res.optimized_points[..., 2].astype(np.float32)
        seeds = jax.jit(lambda c, n, cfg=cfg: slic._compute_seeds(
            c, n, cfg.grid, h, w, 8, "nasp", grad_impl=cfg.nasp.grad_impl))(
            jnp.asarray(color, jnp.float32), jnp.asarray(res.normals))
        arrays[f"{name}__seeds"] = np.asarray(seeds).astype(np.int16)
        arrays.setdefault("jbf_depth", res.jbf_depth.astype(np.float32))
        arrays.setdefault("normals", res.normals.astype(np.float32))
        if name == "fill_holes":
            filled = (res.optimized_points[..., 2] > 50.0) & (noisy <= 50.0)
            print(f"fill_holes: {int(filled.sum())} hole pixels with depth in the output")
    _save(EXT, arrays)


def gen_stages():
    _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig, NormalParams
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.ops import bilateral, normals, pallas_cov, slic

    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    # tests/test_torch_ccl_plane.py: JBF points and the NASP result (grid 3x4)
    jp = NormalParams(cov_impl="xla", dt_impl="xla")
    points = projective_to_real(
        bilateral.joint_bilateral_filter(jnp.asarray(noisy), jnp.asarray(color)), intr)
    nmap = normals.generate_normal_map(points, jp)
    grid = GridParams(rows=3, cols=4)
    cfg = dataclasses.replace(KDEConfig(), grid=grid)
    nasp = slic.segment(jnp.asarray(color), points, nmap, grid=grid, params=cfg.nasp,
                        variant="nasp")
    # tests/test_torch_normals.py: the covariance kernel on a 48x64 crop of
    # the unfiltered scene's vertex map
    vm = np.asarray(projective_to_real(jnp.asarray(noisy), intr)) / 1000.0
    sm = np.asarray(normals.smoothing_map(jnp.asarray(vm), jp))
    v = np.ascontiguousarray(vm[24:72, 32:96]).astype(np.float32)
    rect = sm[24:72, 32:96].astype(np.int32)
    jc, je = pallas_cov._cm_covariances_batched(
        jnp.asarray(v)[None], jnp.asarray(rect)[None], tile=48, interpret=True)
    _save(STAGES, dict(
        points=np.asarray(points, np.float32),
        nasp_labels=np.asarray(nasp.labels).astype(np.int16),
        cluster_normal=np.asarray(nasp.clusters.normal, np.float32),
        cluster_center=np.asarray(nasp.clusters.center, np.float32),
        cov_vm=v, cov_rect=rect,
        cov_count=np.asarray(jc)[0], cov_entries=np.asarray(je)[0],
    ))


def dasp_configs(grid=None):
    """The three pipelines' JAX configs, by name, on `grid` (default: each
    config's own, 15x20)."""
    from kinectdepthmapenhancement_tpu.core.config import RGBFConfig, SPDSPConfig, TOFConfig

    cfgs = {"rgbf": RGBFConfig(), "spdsp": SPDSPConfig(), "tof": TOFConfig()}
    if grid is not None:
        cfgs = {k: dataclasses.replace(c, grid=grid) for k, c in cfgs.items()}
    return cfgs


def _dasp_run(h, w, grid, small):
    """Run the three JAX pipelines on make_noisy_scene(h, w, seed=0) and
    return the fixture's arrays (see the module docstring)."""
    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import slic

    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    d, c = jnp.asarray(noisy), jnp.asarray(color)
    pts = projective_to_real(d, intr)
    cfgs = dasp_configs(grid)
    seeds = jax.jit(lambda cf: slic._compute_seeds(
        cf, None, cfgs["rgbf"].grid, h, w, 4, "dasp"))(jnp.asarray(color, jnp.float32))
    arrays = {"seeds": np.asarray(seeds).astype(np.int16)}
    runs = {
        "rgbf": lambda d, p, c, cfg: pipelines.rgbf_pipeline(d, p, c, cfg),
        "spdsp": lambda d, p, c, cfg: pipelines.spdsp_pipeline(d, p, c, intr, cfg),
        "tof": lambda d, p, c, cfg: pipelines.tof_pipeline(d, p, c, intr, cfg),
    }
    for name, cfg in cfgs.items():
        t0 = time.time()
        fn = jax.jit(lambda d, p, c, run=runs[name], cfg=cfg: run(d, p, c, cfg))
        res = jax.tree_util.tree_map(np.asarray, fn(d, pts, c))
        print(f"{name} {h}x{w}: {time.time() - t0:.1f} s")
        out = {}
        if name == "spdsp":  # its SLIC labels (SPDSPResult does not return them)
            for f, params in (("color_labels", cfg.color_slic), ("depth_labels", cfg.depth_slic)):
                seg = jax.jit(lambda c, p, params=params, cfg=cfg: slic.segment(
                    c, p, grid=cfg.grid, params=params, variant="dasp").labels)
                out[f] = np.asarray(seg(c, pts)).astype(np.int16)
        for f in ("color_labels", "depth_labels", "refined_labels", "merged_labels"):
            if hasattr(res, f):
                out[f] = getattr(res, f).astype(np.int16)
        if name == "rgbf":
            if small:
                out["refined_depth"] = res.refined_depth
        elif name == "spdsp":
            out["optimized_z"] = res.optimized_points[..., 2]
            if small:
                out.update(refined_depth=res.refined_depth, planes_nd=res.planes_nd,
                           plane_fitted_z=res.plane_fitted[..., 2])
        else:
            out["plane_fitted_z"] = res.plane_fitted[..., 2]
            out.pop("refined_labels")  # TOF's front end is SPDSP's
            if small:
                out["merged_eigenvalues"] = res.merged_eigenvalues
        arrays.update({f"{name}__{k}": v for k, v in out.items()})
    return arrays


def gen_dasp():
    _jax()
    from kinectdepthmapenhancement_tpu.core.config import GridParams

    _save(DASP_SMALL, _dasp_run(96, 128, GridParams(rows=3, cols=4), small=True))
    _save(DASP_FULL, _dasp_run(480, 640, None, small=False))


if __name__ == "__main__":
    parts = sys.argv[1:] or ["full", "ext", "stages", "dasp"]
    for part in parts:
        {"full": gen_full, "ext": gen_ext, "stages": gen_stages, "dasp": gen_dasp}[part]()
