"""Generate the JAX-package fixtures the PyTorch port is held against.

    python tests/gen_torch_fixtures.py [full] [ext] [stages] [dasp] [normals] [refs]
                                       [eval] [planes] [registration] [parallel]
                                       [sdc_spread]

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

  normals kde_jax_96x128_normals_seed0.npz — kde_pipeline at 96x128 (the
          oracle scene, grid 3x4) with normals.method "sdc" and
          "bilateral": per method "<method>__nasp_labels",
          "__merged_labels" (int16), "__merged_sizes", "__optimized_z",
          "__normals" (f32) and "__seeds" (int16, sampled from those
          normals), and jbf_depth once.
          kde_jax_640x480_normals_seed0.npz — the same two methods with the
          default grid on make_noisy_scene(480, 640, seed=0), the B=1
          frame chip_smoke.py holds the card to: per method the label maps
          (int16), the seeds, the normals' validity (packed bits), the
          normals on every 4th row and column (f16) and the optimized z as
          its f32 difference from the "cm" method's in kde_jax_640x480_
          seed0.npz ("__optimized_z_minus_cm", checked to add back
          exactly; all zeros on this frame, where the three methods give
          the same optimized z); and mrf_pipeline's output on the same
          frame ("mrf__depth", f32).  The JBF depth of that frame is
          kde_jax_640x480_seed0.npz's.

  refs    torch_refs_96x128_seed0.npz — the JAX and oracle outputs that
          tests/test_torch_nasp.py and tests/test_torch_dasp.py hold the
          port to, on the inputs those modules build from numpy seeds:
          "nasp__*" the pallas_nasp kernels in interpret mode (each
          parametrised case), the JAX points and normals of the NASP scene,
          the JAX segment on the fused Pallas route, and the JAX weighted
          update of the subnormal case; "dasp__*" the SLIC oracle's SP /
          DASP segmentations, the JAX colour seeds and the JAX 5-iteration
          DASP segmentations (~40 s).

  eval    eval_jax_96x128_seed6.npz — the JAX evaluate_tum on the sequence
          of tests/test_datasets.py:106-134 (make_noisy_scene(96, 128,
          seed=6) through kinect_v1_sensor_model, 8 frames, grid 3x4,
          timing_iters=1): per row "<row>__mean_3d_error_mm", "__rmse_mm"
          and "__valid_px"; the pseudo-ground truth the sequence folds to
          ("gt"), and on the evaluated frame each row's scored depth
          ("<row>__z") and the NASP seeds of the kde row ("kde__seeds",
          sampled from its normals), to tell a seed near-tie from a fault.

  planes  kde_jax_planes_seed0.npz — kde_pipeline with plane_merge=True,
          and with plane_merge=True, fill_holes=4, under normals.method
          "cm" and "sdc", on make_banded_scene(seed=0, hole_fraction=0.15)
          (scripts/eval_far_range.py --holes 0.15's frame, where the plane
          stage moves pixels): per run "<method>_<config>__optimized_z"
          (f32; for every run after the first, cm_pm, its difference from
          the first's, "__optimized_z_minus_first", checked to add back
          exactly), "__merged_labels" (int16), "__moved" (packed bits: the
          pixels whose output point lies more than MOVED_MM from the final
          depth bilateral of the JBF points alone) and "__filled" (packed
          bits: input holes with depth in the output), at 640x480
          ("480x640__" first) and at 96x128 on grid 3x4 ("96x128__"
          first), each size written only where pixels move.

  registration
          registration_jax_640x480_seed0.npz — register_depth_to_color
          (eager, no jax.jit) of make_noisy_scene(480, 640, seed=0)'s
          noisy depth through golden.registration_extrinsics() (a 2 degree
          rotation about y and a 25 mm baseline) with the default
          intrinsics: the
          filled pixels ("filled", packed bits) and the z map on every 4th
          row and column ("z_sub4", f32), and the projected coordinates
          ("near_uc", "near_vc") of the source points where one of them
          lies within 1e-3 px of .5, where the two packages may round a
          point to different pixels.

  parallel
          parallel_jax_seed0.npz — the JAX package's parallel/ on 8 CPU
          devices (the part sets XLA_FLAGS' host device count, so it runs
          first of the parts named): "jbf_sharded", jbf_sharded at spatial
          8 on the 48x64 inputs of tests/test_parallel.py:92-95 (seed 5,
          10% holes; parallel_jbf_inputs); "kde__optimized_z", sharded_kde_step on
          make_mesh(8, spatial=2) (data 4 x x 2) over make_noisy_scene(96,
          128, seed=0..3), grid 3x4 (parallel_kde_inputs), the optimized
          points' z (f32; the points are rays * z); and, from the unsharded
          jitted kde_pipeline on the same frames (the sharded step returns
          only the points), the stages golden.kde_gates reads besides:
          "kde__jbf_depth" (f32), "kde__normals" (f16), "kde__nasp_labels"
          and "kde__merged_labels" (int16), each [4, 96, 128, ...] (~4 min).

  sdc_spread
          writes nothing: the SDC plane runs of the planes part at 640x480
          again with ops/integral.py's tables summed in float64 (as the
          port sums them), each held to the planes fixture by
          golden.plane_stage_gates with every bar reported: the spread
          that golden.SDC_PLANES_640X480_BARS doubles (not in the default
          list of parts).

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
REFS = os.path.join(GOLDEN, "torch_refs_96x128_seed0.npz")
NORMALS_SMALL = os.path.join(GOLDEN, "kde_jax_96x128_normals_seed0.npz")
NORMALS_FULL = os.path.join(GOLDEN, "kde_jax_640x480_normals_seed0.npz")
NORMAL_METHODS = ("sdc", "bilateral")
EVAL = os.path.join(GOLDEN, "eval_jax_96x128_seed6.npz")
PLANES = os.path.join(GOLDEN, "kde_jax_planes_seed0.npz")
EVAL_ROWS = ("input", "jbf", "mrf", "rgbf", "kde")
PLANE_METHODS = ("cm", "sdc")
# a pixel the plane stage moved: its output point differs from the final
# depth bilateral of the JBF points alone by more than this (mm); below it,
# the two are the same computation rounded in another order
MOVED_MM = 0.01
REGISTRATION = os.path.join(GOLDEN, "registration_jax_640x480_seed0.npz")
PARALLEL = os.path.join(GOLDEN, "parallel_jax_seed0.npz")
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


def _nasp_refs():
    """The JAX outputs test_torch_nasp.py reads, keyed by case."""
    _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.config import NormalParams
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.ops import normals, pallas_nasp, slic

    import test_torch_nasp as t

    out = {}
    intr = default_kinect_intrinsics(t.W, t.H)
    color, noisy, _ = make_noisy_scene(t.H, t.W, intr, seed=5)
    pts = projective_to_real(jnp.asarray(noisy), intr)
    nmap = normals.generate_normal_map(pts, NormalParams(cov_impl="xla", dt_impl="xla"))
    out["scene_points"], out["scene_normals"] = np.asarray(pts), np.asarray(nmap)
    seeds = t.scene_seeds()
    cl = slic.init_clusters(jnp.asarray(seeds), jnp.asarray(color), pts, nmap)
    cand = np.concatenate(
        [np.asarray(cl.rgb), np.asarray(cl.xy).astype(np.float32),
         np.asarray(cl.center)[:, 2:3], np.asarray(cl.normal)], axis=-1,
    ).reshape(t.GRID.rows, t.GRID.cols, 9)
    out["assign_cand"] = cand
    for r in t.ASSIGN_R:
        res = pallas_nasp.nasp_assign_and_analyze(
            jnp.asarray(color, jnp.float32), pts, nmap, jnp.asarray(cand), interpret=True,
            **t.assign_kw(r))
        for name, a in zip(("labels", "distance", "sums"), res):
            out[f"assign_r{r}__{name}"] = np.asarray(a)
    for mode, r, label_map in t.CELL_SUMS_CASES:
        args, kw = t.cell_sums_inputs(mode, r, label_map)
        out[f"cell_sums_{mode}_r{r}_{label_map}"] = np.asarray(pallas_nasp.nasp_cell_sums(
            *(jnp.asarray(a) for a in args), interpret=True, **kw))
    for f, r in t.LABEL_SUMS_CASES:
        labels, feats = t.label_sums_inputs(f, r)
        out[f"label_sums_f{f}_r{r}"] = np.asarray(pallas_nasp.label_cell_sums(
            jnp.asarray(labels), jnp.asarray(feats), interpret=True, **dict(t.CELL, r=r)))
    for f, r in t.GATHER_CASES:
        labels, table = t.gather_inputs(f, r)
        out[f"gather_f{f}_r{r}"] = np.asarray(pallas_nasp.label_cell_gather(
            jnp.asarray(labels), jnp.asarray(table), interpret=True, **dict(t.CELL, r=r)))
    slic.force_cell(True)
    slic.tables.force_mode("mxu")
    try:
        seg = slic.segment(
            jnp.asarray(color), pts, nmap, grid=t.GRID,
            params=dataclasses.replace(t.PARAMS, stats_impl="pallas"), variant="nasp",
            seeds=jnp.asarray(seeds))
    finally:
        slic.force_cell(None)
        slic.tables.force_mode(None)
    out["segment__labels"], out["segment__distance"] = np.asarray(seg.labels), np.asarray(
        seg.distance)
    for name in t.CLUSTER_FIELDS:
        out[f"segment__{name}"] = np.asarray(getattr(seg.clusters, name))
    labels, color_f, points, normals_, cl = t.subnormal_inputs()
    idx = slic._CellIndex(jnp.asarray(labels), t.GRID, t.R, t.H, t.W, kernel_sums=False)
    upd = slic._update_nasp_weighted(
        idx, jnp.asarray(labels), slic.Clusters(**{k: jnp.asarray(v) for k, v in cl.items()}),
        jnp.asarray(color_f), jnp.asarray(points), jnp.asarray(normals_), t.GRID,
        dataclasses.replace(t.PARAMS, stats_impl="xla"), t.SUBNORMAL_WINDOW, t.H, t.W)
    for name in t.CLUSTER_FIELDS:
        out[f"subnormal__{name}"] = np.asarray(getattr(upd, name))
    return {f"nasp__{k}": v for k, v in out.items()}


def _dasp_refs():
    """The oracle and JAX outputs test_torch_dasp.py reads, keyed by case."""
    _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.config import SLICParams
    from kinectdepthmapenhancement_tpu.ops import slic

    import oracle_slic
    import test_torch_dasp as t

    out = {}
    small = t.small_scene_arrays()
    color, _, points = t.crop(small)
    for name, (variant, sig, iters) in t.ORACLE_CASES.items():
        want = oracle_slic.slic_segment(
            color, None if variant == "sp" else points, None, 3, 4, *sig, iters, variant)
        for f in ("labels", "rgb", "xy", "center"):
            out[f"oracle_{name}__{f}"] = np.asarray(want[f])
    for variant, window in t.SEED_CASES:
        for h, w in t.SEED_SIZES:
            cf = small["color"][:h, :w].astype(np.float32)
            out[f"seeds_{variant}_{h}x{w}"] = np.asarray(slic._compute_seeds(
                jnp.asarray(cf), None, t.GRID, h, w, window, variant, grad_impl="xla"))
    for name, sig in t.FIVE_ITER_CASES.items():
        res = slic.segment(jnp.asarray(color), jnp.asarray(points), None, grid=t.GRID,
                           params=SLICParams(*sig, 5), variant="dasp")
        out[f"five_{name}__labels"] = np.asarray(res.labels)
        out[f"five_{name}__xy"] = np.asarray(res.clusters.xy)
        out[f"five_{name}__center"] = np.asarray(res.clusters.center)
    return {f"dasp__{k}": v for k, v in out.items()}


def gen_refs():
    arrays = {}
    for name, fn in (("nasp", _nasp_refs), ("dasp", _dasp_refs)):
        t0 = time.time()
        arrays.update(fn())
        print(f"{name} refs: {time.time() - t0:.1f} s")
    _save(REFS, arrays)


def normal_configs(grid=None):
    """KDEConfig under each of NORMAL_METHODS (JAX), on `grid` (default 15x20)."""
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig

    base = KDEConfig() if grid is None else dataclasses.replace(KDEConfig(), grid=grid)
    return {m: dataclasses.replace(base, normals=dataclasses.replace(base.normals, method=m))
            for m in NORMAL_METHODS}


def _minus_cm(z):
    """z - the cm method's optimized z at 640x480 (FULL), checked to add
    back to z exactly."""
    with np.load(FULL) as f:
        cm = f["optimized_z"]
    d = (z - cm).astype(np.float32)
    if not np.array_equal(cm + d, z):
        raise ValueError("optimized z does not round-trip through its difference from cm's")
    return d


def _normals_run(h, w, grid, small):
    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import slic

    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    d, c = jnp.asarray(noisy), jnp.asarray(color)
    arrays = {}
    for name, cfg in normal_configs(grid).items():
        t0 = time.time()
        res = jax.jit(lambda d, c, cfg=cfg: pipelines.kde_pipeline(d, c, intr, cfg))(d, c)
        res = jax.tree_util.tree_map(np.asarray, res)
        seeds = jax.jit(lambda c, n, cfg=cfg: slic._compute_seeds(
            c, n, cfg.grid, h, w, 8, "nasp", grad_impl=cfg.nasp.grad_impl))(
            jnp.asarray(color, jnp.float32), jnp.asarray(res.normals))
        print(f"{name} {h}x{w}: {time.time() - t0:.1f} s")
        out = dict(nasp_labels=res.nasp_labels.astype(np.int16),
                   merged_labels=res.merged_labels.astype(np.int16),
                   optimized_z=res.optimized_points[..., 2].astype(np.float32),
                   seeds=np.asarray(seeds).astype(np.int16))
        if small:
            out.update(merged_sizes=res.merged_sizes.astype(np.int32),
                       normals=res.normals.astype(np.float32))
            arrays.setdefault("jbf_depth", res.jbf_depth.astype(np.float32))
        else:
            out.update(normal_valid=np.packbits((res.normals != -1.0).any(-1)),
                       normals_sub4=res.normals[::4, ::4].astype(np.float16),
                       optimized_z_minus_cm=_minus_cm(out.pop("optimized_z")))
        arrays.update({f"{name}__{k}": v for k, v in out.items()})
    if not small:
        t0 = time.time()
        arrays["mrf__depth"] = np.asarray(
            jax.jit(pipelines.mrf_pipeline)(d, c)).astype(np.float32)
        print(f"mrf {h}x{w}: {time.time() - t0:.1f} s")
    return arrays


def gen_normals():
    _jax()
    from kinectdepthmapenhancement_tpu.core.config import GridParams

    _save(NORMALS_SMALL, _normals_run(96, 128, GridParams(rows=3, cols=4), small=True))
    _save(NORMALS_FULL, _normals_run(480, 640, None, small=False))


def tum_eval_frames(datasets, make_noisy_scene, intr_fn):
    """tests/test_datasets.py:106-134's sequence: (timestamp, color, depth)
    for 8 frames of make_noisy_scene(96, 128, seed=6) through the Kinect v1
    sensor model (either package's copies of the NumPy functions)."""
    h, w = 96, 128
    color, _, gt = make_noisy_scene(h, w, intr_fn(w, h), seed=6)
    rng = np.random.default_rng(6)
    return [(100.0 + 0.033 * i, color, datasets.kinect_v1_sensor_model(gt, rng))
            for i in range(8)]


def gen_eval():
    import tempfile

    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core import buffer2d, datasets
    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig, RGBFConfig
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import slic
    from kinectdepthmapenhancement_tpu.utils import evaluate

    grid = GridParams(rows=3, cols=4)
    frames = tum_eval_frames(datasets, make_noisy_scene, default_kinect_intrinsics)
    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "seq")
        datasets.write_tum_sequence(root, frames)
        t0 = time.time()
        rows = evaluate.evaluate_tum(root, frames=8, include_sp_methods=False, grid=grid,
                                     timing_iters=1)
        print(f"evaluate_tum 96x128: {time.time() - t0:.1f} s")
        seq = datasets.TUMSequence(root)
        buf = buffer2d.init(96, 128)
        for i in range(8):
            buf = buffer2d.update(buf, jnp.asarray(seq[i].depth))
        fr, intr = seq[4], seq.intrinsics
    for name in EVAL_ROWS:
        for k, v in rows[name].items():
            arrays[f"{name}__{k}"] = np.asarray(v, np.int64 if k == "valid_px" else np.float64)
    d, c = jnp.asarray(fr.depth), jnp.asarray(fr.color)
    kde_cfg = dataclasses.replace(KDEConfig(), grid=grid)
    rgbf_cfg = dataclasses.replace(RGBFConfig(), grid=grid)
    res = jax.jit(lambda d, c: pipelines.kde_pipeline(d, c, intr, kde_cfg))(d, c)
    arrays.update({
        "gt": np.asarray(buf.depth, np.float32),
        "input__z": np.asarray(fr.depth, np.float32),
        "jbf__z": np.asarray(jax.jit(pipelines.jbf_pipeline)(d, c)),
        "mrf__z": np.asarray(jax.jit(pipelines.mrf_pipeline)(d, c)),
        "rgbf__z": np.asarray(jax.jit(lambda d, c: pipelines.rgbf_pipeline(
            d, projective_to_real(d, intr), c, rgbf_cfg).refined_depth)(d, c)),
        "kde__z": np.asarray(res.optimized_points[..., 2]),
        "kde__seeds": np.asarray(jax.jit(lambda c, n: slic._compute_seeds(
            c, n, grid, 96, 128, 8, "nasp", grad_impl=kde_cfg.nasp.grad_impl))(
            jnp.asarray(fr.color, jnp.float32), res.normals)).astype(np.int16),
    })
    for name in EVAL_ROWS:
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in rows[name].items()))
    _save(EVAL, arrays)


def plane_configs(grid=None):
    """{"<method>_<config>": JAX KDEConfig}: plane_merge=True ("pm") and
    plane_merge=True, fill_holes=4 ("pm_fill") under PLANE_METHODS."""
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig

    base = KDEConfig() if grid is None else dataclasses.replace(KDEConfig(), grid=grid)
    out = {}
    for m in PLANE_METHODS:
        bm = dataclasses.replace(base, normals=dataclasses.replace(base.normals, method=m),
                                 plane_merge=True)
        out[f"{m}_pm"] = bm
        out[f"{m}_pm_fill"] = dataclasses.replace(bm, fill_holes=4)
    return out


def _planes_run(h, w, grid, names=None):
    jax = _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics, normalized_rays, projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.testdata import make_banded_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.ops import plane

    intr = default_kinect_intrinsics(w, h)
    color, sensor, _ = make_banded_scene(h, w, intr, seed=0, hole_fraction=0.15)
    d, c = jnp.asarray(sensor), jnp.asarray(color)
    rays = normalized_rays(intr, h, w)
    arrays, moved_any, first_z = {}, False, None
    pre = f"{h}x{w}__"
    for name, cfg in plane_configs(grid).items():
        if names is not None and name not in names:
            continue
        t0 = time.time()
        res = jax.jit(lambda d, c, cfg=cfg: pipelines.kde_pipeline(d, c, intr, cfg))(d, c)
        base = np.asarray(jax.jit(lambda z, cfg=cfg: plane.depth_bilateral(
            projective_to_real(z, intr), rays, cfg.projection))(res.jbf_depth))
        opt = np.asarray(res.optimized_points)
        moved = np.abs(base - opt).max(-1) > MOVED_MM
        filled = (opt[..., 2] > 50.0) & (sensor <= 50.0)
        print(f"{name} {h}x{w}: {time.time() - t0:.1f} s; the plane stage moved "
              f"{int(moved.sum())} pixels, {int(filled.sum())} holes filled")
        moved_any |= bool(moved.any())
        z = opt[..., 2].astype(np.float32)
        if first_z is None:
            first_z = z
            arrays[f"{pre}{name}__optimized_z"] = z
        else:  # stored as its difference from the first run's, which adds back exactly
            dz = (z - first_z).astype(np.float32)
            if not np.array_equal(first_z + dz, z):
                raise ValueError(f"{name}: optimized z does not round-trip through its difference")
            arrays[f"{pre}{name}__optimized_z_minus_first"] = dz
        arrays.update({
            f"{pre}{name}__merged_labels": np.asarray(res.merged_labels).astype(np.int16),
            f"{pre}{name}__moved": np.packbits(moved),
            f"{pre}{name}__filled": np.packbits(filled),
        })
    return arrays if moved_any else {}


def gen_planes():
    _jax()
    from kinectdepthmapenhancement_tpu.core.config import GridParams

    arrays = _planes_run(480, 640, None)
    small = _planes_run(96, 128, GridParams(rows=3, cols=4))
    if not small:
        print("96x128: the plane stage moves no pixel; no copy written")
    _save(PLANES, {**arrays, **small})


def gen_registration():
    _jax()
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core import registration
    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu_torch.utils import golden

    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    _, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    rot, t = golden.registration_extrinsics()
    z = np.asarray(registration.register_depth_to_color(
        jnp.asarray(noisy), intr, intr, registration.Extrinsics(jnp.asarray(rot), jnp.asarray(t))))
    # the function's projected coordinates, by its own eager operations
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    d = jnp.asarray(noisy)
    pts = jnp.stack([(u - intr.cx) / intr.fx * d, (intr.cy - v) / intr.fy * d, d], -1)
    pc = pts.reshape(-1, 3) @ jnp.asarray(rot).T + jnp.asarray(t)
    valid = np.asarray((d.reshape(-1) > 0.0) & (pc[:, 2] > 1.0))
    safe = jnp.where(valid, pc[:, 2], 1.0)
    uc = np.asarray(pc[:, 0] / safe * intr.fx + intr.cx)
    vc = np.asarray(intr.cy - pc[:, 1] / safe * intr.fy)
    near = valid & ((np.abs(np.abs(uc % 1.0) - 0.5) < golden.TIE_PX)
                    | (np.abs(np.abs(vc % 1.0) - 0.5) < golden.TIE_PX))
    print(f"registration 640x480: {int((z > 0).sum())} pixels filled, "
          f"{int(near.sum())} near-tie source points")
    _save(REGISTRATION, dict(filled=np.packbits(z > 0), z_sub4=z[::4, ::4].astype(np.float32),
                             near_uc=uc[near], near_vc=vc[near]))


def _tables_in_float64():
    """Swap the JAX package's ops/integral.py::build for one that sums the
    summed-area tables and the channel means in float64 and rounds them
    once to f32, as the port does (host callbacks; no x64 mode)."""
    import jax
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.ops import integral

    def prefix(x):
        shape = (x.shape[0] + 1, x.shape[1] + 1) + x.shape[2:]

        def f(a):
            t = np.cumsum(np.cumsum(np.asarray(a, np.float64), 0), 1).astype(np.float32)
            return np.pad(t, [(1, 0), (1, 0)] + [(0, 0)] * (a.ndim - 2))

        return jax.pure_callback(f, jax.ShapeDtypeStruct(shape, jnp.float32), x)

    def build(channels, valid):
        h, w, _ = channels.shape
        mu = jax.pure_callback(
            lambda ch: (np.asarray(ch, np.float64).sum((0, 1)) / (h * w)).astype(np.float32),
            jax.ShapeDtypeStruct(channels.shape[-1:], jnp.float32), channels)
        return integral.CenteredIntegral(
            centered=prefix(channels - mu[None, None, :]),
            count=prefix(jnp.ones((h, w), jnp.float32)),
            valid=prefix(valid.astype(jnp.float32)), mu=mu)

    integral.build = build


def gen_sdc_spread():
    """Writes nothing: prints golden.plane_stage_gates of the JAX package's
    SDC plane runs at 640x480 with its summed-area tables summed in float64
    against the planes fixture (its own runs with f32 tables), the spread
    golden.SDC_PLANES_640X480_BARS is set from (~2 min)."""
    _jax()
    from kinectdepthmapenhancement_tpu.core.testdata import make_banded_scene
    from kinectdepthmapenhancement_tpu_torch.utils import golden

    _tables_in_float64()
    arrays = _planes_run(480, 640, None, names=("sdc_pm", "sdc_pm_fill"))
    _, _, gt = make_banded_scene(480, 640, seed=0, hole_fraction=0.15)
    first = arrays["480x640__sdc_pm__optimized_z"]  # this call's first run
    for name in ("sdc_pm", "sdc_pm_fill"):
        pre = f"480x640__{name}__"
        got = {"optimized_z": arrays[pre + "optimized_z"] if pre + "optimized_z" in arrays
               else first + arrays[pre + "optimized_z_minus_first"],
               "merged_labels": arrays[pre + "merged_labels"].astype(np.int32)}
        for k in ("moved", "filled"):
            got[k] = np.unpackbits(arrays[pre + k])[: 480 * 640].reshape(480, 640) > 0
        gates = golden.plane_stage_gates(got, golden.load_jax_planes("640x480", name), gt,
                                         dict.fromkeys(golden.PLANE_STAGE_BARS))
        print(f"{name}, tables in float64 against f32: "
              + ", ".join(f"{k} {v[0]:.6g}" for k, v in gates.items()))


def parallel_jbf_inputs():
    """The 48x64 depth (10% holes) and colour of tests/test_parallel.py:92-95."""
    h, w = 48, 64
    rng = np.random.default_rng(5)
    depth = rng.uniform(400.0, 4000.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0
    color = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    return depth, color


def parallel_kde_inputs(make_noisy_scene, intr):
    """make_noisy_scene(96, 128, seed=0..3): colour [4, 96, 128, 3] and
    noisy depth [4, 96, 128]."""
    scenes = [make_noisy_scene(96, 128, intr, seed=s) for s in range(4)]
    return np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes])


def gen_parallel():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    jax = _jax()
    if jax.device_count() < 8:
        raise RuntimeError("the parallel part needs 8 CPU devices: run it alone or first")
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh
    from kinectdepthmapenhancement_tpu.parallel.sharding import sharded_kde_step
    from kinectdepthmapenhancement_tpu.parallel.stencil_shard import jbf_sharded

    depth, color = parallel_jbf_inputs()
    mesh8 = make_mesh(8, spatial=8)
    jbf = jax.jit(lambda a, b: jbf_sharded(a, b, mesh8))(jnp.asarray(depth), jnp.asarray(color))

    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    colors, noisy = parallel_kde_inputs(make_noisy_scene, intr)
    t0 = time.time()
    step = sharded_kde_step(make_mesh(8, spatial=2), intr, cfg)
    points = np.asarray(step(jnp.asarray(noisy), jnp.asarray(colors)))
    print(f"sharded_kde_step on the 4 x 2 mesh: {time.time() - t0:.1f} s")
    res = jax.jit(jax.vmap(lambda d, c: pipelines.kde_pipeline(d, c, intr, cfg)))(
        jnp.asarray(noisy), jnp.asarray(colors))
    res = jax.tree_util.tree_map(np.asarray, res)
    gap = float(np.abs(points - res.optimized_points).max())
    print(f"sharded against unsharded optimized points: max |d| {gap:.6g} mm")
    _save(PARALLEL, {
        "jbf_sharded": np.asarray(jbf, np.float32),
        "kde__optimized_z": points[..., 2].astype(np.float32),
        "kde__jbf_depth": res.jbf_depth.astype(np.float32),
        "kde__normals": res.normals.astype(np.float16),
        "kde__nasp_labels": res.nasp_labels.astype(np.int16),
        "kde__merged_labels": res.merged_labels.astype(np.int16),
    })


if __name__ == "__main__":
    parts = sys.argv[1:] or ["full", "ext", "stages", "dasp", "normals", "refs", "eval",
                             "planes", "registration", "parallel"]
    # the parallel part sets the host device count, read at JAX's first use
    parts.sort(key=lambda part: part != "parallel")
    for part in parts:
        {"full": gen_full, "ext": gen_ext, "stages": gen_stages, "dasp": gen_dasp,
         "normals": gen_normals, "refs": gen_refs, "eval": gen_eval,
         "planes": gen_planes, "registration": gen_registration,
         "parallel": gen_parallel, "sdc_spread": gen_sdc_spread}[part]()
