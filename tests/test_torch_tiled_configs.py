"""PyTorch port: the tiled route of the spatial KDE step
(parallel/sharding.py, spatial_route "tiled") under every KDEConfig beyond
the default, on 4 gloo ranks spawned once for the module
(multihost.spawn, a file:// store under the test's temporary directory,
60 s deadline); tests/test_torch_parallel.py holds the default config.

Configs, at 96x128 with grid 3x4 (32-px cells), each at data 2 x x 2
(64-px tiles, one frame a data row) and data 1 x x 4 (32-px tiles, two
frames in the row):
  * "bilateral", "sdc": the normal methods (a 1-column halo; SDC's 27
    columns and its summed-area tables from the group's gathered depth);
  * "plane_merge_fill": plane_merge with fill_holes=4 on
    make_banded_scene(96, 128, seed=0, 1, hole_fraction=0.15), where the
    plane stage acts and holes are filled across tile edges;
  * "iter3": nasp.iterations=3 (the later sweeps on tiles, the cap check's
    verdict combined over the group; at grid 3x4 every label lies within
    the cap of 5, so the capped route);
  * "iter3_global": the same with locality="global" (the global index's
    tile form: features gathered into one whole-frame product);
  * "all": SDC, plane merge, fill_holes=4 and three global-index
    iterations at once, on the banded frames.

Bars: spatial_route reads "tiled"; every KDEResult field of every rank,
gathered, is bitwise kde_pipeline on that data row's own frames; the
[B, K] tables are equal on the ranks of a row; in the hole-fill cases some
pixels within fill_holes columns of an inner tile edge were filled (the
halo carried something).  Frame 0 against the JAX package's committed
outputs, with the bars the unsharded port is held to there, on the same
frame and grid (golden.scene_96x128(), the banded frame of
kde_jax_planes_seed0.npz): kde_gates against kde_jax_96x128_normals_seed0.npz
(bilateral, sdc) and kde_jax_96x128_ext_seed0.npz (iter3; iter3_global
against the same fixture's iter3, whose JAX run took the capped route: the
global index sums in another order), and golden.plane_stage_gates with the
merged labels equal against kde_jax_planes_seed0.npz's cm_pm_fill.  The
unsharded tests inject the JAX seeds; the tiled step computes its own, so
these gates read the port's own seeds.  No fixture holds "all".  The
compiled step (sharded_kde_step) of iter3, iter3_global and "all" at data
1 x x 4: its second call, under tests/test_torch_jit.py's capture_guard
with host access allowed only inside a host step, bitwise its first, one
host step a collective.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gen_torch_fixtures import parallel_kde_inputs
from test_torch_parallel import _second_call
from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_banded_scene, make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models.pipelines import KDEResult, kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import plane
from kinectdepthmapenhancement_tpu_torch.parallel import mesh as mesh_mod
from kinectdepthmapenhancement_tpu_torch.parallel import multihost, sharding
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import make_mesh
from kinectdepthmapenhancement_tpu_torch.utils import golden

torch.set_num_threads(2)
WORLD = 4
H, W = 96, 128
INTR = default_kinect_intrinsics(W, H)
GRID = GridParams(rows=3, cols=4)
MESHES = {"data2_x2": 2, "data1_x4": 4}  # name: x
FILL = 4


def _configs():
    """name: (KDEConfig, scene) of each tiled config."""
    base = dataclasses.replace(KDEConfig(), grid=GRID)

    def normals(method):
        return dataclasses.replace(base.normals, method=method)

    iter3 = dataclasses.replace(base, nasp=dataclasses.replace(base.nasp, iterations=3))
    iter3_global = dataclasses.replace(
        iter3, nasp=dataclasses.replace(iter3.nasp, locality="global"))
    return {
        "bilateral": (dataclasses.replace(base, normals=normals("bilateral")), "noisy"),
        "sdc": (dataclasses.replace(base, normals=normals("sdc")), "noisy"),
        "plane_merge_fill": (dataclasses.replace(base, plane_merge=True, fill_holes=FILL),
                             "banded"),
        "iter3": (iter3, "noisy"),
        "iter3_global": (iter3_global, "noisy"),
        "all": (dataclasses.replace(iter3_global, normals=normals("sdc"), plane_merge=True,
                                    fill_holes=FILL), "banded"),
    }


CONFIGS = tuple(_configs())


def _frames(scene):
    """(depth [2, H, W], colour [2, H, W, 3], ground truth or None) of a
    scene: make_noisy_scene seeds 0 and 1 (frame 0 is
    golden.scene_96x128()'s), or make_banded_scene seeds 0 and 1 with 15%
    holes (frame 0 is the planes fixture's 96x128 frame)."""
    if scene == "noisy":
        colors, noisy = parallel_kde_inputs(make_noisy_scene, INTR)
        return torch.from_numpy(noisy[:2]), torch.from_numpy(colors[:2]), None
    scenes = [make_banded_scene(H, W, INTR, seed=s, hole_fraction=0.15) for s in (0, 1)]
    return (torch.from_numpy(np.stack([s[1] for s in scenes])),
            torch.from_numpy(np.stack([s[0] for s in scenes])), scenes[0][2])


# the configs whose compiled step (data 1 x x 4) is held to its first call
# too: the later iterations' cap checks, host branches in a jit call
COMPILED = ("iter3", "iter3_global", "all")


def _rank_checks():
    """Every config at every mesh on each of WORLD gloo ranks on the CPU:
    (route, collectives, every field's global batch, the tables equal on
    the row's ranks), the per-pixel fields gathered over the world."""
    out = {}
    for mesh_name, x in MESHES.items():
        mesh = make_mesh(WORLD, spatial=x, device="cpu")
        for name, (cfg, scene) in _configs().items():
            depth, color, _ = _frames(scene)
            b = depth.shape[0] // mesh.data
            rows = slice(mesh.d * b, (mesh.d + 1) * b)
            mesh_mod.collectives = 0
            route, res = sharding.spatial_kde(mesh.width_tile(depth[rows]),
                                              mesh.width_tile(color[rows]), mesh, INTR, cfg)
            made = mesh_mod.collectives
            got, same = {}, True
            for f in res._fields:
                v = getattr(res, f).contiguous()
                if f in sharding.PER_PIXEL_FIELDS:
                    got[f] = sharding.gather_global(v, mesh)
                else:
                    every = [torch.empty_like(v) for _ in range(mesh.world_size)]
                    dist.all_gather(every, v)
                    row = every[mesh.d * mesh.x:(mesh.d + 1) * mesh.x]
                    same = same and all(torch.equal(r, row[0]) for r in row)
                    got[f] = torch.cat(every[::mesh.x], dim=0)
            out[(mesh_name, name)] = (route, made, got, same)
            if mesh_name == "data1_x4" and name in COMPILED:
                step = sharding.sharded_kde_step(mesh, INTR, cfg)
                blocks = (mesh.width_tile(depth[rows]), mesh.width_tile(color[rows]))
                first = step(*blocks)
                out[("compiled", name)] = _second_call(step, blocks, first)
                out[("compiled", name)]["first_is_spatial_kde"] = torch.equal(
                    first, res.optimized_points)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    return multihost.spawn(_rank_checks, WORLD, device="cpu", store_dir=str(store),
                           timeout_s=60)


_WANT = {}
_FILLED = {}


def _want(mesh_name, name, monkeypatch):
    """kde_pipeline on each data row's own frames of the mesh, the rows'
    results concatenated, run with one thread as each rank runs (on the
    CPU a B=1 product's reduction is split over the threads, so its sums
    round with the thread count; at B=2 each frame takes a thread).  With
    the hole fill, also the pixels it filled (plane.plane_hole_fill's
    input and output differ) on the data 1 row's frames."""
    key = (mesh_name, name)
    if key not in _WANT:
        cfg, scene = _configs()[name]
        depth, color, _ = _frames(scene)
        data = WORLD // MESHES[mesh_name]
        b = depth.shape[0] // data
        fill, seen = plane.plane_hole_fill, {}

        def record(optimized, *args):
            out = fill(optimized, *args)
            seen["filled"] = (out != optimized).any(-1)
            return out

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with monkeypatch.context() as m:
                m.setattr(plane, "plane_hole_fill", record)
                parts = [kde_pipeline(depth[d * b:(d + 1) * b], color[d * b:(d + 1) * b],
                                      INTR, cfg) for d in range(data)]
        finally:
            torch.set_num_threads(threads)
        if "filled" in seen and data == 1:
            _FILLED[name] = seen["filled"]
        _WANT[key] = KDEResult(*(torch.cat(f, dim=0) for f in zip(*parts)))
    return _WANT[key]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tiled_config_every_field_bitwise(ranks, mesh_name, name, monkeypatch):
    """The config takes the tiled route, and every KDEResult field of every
    rank, gathered, is bitwise kde_pipeline's on each data row's frames;
    the [B, K] tables are equal on the ranks of a row."""
    want = _want(mesh_name, name, monkeypatch)
    for r in ranks:
        route, made, got, same = r[(mesh_name, name)]
        assert route == "tiled" and same
        for f in want._fields:
            assert torch.equal(got[f], getattr(want, f)), f


@pytest.mark.parametrize("name", [n for n in CONFIGS if _configs()[n][0].fill_holes])
def test_hole_fill_crosses_tile_edges(ranks, name, monkeypatch):
    """Holes are filled within fill_holes columns of an inner tile edge at
    x = 2 and 4 (so the fill's halo carried labels and planes that changed
    the result), on the frames held bitwise above."""
    _want("data1_x4", name, monkeypatch)
    filled = _FILLED[name]
    assert int(filled.sum()) > 100
    for x in MESHES.values():
        ws = W // x
        near = torch.zeros(W, dtype=torch.bool)
        for edge in range(ws, W, ws):
            near[edge - FILL:edge + FILL] = True
        assert int(filled[:, :, near].sum()) > 0, x


def test_collectives_a_step(ranks):
    """Collectives a tiled step (mesh.collectives), the same on every rank
    and at either mesh: the default config's 14
    (tests/test_torch_parallel.py); SDC + 1 (the gathered depth);
    plane_merge + 1 (its second float segment sum against the normal
    merge's count sum) and fill_holes + 1 (the fill's halo); each later
    capped NASP iteration + 5 (the cap check's verdicts, two folds, two
    centroid lookups) and the final label index's cap check + 1; off the
    cap each later iteration's index gathers its labels once and its two
    features, plus the two lookups (+ 5), and the final global index
    gathers the labels and the residual's features (+ 1 over the cell
    index's one gather)."""
    made = {k: v[1] for k, v in ranks[0].items() if k[0] in MESHES}
    for r in ranks[1:]:
        assert {k: v[1] for k, v in r.items() if k[0] in MESHES} == made
    print("collectives a tiled step:", made)
    want = {"bilateral": 14, "sdc": 15, "plane_merge_fill": 16, "iter3": 25,
            "iter3_global": 25, "all": 28}
    for mesh_name in MESHES:
        assert {name: made[(mesh_name, name)] for name in CONFIGS} == want, mesh_name


@pytest.mark.parametrize("name", COMPILED)
def test_compiled_step_second_call_under_capture_guard(ranks, name):
    """The compiled step (sharded_kde_step) of the three-iteration configs
    at data 1 x x 4: on every rank its first call equals the tiled route's
    (spatial_kde) output, and its second, under the capture guard with host
    access allowed only inside a host step, is bitwise the first with one
    host step per collective (25, 25 and 28): the cap checks' verdicts come
    out of a host step, which is where the host reads them."""
    want = {"iter3": 25, "iter3_global": 25, "all": 28}[name]
    for r in ranks:
        got = r[("compiled", name)]
        assert got["jitted"] and got["bitwise"] and got["first_is_spatial_kde"], got
        assert got["host_steps"] == got["collectives"] == want, got
        assert got["route"] == "tiled", got


def _frame0(result, i=0):
    return {f: getattr(result, f)[i].numpy() for f in result._fields}


@pytest.mark.parametrize("name, method", [("bilateral", "bilateral"), ("sdc", "sdc")])
def test_normal_methods_frame0_against_jax(ranks, name, method):
    """Frame 0 of the tiled step under the bilateral / SDC normals by
    golden.kde_gates against the JAX package's kde_pipeline on the same
    frame and grid (kde_jax_96x128_normals_seed0.npz)."""
    got = _frame0(_gathered(ranks, name))
    gates = golden.kde_gates(got, golden.load_jax_normals("96x128", method))
    assert not golden.failures(gates), gates


@pytest.mark.parametrize("name", ["iter3", "iter3_global"])
def test_iterations_frame0_against_jax(ranks, name):
    """Frame 0 of the tiled step with three NASP iterations by
    golden.kde_gates against the JAX package's iter3 run on the same frame
    and grid (kde_jax_96x128_ext_seed0.npz; its JAX run took the capped
    route, which iter3_global does not)."""
    got = _frame0(_gathered(ranks, name))
    gates = golden.kde_gates(got, golden.load_jax_ext("iter3"))
    assert not golden.failures(gates), gates


def test_plane_merge_fill_frame0_against_jax(ranks):
    """Frame 0 of the tiled step with plane_merge and fill_holes=4 on the
    banded frame by golden.plane_stage_gates against the JAX package's
    cm_pm_fill run (kde_jax_planes_seed0.npz), the merged labels equal."""
    cfg, scene = _configs()["plane_merge_fill"]
    _, _, gt = _frames(scene)
    res = KDEResult(*(t[0] for t in _gathered(ranks, "plane_merge_fill")))
    depth, _, _ = _frames(scene)
    got = golden.plane_stage_maps(res, depth[0].numpy(), INTR, cfg)
    want = golden.load_jax_planes("96x128", "cm_pm_fill")
    gates = golden.plane_stage_gates(got, want, gt)
    assert not golden.failures(gates), gates
    assert (got["merged_labels"] == want["merged_labels"]).all()


def _gathered(ranks, name):
    """The data 1 x x 4 step's gathered KDEResult of config `name`."""
    got = ranks[0][("data1_x4", name)][2]
    return KDEResult(*(got[f] for f in KDEResult._fields))
