"""PyTorch port: the compiled call (core/jit.py) and the capturable path on
the CPU.

A CUDA graph holds neither a copy of host data to the card nor a read of
the card on the host.  The CPU has no graphs, so these tests hold the
path to the rule that makes it capturable: under `capture_guard` (which
makes torch.tensor, torch.as_tensor of non-tensor data, the host reads of
a tensor and boolean-mask indexing raise) the SECOND of two calls of each
of the slice's paths runs at 96x128 and is bitwise equal to the first,
unguarded one.  The first call builds the constants the ops keep per
device (core/device.constant); the second builds none.  The paths: every
KDE config, JBF, MRF, the stream's chunk step, RGBF, SPDSP and TOF, and
the Buffer2D fold (buffer2d.accumulate and evaluate_tum's jitted step).
The three-iteration KDE configs, SPDSP and TOF run with locality "cell"
and "global": "auto" reads the cap verdict on the host in an eager call,
and a jit call takes it on the device (tests/test_torch_cuda.py and
chip_smoke.py's phase 12 hold that on the card).  Also: the jit key
separates what must be captured apart, jit on CPU tensors is fn's own
call, jit.cond's eager branch, _with_local_index's routes, a host-data
seed override raising under tracing, jit.collective on CPU tensors (fn's
own call; a cond on its verdict reads the host's value), and the timing
/ evaluation harnesses keep their outputs, every evaluate row a compiled
call.  Every
comparison is bitwise.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch.core import buffer2d, device, jit
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import (
    GridParams,
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import pipelines, streaming
from kinectdepthmapenhancement_tpu_torch.ops import plane, slic
from kinectdepthmapenhancement_tpu_torch.utils import evaluate, timing

torch.set_num_threads(2)

H, W = 96, 128
INTR = default_kinect_intrinsics(W, H)
BASE = dataclasses.replace(KDEConfig(), grid=GridParams(3, 4))


def _normals(method):
    return dataclasses.replace(BASE, normals=dataclasses.replace(BASE.normals, method=method))


def _iter3(locality):
    return dataclasses.replace(BASE, nasp=dataclasses.replace(
        BASE.nasp, iterations=3, locality=locality))


CONFIGS = {
    "default": BASE,
    "sdc": _normals("sdc"),
    "bilateral": _normals("bilateral"),
    "plane_merge_fill": dataclasses.replace(BASE, plane_merge=True, fill_holes=4),
    "iter3_cell": _iter3("cell"),
    "iter3_global": _iter3("global"),
    "grid5x6": dataclasses.replace(BASE, grid=GridParams(5, 6)),  # does not divide 96x128
}


class HostAccess(AssertionError):
    """A host read or a host-to-card copy inside capture_guard."""


def _refuse(name):
    def refuse(*args, **kwargs):
        raise HostAccess(f"{name} inside the capture guard")
    return refuse


def _is_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


@contextlib.contextmanager
def capture_guard(host_steps: bool = False):
    """Raise on what a CUDA graph cannot hold: a tensor built from host data
    (torch.tensor, torch.as_tensor of non-tensor data), a read of a
    tensor on the host (item, bool, int, float, index, tolist, cpu, numpy)
    and boolean-mask indexing (its shape is the mask's count, a host
    read).  host_steps=True lifts the guard inside jit.collective, a host
    step (the multi-process paths' collectives), and nowhere else."""
    as_tensor = torch.as_tensor
    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def guarded_as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise HostAccess("torch.as_tensor of host data inside the capture guard")
        return as_tensor(data, *args, **kwargs)

    def guarded_getitem(self, index):
        if _is_mask(index):
            raise HostAccess("boolean-mask indexing inside the capture guard")
        return getitem(self, index)

    def guarded_setitem(self, index, value):
        if _is_mask(index):
            raise HostAccess("boolean-mask indexing inside the capture guard")
        return setitem(self, index, value)

    patches = [(torch, "tensor", _refuse("torch.tensor")), (torch, "as_tensor", guarded_as_tensor)]
    for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "cpu",
                 "numpy"):
        patches.append((torch.Tensor, name, _refuse(f"Tensor.{name}")))
    patches += [(torch.Tensor, "__getitem__", guarded_getitem),
                (torch.Tensor, "__setitem__", guarded_setitem)]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    if host_steps:
        collective = jit.collective

        def lifted(fn, *tensors):
            with pytest.MonkeyPatch.context() as inner:
                for obj, name, value in originals:
                    inner.setattr(obj, name, value)
                return collective(fn, *tensors)

        patches.append((jit, "collective", lifted))
    mp = pytest.MonkeyPatch()
    for obj, name, value in patches:
        mp.setattr(obj, name, value)
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def frames():
    """Two frames [2, H, W] and [2, H, W, 3]; the KDE tests take the first."""
    scenes = [make_noisy_scene(H, W, INTR, seed=s) for s in (0, 3)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes]))
    depth = torch.from_numpy(np.stack([s[1] for s in scenes]))
    return depth, color


def _fields(out):
    return out._asdict() if hasattr(out, "_asdict") else dict(enumerate(
        out if isinstance(out, tuple) else (out,)))


def _assert_equal(got, want):
    fg, fw = _fields(got), _fields(want)
    assert fg.keys() == fw.keys()
    for k in fg:
        if isinstance(fg[k], torch.Tensor):
            assert torch.equal(fg[k], fw[k]), k
        else:
            _assert_equal(fg[k], fw[k])


def test_guard_refuses_host_access():
    x = torch.ones(3)
    with capture_guard():
        for touch in (lambda: torch.tensor([1.0]), lambda: torch.as_tensor(2),
                      lambda: x.sum().item(), lambda: bool(x[0] > 0), lambda: float(x[0]),
                      lambda: x.tolist(), lambda: x.cpu(), lambda: x.numpy(),
                      lambda: x[x > 0], lambda: list(range(10))[x.long()[0]]):
            with pytest.raises(HostAccess):
                touch()
        assert torch.as_tensor(x) is x  # a tensor passes
        assert torch.equal(x[1:], torch.ones(2))
    assert torch.tensor([1.0]).item() == 1.0  # undone


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kde_second_call_makes_no_host_access(frames, name):
    depth, color = frames[0][:1], frames[1][:1]
    cfg = CONFIGS[name]
    first = pipelines.kde_pipeline(depth, color, INTR, cfg)
    with capture_guard():
        second = pipelines.kde_pipeline(depth, color, INTR, cfg)
    _assert_equal(second, first)


@pytest.mark.parametrize("fn", [pipelines.jbf_pipeline, pipelines.mrf_pipeline],
                         ids=["jbf", "mrf"])
def test_baselines_second_call_make_no_host_access(frames, fn):
    depth, color = frames
    first = fn(depth, color)
    with capture_guard():
        second = fn(depth, color)
    assert torch.equal(second, first)


@pytest.mark.parametrize("kde_only", [False, True], ids=["capture", "kde_only"])
def test_chunk_step_second_call_makes_no_host_access(frames, kde_only):
    depth, color = frames
    buf = buffer2d.init(H, W)
    first = streaming._chunk_step(buf, depth, color, INTR, BASE, kde_only)
    with capture_guard():
        second = streaming._chunk_step(buf, depth, color, INTR, BASE, kde_only)
    _assert_equal(second, first)


def _dasp(cfg, locality):
    """cfg at grid 3x4 with both SLICs' locality set."""
    return dataclasses.replace(cfg, grid=GridParams(3, 4), **{
        f: dataclasses.replace(getattr(cfg, f), locality=locality)
        for f in ("color_slic", "depth_slic")})


# RGBF runs one SLIC iteration each (no cap check); SPDSP and TOF run four
# later iterations a SLIC and the ERS labels' index, each checked on "auto"
DASP_CASES = {
    "rgbf": (pipelines.rgbf_pipeline, _dasp(RGBFConfig(), "auto")),
    **{f"{name}_{loc}": (fn, _dasp(cfg, loc))
       for name, fn, cfg in (("spdsp", pipelines.spdsp_pipeline, SPDSPConfig()),
                             ("tof", pipelines.tof_pipeline, TOFConfig()))
       for loc in ("cell", "global")},
}


@pytest.mark.parametrize("name", list(DASP_CASES))
def test_dasp_pipelines_second_call_make_no_host_access(frames, name):
    fn, cfg = DASP_CASES[name]
    depth, color = frames[0][:1], frames[1][:1]
    args = (depth, projective_to_real(depth, INTR), color) + (
        (cfg,) if fn is pipelines.rgbf_pipeline else (INTR, cfg))
    first = fn(*args)
    with capture_guard():
        second = fn(*args)
    _assert_equal(second, first)


@pytest.mark.parametrize("path", ["accumulate", "fold_step"])
def test_buffer_fold_second_call_makes_no_host_access(frames, path):
    """buffer2d.accumulate (a compiled call) and evaluate_tum's jitted
    update step, each bitwise the eager fold of buffer2d.update."""
    stack = torch.cat([frames[0], frames[0].flip(0) + 0.5])
    want = buffer2d.init(H, W)
    for frame in stack:
        want = buffer2d.update(want, frame)
    if path == "accumulate":
        def fold():
            return buffer2d.accumulate(buffer2d.init(H, W), stack)
    else:
        step = jit.jit(buffer2d.update)

        def fold():
            buf = buffer2d.init(H, W)
            for frame in stack:
                buf = step(buf, frame)
            return buf
    first = fold()
    with capture_guard():
        second = fold()
    _assert_equal(first, want)
    _assert_equal(second, want)


@pytest.mark.parametrize("holds", [True, False], ids=["holds_cap", "breaks_cap"])
def test_with_local_index_gives_local_index_routes(frames, holds):
    """pipelines._with_local_index(fn, ...) is fn on _local_index's route,
    bitwise: the cell-local index at r = 4 on labels within the cap, the
    global one on labels that break it."""
    grid = GridParams(12, 16)  # 8-px cells: a roll by 64 px is 8 cells
    cfg = dataclasses.replace(SPDSPConfig(), grid=grid)
    labels = slic.init_labels(grid, H, W).expand(2, H, W).contiguous()
    if not holds:
        labels = labels.clone()
        labels[:, : H // 2] = torch.roll(labels[:, : H // 2], shifts=W // 2, dims=-1)
    points = projective_to_real(frames[0], INTR)

    def fit(index):
        return plane.pca_planes(points, labels, grid.num_clusters, index=index)

    index = pipelines._local_index(labels, cfg)
    assert type(index) is (slic._CellIndex if holds else slic._GlobalIndex)
    _assert_equal(pipelines._with_local_index(fit, labels, cfg), fit(index))


def test_segment_refuses_host_seeds_under_tracing(frames, monkeypatch):
    """A seed override of host data cannot be captured: inside a jit call
    segment raises; eager, it equals the same seeds as a tensor, which
    pass through a jit call unchanged."""
    color = frames[1][:1]
    points = projective_to_real(frames[0][:1], INTR)
    params = RGBFConfig().color_slic
    seeds = slic.segment(color, points, grid=BASE.grid, params=params,
                         variant="dasp").clusters.xy[0].tolist()

    def run(s):
        return slic.segment(color, points, grid=BASE.grid, params=params, variant="dasp",
                            seeds=s)

    want = run(torch.tensor(seeds, dtype=torch.int32))
    _assert_equal(run(seeds), want)
    monkeypatch.setattr(jit, "_mode", "warmup")
    assert jit.tracing()
    with pytest.raises(TypeError, match="device tensor"):
        run(seeds)
    with pytest.raises(TypeError, match="device tensor"):
        run(np.asarray(seeds))
    _assert_equal(run(torch.tensor(seeds, dtype=torch.int32)), want)


def test_key_separates_configs_shapes_dtypes_and_devices():
    x = torch.zeros((2, 8, 8))

    def key(*args, fn=pipelines.kde_pipeline, **kwargs):
        return jit.key_of(fn, args, kwargs)

    same = key(x, INTR, BASE)
    assert key(torch.ones((2, 8, 8)), INTR, BASE) == same  # values are no part of it
    assert key(x, INTR, dataclasses.replace(BASE)) == same
    others = [
        key(x, INTR, CONFIGS["sdc"]),
        key(x, INTR, CONFIGS["iter3_cell"]),
        key(x, INTR, CONFIGS["iter3_global"]),
        key(x, default_kinect_intrinsics(W + 1, H), BASE),
        key(torch.zeros((1, 8, 8)), INTR, BASE),
        key(torch.zeros((2, 8, 8), dtype=torch.float64), INTR, BASE),
        key(torch.zeros((2, 8, 8), device="meta"), INTR, BASE),
        key(torch.zeros((2, 8, 16))[..., ::2], INTR, BASE),  # other strides
        key(x, INTR, BASE, fn=pipelines.jbf_pipeline),
        key(x, INTR, cfg=BASE),
        key(x, BASE, INTR),
    ]
    assert len({same, *others}) == len(others) + 1
    with pytest.raises(TypeError):
        key(x, {1})


def test_jit_on_cpu_tensors_is_the_call_itself(frames):
    depth, color = frames
    jit.clear()
    f = jit.jit(pipelines.kde_pipeline)
    _assert_equal(f(depth, color, INTR, BASE), pipelines.kde_pipeline(depth, color, INTR, BASE))
    assert jit.stats == {"captures": 0, "replays": 0, "host_steps": 0} and jit.keys() == []
    assert not jit.tracing()


def test_cond_eager_branch_and_capped_index_routes():
    calls = []
    t = jit.cond(torch.tensor(True), lambda a: calls.append("t") or a + 1,
                 lambda a: calls.append("f") or a - 1, torch.zeros(2))
    f = jit.cond(torch.tensor([False]), lambda a: calls.append("t") or a + 1,
                 lambda a: calls.append("f") or a - 1, torch.zeros(2))
    assert calls == ["t", "f"] and torch.equal(t, torch.ones(2)) and torch.equal(f, -t)
    # 8-px cells: the grid-init labels hold the cap of 5 cells, and moved by
    # 64 px (8 cells) on the top half they break it
    grid = GridParams(12, 16)
    labels = slic.init_labels(grid, H, W).expand(2, H, W).contiguous()
    broken = labels.clone()
    broken[:, : H // 2] = torch.roll(labels[:, : H // 2], shifts=W // 2, dims=-1)
    feats = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(0))

    def sums(idx):
        return idx.segment_sum(feats, idx.labels >= 0)

    for lab, route in ((labels, slic._CellIndex), (broken, slic._GlobalIndex)):
        idx = slic.capped_index(lab, grid, 5)
        assert type(idx) is route
        got = slic.with_capped_index(sums, lab, grid, 5)
        assert torch.equal(got, sums(idx))


def test_collective_on_cpu_tensors_is_fns_own_call():
    """jit.collective on CPU tensors calls fn once on the same tensors and
    returns its outputs as a list, a host step counted; a cond on a
    one-element bool that fn returned reads the value the step kept, no
    tensor (so the capture guard lets it pass), and a cond on any other
    pred reads the tensor (the guard refuses it)."""
    seen = []
    x = torch.arange(4.0)

    def fn(a):
        seen.append(a)
        return a * 2.0, (a > 1.0).all()

    jit.clear()
    doubled, verdict = jit.collective(fn, x)
    assert len(seen) == 1 and seen[0] is x and jit.stats["host_steps"] == 1
    assert torch.equal(doubled, x * 2.0) and not bool(verdict)
    with capture_guard():
        got = jit.cond(verdict, lambda a: a + 1.0, lambda a: a - 1.0, x)
        with pytest.raises(HostAccess):
            jit.cond(x.sum() > 0, lambda a: a + 1.0, lambda a: a - 1.0, x)
    assert torch.equal(got, x - 1.0)
    with capture_guard(), pytest.raises(HostAccess):
        jit.collective(lambda a: [a.cpu()], x)  # no host access outside host_steps=True
    with capture_guard(host_steps=True):
        (back,) = jit.collective(lambda a: [torch.tensor(a.tolist())], x)
    assert torch.equal(back, x)
    jit.clear()
    assert jit.stats["host_steps"] == 0


def test_device_constants_are_cached_per_value_dtype_and_device():
    a = device.constant((1.0, -1.0), torch.float32, None)
    assert device.constant((1.0, -1.0), torch.float32, "cpu") is a
    assert device.constant((1.0, -1.0), torch.float64, "cpu") is not a
    assert device.constant(0.0, torch.float32, "cpu") is not device.constant(
        -0.0, torch.float32, "cpu")
    assert torch.equal(a, torch.tensor([1.0, -1.0]))


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_time_pipeline_keeps_its_keys(frames, compiled):
    depth, color = frames
    stats = timing.time_pipeline(lambda d, c: pipelines.jbf_pipeline(d, c),
                                 lambda i: (depth[:1], color[:1]), iters=2, compiled=compiled)
    assert set(stats) == {"median_s", "min_s", "fps"}
    assert stats["min_s"] <= stats["median_s"] and stats["fps"] > 0


def test_evaluate_keeps_its_rows_and_keys(frames):
    depth, color = frames
    gt = depth[1].numpy()
    rows = evaluate.evaluate(depth[0].numpy(), color[0].numpy(), gt, include_sp_methods=False,
                             grid=BASE.grid, timing_iters=1, methods=["input", "jbf", "mrf"],
                             device="cpu")
    assert list(rows) == ["input", "jbf", "mrf"]
    for r in rows.values():
        assert set(r) == {"time_ms", "mean_3d_error_mm", "rmse_mm", "valid_px"}
    runs = evaluate.method_runs(INTR, BASE.grid, include_sp_methods=True, fill_steps=4,
                                plane_merge=True)
    assert list(runs) == ["input", "jbf", "mrf", "rgbf", "kde", "kde_fill", "kde_pm",
                          "kde_pm_fill", "spdsp", "tof"]
    assert all(isinstance(fn, jit._Jitted) for fn in runs.values())  # every row compiled
