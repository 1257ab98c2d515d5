"""PyTorch port: run_stream runs the pipeline its config's type names, and
the label-index conds are stages of their own.

On the CPU at 96x128 (grid 3x4): run_stream with a KDEConfig and with an
SPDSPConfig, kde_only both ways, is bitwise its pipeline on each chunk
(spdsp_pipeline on the raw depth's points) and a hand fold of
buffer2d.update and metrics.mean_3d_error in frame order (the same
operations), under the metric key kde_error_mm; any other config type,
TOFConfig (a subclass of SPDSPConfig) and RGBFConfig among them, raises
ValueError before a frame is pulled.  slic.with_capped_index makes the
stages slic.cell_index and slic.global_index only around a jit.cond's
branches: none for a direct call, none in the KDE step.

On the card (marked `cuda`, skipped here): the SPDSP step at 640x480 and
B=8 replays bitwise its eager call with 9 conditional nodes, and the
stamps of its slic.*_index stages inside the replays count each cond's
branches taken; the ERS labels' index forced both ways stamps the branch
taken.  Run there with

    python -m pytest tests/test_torch_streaming_spdsp.py -q --noconftest
"""

import collections
import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch.core import buffer2d, jit
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
from kinectdepthmapenhancement_tpu_torch.utils import metrics, telemetry

H, W = 96, 128
INTR = default_kinect_intrinsics(W, H)
GRID = GridParams(3, 4)
CONFIGS = {
    "kde": dataclasses.replace(KDEConfig(), grid=GRID),
    "spdsp": dataclasses.replace(SPDSPConfig(), grid=GRID),
    "spdsp_gate_off": dataclasses.replace(SPDSPConfig(), grid=GRID, max_plane_residual=math.inf),
}


def _frames(gt, n, seed=0):
    """The Kinect noise model (tests/test_streaming.py:13-17), from a seed."""
    rng = np.random.default_rng(seed)
    var = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    for _ in range(n):
        yield (gt + rng.uniform(-1, 1, gt.shape) * var).astype(np.float32)


def _points(cfg, depths, colors, intr):
    if type(cfg) is KDEConfig:
        return pipelines.kde_pipeline(depths, colors, intr, cfg).optimized_points
    return pipelines.spdsp_pipeline(depths, projective_to_real(depths, intr), colors, intr,
                                    cfg).optimized_points


@pytest.mark.parametrize("kde_only", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_stream_runs_the_configs_pipeline(name, kde_only):
    """Five frames in chunks of 2, 2, 1: each chunk's points and the final
    buffer and metric sums bitwise the pipeline and a hand fold."""
    torch.set_num_threads(2)
    cfg = CONFIGS[name]
    color, _, gt = make_noisy_scene(H, W, INTR, seed=1)
    seen = []
    state = streaming.run_stream(_frames(gt, 5), color, INTR, cfg=cfg, batch=2,
                                 kde_only=kde_only, device="cpu",
                                 on_outputs=lambda start, pts: seen.append((start, pts)))
    frames = np.stack(list(_frames(gt, 5)))
    assert [s for s, _ in seen] == [0, 2, 4]
    buf = buffer2d.init(H, W)
    sums, counts = 0.0, 0
    for start, pts in seen:
        d = torch.from_numpy(frames[start:start + pts.shape[0]])
        c = torch.from_numpy(color)[None].expand(d.shape[0], -1, -1, -1).contiguous()
        want = _points(cfg, d, c, INTR)
        assert torch.equal(pts, want)
        if kde_only:
            sums += float(want.sum() * 1e-30)
            counts += d.shape[0]
            continue
        chunk_err = torch.zeros(())
        for i in range(d.shape[0]):
            buf = buffer2d.update(buf, d[i])
            err, n = metrics.mean_3d_error(want[i], projective_to_real(buf.depth, INTR))
            chunk_err = chunk_err + err * n.to(torch.float32)
            counts += int(n)
        sums += float(chunk_err)
    metric = "kde_checksum" if kde_only else "kde_error_mm"
    assert state.frame_index == 5
    assert state.metric_sums[metric] == sums and state.metric_counts[metric] == counts
    assert "kde_error_mm" in state.metric_sums
    assert torch.equal(state.buffer.depth, buf.depth)
    assert torch.equal(state.buffer.weight, buf.weight)
    if not kde_only:
        assert 0.0 < streaming.mean_metric(state, "kde_error_mm") < 50.0


@pytest.mark.parametrize("cfg", [TOFConfig(), RGBFConfig(), object()],
                         ids=["tof", "rgbf", "object"])
def test_run_stream_refuses_other_configs(cfg):
    pulled = []

    def frames():
        pulled.append(1)
        yield np.zeros((H, W), np.float32)

    with pytest.raises(ValueError, match="KDEConfig or an SPDSPConfig"):
        streaming.run_stream(frames(), np.zeros((H, W, 3), np.uint8), INTR, cfg=cfg,
                             device="cpu")
    assert pulled == []
    with pytest.raises(ValueError, match="KDEConfig or an SPDSPConfig"):
        streaming._chunk_step(buffer2d.init(H, W), torch.zeros(1, H, W),
                              torch.zeros(1, H, W, 3, dtype=torch.uint8), INTR, cfg, True)


@pytest.fixture
def staged(monkeypatch):
    """The names of the telemetry stages opened, in order."""
    names = []

    def stage(name, on=None):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(telemetry, "stage", stage)
    return names


def _index_stages(names):
    return [n for n in names if n.startswith("slic.") and n.endswith("_index")]


def test_only_a_conds_branches_are_stages(monkeypatch, staged):
    """A jit call's warm-up runs both branches of each cond, each inside its
    stage; a direct call, eager or with a fixed locality, opens none."""
    grid = GridParams(12, 16)
    labels = slic.init_labels(grid, H, W).expand(2, H, W).contiguous()
    feats = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(0))

    def sums(idx):
        return idx.segment_sum(feats, idx.labels >= 0)

    want = slic.with_capped_index(sums, labels, grid, 5)
    slic.with_capped_index(sums, labels, grid, 5, locality="cell")
    assert staged == []
    monkeypatch.setattr(jit, "_mode", "warmup")
    got = slic.with_capped_index(sums, labels, grid, 5)
    assert torch.equal(got, want)
    assert staged == ["slic.cell_index", "slic.global_index"]
    staged.clear()
    slic.with_capped_index(sums, labels, grid, 5, locality="global")
    assert staged == []


@pytest.mark.parametrize("name,conds", [("kde", 0), ("spdsp", 9)])
def test_the_steps_index_stages(monkeypatch, staged, name, conds):
    """Warming up, the KDE step (one NASP iteration, on a grid that divides
    the frame) opens no slic.* stage; the SPDSP step opens both of each of
    its nine conds' (four later iterations of each SLIC, the ERS labels'
    index) and slic.assign for each of its two SLICs' ten global sweeps."""
    torch.set_num_threads(2)
    color, noisy, _ = make_noisy_scene(H, W, INTR, seed=1)
    d = torch.from_numpy(noisy)[None]
    c = torch.from_numpy(color)[None]
    monkeypatch.setattr(jit, "_mode", "warmup")
    streaming._chunk_step(buffer2d.init(H, W), d, c, INTR, CONFIGS[name], False)
    assert _index_stages(staged) == ["slic.cell_index", "slic.global_index"] * conds
    assert staged.count("slic.assign") == {"kde": 0, "spdsp": 10}[name]
    assert "stream.fold" in staged


# ------------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compiled call captures CUDA graphs")
    return torch.device("cuda")


def _replay_stages(rec):
    """Each replay's stage entries (between its jit.graph stamps)."""
    out, cur = [], None
    for st in rec.stamps:
        if st.stage == "jit.graph":
            if not st.exit:
                cur = []
            else:
                out.append(cur)
                cur = None
        elif cur is not None and not st.exit:
            cur.append(st.stage)
    return out


@pytest.mark.cuda
def test_spdsp_step_replays_its_eager_call_and_stamps_the_branches_taken(dev):
    """640x480, B=8, the benchmark's SPDSP config: two calls of the compiled
    step (a capture and its replay, then a replay) bitwise the eager step,
    nine conds, and the replays' slic.cell_index / slic.global_index
    stamps as many as the conds' IF / ELSE branches taken, and ten
    slic.assign stamps a replay (the two SLICs' global sweeps)."""
    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color, _, gt = make_noisy_scene(h, w, intr, seed=0)
    depths = torch.from_numpy(np.stack(list(_frames(gt, 8)))).to(dev)
    colors = torch.from_numpy(color).to(dev).expand(8, -1, -1, -1).contiguous()
    cfg = dataclasses.replace(SPDSPConfig(), max_plane_residual=math.inf)
    buf = buffer2d.init(h, w, dev)
    jit.clear()
    telemetry.disable()
    telemetry.collect()
    telemetry.enable()
    try:
        got = [streaming._step(buf, depths, colors, intr, cfg, False) for _ in range(2)]
        (key,) = jit.keys()
        rec = telemetry.collect()
        telemetry.disable()
        want = streaming._chunk_step(buf, depths, colors, intr, cfg, False)
        for out in got:
            assert torch.equal(out[0].depth, want[0].depth)
            assert torch.equal(out[0].weight, want[0].weight)
            assert all(torch.equal(a, b) for a, b in zip(out[1:], want[1:]))
        assert key["conds"] == 9 and key["host_branches"] == 0
        replays = _replay_stages(rec)
        assert len(replays) == 2 and rec.stamps_lost == 0
        seen = collections.Counter(s for r in replays for s in r)
        assert seen["slic.cell_index"] == sum(t[0] for t in key["taken"])
        assert seen["slic.global_index"] == sum(t[1] for t in key["taken"])
        assert seen["slic.cell_index"] + seen["slic.global_index"] == 2 * 9
        assert seen["slic.assign"] == 2 * 10
        for stage in ("rgbf.color_slic", "rgbf.depth_slic", "rgbf.ers", "spdsp.planes",
                      "spdsp.mrf", "stream.fold"):
            assert seen[stage] == 2, stage
    finally:
        telemetry.disable()
        telemetry.collect()
        jit.clear()


@pytest.mark.cuda
def test_ers_index_stamps_follow_the_branch_taken(dev):
    """SPDSP's ERS-index cond on labels within cap 4, then on labels rolled
    off it, then within again (tests/test_torch_cuda.py's
    test_ers_index_device_branch_both_ways): each replay stamps the stage
    of the branch the device took, bitwise the eager host branch."""
    grid = GridParams(12, 16)  # 8-px cells: a 64-px move breaks the cap of 4
    cfg = dataclasses.replace(SPDSPConfig(), grid=grid)
    labels = slic.init_labels(grid, H, W, dev).expand(2, H, W).contiguous()
    broken = labels.clone()
    broken[:, : H // 2] = torch.roll(labels[:, : H // 2], shifts=W // 2, dims=-1)
    depth = torch.stack([torch.from_numpy(make_noisy_scene(H, W, INTR, seed=s)[1])
                         for s in (0, 3)]).to(dev)
    points = projective_to_real(depth, INTR)

    def planes(lab, pts):
        return pipelines._with_local_index(
            lambda idx: plane.pca_planes(pts, lab, grid.num_clusters, index=idx), lab, cfg)

    jit.clear()
    telemetry.disable()
    telemetry.collect()
    telemetry.enable()
    try:
        f = jit.jit(planes)
        got = [f(lab, points) for lab in (labels, broken, labels)]
        (key,) = jit.keys()
        rec = telemetry.collect()
        telemetry.disable()
        for lab, out in zip((labels, broken, labels), got):
            assert all(torch.equal(g, e) for g, e in zip(out, planes(lab, points)))
        assert key["conds"] == 1 and key["taken"] == [[2, 1]]
        assert _replay_stages(rec) == [["slic.cell_index"], ["slic.global_index"],
                                       ["slic.cell_index"]]
    finally:
        telemetry.disable()
        telemetry.collect()
        jit.clear()
