"""The spdsp_vga configuration: its pipeline file, its frozen reference
(bitwise the port's plain route on the CPU), its cell run end to end on
the CPU at a small size, and the readers of its stages on a synthetic
traced run (following test_kdebench_program_trace.py)."""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from kdebench import harness, program_trace, scene
from kdebench.reference.core import config as rc
from kdebench.tests.test_kdebench_program_trace import MS, T0, read, run
from kinectdepthmapenhancement_tpu_torch.utils.telemetry import Records, Stamp

CELL = "spdsp_vga.replay_b8"
SEED = 2**31 + 29


def test_the_cell_runs_spdsp_at_its_published_settings():
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    cell = harness.resolve(CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "replay" and cell.traffic["batch"] == 8
    assert harness.pipeline_name(cell.config) == "spdsp"
    assert cell.pipeline.__name__ == "kdebench.pipelines.spdsp"
    assert (cell.config["height"], cell.config["width"]) == (480, 640)
    assert cell.config["reduced"] == [] and cell.config["assumed"] == []
    cfg = cell.pipeline.port_kwargs(harness.overrides(cell))["cfg"]
    assert type(cfg) is pc.SPDSPConfig
    assert cfg == dataclasses.replace(pc.SPDSPConfig(), max_plane_residual=math.inf)
    assert (cfg.grid.rows, cfg.grid.cols) == (15, 20)
    assert 480 % cfg.grid.rows == 0 and 640 % cfg.grid.cols == 0  # the capped routes
    assert cfg.color_slic.iterations == cfg.depth_slic.iterations == 5
    assert cfg.projection.mrf_iterations == 20 and cfg.projection.mrf_window == 5


def test_the_spdsp_defaults_are_the_ports():
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    assert dataclasses.asdict(rc.SPDSPConfig()) == dataclasses.asdict(pc.SPDSPConfig())


def _frames(n=2):
    intr = scene.Intrinsics(115.0, 115.0, 64.0, 48.0)
    color, draws = scene.frames(SEED, 96, 128, intr, n)
    return intr, torch.from_numpy(np.stack(draws)), torch.from_numpy(np.stack([color] * n))


@pytest.mark.parametrize("cap", [4, 1], ids=["within_cap", "off_cap"])
@pytest.mark.parametrize("residual", ["inf", 0.0025])
def test_the_reference_is_the_ports_plain_route(monkeypatch, residual, cap):
    """96x128 frames, grid 3x4: bitwise on the CPU, where every port stage
    is its plain version.  The ERS labels keep to the cap of 4, and at a
    cap of 1 (both sides' _LOCAL_CAP) they leave it: the global index."""
    from kdebench.reference.models import spdsp as rspdsp
    from kinectdepthmapenhancement_tpu_torch.core import config as pc
    from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, projective_to_real
    from kinectdepthmapenhancement_tpu_torch.models import pipelines
    from kinectdepthmapenhancement_tpu_torch.ops import slic

    torch.set_num_threads(1)
    monkeypatch.setattr(pipelines, "_LOCAL_CAP", cap)
    monkeypatch.setattr(rspdsp, "_LOCAL_CAP", cap)
    intr, depths, colors = _frames()
    overrides = {"grid": {"rows": 3, "cols": 4}, "max_plane_residual": residual}
    cfg = harness.pipeline("spdsp").port_kwargs(overrides)["cfg"]
    pi = Intrinsics(*intr)
    port = pipelines.spdsp_pipeline(depths, projective_to_real(depths, pi), colors, pi, cfg)
    route = slic._CellIndex if cap == 4 else slic._GlobalIndex
    assert type(pipelines._local_index(port.refined_labels, cfg)) is route
    mine = harness.pipeline("spdsp").reference(depths, colors, intr._asdict(), overrides)
    assert torch.equal(port.optimized_points, mine)
    assert cfg == dataclasses.replace(pc.SPDSPConfig(), grid=pc.GridParams(3, 4),
                                      max_plane_residual=float(residual))


def test_a_small_run_of_the_cell_is_correct(small_cell):
    """The whole run on the CPU at 96x128, grid 3x4, every chunk judged; an
    answer altered where the step produces it is not correct."""
    from kinectdepthmapenhancement_tpu_torch.models import streaming

    torch.set_num_threads(2)
    cell = small_cell(CELL)
    cell.config[harness.pipeline_name(cell.config)]["max_plane_residual"] = "inf"
    cell.traffic = dict(cell.traffic, judged_every=1)
    out = harness.run(cell, SEED, 0.5, False, device="cpu", t_process=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 8
    assert out["checks"]["points_mean_mm"]["value"] == 0.0

    step = streaming._step

    def altered(buf, depths, color, intr, cfg, kde_only):
        buf, pts, err, n = step(buf, depths, color, intr, cfg, kde_only)
        pts = pts.clone()
        pts[-1, ..., 2] += 2.0
        return buf, pts, err, n

    streaming._step = altered
    try:
        out = harness.run(cell, SEED, 0.5, False, device="cpu", t_process=time.perf_counter())
    finally:
        streaming._step = step
    assert not out["correct"]


STAGES = ("rgbf.color_slic", "rgbf.depth_slic", "rgbf.ers", "spdsp.planes", "spdsp.mrf")


def records(steps=4, global_index=True, cell_index=True, lost=0):
    """Each step k a replay from T0 + 30 k ms + 2 ms: the five stages back
    to back, 1, 2, 3, 4 and 5 ms (15 ms of a 21 ms replay), a
    slic.cell_index stage of 0.5 ms inside rgbf.color_slic and a
    slic.global_index stage of 1.5 ms inside spdsp.planes."""
    stamps = []
    for k in range(steps):
        t = T0 + 30 * MS * k + 2 * MS
        stamps.append(Stamp("jit.graph", False, t, 0))
        for i, name in enumerate(STAGES):
            stamps.append(Stamp(name, False, t, 0))
            inner = {"rgbf.color_slic": ("slic.cell_index", cell_index, MS // 2),
                     "spdsp.planes": ("slic.global_index", global_index, 3 * MS // 2)}
            if name in inner and inner[name][1]:
                sub, _, d = inner[name]
                stamps += [Stamp(sub, False, t, 0), Stamp(sub, True, t + d, 0)]
            t += (i + 1) * MS
            stamps.append(Stamp(name, True, t, 0))
        stamps.append(Stamp("jit.graph", True, t + 6 * MS, 0))
    if lost:
        stamps = stamps[len(stamps) // 2:]
    return Records([], [], stamps, lost, 0, 4_000.0)


def test_the_stage_readers(monkeypatch):
    # 3 replays before the stretch, 2 frames each: a stage's ms x 3 / 6 frames
    rec = records()
    assert read(monkeypatch, rec, f"dasp_device_ms.{CELL}") == pytest.approx(1.5)
    assert read(monkeypatch, rec, f"ers_device_ms.{CELL}") == pytest.approx(1.5)
    assert read(monkeypatch, rec, f"pca_planes_device_ms.{CELL}") == pytest.approx(2.0)
    assert read(monkeypatch, rec, f"mrf_device_ms.{CELL}") == pytest.approx(2.5)
    assert read(monkeypatch, rec, f"global_index_device_ms.{CELL}") == pytest.approx(0.75)
    p = program_trace.program(run())
    assert sum(p.stage_frame_ms(s) for s in STAGES) <= float(p.graph_ms[:3].sum() / 6)


def test_the_global_index_reads_zero_only_beside_cell_local_stamps(monkeypatch):
    m = f"global_index_device_ms.{CELL}"
    assert read(monkeypatch, records(global_index=False), m) == 0.0
    assert read(monkeypatch, records(global_index=False, cell_index=False), m) is None
    assert read(monkeypatch, records(cell_index=False), m) == pytest.approx(0.75)


@pytest.mark.parametrize("metric", ["dasp_device_ms", "ers_device_ms", "pca_planes_device_ms",
                                    "mrf_device_ms", "global_index_device_ms"])
def test_nothing_to_read_gives_none(monkeypatch, metric):
    assert read(monkeypatch, records(lost=12), f"{metric}.{CELL}") is None
    assert read(monkeypatch, None, f"{metric}.{CELL}") is None
    short = records()._replace(stamps=records().stamps[:-1])  # a replay short
    assert read(monkeypatch, short, f"{metric}.{CELL}") is None
