"""A run with the timed path broken underneath comes out not correct: the
harness's whole run past its look for a card, on the CPU at 96x128, with
run_stream's compiled step replaced by a faulty one.  One fault a kind the
cell can have: a step that returns its state unchanged (replay), half of
the chunk left out and the mean taken over the rest (replay), an answer
altered where it is produced (both).  The exchange between chips: the
cells run on one chip and have none.  A sound run comes out correct."""

import time

import pytest
import torch

from kdebench import harness
from kinectdepthmapenhancement_tpu_torch.models import streaming


def unchanged_state(buf, depths, color, intr, cfg, kde_only):
    _, pts, err, n = streaming._chunk_step(buf, depths, color, intr, cfg, kde_only)
    return buf, pts, err, n


def half_the_chunk(buf, depths, color, intr, cfg, kde_only):
    k = depths.shape[0] // 2
    buf, pts, err, n = streaming._chunk_step(buf, depths[:k], color[:k], intr, cfg, kde_only)
    return buf, torch.cat([pts, pts]), err, n


def altered_answer(buf, depths, color, intr, cfg, kde_only):
    buf, pts, err, n = streaming._chunk_step(buf, depths, color, intr, cfg, kde_only)
    pts = pts.clone()
    pts[-1, ..., 2] += 2.0  # the chunk's last frame, 2 mm further away
    return buf, pts, err, n


def run(small_cell, workload, seconds, step=None, monkeypatch=None):
    torch.set_num_threads(2)
    cell = small_cell(workload)
    if cell.traffic["kind"] == "sensor":  # every frame judged, so the altered one is
        cell.traffic = dict(cell.traffic, judged_frames=10**6)
    else:
        cell.traffic = dict(cell.traffic, judged_every=1)
    if step is not None:
        monkeypatch.setattr(streaming, "_step", step)
    return harness.run(cell, 2**31 + 11, seconds, False, device="cpu",
                       t_process=time.perf_counter())


@pytest.mark.parametrize("workload", ["kinect_v1_vga.sensor30", "kinect_v1_vga.replay_b8"])
def test_a_sound_run_is_correct(small_cell, workload):
    out = run(small_cell, workload, 0.5)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("kinect_v1_vga.replay_b8", unchanged_state),
    ("kinect_v1_vga.replay_b8", half_the_chunk),
    ("kinect_v1_vga.replay_b8", altered_answer),
    ("kinect_v1_vga.sensor30", altered_answer),
])
def test_a_broken_step_is_not_correct(small_cell, monkeypatch, workload, fault):
    out = run(small_cell, workload, 0.5, fault, monkeypatch)
    assert not out["correct"], out["checks"]
    failed = [k for k, c in out["checks"].items()
              if c["value"] is None or c["value"] > c["limit"]]
    assert failed


def test_jax_loaded_after_the_window_gives_no_result(small_cell, monkeypatch):
    """The reference and the kernel counts load after the window: a module
    of JAX's that they brought in would stop the run before its result."""
    import sys

    from kdebench import check

    judge = check.judge

    def judge_loading_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", object())
        return judge(*args, **kw)

    monkeypatch.setattr(check, "judge", judge_loading_jax)
    with pytest.raises(harness.BenchError, match="before the result: jax"):
        run(small_cell, "kinect_v1_vga.sensor30", 0.3)
