"""PyTorch port: the evaluation harness (utils/evaluate.py), the `evaluate`
command, utils/timing.time_pipeline and the montage / GIF writers of
utils/visualize.py, on the CPU, against the JAX package's.

Bars, and why:
  * evaluate_tum on tests/test_datasets.py:106-134's sequence (96x128,
    seed 6, 8 frames, grid 3x4, timing_iters=1) against the JAX package's
    rows (tests/golden/eval_jax_96x128_seed6.npz, tests/gen_torch_fixtures.py
    eval): valid_px EXACT; mean_3d_error_mm and rmse_mm within rtol 1e-5
    for input, jbf and mrf and 1e-4 for rgbf and kde (XLA on the CPU
    contracts FMAs and sums in another order, the port rounds every
    operation; measured: every row within 2.5e-6, the input row's error
    equal); the pseudo-ground truth the port folds within rtol 1e-6 of the
    JAX fold (tests/test_torch_streaming.py's buffer bar);
  * write_report: the JAX package's bytes for the same rows;
  * the command at 48x64 (`--device cpu`) parses as tests/test_cli.py:55-90
    parses the JAX package's report; `--device cuda` raises without a card;
  * comparison_figure and save_video: the JAX package's bytes.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from kinectdepthmapenhancement_tpu.utils import evaluate as jev
from kinectdepthmapenhancement_tpu.utils import visualize as jvis
from kinectdepthmapenhancement_tpu_torch import cli
from kinectdepthmapenhancement_tpu_torch.core import buffer2d, datasets
from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.utils import evaluate, visualize
from kinectdepthmapenhancement_tpu_torch.utils.timing import time_pipeline

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "eval_jax_96x128_seed6.npz")
ROW_RTOL = {"input": 1e-5, "jbf": 1e-5, "mrf": 1e-5, "rgbf": 1e-4, "kde": 1e-4}


def _sequence(root, h, w, seed, n):
    """Frames of make_noisy_scene(h, w, seed) through the Kinect v1 sensor
    model, written as a TUM sequence (tests/test_datasets.py:106-134 at
    96x128, seed 6, 8 frames; tests/test_cli.py:55-70 at 48x64, seed 9, 4)."""
    color, _, gt = make_noisy_scene(h, w, default_kinect_intrinsics(w, h), seed=seed)
    rng = np.random.default_rng(seed)
    frames = [(100.0 + 0.033 * i, color, datasets.kinect_v1_sensor_model(gt, rng))
              for i in range(n)]
    datasets.write_tum_sequence(root, frames)
    return frames


def test_evaluate_tum_against_jax_fixture(tmp_path):
    root = str(tmp_path / "seq")
    _sequence(root, 96, 128, 6, 8)
    rows = evaluate.evaluate_tum(root, frames=8, grid=GridParams(rows=3, cols=4),
                                 timing_iters=1, device="cpu")
    assert list(rows) == list(ROW_RTOL)
    with np.load(FIXTURE) as f:
        want = {k: f[k] for k in f.files}
    for name, rtol in ROW_RTOL.items():
        got = rows[name]
        assert got["valid_px"] == int(want[f"{name}__valid_px"]), name
        for k in ("mean_3d_error_mm", "rmse_mm"):
            w = float(want[f"{name}__{k}"])
            print(f"{name} {k}: port {got[k]!r}, JAX {w!r}, relative {abs(got[k] / w - 1):.3g}")
            assert got[k] == pytest.approx(w, rel=rtol), (name, k)
        assert got["time_ms"] > 0.0
    # the denoisers beat the banded input (tests/test_datasets.py:131-133)
    assert rows["kde"]["rmse_mm"] < rows["input"]["rmse_mm"]
    assert rows["jbf"]["rmse_mm"] < rows["input"]["rmse_mm"]
    # the pseudo-ground truth the sequence folds to
    seq = datasets.TUMSequence(root)
    buf = buffer2d.init(96, 128)
    for fr in seq:
        buf = buffer2d.update(buf, torch.from_numpy(fr.depth))
    np.testing.assert_allclose(buf.depth.numpy(), want["gt"], rtol=1e-6)


def test_write_report_is_the_jax_layout(tmp_path):
    rows = {"input": {"time_ms": 0.25, "mean_3d_error_mm": 8.818764686584473,
                      "rmse_mm": 9.8349027633667, "valid_px": 11854},
            "kde_pm_fill": {"time_ms": 1234.5678, "mean_3d_error_mm": 5.82710075378418,
                            "rmse_mm": 7.042537212371826, "valid_px": 7}}
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    text = evaluate.write_report(a, rows)
    assert text == jev.write_report(b, rows)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _parse_report(text, names):
    """tests/test_cli.py:80-90's parse of an evaluation.txt."""
    assert text.startswith("runtime")
    assert "error" in text
    lines = [ln for ln in text.splitlines() if ln.startswith(tuple(n + " " for n in names))]
    assert len(lines) == len(names)
    for line in lines:
        assert np.isfinite(float(line.split()[1]))
    return lines


def test_cli_evaluate_tum(tmp_path, capsys):
    root = str(tmp_path / "seq")
    _sequence(root, 48, 64, 9, 4)
    out, fig = str(tmp_path / "evaluation.txt"), str(tmp_path / "cmp.png")
    rc = cli.main(["evaluate", out, "--tum", root, "--frames", "4", "--methods", "input,jbf",
                   "--timing-iters", "1", "--figure", fig, "--device", "cpu"])
    assert rc == 0
    _parse_report(open(out).read(), ("input", "jbf"))
    assert "runtimes measured on cpu" in capsys.readouterr().out
    with Image.open(fig) as im:  # input, ground truth, jbf: one row of three
        assert im.size == (3 * 64, 48 + 18)


def test_cli_evaluate_scene_and_device(tmp_path, capsys):
    out = str(tmp_path / "evaluation.txt")
    rc = cli.main(["evaluate", out, "--frames", "5", "--methods", "input",
                   "--timing-iters", "1", "--device", "cpu"])
    assert rc == 0
    assert "--frames only applies with --tum" in capsys.readouterr().err
    lines = _parse_report(open(out).read(), ("input",))
    assert lines[0].endswith(f"n={int((make_noisy_scene(480, 640, seed=0)[1] > 50).sum())})")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["evaluate", out, "--methods", "input"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.evaluate_tum(str(tmp_path))


def test_rows_and_method_filter():
    h, w = 48, 64
    color, noisy, gt = make_noisy_scene(h, w, default_kinect_intrinsics(w, h), seed=3)
    with pytest.raises(ValueError, match="kde_pm_fill"):
        evaluate.evaluate(noisy, color, gt, methods=["kde_pm_fill"], device="cpu")
    rows = evaluate.evaluate(noisy, color, gt, methods=["input", "kde_pm_fill"],
                             plane_merge=True, fill_steps=2, timing_iters=1,
                             grid=GridParams(rows=3, cols=4), device="cpu")
    assert list(rows) == ["input", "kde_pm_fill"]
    assert set(rows["kde_pm_fill"]) == {"time_ms", "mean_3d_error_mm", "rmse_mm", "valid_px"}


def test_time_pipeline_fresh_inputs():
    calls = []

    def make_args(i):
        calls.append(i)
        return (torch.full((4,), float(i)),)

    stats = time_pipeline(lambda x: x * 2.0, make_args, iters=3)
    assert calls == [-1, 0, 1, 2]
    assert set(stats) == {"median_s", "min_s", "fps"}
    assert 0.0 < stats["min_s"] <= stats["median_s"]
    assert stats["fps"] == pytest.approx(1.0 / stats["median_s"])


def test_montage_and_gif_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    panels = {name: rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
              for name in ("input", "ground truth", "jbf", "kde_pm_fill")}
    got = visualize.comparison_figure({k: torch.from_numpy(v) for k, v in panels.items()})
    want = jvis.comparison_figure(panels)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(visualize.comparison_figure(list(panels.items()), cols=2),
                                  jvis.comparison_figure(list(panels.items()), cols=2))
    a, b = str(tmp_path / "a.gif"), str(tmp_path / "b.gif")
    visualize.save_video(a, [torch.from_numpy(v) for v in panels.values()], fps=12.0)
    jvis.save_video(b, list(panels.values()), fps=12.0)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError):
        visualize.save_video(a, [])
