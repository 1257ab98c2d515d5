"""A configuration names its pipeline, and the harness finds the port's
keyword arguments and the plain reference by that name
(pipelines/<name>.py): the KDE cells' file gives what the harness gave
before it had one, and a new pipeline comes in as new files only."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import kdebench.reference as ref
from kdebench import check, harness, scene
from kdebench.reference.core import config as rc

MANIFEST = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in MANIFEST["configs"]}
SEED = 2**31 + 23
# the cells that came before configurations named their pipeline
KDE_CELLS = ["kinect_v1_vga.sensor30", "kinect_v2_tof.replay_b8", "kinect_v1_vga.replay_b8",
             "kinect_v2_tof.sensor30"]


def _config(name):
    return json.loads((harness.REPO / CONFIGS[name]["file"]).read_text())


KDE_CONFIGS = [c for c in sorted(CONFIGS) if harness.pipeline_name(_config(c)) == "kde"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_every_configuration_names_a_pipeline_file(config):
    cfg = _config(config)
    name = harness.pipeline_name(cfg)
    assert (harness.PIPELINES / f"{name}.py").is_file()
    assert isinstance(cfg[name], dict)
    pipe = harness.pipeline(name)
    assert callable(pipe.port_kwargs) and callable(pipe.reference)
    assert isinstance(pipe.FILES, dict)


@pytest.mark.parametrize("workload", KDE_CELLS)
def test_the_cells_run_kde(workload):
    cell = harness.resolve(workload)
    assert "pipeline" not in cell.config  # no key: the default
    assert harness.pipeline_name(cell.config) == "kde"
    assert cell.pipeline.__name__ == "kdebench.pipelines.kde"
    assert harness.overrides(cell) is cell.config["kde"]


def _manifest_with(tmp_path, config):
    """BENCHMARK.json with kinect_v1_vga's file replaced by `config`."""
    path = tmp_path / "configs" / "kinect_v1_vga.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(config))
    manifest = json.loads(json.dumps(MANIFEST))
    for c in manifest["configs"]:
        if c["name"] == "kinect_v1_vga":
            c["file"] = str(path)
    return manifest


@pytest.mark.parametrize("change", ["an unknown pipeline", "no overrides under its name"])
def test_an_unknown_pipeline_fails(tmp_path, change):
    cfg = _config("kinect_v1_vga")
    if change == "an unknown pipeline":
        cfg["pipeline"] = "nosuchpipeline"
    else:
        del cfg["kde"]
    with pytest.raises(harness.BenchError):
        harness.resolve("kinect_v1_vga.sensor30", _manifest_with(tmp_path, cfg))


def _old_port_config(overrides):
    """harness.port_config as it was before pipelines/kde.py."""
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    return harness._replace(pc.KDEConfig(), overrides)


@pytest.mark.parametrize("overrides", [_config(c)["kde"] for c in KDE_CONFIGS]
                         + [{"grid": {"rows": 3, "cols": 4}}])
def test_kde_port_kwargs_are_the_old_port_config(overrides):
    got = harness.pipeline("kde").port_kwargs(overrides)
    assert list(got) == ["cfg"]
    assert got["cfg"] == _old_port_config(overrides)
    if overrides.get("max_plane_residual") == "inf":
        assert got["cfg"].max_plane_residual == math.inf


@pytest.mark.parametrize("config", KDE_CONFIGS)
def test_kde_reference_is_ref_enhance(config):
    """Bitwise on a 96x128 frame pair, with the configuration's overrides
    and its intrinsics scaled to the frame."""
    torch.set_num_threads(1)
    cfg = _config(config)
    s = 128 / cfg["width"]
    intr = {"fx": cfg["intrinsics"]["fx"] * s, "fy": cfg["intrinsics"]["fy"] * s,
            "cx": 64.0, "cy": 48.0}
    color, draws = scene.frames(SEED, 96, 128, scene.Intrinsics(**intr), 2)
    depths = torch.from_numpy(np.stack(draws))
    colors = torch.from_numpy(np.stack([color, color]))
    got = harness.pipeline("kde").reference(depths, colors, intr, cfg["kde"])
    want = ref.enhance(depths, colors, ref.Intrinsics(**intr),
                       harness._replace(rc.KDEConfig(), cfg["kde"]))
    assert torch.equal(got, want)


TOY = '''"""A toy pipeline: each point is (depth x scale, red, fx)."""
import torch

FILES = {}
CHUNKS = []


def port_kwargs(overrides):
    return {"cfg": ("toy", overrides["scale"])}


def reference(depths, colors, intrinsics, overrides):
    CHUNKS.append(depths.shape[0])
    z = depths * overrides["scale"]
    return torch.stack([z, colors[..., 0].to(z.dtype), torch.full_like(z, intrinsics["fx"])], -1)
'''


@pytest.mark.parametrize("workload,chunks", [("kinect_v1_vga.sensor30", [1] * 16),
                                             ("kinect_v1_vga.replay_b8", [8, 8])])
def test_a_new_pipeline_is_new_files_only(tmp_path, monkeypatch, workload, chunks):
    """A pipeline file in a directory of its own and a configuration that
    names it: the cell resolves to it, the port's call takes its keyword
    arguments and check.reference_points returns its points, in the mix's
    chunks."""
    (tmp_path / "pipelines").mkdir()
    (tmp_path / "pipelines" / "toy.py").write_text(TOY)
    monkeypatch.setattr(harness, "PIPELINES", tmp_path / "pipelines")
    cfg = {k: v for k, v in _config("kinect_v1_vga").items() if k != "kde"}
    cfg.update(pipeline="toy", toy={"scale": 2.0}, height=48, width=64,
               intrinsics={"fx": 57.5, "fy": 57.5, "cx": 32.0, "cy": 24.0})
    cell = harness.resolve(workload, _manifest_with(tmp_path, cfg))
    assert cell.pipeline.__name__ == "kdebench.pipelines.toy"

    ctx = harness.frames_context(cell, SEED, 0.0, torch.device("cpu"))
    points, least = check.reference_points(cell, ctx)
    assert least is None and cell.pipeline.CHUNKS == chunks
    depths = torch.from_numpy(np.stack(ctx.draws))
    red = torch.from_numpy(ctx.color[..., 0]).float().expand_as(depths)
    assert torch.equal(points, torch.stack([depths * 2.0, red, torch.full_like(depths, 57.5)],
                                           -1))

    seen = {}
    ctx = harness.setup(cell, SEED, 0.0, torch.device("cpu"))
    ctx = dataclasses.replace(ctx, _run_stream=lambda *args, **kw: seen.update(kw))
    ctx.run_stream(iter(()), batch=8, kde_only=False)
    assert seen["cfg"] == ("toy", 2.0) and seen["batch"] == 8 and seen["kde_only"] is False
