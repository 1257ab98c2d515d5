"""The frozen reference: faithful to the port's plain route when copied,
free of the port and of JAX, and with the port's configuration defaults."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import kdebench.reference as ref
from kdebench import scene
from kdebench.reference.core import config as rc

REFERENCE = Path(ref.__file__).resolve().parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    files = sorted(REFERENCE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "kinectdepthmapenhancement_tpu",
                               "kinectdepthmapenhancement_tpu_torch", "kdebench"), (path, name)


def test_every_copied_file_is_listed():
    """The copies are reference.FILES and every pipeline file's FILES, each
    listed once."""
    from kdebench import harness

    listed = list(ref.FILES)
    for path in sorted(harness.PIPELINES.glob("*.py")):
        files = harness.pipeline(path.stem).FILES
        for copy, (source, commit) in files.items():
            assert source.endswith(".py") and len(commit) == 40, (path.stem, copy)
        listed += list(files)
    present = {str(p.relative_to(REFERENCE)) for p in REFERENCE.rglob("*.py")
               if p.name not in ("__init__.py", "record.py")}
    assert len(listed) == len(set(listed))
    assert present == set(listed)
    assert len(ref.SOURCE_COMMIT) == 40


def test_the_configuration_defaults_are_the_ports():
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    assert dataclasses.asdict(rc.KDEConfig()) == dataclasses.asdict(pc.KDEConfig())


@pytest.mark.parametrize("grid,inf", [((3, 4), False), ((3, 4), True), ((15, 20), True)])
def test_the_reference_is_the_ports_plain_route(grid, inf):
    """96x128 frames: grid 3x4 divides them (the cell-local route), 15x20
    does not (the global route); bitwise on the CPU, where every port stage
    is its plain version."""
    from kinectdepthmapenhancement_tpu_torch.core import config as pc
    from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics
    from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline

    torch.set_num_threads(1)
    intr = scene.Intrinsics(115.0, 115.0, 64.0, 48.0)
    color, draws = scene.frames(2**31 + 3, 96, 128, intr, 2)
    depth = torch.from_numpy(np.stack(draws))
    colors = torch.from_numpy(np.stack([color, color]))
    residual = float("inf") if inf else 0.0025
    port = kde_pipeline(depth, colors, Intrinsics(*intr), dataclasses.replace(
        pc.KDEConfig(), grid=pc.GridParams(*grid), max_plane_residual=residual))
    mine = ref.enhance(depth, colors, ref.Intrinsics(*intr), dataclasses.replace(
        rc.KDEConfig(), grid=rc.GridParams(*grid), max_plane_residual=residual))
    assert torch.equal(port.optimized_points, mine)


def test_the_reference_fold_is_the_ports():
    from kinectdepthmapenhancement_tpu_torch.core import buffer2d
    from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, projective_to_real
    from kinectdepthmapenhancement_tpu_torch.utils import metrics

    intr = scene.Intrinsics(115.0, 115.0, 64.0, 48.0)
    _, draws = scene.frames(5, 96, 128, intr, 4)
    pb, rb = buffer2d.init(96, 128), ref.init_buffer(96, 128, "cpu")
    for d in draws:
        d = torch.from_numpy(d)
        pb, rb = buffer2d.update(pb, d), ref.fold(rb, d)
        pts = projective_to_real(d, Intrinsics(*intr)) + 1.0
        assert torch.equal(torch.stack(metrics.mean_3d_error(pts, projective_to_real(
            pb.depth, Intrinsics(*intr)))).double(), torch.stack(ref.frame_error(
                pts, rb, ref.Intrinsics(*intr))).double())
    assert torch.equal(pb.depth, rb.depth) and torch.equal(pb.weight, rb.weight)


def test_the_control_rounds_every_product_to_tf32():
    from kdebench.reference.ops import tables

    a = torch.tensor([[3000.7, 1.0]])
    b = torch.tensor([[1.0], [0.0]])
    assert float(tables.exact_matmul(a, b)) == pytest.approx(3000.7, abs=1e-3)
    with ref.tf32():
        assert float(tables.exact_matmul(a, b)) == 3000.0
    assert not tables.allow_tf32
