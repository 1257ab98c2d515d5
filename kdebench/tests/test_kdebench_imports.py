"""No module the benchmark loads is JAX's or the JAX package's: top-level
names compared whole, since the port's name begins with the JAX
package's."""

import subprocess
import sys

from kdebench import harness


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kinectdepthmapenhancement_tpu_torch_x", object())
    assert "kinectdepthmapenhancement_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kinectdepthmapenhancement_tpu.ops", object())
    assert harness.forbidden_modules() == ["kinectdepthmapenhancement_tpu.ops"]


def test_the_harness_and_the_port_load_no_jax():
    """In a fresh process: every module of the harness, every driver,
    metric and kernel count, the reference and the port's entry."""
    code = (
        "import sys; sys.path.insert(0, {repo!r});"
        "from kdebench import harness, check, families, trace, scene;"
        "import kdebench.reference;"
        "families.load();"
        "[harness.resolve(w['name']) for w in harness.load_json(harness.REPO / "
        "'BENCHMARK.json')['workloads']];"
        "from kinectdepthmapenhancement_tpu_torch.models.streaming import run_stream;"
        "print(harness.forbidden_modules())"
    ).format(repo=str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
