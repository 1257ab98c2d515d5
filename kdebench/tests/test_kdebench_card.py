"""On the card: the control (the reference in TF32 in the port's place)
fails each cell's limits at the cell's own size on three seeds, and one
run of each cell prints a result line of the contract's shape.  Run on a
card with `python -m pytest kdebench/tests/test_kdebench_card.py -q -s`;
skipped without one."""

import json
import subprocess
import sys

import pytest

from kdebench import harness

WORKLOADS = [w["name"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(card, workload):
    from kdebench import check

    cell = harness.resolve(workload)
    limits = cell.limits["limits"]
    for seed in SEEDS:
        ctx = harness.frames_context(cell, seed, 0.0, card)
        got = check.control_numbers(cell, ctx, steps=64)
        print(workload, seed, json.dumps(got))
        assert any(got[k] is None or got[k] > limits[k] for k in limits if k in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_prints_the_contracts_result(card, workload):
    out = subprocess.run(
        [sys.executable, "kdebench/run.py", "--workload", workload, "--seed", str(2**31 + 104),
         "--seconds", "2", "--trace", "0"], cwd=harness.REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
