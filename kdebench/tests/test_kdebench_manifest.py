"""BENCHMARK.json resolves, entry by entry, to the files the harness finds
by name, and keeps to the benchmark's contract; an unknown name fails."""

import json
import re

import pytest

from kdebench import families, harness

MANIFEST = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.resolve(workload)
    # the mix's kind names a driver of its own, with the driver's interface
    assert (harness.HERE / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    for name in ("warm", "window", "frame_draws"):
        assert callable(getattr(cell.driver, name)), name
    assert cell.driver.SPANS
    assert {"points_mean_mm", "points_off_ppm"} <= set(cell.limits["limits"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for reader in cell.readers.values():
        assert callable(reader.read)


@pytest.mark.parametrize("field,value", [
    ("workload", "kinect_v1_vga.nosuchmix"),
    ("config", "nosuchconfig"),
    ("traffic", "nosuchmix"),
])
def test_an_unknown_name_fails(field, value):
    manifest = json.loads(json.dumps(MANIFEST))
    w = manifest["workloads"][0]
    name = value if field == "workload" else w["name"]
    if field != "workload":
        w[field] = value
    with pytest.raises(harness.BenchError):
        harness.resolve(name, manifest)


def test_an_unknown_metric_fails():
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["per_layer"].append(dict(manifest["per_layer"][0], name="nosuch_metric"))
    with pytest.raises(harness.BenchError):
        harness.resolve(manifest["per_layer"][0]["workloads"][0], manifest)


def test_a_metric_of_a_part_is_read_by_its_quantitys_reader():
    assert harness.reader("frames_per_s.kinect_v2_tof").__doc__ == harness.reader(
        "frames_per_s").__doc__
    assert harness.reader("latency_p50_ms").__name__ == "kdebench.metrics.latency_p50_ms"
    with pytest.raises(harness.BenchError):
        harness.reader("nosuch_quantity.kinect_v1_vga")


def test_the_manifest_keeps_to_the_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["kdebench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        cfg = json.loads((harness.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["name"]) and len(w["why"]) <= 200
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        # every cell it lists reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_kernel_family_is_a_file_of_its_own():
    fams = families.load()
    for name, mod in fams.items():
        assert isinstance(mod.PATTERN, str), name
        assert mod.BOUND in ("operations", "bytes") and callable(mod.count), name
    names = {
        "jbf": "void (anonymous namespace)::jbf_kernel<5>(float const*)",
        "chamfer_dt": "(anonymous namespace)::dt_kernel(int const*, int, float*)",
        "cm_covariance": "(anonymous namespace)::cov_kernel(float const*)",
        "seed_gradient": "(anonymous namespace)::grad_kernel<true>(float const*)",
        "nasp_assign_analyze": "(anonymous namespace)::assign_analyze_kernel<4>(float)",
        "nasp_cell_sums": "(anonymous namespace)::nasp_sums_kernel<1>(int const*)",
        "label_cell_sums": "(anonymous namespace)::label_sums_kernel<2>(int const*)",
        "label_cell_gather": "(anonymous namespace)::label_gather_kernel<6>(int const*)",
    }
    assert set(fams) >= set(names)
    # each trace name is its own family's and no other's
    for fam, trace_name in names.items():
        assert [f for f, mod in fams.items() if mod.PATTERN_RE.search(trace_name)] == [fam]
        assert families.family_of(trace_name, fams) == fam
    assert families.family_of("void at::native::elementwise_kernel<128, 4>", fams) is None
