"""The kernel counts (kernels/*.py, copied from chip_smoke.py's phase 3)
give PERF.md's kernel table, column `bound ms`, rows 1-8, at 640x480 B=1
and B=4, to the table's rounding: counted on the reference's own
intermediates of make_noisy_scene(480, 640, seed=0..3), the frames
chip_smoke.py's phase 3 counted on."""

import numpy as np
import pytest
import torch

import kdebench.reference as ref
from kdebench import families, peaks
from kdebench.reference import record

# (family, calls in that order a kde_pipeline call makes, bound) -> ms B=1, B=4
TABLE = {
    "jbf": ([(0.0048, 0.0193)], "operations"),
    "chamfer_dt": ([(0.0012, 0.0048)], "operations"),
    "cm_covariance": ([(0.0367, 0.1469)], "operations"),
    "seed_gradient": ([(0.0035, 0.0140)], "operations"),
    "nasp_assign_analyze": ([(0.0078, 0.0311)], "operations"),
    "nasp_cell_sums": ([(0.0040, 0.0160)], "bytes"),
    "label_cell_sums": ([(0.0011, 0.0046)], "bytes"),
    # F = 6 (CCL), F = 1, F = 3 (the plane stage)
    "label_cell_gather": ([(0.0026, 0.0103), (0.0007, 0.0029), (0.0015, 0.0059)], "bytes"),
}


@pytest.fixture(scope="module")
def recorded():
    from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene

    torch.set_num_threads(4)
    intr = default_kinect_intrinsics(640, 480)
    scenes = [make_noisy_scene(480, 640, intr, seed=s) for s in range(4)]
    out = {}
    for b in (1, 4):
        depth = torch.from_numpy(np.stack([s[1] for s in scenes[:b]]))
        color = torch.from_numpy(np.stack([s[0] for s in scenes[:b]]))
        with record.recording() as calls:
            ref.enhance(depth, color, ref.Intrinsics(*intr), ref.KDEConfig())
        out[b] = list(calls)
    return out


@pytest.mark.parametrize("b", [1, 4])
def test_the_counts_give_the_kernel_tables_bounds(recorded, b):
    fams = families.load()
    got = {}
    for call in recorded[b]:
        ops, nb = fams[call.family].count(call)
        got.setdefault(call.family, []).append(peaks.least_s(ops, nb))
    assert set(got) == set(TABLE)
    for fam, (rows, bound) in TABLE.items():
        assert fams[fam].BOUND == bound
        assert [round(s * 1e3, 4) for s, _ in got[fam]] == [r[b == 4] for r in rows], fam
        assert {side for _, side in got[fam]} == {bound}, fam
