"""The composed-oracle gates for a KDE result at 96x128.

The JAX package's tests/test_oracle_pipeline.py holds its kde_pipeline
against the NumPy oracle's outputs, committed as tests/golden/
kde_oracle_96x128_seed0{,_refexact}.npz.  These functions apply the same
thresholds (test_oracle_pipeline.py:68-116 and :150-155) to the port's
result, so the CPU tests and chip_smoke.py hold the port to the same bar.
The fixtures are only read (np.load): tests/golden.py rewrites a fixture
whose key differs, so nothing here goes through it.

Each gate returns {name: (value, limit, passed)}.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np

from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene

FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden",
)
Gate = Dict[str, Tuple[float, float, bool]]


def scene_96x128():
    """(intr, color, noisy) exactly as test_oracle_pipeline.py:38-41 builds
    them; the grid is GridParams(rows=3, cols=4)."""
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    return intr, color, noisy


def load_fixture(refexact: bool) -> Dict[str, np.ndarray]:
    name = "kde_oracle_96x128_seed0" + ("_refexact" if refexact else "")
    with np.load(os.path.join(FIXTURES, name + ".npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__key__"}


def _endpoint_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    gates: Gate = {}
    got_l = got["nasp_labels"]
    agree = float((got_l == want["nasp_labels"]).mean())
    gates["nasp_label_agreement"] = (agree, 0.995, agree > 0.995)
    diff = np.abs(got["optimized_points"] - want["optimized_points"]).max(-1)
    within = float((diff < 1.0).mean())
    gates["optimized_within_1mm"] = (within, 0.99, within > 0.99)
    q = float(np.quantile(diff, 0.999))
    gates["optimized_q999_mm"] = (q, 120.0, q < 120.0)
    return gates


def kde_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    """Default-gate fixture (test_oracle_pipeline.py:68-116)."""
    gates: Gate = {}
    jd = np.abs(got["jbf_depth"] - want["jbf"]) - 2e-4 * np.abs(want["jbf"])
    worst = float(jd.max())
    gates["jbf_allclose_excess_mm"] = (worst, 0.25, worst <= 0.25)

    got_n, wn = got["normals"], want["normals"]
    gv, wv = (got_n != -1.0).any(-1), (wn != -1.0).any(-1)
    flags = float((gv == wv).mean())
    gates["normal_flags_match"] = (flags, 0.995, flags > 0.995)
    both_zero = (np.linalg.norm(got_n, axis=-1) < 1e-6) & (np.linalg.norm(wn, axis=-1) < 1e-6)
    ok = both_zero | (np.abs(np.sum(got_n * wn, axis=-1)) > 0.999)
    frac = float(ok[gv & wv].mean())
    gates["normal_direction_agreement"] = (frac, 0.995, frac > 0.995)

    gates.update(_endpoint_gates(got, want))

    got_l, got_m, want_m = got["nasp_labels"], got["merged_labels"], want["merged_labels"]
    stable = got_l == want["nasp_labels"]
    inv = float(((got_m < 0) == (want_m < 0))[stable].mean())
    gates["merged_invalid_agreement"] = (inv, 0.995, inv > 0.995)
    pairs: Dict[int, int] = {}
    ok_pairs = total = 0
    for g, w_ in zip(got_m[stable].ravel(), want_m[stable].ravel()):
        if g >= 0 and w_ >= 0:
            total += 1
            ok_pairs += pairs.setdefault(int(g), int(w_)) == w_
    part = ok_pairs / total if total else 0.0
    gates["merged_partition_agreement"] = (part, 0.995, total > 0 and part > 0.995)
    return gates


def kde_refexact_gates(got: Mapping[str, np.ndarray], want: Mapping[str, np.ndarray]) -> Gate:
    """Reference-exact fixture, max_plane_residual=inf
    (test_oracle_pipeline.py:150-155)."""
    return _endpoint_gates(got, want)


def failures(gates: Gate) -> Dict[str, Tuple[float, float, bool]]:
    return {k: v for k, v in gates.items() if not v[2]}
