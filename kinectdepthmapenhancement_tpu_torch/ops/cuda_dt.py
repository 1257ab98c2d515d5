"""Chamfer distance transform: CUDA kernel wrapper, its plain PyTorch
version, and a launch counter.

Counterpart of the JAX package's ops/pallas_dt.py (distance_transform) and of
the XLA relaxation in ops/normals.py::distance_transform.  Kernel source:
csrc/dt.cu.  min and + are exact in f32 and min is order-free, so the kernel
is bitwise equal to the plain version.  The kernel forms the init itself
from the i32 map, so a call of up to kde_dt_max_rounds() rounds is one
device activity.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from kinectdepthmapenhancement_tpu_torch import _build

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/dt.cu"
REPLACES = "kinectdepthmapenhancement_tpu/ops/pallas_dt.py:60"
launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
# the same launches by the width of the array launched on, "chamfer_dt:w<W>"
# (chip_smoke.py clears it with launches)
launch_forms: Dict[str, int] = {}

# chamfer 3x3 neighbourhood, weights 1 / 1.4 (JAX ops/normals.py:81-85)
_NEIGH = (
    (-1, -1, 1.4), (-1, 0, 1.0), (-1, 1, 1.4),
    (0, -1, 1.0), (0, 1, 1.0),
    (1, -1, 1.4), (1, 0, 1.0), (1, 1, 1.4),
)


def _init(dci: torch.Tensor) -> torch.Tensor:
    """0 where dci == 0, w + h elsewhere (f32)."""
    h, w = dci.shape[-2:]
    init = torch.full(dci.shape, float(w + h), dtype=torch.float32, device=dci.device)
    return init.masked_fill(dci == 0, 0.0)


def distance_transform_plain(dci: torch.Tensor, iterations: int) -> torch.Tensor:
    """Plain PyTorch version: dci i32 [B, H, W] -> f32 [B, H, W];
    `iterations` Jacobi rounds of 3x3 min-plus relaxation, +inf outside the
    image."""
    _, h, w = dci.shape
    dt = _init(dci)
    for _ in range(iterations):
        best = dt
        pad = F.pad(dt, (1, 1, 1, 1), value=float("inf"))
        for dy, dx, cost in _NEIGH:
            nb = pad[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            best = torch.minimum(best, nb + cost)
        dt = best
    return dt


def distance_transform(dci: torch.Tensor, iterations: int) -> torch.Tensor:
    """Chamfer DT: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  dci: i32 [B, H, W].  On the card one launch runs up to
    kde_dt_max_rounds() rounds: the first forms the init from dci, each
    later one continues from the launch before; 0 rounds is one launch that
    writes the init."""
    if dci.device.type == "cpu":
        return distance_transform_plain(dci, iterations)
    global launches
    b, h, w = dci.shape
    _build.check_tensor(dci, "dt dci", torch.int32, (b, h, w))
    max_rounds = _build.load().kde_dt_max_rounds()
    argtypes = [_build.PTR, _build.INT, _build.PTR] + [_build.INT] * 4
    src, from_dci, left = dci, 1, max(iterations, 0)
    while True:
        rounds = min(max_rounds, left)
        out = torch.empty((b, h, w), dtype=torch.float32, device=dci.device)
        _build.launch(
            "kde_dt", argtypes, dci.device,
            (src.data_ptr(), from_dci, out.data_ptr(), b, h, w, rounds),
        )
        launches += 1
        launch_forms[f"chamfer_dt:w{w}"] = launch_forms.get(f"chamfer_dt:w{w}", 0) + 1
        src, from_dci, left = out, 0, left - rounds
        if left == 0:
            return out
