"""Chamfer distance transform: CUDA kernel wrapper, its plain PyTorch
version, and a launch counter.

Counterpart of the JAX package's ops/pallas_dt.py (distance_transform) and of
the XLA relaxation in ops/normals.py::distance_transform.  Kernel source:
csrc/dt.cu.  min and + are exact in f32 and min is order-free, so the kernel
is bitwise equal to the plain version.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kinectdepthmapenhancement_tpu_torch import _build

SOURCE = "kinectdepthmapenhancement_tpu_torch/csrc/dt.cu"
REPLACES = "kinectdepthmapenhancement_tpu/ops/pallas_dt.py:60"
launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)

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
    """Chamfer DT: the CUDA kernel for CUDA tensors (all rounds in one
    launch, in chunks of at most kde_dt_max_rounds()), the plain version for
    CPU tensors.  dci: i32 [B, H, W]."""
    if dci.device.type == "cpu":
        return distance_transform_plain(dci, iterations)
    global launches
    b, h, w = dci.shape
    _build.check_tensor(dci, "dt dci", torch.int32, (b, h, w))
    fn = _build.function(
        "kde_dt", [_build.PTR, _build.PTR] + [_build.INT] * 4 + [_build.PTR]
    )
    max_rounds = _build.load().kde_dt_max_rounds()
    with torch.cuda.device(dci.device):
        cur = _init(dci)
        done = 0
        while done < iterations:
            rounds = min(max_rounds, iterations - done)
            out = torch.empty_like(cur)
            code = fn(
                cur.data_ptr(), out.data_ptr(), b, h, w, rounds,
                torch.cuda.current_stream().cuda_stream,
            )
            _build.check_status("kde_dt", code)
            launches += 1
            cur = out
            done += rounds
    return cur
