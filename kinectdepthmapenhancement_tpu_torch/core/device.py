"""The device an entry point runs on: the card unless the caller asks
for another; and the small constant tensors the ops read there."""

from __future__ import annotations

from typing import Dict

import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def resolve_device(device=None) -> torch.device:
    """torch.device(device), "cuda" when None; a CUDA device without a card
    raises (there is no fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device) for a number or a
    tuple of them, built once per (values, dtype, device) and then served
    from a cache: a captured call (core/jit.py) cannot copy host data to
    the card, so the ops take their constants from here.  The tensor is
    shared: nothing may write into it."""
    device = torch.device("cpu" if device is None else device)
    key = (repr(values), dtype, device)  # repr keeps -0.0 apart from 0.0
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
