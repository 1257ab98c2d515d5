"""The device an entry point runs on: the card unless the caller asks
for another."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device(device), "cuda" when None; a CUDA device without a card
    raises (there is no fallback to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev
