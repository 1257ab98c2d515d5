"""Checkpoint / resume for long streaming runs.

PyTorch counterpart of the JAX package's utils/checkpoint.py: the streaming
cursor, the temporal DepthBuffer and the accumulated metrics, in one .npz
with the JAX package's keys ("frame_index", "buffer_depth",
"buffer_weight", "msum_<name>", "mcnt_<name>"), so a run checkpointed by
either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core.buffer2d import DepthBuffer


@dataclasses.dataclass
class StreamState:
    """Resumable state of a streaming run."""

    frame_index: int
    buffer: DepthBuffer
    metric_sums: Dict[str, float]
    metric_counts: Dict[str, int]


def save(path: str, state: StreamState) -> None:
    """Write `state` to `path` (through a temporary file and a rename, so a
    killed run leaves the previous checkpoint whole)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "frame_index": np.asarray(state.frame_index),
        "buffer_depth": state.buffer.depth.cpu().numpy(),
        "buffer_weight": state.buffer.weight.cpu().numpy(),
    }
    for k, v in state.metric_sums.items():
        payload[f"msum_{k}"] = np.asarray(v)
    for k, v in state.metric_counts.items():
        payload[f"mcnt_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load(path: str, device=None) -> Optional[StreamState]:
    """The state saved at `path`, its buffer on `device`; None if there is
    no file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        sums = {k[5:]: float(z[k]) for k in z.files if k.startswith("msum_")}
        counts = {k[5:]: int(z[k]) for k in z.files if k.startswith("mcnt_")}
        return StreamState(
            frame_index=int(z["frame_index"]),
            buffer=DepthBuffer(
                depth=torch.from_numpy(z["buffer_depth"]).to(device),
                weight=torch.from_numpy(z["buffer_weight"]).to(device),
            ),
            metric_sums=sums,
            metric_counts=counts,
        )
