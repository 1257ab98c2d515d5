"""Carry the JAX package's frozen state across to the port.

The system has no learned weights: its state is the frozen configuration,
the camera intrinsics and, for a streaming run, its resumable StreamState.
These helpers rebuild the port's dataclasses from instances of the JAX
package's, by class name and field by field, so both packages compute from
the same parameters and a JAX run resumes in the port.  They read only
dataclass and NamedTuple metadata and arrays (through NumPy), and never
import the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core import config as _config
from kinectdepthmapenhancement_tpu_torch.core.buffer2d import DepthBuffer
from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device
from kinectdepthmapenhancement_tpu_torch.utils.checkpoint import StreamState


def config_from_jax(cfg: Any) -> Any:
    """Port counterpart of any config dataclass instance, recursively.

    Raises TypeError for a class the port does not define and ValueError
    when the two classes do not have exactly the same fields."""
    if not dataclasses.is_dataclass(cfg) or isinstance(cfg, type):
        raise TypeError(f"not a dataclass instance: {cfg!r}")
    name = type(cfg).__name__
    cls = getattr(_config, name, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"the port has no config class {name!r}")
    src = [f.name for f in dataclasses.fields(cfg)]
    dst = [f.name for f in dataclasses.fields(cls)]
    if src != dst:
        missing = sorted(set(dst) - set(src))
        unknown = sorted(set(src) - set(dst))
        raise ValueError(
            f"{name}: fields differ (unknown {unknown}, missing {missing}, "
            f"order {src} vs {dst})"
        )
    kwargs = {}
    for field in src:
        value = getattr(cfg, field)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = config_from_jax(value)
        kwargs[field] = value
    return cls(**kwargs)


def intrinsics_from_jax(intr: Any) -> Intrinsics:
    """Port Intrinsics from the JAX package's Intrinsics NamedTuple."""
    fields = getattr(intr, "_fields", None)
    if fields is None:
        raise TypeError(f"not a NamedTuple instance: {intr!r}")
    if tuple(fields) != Intrinsics._fields:
        raise ValueError(f"Intrinsics fields differ: {fields} vs {Intrinsics._fields}")
    return Intrinsics(*(float(getattr(intr, f)) for f in fields))


def stream_state_from_jax(state: Any, device=None) -> StreamState:
    """Port StreamState from the JAX package's utils/checkpoint.StreamState:
    the cursor, the DepthBuffer's arrays (on `device`, the card when None;
    without a card that raises) and the metrics."""
    fields = [f.name for f in dataclasses.fields(state)] if dataclasses.is_dataclass(state) else None
    if fields != [f.name for f in dataclasses.fields(StreamState)]:
        raise TypeError(f"not a StreamState: {state!r}")
    dev = resolve_device(device)
    buf = state.buffer
    return StreamState(
        frame_index=int(state.frame_index),
        buffer=DepthBuffer(
            depth=torch.from_numpy(np.array(buf.depth, dtype=np.float32)).to(dev),
            weight=torch.from_numpy(np.array(buf.weight, dtype=np.float32)).to(dev),
        ),
        metric_sums={k: float(v) for k, v in state.metric_sums.items()},
        metric_counts={k: int(v) for k, v in state.metric_counts.items()},
    )
