"""The eager half of the port's core/jit.py: the reference runs no
compiled call, so `tracing()` is always False and `cond` is a host branch
on its predicate (the tiled route, which alone reaches it eagerly, is not
part of the reference)."""

from __future__ import annotations

from typing import Callable

import torch


def tracing() -> bool:
    return False


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)
