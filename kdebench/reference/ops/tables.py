"""Cluster-table access primitives (PyTorch counterpart of the JAX
package's ops/tables.py).

The framework moves data between the image plane [B, H, W] and the small
cluster tables [B, K, F]: per-pixel gathers (table[labels]) and per-cluster
reductions (segment sums).

  * gather is an exact index op (0 for invalid labels).
  * segment_sum is a one-hot product P^T @ feats in f32.  Float
    `index_add_` / `scatter_add_` are kept off this path on purpose: on CUDA
    they accumulate with atomics, in an order that changes from run to run,
    and the size, residual and merge gates downstream sit on f32
    boundaries.  The product is deterministic on every device, and exact
    for integer-valued sums below 2^24.

Every product here runs through exact_matmul, which turns TF32 off: a
one-hot matmul under TF32 silently rounds the table values to a 10-bit
mantissa (the same class of bug shipped on the TPU as a bf16 miscompile,
see the JAX package's tables.py:55-83).
"""

from __future__ import annotations

from typing import Optional

import torch


# the control's switch (kdebench/reference/__init__.py: tf32()): True runs
# every product in TF32, the precision below the configuration's f32
allow_tf32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (to nearest, ties away from
    zero), the rounding a TF32 product applies to its f32 operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul in full f32: TF32 is switched off for cuBLAS and cuDNN
    around the call and the previous settings are restored.  Under the
    control's allow_tf32 the operands are rounded to TF32 first and the
    product is TF32's on every device."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    if allow_tf32:
        a, b = _tf32(a), _tf32(b)
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """[..., K] f32 one-hot of labels; invalid (<0 or >=k) rows are all zero."""
    ids = torch.arange(k, dtype=labels.dtype, device=labels.device)
    return (labels[..., None] == ids).to(torch.float32)


def gather(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """table[labels] with 0 for invalid labels (< 0), per batch element.

    table: [B, K, F]; labels: [B, ...] -> [B, ..., F]."""
    b, k, f = table.shape
    flat = labels.reshape(b, -1).long()
    idx = flat.clamp(0, k - 1)
    out = torch.gather(table, 1, idx[..., None].expand(b, idx.shape[1], f))
    out = torch.where((flat >= 0)[..., None], out, torch.zeros_like(out))
    return out.reshape(labels.shape + (f,))


def segment_sum(
    feats: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    *,
    onehot: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-cluster sums of feats [B, N, F] grouped by labels -> [B, K, F].

    labels: [B, N], or [N] shared by the whole batch.  Invalid labels (<0 or
    >=k) are dropped.  Pass a precomputed `onehot` ([N, K] or [B, N, K]) to
    amortise it."""
    p = one_hot(labels, k) if onehot is None else onehot
    return exact_matmul(p.transpose(-1, -2), feats.to(torch.float32))
