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

Which code sums how: the small K-side folds take these products.  The
label indexes' pixel sums and counts take hand kernels on the card
(ops/cuda_nasp.py): the cell-local index its per-(cell, candidate) sums,
the global index (slic._GlobalIndex) label_sums, and both label_counts.
None of them uses float atomics: the label sums add in double in a fixed
order and round once (within 1 ulp of the exact sum unless the terms
cancel, so not bitwise this product), the counts add integers in f32
(exact in any order).  On the CPU every one is this product.

Every product here runs through exact_matmul, which turns TF32 off: a
one-hot matmul under TF32 silently rounds the table values to a 10-bit
mantissa (the same class of bug shipped on the TPU as a bf16 miscompile,
see the JAX package's tables.py:55-83).
"""

from __future__ import annotations

from typing import Optional

import torch


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul in full f32: TF32 is switched off for cuBLAS and cuDNN
    around the call and the previous settings are restored."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
