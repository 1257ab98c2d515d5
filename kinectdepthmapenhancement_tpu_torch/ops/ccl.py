"""Superpixel merging via connected components over the cluster graph.

PyTorch counterpart of the normal-merge part of the JAX package's ops/ccl.py
(LabelEquivalenceSeg in the reference).  The merge predicate depends only on
the two pixels' ORIGINAL cluster ids, so the reference's pixel-level
label-equivalence fixpoint equals connected components over the ~300-node
cluster adjacency graph:
  1. cluster adjacency from 4-neighbour pixel pairs (cell-local pair
     matrices through the label index),
  2. the predicate on the [K, K] matrix,
  3. min-label components by boolean matrix squaring (exact in f32: counts
     stay below 2^24),
  4. merged stats by K-side segment sums and one per-pixel gather.
Fidelity notes are the JAX package's (ccl.py:19-31): run to convergence, two
clusters with exactly equal normals do not merge (acos(1) > 0 fails),
border clamps fixed, label -1 stays -1.

Tensors carry a leading batch dimension; tables are [B, K, ...].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from kinectdepthmapenhancement_tpu_torch.core.config import CCLParams
from kinectdepthmapenhancement_tpu_torch.ops import stencil, tables
from kinectdepthmapenhancement_tpu_torch.ops.slic import _CellIndex

INVALID_ND = 5.0


class MergeResult(NamedTuple):
    labels: torch.Tensor       # [B, H, W] i32: merged cluster id (component min) or -1
    nd_map: torch.Tensor       # [B, H, W, 4] f32: per-pixel merged plane (n, d)
    variance: torch.Tensor     # [B, K] f32: per merged-cluster normal coherence
    sizes: torch.Tensor        # [B, K] i32: per merged-cluster pixel count
    cluster_nd: torch.Tensor   # [B, K, 4] f32: per merged-cluster plane
    rep: torch.Tensor          # [B, K] i32: component representative per ORIGINAL id


def _adjacency(idx: _CellIndex) -> torch.Tensor:
    """[B, K, K] bool: cluster pairs adjacent via a 4-neighbour pixel pair."""
    labels = idx.labels
    b, h, w = labels.shape
    col = torch.full((b, h, 1), -1, dtype=labels.dtype, device=labels.device)
    row = torch.full((b, 1, w), -1, dtype=labels.dtype, device=labels.device)
    right = torch.cat([labels[:, :, 1:], col], dim=2)
    down = torch.cat([labels[:, 1:, :], row], dim=1)
    counts = idx.pair_counts(right) + idx.pair_counts(down)
    return (counts + counts.transpose(1, 2)) > 0.0


def _components(mergeable: torch.Tensor) -> torch.Tensor:
    """Min-label connected components over [B, K, K] bool adjacency.
    Returns rep [B, K] i32 (component minimum id); nodes without mergeable
    edges keep their own id.  Transitive closure by ceil(log2(K)) rounds of
    R <- (R @ R > 0) (0/1 operands, f32 accumulation: counts <= K, exact)."""
    k = mergeable.shape[-1]
    dev = mergeable.device
    ids = torch.arange(k, dtype=torch.int32, device=dev)
    reach = (mergeable | torch.eye(k, dtype=torch.bool, device=dev)).to(torch.float32)
    for _ in range(max(1, math.ceil(math.log2(k)))):
        reach = (tables.exact_matmul(reach, reach) > 0.0).to(torch.float32)
    cand = torch.where(reach > 0.0, ids, torch.full_like(ids, k))
    return cand.amin(dim=-1).to(torch.int32)


def _merge(
    labels: torch.Tensor,
    cluster_nd: torch.Tensor,       # [B, K, 4]
    cluster_valid: torch.Tensor,    # [B, K] bool
    cluster_centers: torch.Tensor,  # [B, K, 3]
    predicate,
    index: _CellIndex,
) -> MergeResult:
    """Merge through the cell-local label index over `labels`.  Every
    per-pixel quantity of the reference's count/calc_nd kernels is a
    function of the pixel's ORIGINAL cluster id, so the stats collapse to
    K-side table algebra plus ONE final per-pixel gather."""
    k = cluster_nd.shape[1]
    idx = index
    adj = _adjacency(idx)
    na = cluster_nd[:, :, None, :3]
    nb = cluster_nd[:, None, :, :3]
    dot = stencil.dot3(na, nb)
    dd = (cluster_nd[:, :, None, 3] - cluster_nd[:, None, :, 3]).abs()
    pred = predicate(dot, dd)
    mergeable = adj & pred & cluster_valid[:, :, None] & cluster_valid[:, None, :]

    rep = _components(mergeable)

    # ---- stats (countKernel / calculate_nd), K-side
    counts = idx.counts()                        # [B, K] pixels per original id
    valid_f = cluster_valid.to(torch.float32)
    cnt_v = counts * valid_f
    feats_k = torch.cat(
        [cluster_nd[..., :3] * cnt_v[..., None], cluster_centers * cnt_v[..., None], cnt_v[..., None]],
        dim=-1,
    )
    sums = tables.segment_sum(feats_k, rep, k)   # [B, K(merged), 7]
    sizes = sums[..., 6]
    safe = torch.clamp_min(sizes, 1.0)
    mean_n = sums[..., 0:3] / safe[..., None]
    mean_c = sums[..., 3:6] / safe[..., None]
    mdist = stencil.dot3(mean_n, mean_c).abs()
    merged_nd_k = torch.cat([mean_n, mdist[..., None]], dim=-1)

    # variance: mean over member pixels of dot(original nd, merged mean normal)
    var_sum = stencil.dot3(sums[..., 0:3], mean_n) / safe

    # ---- per-pixel maps: K-side composition + ONE gather by original labels
    by_k = tables.gather(merged_nd_k, rep)       # [B, K, 4]
    tbl = torch.cat([rep.to(torch.float32)[..., None], valid_f[..., None], by_k], dim=-1)
    g = idx.gather(tbl)
    pix_valid = (labels >= 0) & (g[..., 1] > 0.0)
    merged = torch.where(pix_valid, g[..., 0].to(torch.int32), torch.full_like(labels, -1))
    nd_map = torch.where((merged >= 0)[..., None], g[..., 2:6], torch.zeros_like(g[..., 2:6]))
    return MergeResult(
        labels=merged,
        nd_map=nd_map,
        variance=var_sum,
        sizes=sizes.to(torch.int32),
        cluster_nd=merged_nd_k,
        rep=rep,
    )


def merge_normals(
    labels: torch.Tensor,
    cluster_normals: torch.Tensor,  # [B, K, 3], -1 sentinel
    cluster_centers: torch.Tensor,  # [B, K, 3]
    p: CCLParams = CCLParams(),
    *,
    index: _CellIndex,
) -> MergeResult:
    """LabelEquivalenceSeg::labelImage (LabelEquivalenceSeg.cu:228-282).

    Per-cluster plane: n = cluster normal, d = |n . center| (initLabel,
    cu:8-35); merge when 0 < acos(n1.n2) < pi/8 and |d1-d2| < offset max.
    `index` is the cell-local index over `labels` (slic.cell_index)."""
    valid = (cluster_normals != -1.0).any(dim=-1)
    d = stencil.dot3(cluster_normals, cluster_centers).abs()
    nd = torch.cat([cluster_normals, d[..., None]], dim=-1)
    nd = torch.where(valid[..., None], nd, torch.full_like(nd, INVALID_ND))
    cos_max = math.cos(p.normal_angle_max)

    def predicate(dot, dd):
        # acos(dot) > 0  <=>  dot < 1;  acos(dot) < max  <=>  dot > cos(max);
        # dot > 1 -> acos is NaN -> both comparisons false in the reference.
        return (dot < 1.0) & (dot > cos_max) & (dd < p.plane_offset_max)

    return _merge(labels, nd, valid, cluster_centers, predicate, index)
