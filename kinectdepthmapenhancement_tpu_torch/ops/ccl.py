"""Superpixel merging via connected components over the cluster graph.

PyTorch counterpart of the JAX package's ops/ccl.py: the normal merge
(LabelEquivalenceSeg in the reference), the PCA merge of TOF
(LabelEquivalenceSegPCA) and the plane-consistency merge (merge_planes, a
spec extension with no reference equivalent).  The merge predicate depends
only on the two pixels' ORIGINAL cluster ids, so the reference's pixel-level
label-equivalence fixpoint equals connected components over the ~300-node
cluster adjacency graph:
  1. cluster adjacency from 4-neighbour pixel pairs (cell-local pair
     matrices through the label index),
  2. the predicate on the [K, K] matrix,
  3. min-label components by boolean matrix squaring (exact in f32: counts
     stay below 2^24),
  4. merged stats by K-side segment sums and one per-pixel gather.
Pixel sums and gathers go through a label index (slic.label_index): the
cell-local one (slic._CellIndex) over single-iteration or capped labels,
else the global one (slic._GlobalIndex).
Fidelity notes are the JAX package's (ccl.py:19-31): run to convergence, two
clusters with exactly equal normals do not merge under the normal merge
(acos(1) > 0 fails) and do under the PCA merge, border clamps fixed, label -1 stays -1.

Tensors carry a leading batch dimension; tables are [B, K, ...].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu_torch.core.config import CCLParams, CCLPCAParams
from kinectdepthmapenhancement_tpu_torch.ops import stencil, tables
from kinectdepthmapenhancement_tpu_torch.ops.slic import LabelIndex

INVALID_ND = 5.0


class MergeResult(NamedTuple):
    labels: torch.Tensor       # [B, H, W] i32: merged cluster id (component min) or -1
    nd_map: torch.Tensor       # [B, H, W, 4] f32: per-pixel merged plane (n, d)
    variance: torch.Tensor     # [B, K] f32: per merged-cluster normal coherence
    sizes: torch.Tensor        # [B, K] i32: per merged-cluster pixel count
    cluster_nd: torch.Tensor   # [B, K, 4] f32: per merged-cluster plane
    eigenvalues: torch.Tensor  # [B, K] f32 (PCA merge; zeros otherwise)
    eigen_map: torch.Tensor    # [B, H, W] f32 (PCA merge; zeros otherwise)
    rep: torch.Tensor          # [B, K] i32: component representative per ORIGINAL id


def _adjacency(idx) -> torch.Tensor:
    """[B, K, K] bool: cluster pairs adjacent via a 4-neighbour pixel pair.
    On a width tile (idx.tile) the right neighbour of the last column comes
    from the next tile, -1 past the frame; pair counts gather per cell."""
    labels = idx.labels
    b, h, w = labels.shape
    col = (torch.full((b, h, 1), -1, dtype=labels.dtype, device=labels.device)
           if idx.tile is None else idx.tile.right_labels(labels))
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
    eigenvalues: Optional[torch.Tensor],
    idx: LabelIndex,
) -> MergeResult:
    """Merge through a label index over `labels`.  Every per-pixel
    quantity of the reference's count/calc_nd kernels is a function of the
    pixel's ORIGINAL cluster id, so the stats collapse to K-side table
    algebra plus ONE final per-pixel gather (6 features, 7 with the PCA
    merge's eigenvalue column)."""
    k = cluster_nd.shape[1]
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
    cols = [cluster_nd[..., :3] * cnt_v[..., None], cluster_centers * cnt_v[..., None],
            cnt_v[..., None]]
    if eigenvalues is not None:
        cols.append(eigenvalues[..., None] * cnt_v[..., None])
    sums = tables.segment_sum(torch.cat(cols, dim=-1), rep, k)  # [B, K(merged), 7|8]
    sizes = sums[..., 6]
    safe = torch.clamp_min(sizes, 1.0)
    mean_n = sums[..., 0:3] / safe[..., None]
    mean_c = sums[..., 3:6] / safe[..., None]
    mdist = stencil.dot3(mean_n, mean_c).abs()
    merged_nd_k = torch.cat([mean_n, mdist[..., None]], dim=-1)

    # variance: mean over member pixels of dot(original nd, merged mean normal)
    var_sum = stencil.dot3(sums[..., 0:3], mean_n) / safe
    eig_k = sums[..., 7] / safe if eigenvalues is not None else torch.zeros_like(safe)

    # ---- per-pixel maps: K-side composition + ONE gather by original labels
    by_rep = merged_nd_k if eigenvalues is None else torch.cat(
        [merged_nd_k, eig_k[..., None]], dim=-1)
    by_k = tables.gather(by_rep, rep)            # [B, K, 4|5]
    tbl = torch.cat([rep.to(torch.float32)[..., None], valid_f[..., None], by_k], dim=-1)
    g = idx.gather(tbl)
    pix_valid = (labels >= 0) & (g[..., 1] > 0.0)
    merged = torch.where(pix_valid, g[..., 0].to(torch.int32), torch.full_like(labels, -1))
    nd_map = torch.where((merged >= 0)[..., None], g[..., 2:6], torch.zeros_like(g[..., 2:6]))
    eig_map = (torch.where(merged >= 0, g[..., 6], 0.0) if eigenvalues is not None
               else torch.zeros_like(g[..., 0]))
    return MergeResult(
        labels=merged,
        nd_map=nd_map,
        variance=var_sum,
        sizes=sizes.to(torch.int32),
        cluster_nd=merged_nd_k,
        eigenvalues=eig_k,
        eigen_map=eig_map,
        rep=rep,
    )


def merge_normals(
    labels: torch.Tensor,
    cluster_normals: torch.Tensor,  # [B, K, 3], -1 sentinel
    cluster_centers: torch.Tensor,  # [B, K, 3]
    p: CCLParams = CCLParams(),
    *,
    index: LabelIndex,
) -> MergeResult:
    """LabelEquivalenceSeg::labelImage (LabelEquivalenceSeg.cu:228-282).

    Per-cluster plane: n = cluster normal, d = |n . center| (initLabel,
    cu:8-35); merge when 0 < acos(n1.n2) < pi/8 and |d1-d2| < offset max.
    `index`: the label index over `labels` (slic.label_index)."""
    valid = (cluster_normals != -1.0).any(dim=-1)
    d = stencil.dot3(cluster_normals, cluster_centers).abs()
    nd = torch.cat([cluster_normals, d[..., None]], dim=-1)
    nd = torch.where(valid[..., None], nd, torch.full_like(nd, INVALID_ND))
    cos_max = math.cos(p.normal_angle_max)

    def predicate(dot, dd):
        # acos(dot) > 0  <=>  dot < 1;  acos(dot) < max  <=>  dot > cos(max);
        # dot > 1 -> acos is NaN -> both comparisons false in the reference.
        return (dot < 1.0) & (dot > cos_max) & (dd < p.plane_offset_max)

    return _merge(labels, nd, valid, cluster_centers, predicate, None, index)


def merge_pca(
    labels: torch.Tensor,
    cluster_nd: torch.Tensor,       # [B, K, 4] PCA planes; invalid = 5.0s
    cluster_centers: torch.Tensor,  # [B, K, 3]
    eigenvalues: torch.Tensor,      # [B, K]
    p: CCLPCAParams = CCLPCAParams(),
    *,
    index: LabelIndex,
) -> MergeResult:
    """LabelEquivalenceSegPCA::labelImage (LabelEquivalenceSegPCA.cu:
    219-299).  Validity |nd.x| < 1.1 (invalid sentinel 5.0); merge when
    |acos(n1.n2)| < pi/8 (equal normals DO merge) and |d1-d2| < 700.  The
    merged clusters' mean smallest eigenvalues come back in `eigenvalues`
    and, per pixel, in `eigen_map`.  `index`: the label index over
    `labels`."""
    valid = cluster_nd[..., 0].abs() < 1.1
    cos_max = math.cos(p.normal_angle_max)

    def predicate(dot, dd):
        return (dot <= 1.0) & (dot > cos_max) & (dd < p.plane_offset_max)

    return _merge(labels, cluster_nd, valid, cluster_centers, predicate, eigenvalues, index)


def _cov3(scat6: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[B, K, 3, 3] covariance from the centred scatter [B, K, 6]
    (xx, xy, xz, yy, yz, zz) over n points."""
    xx, xy, xz, yy, yz, zz = scat6.unbind(-1)
    rows = [torch.stack(r, dim=-1) for r in ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))]
    return torch.stack(rows, dim=-2) / torch.clamp_min(n, 1.0)[..., None, None]


def _regress(scat6: torch.Tensor, mean: torch.Tensor, n: torch.Tensor):
    """z-regression plane z = a x + b y + c from centred moments (a 2x2
    solve; JAX ccl.py:323-343 says why not the total-LSQ eigenproblem).
    Returns (unit normal [B, K, 3] with d >= 0, d [B, K], solvable & n >= 3)."""
    sxx, sxy, sxz, syy, syz = (scat6[..., i] for i in range(5))
    det = sxx * syy - sxy * sxy
    solvable = det > 1e-6
    det_s = torch.where(solvable, det, 1.0)
    a = (sxz * syy - syz * sxy) / det_s
    b = (sxx * syz - sxy * sxz) / det_s
    nv = torch.stack([-a, -b, torch.ones_like(a)], dim=-1)
    nv = nv / torch.sqrt(stencil.dot3(nv, nv))[..., None]
    dv = stencil.dot3(nv, mean)
    sgn = torch.where(dv < 0.0, -1.0, 1.0)
    return nv * sgn[..., None], dv * sgn, solvable & (n >= 3.0)


def _outer6(e: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 6] products (xx, xy, xz, yy, yz, zz)."""
    x, y, z = e.unbind(-1)
    return torch.stack([x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)


def merge_planes(
    points: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    *,
    index: LabelIndex,
    tau: float = 0.0035,
    min_points: int = 100,
) -> MergeResult:
    """Plane-consistency CCL merge (JAX ccl.py:251-410; a spec extension
    with no reference equivalent, KDEConfig.plane_merge).  Fits a
    z-regression plane per ORIGINAL superpixel over its valid-depth
    members, and merges adjacent clusters whose planes explain each other's
    members: with w = n / d and each cluster's member mean and covariance,

        cross^2(p -> q) = (1 - w_p . mean_q)^2 + w_p^T C_q w_p  <  tau^2

    both ways.  Components are refit from recombined moments (the
    parallel-axis correction on cluster-mean deltas), so each component's
    plane is the fit of all its members; variance is the size-weighted
    coherence |n_member . n_component|.  `sizes` counts valid-depth member
    pixels only (JAX ccl.py:405, kept as it is).

    points [B, H, W, 3] mm; labels [B, H, W] i32.  `index`: the label
    index over `labels` (slic.label_index).
    The two [K, K] products run in f32 with TF32 off (tables.exact_matmul):
    (1 - a) must resolve ~1e-3 where a ~ 1."""
    b = labels.shape[0]
    z = points[..., 2]
    mask = (labels >= 0) & (z > VALID_DEPTH_MM)

    sums = index.segment_sum(torch.cat([points, torch.ones_like(z)[..., None]], dim=-1), mask)
    cnt = sums[..., 3]
    mean = sums[..., :3] / torch.clamp_min(cnt, 1.0)[..., None]
    centered = torch.where(mask[..., None], points - index.gather(mean), 0.0)
    scat = index.segment_sum(_outer6(centered), mask)  # [B, K, 6] centred scatter

    cov = _cov3(scat, cnt)
    nvec, d, fit_ok = _regress(scat, mean, cnt)
    valid_c = fit_ok & (cnt >= float(min_points)) & (d > 1e-3)

    w_vec = nvec / torch.clamp_min(d, 1e-6)[..., None]  # [B, K, 3]
    a = tables.exact_matmul(w_vec, mean.transpose(1, 2))  # [B, p, q]
    ww = (w_vec[..., :, None] * w_vec[..., None, :]).reshape(b, k, 9)
    quad = tables.exact_matmul(ww, cov.reshape(b, k, 9).transpose(1, 2))  # w_p^T C_q w_p
    one_minus = 1.0 - a
    cross2 = one_minus * one_minus + quad
    ok = cross2 < tau * tau
    mergeable = (
        _adjacency(index) & ok & ok.transpose(1, 2)
        & valid_c[:, :, None] & valid_c[:, None, :]
    )
    rep = _components(mergeable)

    # component refit from recombined moments (parallel-axis, f32-safe: the
    # corrections are cluster-mean deltas, not raw coordinate moments)
    sums_c = tables.segment_sum(sums, rep, k)  # [B, K, 4] keyed by rep id
    cnt_c = sums_c[..., 3]
    mean_c = sums_c[..., :3] / torch.clamp_min(cnt_c, 1.0)[..., None]
    delta = mean - tables.gather(mean_c, rep)
    corr = _outer6(delta) * cnt[..., None]
    scat_c = tables.segment_sum(scat + corr, rep, k)
    nc, dc, _ = _regress(scat_c, mean_c, cnt_c)
    cluster_nd = torch.cat([nc, dc[..., None]], dim=-1)  # keyed by rep

    coh = stencil.dot3(nvec, tables.gather(nc, rep)).abs()
    var_sum = tables.segment_sum(
        (coh * cnt * valid_c.to(torch.float32))[..., None], rep, k)[..., 0]
    variance = var_sum / torch.clamp_min(cnt_c, 1.0)

    # per-pixel maps: K-side composition + ONE gather (as in _merge)
    by_k = tables.gather(cluster_nd, rep)
    tbl = torch.cat(
        [rep.to(torch.float32)[..., None], valid_c.to(torch.float32)[..., None], by_k], dim=-1)
    g = index.gather(tbl)
    pix_valid = (labels >= 0) & (g[..., 1] > 0.0)
    merged = torch.where(pix_valid, g[..., 0].to(torch.int32), -1)
    nd_map = torch.where((merged >= 0)[..., None], g[..., 2:6], 0.0)
    return MergeResult(
        labels=merged,
        nd_map=nd_map,
        variance=variance,
        sizes=cnt_c.to(torch.int32),
        cluster_nd=cluster_nd,
        eigenvalues=torch.zeros_like(cnt_c),
        eigen_map=torch.zeros_like(z),
        rep=rep,
    )
