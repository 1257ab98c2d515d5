"""Edge-refined superpixels: boundary snapping + label-constrained bilateral.

PyTorch counterpart of the JAX package's ops/ers.py (EdgeRefinedSuperpixel
in the reference, EdgeRefinedSuperpixel.cu).  No TPU kernel exists for this
stage, so it is plain PyTorch on every device.

edge_refine (edge_refining, cu:4-102) snaps depth-superpixel boundaries to
colour-superpixel boundaries: at each depth-label discontinuity it scans up
to window/2 px (left before right / up before down, nearest first) for a
colour-label change, relabels the run in between to the far side's depth
label, and zeroes depth where the step exceeds 10% of depth.  The
reference mutates labels and depth in place from many threads and
tolerates the races (reference bug (e)); the port keeps the JAX package's
deterministic spec (its ers.py:11-18):
  * boundary detection, relabel sources and zeroing tests read the
    PRE-PASS labels / depth (horizontal pass), and the horizontal pass's
    output (vertical pass, run on the transposed maps);
  * where several boundary commands cover one pixel, the command from the
    NEAREST boundary wins; ties go to the left / up boundary;
  * depth is zeroed by the winning command only.

depth_enhance (depthmap_enhancement, cu:104-205) is a three-pass 7x7
bilateral: a label-constrained weighted mean, a label-constrained mean
absolute deviation, then an adaptive-colour-sigma bilateral whose sigma is
max(adaptive, 0.3 sigma_0) once per pixel (the JAX package's fix of the
reference's in-loop recurrence, its ers.py:186-198).  Terms are gated on
their sigma; each weight factor and product flushes subnormals as XLA does
(stencil.flush_subnormal).

Tensors carry a leading batch dimension: labels and depth [B, H, W],
colour [B, H, W, 3].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.camera import VALID_DEPTH_MM
from ..core.config import ERSParams
from ..ops import stencil

LABEL_PAD = -999999  # out-of-image label (JAX ers.py:65, :153)


class ERSResult(NamedTuple):
    labels: torch.Tensor  # [B, H, W] i32 refined depth labels
    depth: torch.Tensor   # [B, H, W] f32 refined depth


def _shift(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a shifted along its last axis so that out[..., x] = a[..., x + d],
    `fill` out of range."""
    if d == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(d),), fill, dtype=a.dtype, device=a.device)
    if d > 0:
        return torch.cat([a[..., d:], pad], dim=-1)
    return torch.cat([pad, a[..., :d]], dim=-1)


def _row_pass(
    color_labels: torch.Tensor, labels: torch.Tensor, depth: torch.Tensor, half: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One horizontal snapping pass along the last axis (JAX ers.py:46-123),
    over every row of every frame at once."""
    w = labels.shape[-1]
    x = torch.arange(w, device=labels.device)
    # boundary at p: labels[p] != labels[p + 1] (x + 1 < w)
    lab_r = _shift(labels, 1, LABEL_PAD)
    boundary = (labels != lab_r) & (x + 1 < w)

    # first colour-change distance and side per boundary pixel, d = 1..half,
    # left checked before right at each d (the reference's loop order)
    col = color_labels
    hit_d = torch.full_like(labels, half + 1)
    hit_left = torch.zeros_like(labels, dtype=torch.bool)
    for d in range(1, half + 1):
        diff_l = (x - d >= 0) & (_shift(col, -d, -1) != col)
        diff_r = (x + d < w) & (_shift(col, d, -1) != col)
        unhit = hit_d > half
        hit_left = hit_left | (unhit & diff_l)
        hit_d = torch.where(unhit & (diff_l | diff_r), d, hit_d)
    has_hit = boundary & (hit_d <= half)
    left_cmd = has_hit & hit_left
    right_cmd = has_hit & ~hit_left

    # depth-step zero tests on the pre-pass depth: a left-hit run compares
    # depth[q] with depth[q + 1], a right-hit run with depth[q - 1]
    zero_l = (depth - _shift(depth, 1, 0.0)).abs() > depth * 0.1
    zero_r = (depth - _shift(depth, -1, 0.0)).abs() > depth * 0.1

    new_labels, new_depth = labels, depth
    decided = torch.zeros_like(boundary)
    # candidates in priority order (nearest boundary, left / up first):
    # (j, side): (0, L@q), (1, R@q-1), (1, L@q+1), (2, R@q-2), (2, L@q+2), ...
    for j in range(half):
        for side in (("right", "left") if j > 0 else ("left",)):
            if side == "left":
                # p = q + j is a left-hit boundary whose run [p-d+1, p] covers q;
                # it relabels to labels[p + 1]
                cmd = _shift(left_cmd, j, False) & (_shift(hit_d, j, 0) >= j + 1)
                newl = _shift(lab_r, j, -1)
                zero = zero_l
            else:
                # p = q - j is a right-hit boundary whose run [p+1, p+d-1]
                # covers q; it relabels to labels[p]
                cmd = _shift(right_cmd, -j, False) & (_shift(hit_d, -j, 0) >= j + 1)
                newl = _shift(labels, -j, -1)
                zero = zero_r
            take = cmd & ~decided
            new_labels = torch.where(take, newl, new_labels)
            new_depth = torch.where(take & zero, 0.0, new_depth)
            decided = decided | take
    return new_labels, new_depth


def edge_refine(
    color_labels: torch.Tensor,
    depth_labels: torch.Tensor,
    depth: torch.Tensor,
    p: ERSParams = ERSParams(),
) -> ERSResult:
    """edge_refining (cu:4-102): the horizontal pass, then the vertical pass
    on its output (the row pass on the transposed maps)."""
    half = p.window // 2
    lab1, dep1 = _row_pass(color_labels, depth_labels, depth, half)
    cols = [a.transpose(-1, -2) for a in (color_labels, lab1, dep1)]
    lab2, dep2 = _row_pass(*cols, half)
    return ERSResult(labels=lab2.transpose(-1, -2).contiguous(),
                     depth=dep2.transpose(-1, -2).contiguous())


def depth_enhance(
    refined: ERSResult, color: torch.Tensor, p: ERSParams = ERSParams()
) -> torch.Tensor:
    """depthmap_enhancement (cu:104-205): the three-pass adaptive bilateral
    (JAX ers.py:140-219), 0 where pass 1 found no support."""
    depth, labels = refined.depth, refined.labels
    h, w = depth.shape[-2:]
    r = p.window // 2
    flush = stencil.flush_subnormal
    cf = color.to(torch.float32)
    spatial = stencil.gaussian_spatial_filter(p.window, p.spatial_sigma, depth.device)
    dpad = stencil.pad2d(depth, r, 0.0)
    cpad = stencil.pad2d(cf, r, 0.0)
    lpad = stencil.pad2d(labels, r, LABEL_PAD)
    zero = torch.zeros_like(depth)
    one = torch.ones_like(depth)

    def color_weight(ng, c2):
        e = cf - ng
        return flush(torch.exp(-stencil.dot3(e, e) / c2))

    # pass 1: label-constrained weighted mean
    wsum, dsum = zero, zero
    c2 = torch.full((), 2.0 * p.color_sigma**2, dtype=torch.float32, device=depth.device)
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        nl = stencil.shift(lpad, dy, dx, r, (h, w))
        ok = (nd > VALID_DEPTH_MM) & (nl == labels)
        filt = spatial[dy + r, dx + r].expand_as(depth)
        if p.color_sigma:
            filt = flush(filt * color_weight(stencil.shift(cpad, dy, dx, r, (h, w)), c2))
        filt = torch.where(ok, filt, zero)
        dsum = dsum + nd * filt
        wsum = wsum + filt
    w_avg = dsum / torch.where(wsum > 0, wsum, one)

    # pass 2: label-constrained mean absolute deviation
    cnt, dev = zero, zero
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        nl = stencil.shift(lpad, dy, dx, r, (h, w))
        ok = (nd > VALID_DEPTH_MM) & (nl == labels)
        dev = dev + torch.where(ok, (nd - w_avg).abs(), zero)
        cnt = cnt + ok.to(torch.float32)
    dev = dev / torch.where(cnt > 0, cnt, one)

    # pass 3: the adaptive-sigma bilateral (NOT label-constrained); sigma is
    # floored at 0.3 sigma_0 once per pixel
    adaptive = 5.0 * dev / torch.square(torch.where(w_avg != 0.0, w_avg, one))
    sigma = torch.clamp_min(adaptive, p.color_sigma * 0.3)
    c2_px = 2.0 * torch.square(torch.clamp_min(sigma, 1e-30))
    d2 = torch.full((), 2.0 * p.depth_sigma**2, dtype=torch.float32, device=depth.device)
    num, den = zero, zero
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        filt = spatial[dy + r, dx + r].expand_as(depth)
        if p.color_sigma:
            filt = flush(filt * color_weight(stencil.shift(cpad, dy, dx, r, (h, w)), c2_px))
        if p.depth_sigma:
            e = nd - w_avg
            filt = flush(filt * flush(torch.exp(-(e * e) / d2)))
        filt = torch.where(nd > VALID_DEPTH_MM, filt, zero)
        num = num + nd * filt
        den = den + filt
    has = den != 0.0
    out = torch.where(has, num / torch.where(has, den, one), zero)
    return torch.where(wsum > 0.0, out, zero)


def edge_refined_superpixel(
    color_labels: torch.Tensor,
    depth_labels: torch.Tensor,
    depth: torch.Tensor,
    color: torch.Tensor,
    p: ERSParams = ERSParams(),
) -> ERSResult:
    """EdgeRefinedSuperpixel::EdgeRefining (cu:208-223): snap, then enhance."""
    refined = edge_refine(color_labels, depth_labels, depth, p)
    return ERSResult(labels=refined.labels, depth=depth_enhance(refined, color, p))
