"""Normal-map generation: SAMG smoothing-area map, then CM, SDC or
bilateral normals.

PyTorch counterpart of the JAX package's ops/normals.py (NormalEstimation/
{SmoothingAreaMapGenerator,NormalMapGenerator} in the reference).  Vertices
are in METRES here (NormalMapGenerator.cu:505-511 divides the mm point map
by 1000 on entry).  The documented spec decisions are the JAX package's:
the gather form of the depth-change map with a clamped x = w-1 read, the
bounded min-plus chamfer relaxation, per-query-centred direct covariance
accumulation, the closed-form eigensolver, and the (-1, -1, -1) sentinel.

The chamfer DT runs in ops/cuda_dt.py and the covariance sweep in
ops/cuda_cov.py (CUDA kernels on the card, their plain versions on the
CPU).  The SDC normals read f32 summed-area tables (ops/integral.py, summed
in float64: see there) at each pixel's own window size, by gathers; the
bilateral normals are the one-pixel cross product.  Neither has a TPU
kernel behind it: both are plain PyTorch on every device.

Image tensors carry a leading batch dimension: [B, H, W, ...].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.config import NormalParams
from ..core.device import constant
from ..ops import cuda_cov, cuda_dt, integral, stencil

BAD = -1.0
FLT_EPSILON = 1.19209290e-07

# ------------------------------------------------------------------- SAMG


def dci_map(vertices_m: torch.Tensor, max_depth_change: float) -> torch.Tensor:
    """Depth-change indication map: 0 at discontinuities, 255 elsewhere (i32)."""
    z = vertices_m[..., 2]
    b, h, w = z.shape
    z_r = torch.cat([z[:, :, 1:], z[:, :, -1:]], dim=2)
    z_d = torch.cat([z[:, 1:, :], z[:, -1:, :]], dim=1)
    thr = max_depth_change * (z.abs() + 1.0) * 2.0
    horiz = ((z - z_r).abs() > thr) | (z == 0.0) | (z_r == 0.0)
    vert = ((z - z_d).abs() > thr) | (z == 0.0) | (z_d == 0.0)
    # the left neighbour's horizontal test also zeroes p; the up neighbour's vertical
    horiz_from_left = torch.cat(
        [torch.zeros((b, h, 1), dtype=torch.bool, device=z.device), horiz[:, :, :-1]], dim=2
    )
    vert_from_up = torch.cat(
        [torch.zeros((b, 1, w), dtype=torch.bool, device=z.device), vert[:, :-1, :]], dim=1
    )
    zero = horiz | vert | horiz_from_left | vert_from_up
    return torch.where(zero, 0, 255).to(torch.int32)


def distance_transform(dci: torch.Tensor, iterations: int) -> torch.Tensor:
    """Chamfer (3x3, weights 1/1.4) distance to the nearest dci == 0 pixel,
    by `iterations` rounds of min-plus relaxation (ops/cuda_dt.py)."""
    return cuda_dt.distance_transform(dci.contiguous(), iterations)


def smoothing_map(vertices_m: torch.Tensor, p: NormalParams) -> torch.Tensor:
    """Final smoothing-area map = min(DT, size + z/10)  [pixels]."""
    dci = dci_map(vertices_m, p.max_depth_change_factor)
    dt = distance_transform(dci, p.dt_iterations)
    ddsa = p.normal_smoothing_size + vertices_m[..., 2] / 10.0
    return torch.minimum(dt, ddsa)


# -------------------------------------------------------------- eigensolver


def _compute_roots(m00, m01, m02, m11, m12, m22):
    """Eigenvalues of the symmetric 3x3, ascending; computeRoots
    (NormalMapGenerator.cu:145-191) vectorised.  Returns (r0, r1, r2)."""
    c0 = (
        m00 * m11 * m22
        + 2.0 * m01 * m02 * m12
        - m00 * m12 * m12
        - m11 * m02 * m02
        - m22 * m01 * m01
    )
    c1 = m00 * m11 - m01 * m01 + m00 * m22 - m02 * m02 + m11 * m22 - m12 * m12
    c2 = m00 + m11 + m22

    # quadratic fallback (computeRoots2): roots (0, (c2-sd)/2, (c2+sd)/2)
    d = torch.clamp_min(c2 * c2 - 4.0 * c1, 0.0)
    sd = torch.sqrt(d)
    q0 = torch.zeros_like(c2)
    q1 = 0.5 * (c2 - sd)
    q2 = 0.5 * (c2 + sd)

    s_inv3 = 1.0 / 3.0
    s_sqrt3 = math.sqrt(3.0)
    c2_over_3 = c2 * s_inv3
    a_over_3 = torch.clamp_max((c1 - c2 * c2_over_3) * s_inv3, 0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = torch.clamp_max(half_b * half_b + a_over_3 * a_over_3 * a_over_3, 0.0)
    rho = torch.sqrt(-a_over_3)
    theta = torch.atan2(torch.sqrt(-q), half_b) * s_inv3
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    e0 = c2_over_3 + 2.0 * rho * cos_t
    e1 = c2_over_3 - rho * (cos_t + s_sqrt3 * sin_t)
    e2 = c2_over_3 - rho * (cos_t - s_sqrt3 * sin_t)
    # the reference's swap sequence sorts ascending
    lo = torch.minimum(torch.minimum(e0, e1), e2)
    hi = torch.maximum(torch.maximum(e0, e1), e2)
    mid = e0 + e1 + e2 - lo - hi

    use_quad = (c0.abs() < FLT_EPSILON) | (lo <= 0.0)
    r0 = torch.where(use_quad, q0, lo)
    r1 = torch.where(use_quad, q1, mid)
    r2 = torch.where(use_quad, q2, hi)
    return r0, r1, r2


def smallest_eigenvector(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalue, eigenvector) of the smallest eigenvalue of symmetric 3x3
    covariances cov[..., 3, 3]; computeEigenValueAndVector
    (NormalMapGenerator.cu:193-242): scale by max |entry|, solve the cubic,
    take the longest cross product of rows of (M - lambda I)."""
    m00 = cov[..., 0, 0]
    m01 = cov[..., 0, 1]
    m02 = cov[..., 0, 2]
    m11 = cov[..., 1, 1]
    m12 = cov[..., 1, 2]
    m22 = cov[..., 2, 2]
    scale = torch.stack(
        [m00.abs(), m01.abs(), m02.abs(), m11.abs(), m12.abs(), m22.abs()], dim=-1
    ).amax(dim=-1)
    tiny = 1e-300 if scale.dtype == torch.float64 else 1e-37
    scale = torch.where(scale <= tiny, torch.ones_like(scale), scale)
    s00, s01, s02 = m00 / scale, m01 / scale, m02 / scale
    s11, s12, s22 = m11 / scale, m12 / scale, m22 / scale

    r0, _, _ = _compute_roots(s00, s01, s02, s11, s12, s22)
    eigenvalue = r0 * scale

    a00 = s00 - r0
    a11 = s11 - r0
    a22 = s22 - r0
    # rows of (M - lambda I): (a00, s01, s02), (s01, a11, s12), (s02, s12, a22)
    v1 = torch.stack(
        [s01 * s12 - s02 * a11, s02 * s01 - a00 * s12, a00 * a11 - s01 * s01], dim=-1
    )
    v2 = torch.stack(
        [s01 * a22 - s02 * s12, s02 * s02 - a00 * a22, a00 * s12 - s01 * s02], dim=-1
    )
    v3 = torch.stack(
        [a11 * a22 - s12 * s12, s12 * s02 - s01 * a22, s01 * s12 - a11 * s02], dim=-1
    )
    l1 = stencil.dot3(v1, v1)
    l2 = stencil.dot3(v2, v2)
    l3 = stencil.dot3(v3, v3)
    use1 = (l1 >= l2) & (l1 >= l3)
    use2 = (~use1) & (l2 >= l3)
    vec = torch.where(use1[..., None], v1, torch.where(use2[..., None], v2, v3))
    ln = torch.sqrt(torch.where(use1, l1, torch.where(use2, l2, l3)))
    vec = vec / torch.clamp_min(ln, 1e-30)[..., None]
    return eigenvalue, vec


# ------------------------------------------------------------------ normals


def _cross_product_normal(vertices_m: torch.Tensor):
    """Shared 1-pixel cross-product core of computeRestNormal.

    Returns (n [B,H,W,3] normalised by -|n| where |n| > 0, else the raw
    cross), d_h, d_v.  The +-1 neighbour step is a select between the two
    edge-clamped shifted images."""
    _, h, w, _ = vertices_m.shape
    vpad = stencil.pad_channels_last(vertices_m, 1, "replicate")
    p_r = vpad[:, 1 : 1 + h, 2 : 2 + w]
    p_l = vpad[:, 1 : 1 + h, 0:w]
    p_d = vpad[:, 2 : 2 + h, 1 : 1 + w]
    p_u = vpad[:, 0:h, 1 : 1 + w]
    step_neg = (p_r[..., 2] == 0.0)[..., None]
    ph01 = torch.where(step_neg, p_l, p_r)
    pv01 = torch.where(step_neg, p_u, p_d)
    p0 = vertices_m
    v_h = ph01 - p0
    v_v = pv01 - p0
    nx = v_h[..., 2] * v_v[..., 1] - v_h[..., 1] * v_v[..., 2]
    ny = -(v_h[..., 0] * v_v[..., 2] - v_h[..., 2] * v_v[..., 0])
    nz = v_h[..., 1] * v_v[..., 0] - v_h[..., 0] * v_v[..., 1]
    n = torch.stack([nx, ny, nz], dim=-1)
    norm = torch.sqrt(stencil.dot3(n, n))
    pos = norm > 0.0
    n = torch.where(pos[..., None], n / torch.where(pos, -norm, torch.ones_like(norm))[..., None], n)
    d_h = torch.sqrt(stencil.dot3(v_h, v_h))
    d_v = torch.sqrt(stencil.dot3(v_v, v_v))
    return n, d_h, d_v


def _final_flip(normal: torch.Tensor) -> torch.Tensor:
    """(-x, y, -z) for every pixel with any component != -1
    (computeRestNormal tail, NormalMapGenerator.cu:347-353)."""
    valid = (normal != BAD).any(dim=-1)
    sign = constant((-1.0, 1.0, -1.0), normal.dtype, normal.device)
    return torch.where(valid[..., None], normal * sign, normal)


def _rest_normals(normal: torch.Tensor, vertices_m: torch.Tensor) -> torch.Tensor:
    """computeRestNormal fill-in for pixels that are exactly (-1,-1,-1),
    then the final sign flip for all valid pixels."""
    n, d_h, d_v = _cross_product_normal(vertices_m)
    z = vertices_m[..., 2]
    take = (z != 0.0) & (d_h < z * 0.01) & (d_v < z * 0.01)
    is_bad = (normal == BAD).all(dim=-1)
    filled = torch.where((is_bad & take)[..., None], n, normal)
    return _final_flip(filled)


def bilateral_normals(vertices_m: torch.Tensor) -> torch.Tensor:
    """computeNormalBilateralGPU (NormalMapGenerator.cu:355-395): the
    one-pixel cross product, sign-flipped, (-1,-1,-1) where z == 0."""
    n, _, _ = _cross_product_normal(vertices_m)
    flip = n * constant((-1.0, 1.0, -1.0), n.dtype, n.device)
    bad = vertices_m[..., 2] == 0.0
    return torch.where(bad[..., None], torch.full_like(flip, BAD), flip)


def _box_channels(z_m: torch.Tensor) -> integral.CenteredIntegral:
    """SDC's tables of a frame's z [B, H, W] in metres: z (0 where invalid)
    and the valid count.  (The JAX package's nine-moment form for method
    "cm" has no caller: the CM covariances are accumulated directly.)"""
    z = z_m.contiguous()
    return integral.build(z[..., None], z != 0.0)


MAX_RECT = 21  # ddsa = 20 + z/10 with z <= ~15 m caps the window at 21 px


def _edge_shift(vertices_m: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """out[b, y, x] = vertices_m[b, y + dy, x + dx] with the indices clamped
    to the image (the JAX package's slice of the edge-padded image), for
    per-pixel offsets dy, dx [B, H, W]."""
    b, h, w, _ = vertices_m.shape
    dev = vertices_m.device
    y = torch.clamp(torch.arange(h, device=dev)[:, None] + dy, 0, h - 1)
    x = torch.clamp(torch.arange(w, device=dev)[None, :] + dx, 0, w - 1)
    bi = torch.arange(b, device=dev)[:, None, None]
    return vertices_m[bi, y, x]


def sdc_normals(
    vertices_m: torch.Tensor, smoothing: torch.Tensor, border: int, *, x0: int = 0,
    width: Optional[int] = None, frame_z_m: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """computeNormalSDC_GPU (NormalMapGenerator.cu:29-120), stale-flip FIXED,
    with the JAX package's quirks: pU one row up and one column left (the
    reference's -r4*width - 1), the window size truncated to int, sizes
    from 21 up clamped to 21, and a strict `>` in the border test.

    The JAX package loops over the 20 window sizes with fixed-offset slices
    and selects per pixel; here each pixel reads the four corners of each
    box at its own size's offsets (integral's gather form): the same table
    values and the same additions.  A pixel whose size is below 2 has
    smoothing < 2 and is invalid either way.

    The image may be columns [x0, x0 + W) of a frame `width` wide (a width
    tile with its halo): the summed-area tables are then built from the
    whole frame's z in metres, frame_z_m [B, H, width] (their channel mean
    and prefixes are whole-frame quantities), each pixel reads them at its
    global column, and the border test reads global columns.  The edge
    shifts clamp to the image, which is the frame's edge wherever a kept
    pixel can reach it (stencil_shard.haloed_normals)."""
    _, h, w = smoothing.shape
    dev = smoothing.device
    width = w if width is None else width
    if frame_z_m is None:
        if (x0, width) != (0, w):
            raise ValueError("the SDC normals of a width tile need the frame's z (frame_z_m)")
        frame_z_m = vertices_m[..., 2]
    ci = _box_channels(frame_z_m)
    pi = integral.crop_width(integral.pad_tables(ci, MAX_RECT + 3, h, width), x0, w)
    v = torch.arange(h, device=dev)[:, None]
    u = torch.arange(x0, x0 + w, device=dev)[None, :]
    in_border = (u < border) | (u > width - border) | (v < border) | (v > h - border)

    s = torch.clamp(smoothing.to(torch.int32), 2, MAX_RECT).to(torch.int64)
    r2, r4 = s >> 1, s >> 2
    cont = integral.fixed_box_count(pi, -r2 - 1, -r2 - 1, s, s)
    cL = integral.fixed_box_count(pi, -r2 - 1, -r4 - 1, r2, r2)
    cR = integral.fixed_box_count(pi, 0, -r4 - 1, r2, r2)
    cU = integral.fixed_box_count(pi, -r4 - 1, -r2 - 1, r2, r2)
    cD = integral.fixed_box_count(pi, -r4 - 1, 0, r2, r2)
    sL = integral.fixed_box_sum(pi, 0, -r2 - 1, -r4 - 1, r2, r2)
    sR = integral.fixed_box_sum(pi, 0, 0, -r4 - 1, r2, r2)
    sU = integral.fixed_box_sum(pi, 0, -r4 - 1, -r2 - 1, r2, r2)
    sD = integral.fixed_box_sum(pi, 0, -r4 - 1, 0, r2, r2)
    zero = torch.zeros_like(s)
    pL = _edge_shift(vertices_m, zero, -r4 - 1)
    pR = _edge_shift(vertices_m, zero, r4 + 1)
    pU = _edge_shift(vertices_m, -r4, zero - 1)  # reference: -r4*width - 1
    pD = _edge_shift(vertices_m, r4, zero + 1)

    mL = sL / torch.clamp_min(cL, 1.0)
    mR = sR / torch.clamp_min(cR, 1.0)
    mU = sU / torch.clamp_min(cU, 1.0)
    mD = sD / torch.clamp_min(cD, 1.0)

    mean_x_z = mR - mL
    mean_y_z = mD - mU
    mean_x_x = pR[..., 0] - pL[..., 0]
    mean_x_y = pR[..., 1] - pL[..., 1]
    mean_y_x = pD[..., 0] - pU[..., 0]
    mean_y_y = pD[..., 1] - pU[..., 1]

    nx = mean_x_z * mean_y_y - mean_x_y * mean_y_z
    ny = -(mean_x_x * mean_y_z - mean_x_z * mean_y_x)
    nz = mean_x_y * mean_y_x - mean_x_x * mean_y_y
    nlen2 = (nx * nx + ny * ny) + nz * nz

    cos_theta = -((vertices_m[..., 0] * nx + vertices_m[..., 1] * ny)
                  + vertices_m[..., 2] * nz)
    sgn = torch.where(cos_theta <= 0.0, -1.0, 1.0)
    scale = sgn / torch.sqrt(torch.clamp_min(nlen2, 1e-30))
    n = torch.stack([nx, ny, nz], dim=-1) * scale[..., None]

    bad = (
        in_border
        | (smoothing <= 2.0)
        | (cont == 0)
        | (cL == 0) | (cR == 0) | (cU == 0) | (cD == 0)
        | (nlen2 == 0.0)
    )
    return torch.where(bad[..., None], torch.full_like(n, BAD), n)


def cm_normals(
    vertices_m: torch.Tensor, smoothing: torch.Tensor, border: int, *, x0: int = 0,
    width: Optional[int] = None,
) -> torch.Tensor:
    """computeNormalCM_GPU (NormalMapGenerator.cu:244-302): per-pixel
    covariance at the pixel's own window size (ops/cuda_cov.py), smallest
    eigenvector, reference sign convention, invalid border.  The image may
    be columns [x0, x0 + W) of a frame `width` wide (a width tile with its
    halo): the border test reads global columns."""
    _, h, w = smoothing.shape
    dev = smoothing.device
    width = w if width is None else width
    v = torch.arange(h, device=dev)[:, None]
    u = torch.arange(x0, x0 + w, device=dev)[None, :]
    in_border = (u <= border) | (u >= width - border) | (v <= border) | (v >= h - border)

    rect = smoothing.to(torch.int32)
    cont, ent = cuda_cov.cm_covariances(vertices_m.contiguous(), rect.contiguous())
    c_xx, c_xy, c_xz = ent[..., 0], ent[..., 1], ent[..., 2]
    c_yy, c_yz, c_zz = ent[..., 3], ent[..., 4], ent[..., 5]
    cov = torch.stack(
        [
            torch.stack([c_xx, c_xy, c_xz], -1),
            torch.stack([c_xy, c_yy, c_yz], -1),
            torch.stack([c_xz, c_yz, c_zz], -1),
        ],
        dim=-2,
    )
    _, vec = smallest_eigenvector(cov)
    ez_neg = vec[..., 2] < 0.0
    flip_y = constant((1.0, -1.0, 1.0), vec.dtype, dev)
    stored = torch.where(ez_neg[..., None], vec * flip_y, vec * -flip_y)
    bad = in_border | (smoothing <= 2.0) | (cont == 0)
    return torch.where(bad[..., None], torch.full_like(stored, BAD), stored)


def generate_normal_map(
    points_mm: torch.Tensor, p: NormalParams = NormalParams(), *, x0: int = 0,
    width: Optional[int] = None, frame_z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NormalMapGenerator::generateNormalMap (cu:513-524): mm -> m, then
    the bilateral normals as they are, or the smoothing map, the SDC or CM
    normals, fill + flip.

    points_mm: [B, H, W, 3] real-world points in millimetres.
    Returns normals [B, H, W, 3] with the (-1,-1,-1) invalid sentinel.
    x0, width: the normals of columns [x0, x0 + W) of a frame `width` wide
    (a haloed width tile, parallel/stencil_shard.haloed_normals): the CM
    and SDC border tests read global columns, and the SDC tables come from
    frame_z, the whole frame's depth [B, H, width] in mm (sdc_normals);
    the bilateral normals read one pixel each side and no column index."""
    if p.method not in ("cm", "sdc", "bilateral"):
        raise ValueError(f"unknown normal method {p.method!r}")
    # mm -> m as the product with the f32 1/1000 on every device: PyTorch
    # on CUDA and XLA under jit both turn the division into this product,
    # PyTorch on the CPU would divide
    vm = points_mm * (1.0 / 1000.0)
    if p.method == "bilateral":
        return bilateral_normals(vm)
    border = int(p.normal_smoothing_size)
    smooth = smoothing_map(vm, p)
    if p.method == "sdc":
        frame_z_m = None if frame_z is None else frame_z * (1.0 / 1000.0)
        raw = sdc_normals(vm, smooth, border, x0=x0, width=width, frame_z_m=frame_z_m)
    else:
        raw = cm_normals(vm, smooth, border, x0=x0, width=width)
    return _rest_normals(raw, vm)
