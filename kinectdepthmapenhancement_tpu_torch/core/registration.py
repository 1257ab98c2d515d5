"""Depth-to-colour viewpoint registration and intrinsics from the sensor's
calibration, on tensors.

PyTorch counterpart of the JAX package's core/registration.py.  The
reference gets both from OpenNI: registration is left to the hardware
(`AlternativeViewPointCapability::SetViewPoint(Image_Generator)`,
Kinect/Kinect.cpp:70-75) and the intrinsic matrix comes from the depth
generator's ZPD / ZPPS properties, fx = fy = F / (2 * pixel_size),
cx = W/2, cy = H/2 (Kinect/Kinect.cpp:89-95).  Unregistered RGB-D data
(NYU-v2 raw, TUM) needs both done here:

  * `intrinsics_from_zpd_zpps`: the Kinect.cpp:89-95 formula;
  * `register_depth_to_color`: a forward-warp z-buffer splat.  Every depth
    pixel is unprojected (the y-flipped convention of core/camera.py),
    moved into the colour camera's frame by the rigid transform, projected
    with the colour intrinsics and rounded to the nearest pixel (half to
    even, as jnp.round); each target pixel keeps the least z (the near
    surface wins, as the hardware's viewpoint mapping does).

The rigid transform is three f32 multiply-adds a component, each operation
rounded: no matmul, so no TF32 product on the card.  The z-buffer is a
scatter_reduce "amin", whose result does not depend on the order of the
splats, so the card's output equals the CPU's.  The unprojection is
core/camera.py's projective_to_real, whose divisions by fx and fy are true
divisions on every device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, projective_to_real


def intrinsics_from_zpd_zpps(
    zpd_mm: float, zpps_mm: float, width: int = 640, height: int = 480
) -> Intrinsics:
    """fx = fy = ZPD / (2 * ZPPS), cx = W/2, cy = H/2 (Kinect.cpp:89-95).

    ZPD is the zero-plane distance (focal length, mm) and ZPPS the zero-plane
    pixel size (mm/px at ZPD, for the 1280-wide sensor mode, hence the
    factor 2 at 640x480).
    """
    f = float(zpd_mm) / (2.0 * float(zpps_mm))
    return Intrinsics(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)


class Extrinsics(NamedTuple):
    """Rigid transform depth camera -> colour camera: p_c = R @ p_d + t."""

    rotation: torch.Tensor     # [3, 3]
    translation: torch.Tensor  # [3] mm

    @staticmethod
    def identity(device=None) -> "Extrinsics":
        return Extrinsics(torch.eye(3, dtype=torch.float32, device=device),
                          torch.zeros(3, dtype=torch.float32, device=device))


def register_depth_to_color(
    depth: torch.Tensor,
    depth_intr: Intrinsics,
    color_intr: Intrinsics,
    extr: Extrinsics,
    out_shape: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Warp a depth map from the depth camera into the colour camera's frame.

    depth: [H, W] f32 mm (z <= 0 invalid).  Returns [Ho, Wo] f32 mm in the
    colour camera's pixel grid on depth's device, 0 where no depth pixel
    lands.  Nearest-pixel splat with z-buffering (min z wins on collision).
    """
    h, w = depth.shape
    ho, wo = out_shape or (h, w)
    dev, f32 = depth.device, torch.float32
    rot = torch.as_tensor(extr.rotation).to(dev, f32)
    t = torch.as_tensor(extr.translation).to(dev, f32)

    pts = projective_to_real(depth, depth_intr).reshape(-1, 3)
    x, y, z = pts.unbind(-1)
    pc = [x * rot[j, 0] + y * rot[j, 1] + z * rot[j, 2] + t[j] for j in range(3)]
    zc = pc[2]
    valid = (depth.reshape(-1) > 0.0) & (zc > 1.0)
    safe_z = torch.where(valid, zc, torch.ones_like(zc))
    uc = pc[0] / safe_z * color_intr.fx + color_intr.cx
    vc = color_intr.cy - pc[1] / safe_z * color_intr.fy
    ui = torch.round(uc).to(torch.int32)
    vi = torch.round(vc).to(torch.int32)

    inside = valid & (ui >= 0) & (ui < wo) & (vi >= 0) & (vi < ho)
    # out-of-frame splats go to index 0 with +inf, which no minimum takes
    idx = torch.where(inside, vi.long() * wo + ui.long(), torch.zeros_like(ui, dtype=torch.long))
    zsplat = torch.where(inside, zc, torch.full_like(zc, float("inf")))
    out = torch.full((ho * wo,), float("inf"), dtype=f32, device=dev)
    out.scatter_reduce_(0, idx, zsplat, "amin")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out)).reshape(ho, wo)
