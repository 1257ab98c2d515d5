"""Debug renders mirroring the reference's image dumps, on tensors.

PyTorch counterpart of the JAX package's utils/visualize.py:
SuperpixelSegmentation::getSegmentedImage / getRandomColorImage
(SuperpixelSegmentation.cpp:53-120), NormalMapGenerator::getNormalImg
(NormalMapGenerator.cu:423-440), MarkovRandomField::getRGB
(MarkovRandomField.cpp:86-99) and Kinect::CreateDepthImage
(Kinect/Kinect.cpp:108-151).  The renders return u8 tensors on the input's
device; point_cloud returns a NumPy array; the writers import PIL only
when called.  save_video and comparison_figure (the evaluation harness's
montage, utils/evaluate.py) take NumPy arrays or tensors and write the same
bytes as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def random_color_labels(labels: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Per-label random colours (the JAX package's palette); -1 labels are
    black (getRandomColorImage)."""
    rng = np.random.default_rng(seed)
    palette = torch.from_numpy(rng.integers(0, 255, (k, 3), dtype=np.uint8)).to(labels.device)
    img = palette[labels.clamp_min(0).long()]
    return torch.where((labels >= 0)[..., None], img, torch.zeros_like(img))


def label_boundaries(color: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """White superpixel boundaries over the colour image
    (getSegmentedImage 'Line' mode, SuperpixelSegmentation.cpp:57-73)."""
    down = torch.cat([labels[..., 1:, :], labels[..., -1:, :]], dim=-2)
    right = torch.cat([labels[..., :, 1:], labels[..., :, -1:]], dim=-1)
    edge = (labels != down) | (labels != right)
    return torch.where(edge[..., None], torch.full_like(color, 255), color).to(torch.uint8)


def normal_image(normals: torch.Tensor) -> torch.Tensor:
    """n -> u8 rgb via 255*(n+1)/2 (getNormalImg)."""
    return torch.clamp(255.0 * (normals + 1.0) / 2.0, 0, 255).to(torch.uint8)


def depth_rgb(depth: torch.Tensor, scale: float = 5000.0) -> torch.Tensor:
    """The reference's ratio-based BGR ramp (MarkovRandomField::getRGB):
    valid depth maps through a 3-segment ramp, invalid (<= 50 mm) is black."""
    ratio = torch.clamp_max(depth / scale, 0.99)
    zero = torch.zeros_like(ratio)
    c0 = torch.where(ratio < 0.33, ratio / 0.33 * 255.0,
                     torch.where(ratio < 0.66, (0.66 - ratio) / 0.33 * 255.0, zero))
    c1 = torch.where(ratio < 0.33, zero,
                     torch.where(ratio < 0.66, (ratio - 0.33) / 0.33 * 255.0,
                                 (0.99 - ratio) / 0.33 * 255.0))
    c2 = torch.where(ratio < 0.66, zero, (ratio - 0.66) / 0.33 * 255.0)
    img = torch.stack([c0, c1, c2], dim=-1)
    valid = depth > 50.0
    return torch.where(valid[..., None], torch.clamp(img, 0, 255),
                       torch.zeros_like(img)).to(torch.uint8)


def depth_histogram_image(depth: torch.Tensor, max_depth_mm: int = 10000) -> torch.Tensor:
    """Histogram-equalised depth render of one frame [H, W]
    (Kinect::CreateDepthImage, the NiSimpleViewer algorithm): each valid
    pixel maps to 256*(1 - cdf(z)) in the G and R channels of the BGR image
    (blue stays 0); z == 0 stays at bin 0's value, 0."""
    z = torch.clamp(depth.to(torch.int32), 0, max_depth_mm - 1).long()
    valid = z > 0
    hist = torch.zeros((max_depth_mm,), dtype=torch.float32, device=depth.device)
    hist.index_add_(0, torch.where(valid, z, 0).reshape(-1),
                    valid.to(torch.float32).reshape(-1))
    cdf = torch.cumsum(hist, dim=0)
    points = torch.clamp_min(cdf[-1], 1.0)
    ramp = 256.0 * (1.0 - cdf / points)
    ramp[0] = 0.0  # depth_hist[0] is never rescaled (stays 0)
    val = torch.clamp(ramp[z], 0, 255).to(torch.uint8)
    return torch.stack([torch.zeros_like(val), val, val], dim=-1)  # (B, G, R)


def point_cloud(
    points_mm: torch.Tensor,
    color: Optional[torch.Tensor] = None,
    *,
    max_depth_mm: float = 15000.0,
    flip_z: bool = False,
) -> np.ndarray:
    """Flatten a [H, W, 3] point map (mm) to an [N, 6] xyzrgb NumPy array in
    metres, keeping points with 50 < z < max_depth_mm (the reference's PCL
    cloud, main.cpp:234-301).  flip_z=True stores z negated, the
    reference's PCL convention."""
    pts = points_mm.detach().to(torch.float32).reshape(-1, 3).cpu().numpy()
    ok = (pts[:, 2] > 50.0) & (pts[:, 2] < max_depth_mm)
    xyz = pts[ok] / 1000.0
    if flip_z:
        xyz = xyz * np.array([1.0, 1.0, -1.0], np.float32)
    if color is None:
        rgb = np.full_like(xyz, 255.0)
    else:
        rgb = torch.as_tensor(color).reshape(-1, 3).cpu().numpy().astype(np.float32)[ok]
    return np.concatenate([xyz, rgb], axis=-1)


def save_ply(path: str, cloud: np.ndarray) -> None:
    """Write an [N, 6] xyzrgb cloud as ASCII PLY (the reference's PCL
    viewer and pcd dumps, main.cpp:362-413, Kinect.cpp SavePointcloud)."""
    header = "\n".join([
        "ply",
        "format ascii 1.0",
        f"element vertex {cloud.shape[0]}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        "end_header",
    ])
    body = "\n".join(
        f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {int(p[3])} {int(p[4])} {int(p[5])}"
        for p in cloud
    )
    with open(path, "w") as f:
        f.write(header + "\n" + body + "\n")


def save_png(path: str, image: torch.Tensor) -> None:
    """Write a u8 image (the reference's cv::imwrite debug hooks)."""
    from PIL import Image

    Image.fromarray(torch.as_tensor(image).cpu().numpy()).save(path)


def _host(image) -> np.ndarray:
    """A u8 image as a NumPy array (a tensor is copied to the host)."""
    return (image.cpu().numpy() if isinstance(image, torch.Tensor)
            else np.asarray(image)).astype(np.uint8, copy=False)


def save_video(path: str, frames, fps: float = 30.0) -> None:
    """Write a frame sequence as an animated GIF, the counterpart of the
    reference's per-run segmentation cv::VideoWriter
    (SuperpixelSegmentation.cpp:9, 30 fps XVID).  `frames` is an iterable of
    u8 [H, W, 3] images; GIF is the codec-free container PIL can always
    write (path should end in .gif)."""
    from PIL import Image

    imgs = [Image.fromarray(_host(f)) for f in frames]
    if not imgs:
        raise ValueError("no frames")
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(round(1000.0 / fps)), loop=0)


def comparison_figure(panels, cols: int = 3, caption_h: int = 18) -> np.ndarray:
    """Side-by-side montage of captioned depth renders, the reference's PCL
    6-viewport comparison (INPUT / GROUND TRUTH / MRF / RGBF / JBF /
    PROPOSED, main.cpp:362-413) as one image.

    panels: an ordered dict or list of (name, u8 [H, W, 3] image); returns
    the montage as a u8 NumPy array (rows of `cols` panels, each under a
    caption bar)."""
    from PIL import Image, ImageDraw

    items = list(panels.items()) if isinstance(panels, dict) else list(panels)
    if not items:
        raise ValueError("no panels")
    h, w = items[0][1].shape[:2]
    rows = -(-len(items) // cols)
    out = np.zeros((rows * (h + caption_h), cols * w, 3), np.uint8)
    for i, (name, img) in enumerate(items):
        r, c = divmod(i, cols)
        y0 = r * (h + caption_h)
        bar = Image.new("RGB", (w, caption_h), (30, 30, 30))
        ImageDraw.Draw(bar).text((4, 2), str(name), fill=(255, 255, 255))
        out[y0:y0 + caption_h, c * w:(c + 1) * w] = np.asarray(bar)
        out[y0 + caption_h:y0 + caption_h + h, c * w:(c + 1) * w] = _host(img)
    return out


def dump_kde_debug(out_dir: str, res, color: torch.Tensor, k: int, frame_id: int = 0) -> list:
    """Per-frame debug dumps of one frame's KDEResult, mirroring the
    reference's cv::imwrite("segmentation.jpg"/"labelImage.jpg") hooks
    (KinectDepthEnhancement.cpp:69,77) behind an explicit flag, plus the
    normal and refined-depth renders.  Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{frame_id:06d}")
    renders = (
        ("segmentation", label_boundaries(color, res.nasp_labels)),
        ("labelImage", random_color_labels(res.merged_labels, k)),
        ("normals", normal_image(res.normals)),
        ("depth", depth_rgb(res.optimized_points[..., 2])),
    )
    paths = []
    for name, img in renders:
        path = f"{base}_{name}.png"
        save_png(path, img)
        paths.append(path)
    return paths
