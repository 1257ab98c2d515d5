"""Real RGB-D dataset loaders (TUM RGB-D and paired PNG) and the Kinect v1
sensor model, NumPy only.

A copy of the JAX package's core/datasets.py.  The reference consumes live
OpenNI frames or its own depth.xml replay (main.cpp:139-163); these read
the two common on-disk formats directly (no OpenCV / ROS dependency):

  * the TUM RGB-D benchmark layout: <seq>/rgb.txt and <seq>/depth.txt
    ("timestamp filename" index lines), <seq>/rgb/*.png (8-bit RGB) and
    <seq>/depth/*.png (16-bit, depth [m] * 5000), associated by nearest
    timestamp (the dataset's associate.py contract: greedy best match
    within max_difference, default 0.02 s);
  * NYU-v2-style paired PNGs: parallel rgb/ and depth/ directories, 16-bit
    depth PNGs already in millimetres (scale override available).

Depths are returned as f32 millimetres (0 = invalid, the z <= 50 mm
sentinel convention) and RGB as u8 [H, W, 3]; the pipelines take them
after torch.from_numpy(...).to(device).

kinect_v1_sensor_model is a physically-faithful Kinect v1 synthesizer
(triangulation disparity quantization + axial noise).  The quantization
banding it reproduces is the dominant Kinect v1 artifact the enhancement
pipelines exist to remove (the reference's own uniform-noise model,
main.cpp:127-130, has none).  write_tum_sequence round-trips with
TUMSequence, so the loader path is exercised without a dataset.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics
from kinectdepthmapenhancement_tpu_torch.core.io import imread_rgb

# TUM depth PNGs store depth[m] * 5000 (dataset format spec).
TUM_DEPTH_SCALE = 5000.0

# Per-sequence-family pinhole intrinsics published by the TUM benchmark
# (ROS default / freiburg1 / freiburg2 / freiburg3 calibrations).
TUM_INTRINSICS: Dict[str, Intrinsics] = {
    "default": Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5),
    "fr1": Intrinsics(fx=517.3, fy=516.5, cx=318.6, cy=255.3),
    "fr2": Intrinsics(fx=520.9, fy=521.0, cx=325.1, cy=249.7),
    "fr3": Intrinsics(fx=535.4, fy=539.2, cx=320.1, cy=247.6),
}


def read_depth_png(path: str, *, scale_to_mm: float = 1000.0 / TUM_DEPTH_SCALE) -> np.ndarray:
    """Read a 16-bit depth PNG -> f32 mm.  scale_to_mm converts stored
    integer units to millimetres (TUM: 1000/5000 = 0.2; NYU-mm PNGs: 1.0).
    Stored 0 stays 0 (invalid)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim != 2:
        raise ValueError(f"{path}: depth PNG must be single-channel, got {arr.shape}")
    return arr.astype(np.float32) * np.float32(scale_to_mm)


def write_depth_png(path: str, depth_mm: np.ndarray, *, scale_to_mm: float = 1000.0 / TUM_DEPTH_SCALE) -> None:
    """Write f32 mm depth as a 16-bit PNG in the given storage units
    (round-trips with read_depth_png up to the integer quantization)."""
    from PIL import Image

    stored = np.clip(
        np.round(np.asarray(depth_mm, np.float64) / scale_to_mm), 0, 65535
    ).astype(np.uint16)
    Image.fromarray(stored).save(path)


def _read_index(path: str) -> List[Tuple[float, str]]:
    """Parse a TUM index file: '# comment' lines, then 'timestamp path'."""
    out: List[Tuple[float, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def associate(
    a: Sequence[Tuple[float, str]],
    b: Sequence[Tuple[float, str]],
    *,
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (the TUM associate.py contract):
    all candidate pairs within max_difference sorted by |dt|, matched
    greedily so each entry is used at most once.  Returns index pairs into
    (a, b), sorted by a-timestamp.

    Candidates are generated with a bisect-bounded window per a-entry
    (O(|a| log |b| + matches)) rather than the full |a|x|b| product — real
    TUM sequences are ~3000x3000 entries and index files are unsorted only
    in pathological cases, so b is sorted by timestamp first."""
    import bisect

    b_sorted = sorted(range(len(b)), key=lambda j: b[j][0])
    b_times = [b[j][0] + offset for j in b_sorted]
    cand = []
    for i, (ta, _) in enumerate(a):
        lo = bisect.bisect_left(b_times, ta - max_difference)
        hi = bisect.bisect_right(b_times, ta + max_difference)
        for k in range(lo, hi):
            dt = abs(ta - b_times[k])
            if dt < max_difference:
                cand.append((dt, i, b_sorted[k]))
    cand.sort()
    used_a: set = set()
    used_b: set = set()
    pairs: List[Tuple[int, int]] = []
    for _, i, j in cand:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort(key=lambda p: a[p[0]][0])
    return pairs


@dataclasses.dataclass(frozen=True)
class RGBDFrame:
    """One associated RGB-D frame: u8 color, f32 mm depth (0 = invalid)."""

    color: np.ndarray
    depth: np.ndarray
    timestamp: float
    color_path: str = ""
    depth_path: str = ""


class TUMSequence:
    """A TUM RGB-D sequence directory: index parsing + association at
    construction, image decoding on access (frames are lazy)."""

    def __init__(
        self,
        root: str,
        *,
        max_difference: float = 0.02,
        intrinsics: Optional[Intrinsics] = None,
    ):
        self.root = root
        self.rgb_index = _read_index(os.path.join(root, "rgb.txt"))
        self.depth_index = _read_index(os.path.join(root, "depth.txt"))
        self.pairs = associate(
            self.rgb_index, self.depth_index, max_difference=max_difference
        )
        if intrinsics is None:
            name = os.path.basename(os.path.normpath(root)).lower()
            fam = next((k for k in ("fr1", "fr2", "fr3")
                        if f"freiburg{k[-1]}" in name or name.startswith(k)), "default")
            intrinsics = TUM_INTRINSICS[fam]
        self.intrinsics = intrinsics

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> RGBDFrame:
        ri, di = self.pairs[i]
        ts, rgb_rel = self.rgb_index[ri]
        _, depth_rel = self.depth_index[di]
        rgb_path = os.path.join(self.root, rgb_rel)
        depth_path = os.path.join(self.root, depth_rel)
        return RGBDFrame(
            color=imread_rgb(rgb_path),
            depth=read_depth_png(depth_path),
            timestamp=ts,
            color_path=rgb_path,
            depth_path=depth_path,
        )

    def __iter__(self) -> Iterator[RGBDFrame]:
        for i in range(len(self)):
            yield self[i]


def write_tum_sequence(
    root: str,
    frames: Sequence[Tuple[float, np.ndarray, np.ndarray]],
) -> None:
    """Write (timestamp, color u8 [H,W,3], depth f32 mm) frames as a TUM
    sequence directory (rgb.txt/depth.txt + rgb/ + depth/).  Round-trips
    with TUMSequence; also the export path for users converting captures."""
    from PIL import Image

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    depth_lines = ["# depth images", "# timestamp filename"]
    for ts, color, depth in frames:
        rgb_rel = f"rgb/{ts:.6f}.png"
        depth_rel = f"depth/{ts:.6f}.png"
        Image.fromarray(np.asarray(color, np.uint8)).save(os.path.join(root, rgb_rel))
        write_depth_png(os.path.join(root, depth_rel), depth)
        rgb_lines.append(f"{ts:.6f} {rgb_rel}")
        depth_lines.append(f"{ts:.6f} {depth_rel}")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(depth_lines) + "\n")


class PairedPNGDataset:
    """NYU-v2-style paired PNG dirs: sorted rgb/*.{png,jpg} matched 1:1 with
    sorted depth/*.png by position; depth PNGs in mm by default."""

    def __init__(self, root: str, *, depth_scale_to_mm: float = 1.0):
        self.root = root
        rgb_dir = os.path.join(root, "rgb")
        depth_dir = os.path.join(root, "depth")
        self.rgb_files = sorted(
            f for f in os.listdir(rgb_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        self.depth_files = sorted(
            f for f in os.listdir(depth_dir) if f.lower().endswith(".png")
        )
        if len(self.rgb_files) != len(self.depth_files):
            raise ValueError(
                f"{root}: {len(self.rgb_files)} rgb vs {len(self.depth_files)} depth files"
            )
        self.depth_scale_to_mm = depth_scale_to_mm

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, i: int) -> RGBDFrame:
        rgb_path = os.path.join(self.root, "rgb", self.rgb_files[i])
        depth_path = os.path.join(self.root, "depth", self.depth_files[i])
        return RGBDFrame(
            color=imread_rgb(rgb_path),
            depth=read_depth_png(depth_path, scale_to_mm=self.depth_scale_to_mm),
            timestamp=float(i),
            color_path=rgb_path,
            depth_path=depth_path,
        )


# ------------------------------------------------------------ sensor model

# Kinect v1 triangulation constants: baseline 75 mm, depth-camera focal
# ~580 px, disparity measured in 1/8-pixel steps (Khoshelham & Elberink,
# "Accuracy and Resolution of Kinect Depth Data", Sensors 2012).
KINECT_BASELINE_MM = 75.0
KINECT_FOCAL_PX = 580.0
KINECT_DISPARITY_STEP = 1.0 / 8.0


def kinect_v1_sensor_model(
    depth_mm: np.ndarray,
    rng: np.random.Generator,
    *,
    disparity_noise_px: float = 0.06,
    max_range_mm: float = 10000.0,
) -> np.ndarray:
    """Simulate Kinect v1 measurement of a true depth map: the sensor
    triangulates disparity d = b*f/z, jitters it by ~0.06 px (empirical
    plane-fit residuals), QUANTIZES to 1/8-px steps, and back-projects.
    Output has the characteristic depth banding (step ~ z^2/(8 b f):
    ~2.4 mm at 1 m, ~22 mm at 3 m) and z^2-growing axial noise.  Invalid
    (<=0 or out-of-range) pixels return 0."""
    z = np.asarray(depth_mm, np.float64)
    valid = (z > 0) & (z < max_range_mm)
    bf = KINECT_BASELINE_MM * KINECT_FOCAL_PX
    disp = np.where(valid, bf / np.where(valid, z, 1.0), 0.0)
    disp = disp + rng.normal(0.0, disparity_noise_px, z.shape)
    disp = np.round(disp / KINECT_DISPARITY_STEP) * KINECT_DISPARITY_STEP
    ok = valid & (disp > bf / max_range_mm)
    out = np.where(ok, bf / np.where(ok, disp, 1.0), 0.0)
    return out.astype(np.float32)
