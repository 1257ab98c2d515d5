"""File replay IO: colour images and OpenCV-FileStorage XML depth maps.

A copy of the JAX package's core/io.py (NumPy only; PIL imported when an
image is read).

Replaces the reference's file-replay path (main.cpp:139-157), which reads
`experiment/groundtruth/depth.xml` (cv::FileStorage matrices "averaged_depth"
and "depth") plus `color.jpg`, and the capture-mode writer (main.cpp:112-115).

The reference repo's own input/depth.xml is a stripped large blob
(.MISSING_LARGE_BLOBS); callers regenerate depth with
core.buffer2d.synthetic_noise over any ground-truth depth (NYU/TUM or the
procedural scene in testdata.py).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """Read an image file to u8 RGB [H, W, 3] (no OpenCV dependency)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def read_filestorage_xml(path: str) -> Dict[str, np.ndarray]:
    """Parse an OpenCV cv::FileStorage XML file of 2-D float matrices.

    Supports the subset the reference writes (main.cpp:112-115): top-level
    <opencv_storage> containing named <mat type_id="opencv-matrix"> nodes with
    <rows>, <cols>, <dt> in {f, d} and whitespace-separated <data>.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    out: Dict[str, np.ndarray] = {}
    for node in root:
        if node.get("type_id") != "opencv-matrix":
            continue
        rows = int(node.findtext("rows"))
        cols = int(node.findtext("cols"))
        dt = (node.findtext("dt") or "f").strip()
        data = node.findtext("data") or ""
        vals = np.array([float(t) for t in data.split()], dtype=np.float64)
        if vals.size != rows * cols:
            raise ValueError(
                f"matrix '{node.tag}': expected {rows * cols} values, got {vals.size}"
            )
        arr = vals.reshape(rows, cols)
        out[node.tag] = arr.astype(np.float32 if dt == "f" else np.float64)
    return out


def write_filestorage_xml(path: str, mats: Dict[str, np.ndarray]) -> None:
    """Write matrices in cv::FileStorage XML form (round-trips with the
    reader above and with OpenCV)."""
    lines = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, arr in mats.items():
        if not re.match(r"^[A-Za-z_][A-Za-z0-9_-]*$", name):
            raise ValueError(f"invalid FileStorage node name: {name!r}")
        a = np.asarray(arr)
        dt = "d" if a.dtype == np.float64 else "f"
        body = " ".join(
            repr(float(v)) if dt == "d" else f"{float(v):.9g}" for v in a.ravel()
        )
        lines += [
            f'<{name} type_id="opencv-matrix">',
            f"  <rows>{a.shape[0]}</rows>",
            f"  <cols>{a.shape[1]}</cols>",
            f"  <dt>{dt}</dt>",
            f"  <data>{body}</data>",
            f"</{name}>",
        ]
    lines.append("</opencv_storage>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
