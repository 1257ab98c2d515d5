"""The plain reference that decides `correct`: a frozen copy of the port's
plain PyTorch route of kde_pipeline (JBF, CM normals, NASP, CCL merge,
plane projection) and of run_stream's chunk step (the temporal buffer fold
and the mean 3-D error against it).

Copied from kinectdepthmapenhancement_tpu_torch at commit SOURCE_COMMIT,
file by file as FILES maps them.  The copies differ from their sources
only in these ways: imports are relative; the kernel wrappers
(ops/cuda_*.py) keep their plain versions alone, each recorded
(record.py); slic's stats route is the plain one for every stats_impl;
core/jit.py is its eager half; buffer2d drops its compiled `accumulate`;
pipelines keeps kde_pipeline and the baselines; tables.exact_matmul
follows the control's switch (`tf32()`).  It imports nothing of the port
and nothing of JAX, and takes nothing the port made: the harness hands it
the same depth frames, colour image and intrinsics that it hands the port.

FILES are the copies every pipeline shares.  A pipeline's file,
kdebench/pipelines/<name>.py, lists in its own FILES the copies here that
it adds (reference file -> (the port's file, the commit it was copied
at)), so a new pipeline's copies come in as new files; nothing here
imports the pipeline files.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

from .core import buffer2d
from .core.camera import Intrinsics, projective_to_real
from .core.config import KDEConfig
from .models.pipelines import kde_pipeline
from .ops import tables
from .utils import metrics

SOURCE_COMMIT = "327a054e3e58fb5792ecd7a04055f13060463e42"
SOURCE_PACKAGE = "kinectdepthmapenhancement_tpu_torch"
# the reference's file -> the port's file it was copied from
FILES = {
    "core/buffer2d.py": "core/buffer2d.py",
    "core/camera.py": "core/camera.py",
    "core/config.py": "core/config.py",
    "core/device.py": "core/device.py",
    "core/jit.py": "core/jit.py",
    "models/pipelines.py": "models/pipelines.py",
    "ops/bilateral.py": "ops/bilateral.py",
    "ops/ccl.py": "ops/ccl.py",
    "ops/cuda_bilateral.py": "ops/cuda_bilateral.py",
    "ops/cuda_cov.py": "ops/cuda_cov.py",
    "ops/cuda_dt.py": "ops/cuda_dt.py",
    "ops/cuda_gradient.py": "ops/cuda_gradient.py",
    "ops/cuda_nasp.py": "ops/cuda_nasp.py",
    "ops/integral.py": "ops/integral.py",
    "ops/normals.py": "ops/normals.py",
    "ops/plane.py": "ops/plane.py",
    "ops/slic.py": "ops/slic.py",
    "ops/stencil.py": "ops/stencil.py",
    "ops/tables.py": "ops/tables.py",
    "utils/metrics.py": "utils/metrics.py",
}

__all__ = ["Intrinsics", "KDEConfig", "enhance", "fold", "frame_error", "init_buffer", "tf32"]


def enhance(depths: torch.Tensor, color: torch.Tensor, intr: Intrinsics,
            cfg: KDEConfig) -> torch.Tensor:
    """kde_pipeline's enhanced points [B, H, W, 3] (mm) of depths
    [B, H, W] f32 mm and color [B, H, W, 3] u8."""
    return kde_pipeline(depths, color, intr, cfg).optimized_points


def init_buffer(h: int, w: int, device) -> buffer2d.DepthBuffer:
    return buffer2d.init(h, w, device)


def fold(buf: buffer2d.DepthBuffer, depth: torch.Tensor) -> buffer2d.DepthBuffer:
    """One frame [H, W] through the temporal buffer (buffer2d.update)."""
    return buffer2d.update(buf, depth)


def frame_error(points: torch.Tensor, buf: buffer2d.DepthBuffer,
                intr: Intrinsics) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean 3-D error, count) of one frame's points [H, W, 3] against the
    buffer's point map, as run_stream's chunk step forms it."""
    return metrics.mean_3d_error(points, projective_to_real(buf.depth, intr))


@contextlib.contextmanager
def tf32() -> Iterator[None]:
    """The control: every product of the reference in TF32, the precision
    below the configuration's f32 (the port runs them with TF32 off)."""
    prev = (tables.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tables.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (tables.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
