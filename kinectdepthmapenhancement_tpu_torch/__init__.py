"""kinectdepthmapenhancement_tpu_torch — the PyTorch / CUDA port.

A second package beside kinectdepthmapenhancement_tpu (the JAX reference):
the same functions under the same names, on tensors with a leading batch
dimension.  Plain tensor code is PyTorch; each TPU Pallas kernel of the
ported path is a hand-written CUDA kernel for Hopper (csrc/, built at
first use by _build.py), wrapped in ops/cuda_*.py beside its plain PyTorch
version.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

Layout
------
core/      config dataclasses, camera model, procedural test scenes, the
           Kinect v1 sensor model and the TUM / paired-PNG dataset loaders,
           depth-to-colour registration, the temporal depth buffer
           (buffer2d), FileStorage XML and image IO, the entry points'
           device
ops/       stencils, JBF and MRF, integral images, CM / SDC / bilateral
           normals, tables, SLIC (NASP, SP, DASP; cell, capped and global
           routes), ERS, CCL normal, plane and PCA merges, plane stage,
           PCA planes, MRF sweeps and hole fill, and the kernel wrappers
           cuda_{bilateral,dt,cov,gradient,nasp}.py
models/    pipelines (kde, jbf, mrf, rgbf, spdsp, tof), streaming (run_stream)
utils/     the evaluation harness (evaluate.py: every method timed and
           scored on one frame or a TUM sequence), pipeline timing, call
           timing (CUDA events), device timing (profiler), golden and
           far-range gates, depth metrics, checkpoints, debug renders and
           the comparison montage, kernel variants
native/    the C++ frame source (framesource.cpp: FileStorage XML and raw
           depth frames read round robin on a background thread), built
           with g++ at first use under build/native/ and bound with ctypes
parallel/  multi-process execution on torch.distributed: the ('data', 'x')
           mesh, initialisation from torch's env names, halo exchange, the
           JBF on width tiles, the sharded KDE step and its dryrun
cli.py     `python -m kinectdepthmapenhancement_tpu_torch enhance|evaluate ...`
convert.py carries the JAX package's config, intrinsics and streaming
           state across

The camera and config names (as the JAX package's __init__ does) and the
pipelines and their result types (the JAX package's models/__init__.py)
are re-exported here.  Importing the package builds no kernel and
initialises no CUDA context.
"""

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    normalized_rays,
    projective_to_real,
    real_to_projective,
)
from kinectdepthmapenhancement_tpu_torch.core.config import (
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    SLICParams,
    PipelineConfig,
)

from kinectdepthmapenhancement_tpu_torch.models import (
    KDEResult,
    RGBFResult,
    SPDSPResult,
    TOFResult,
    jbf_pipeline,
    kde_pipeline,
    mrf_pipeline,
    rgbf_pipeline,
    spdsp_pipeline,
    tof_pipeline,
)

__version__ = "0.1.0"

__all__ = [
    "Intrinsics", "default_kinect_intrinsics", "normalized_rays", "projective_to_real",
    "real_to_projective",
    "KDEConfig", "RGBFConfig", "SPDSPConfig", "SLICParams", "PipelineConfig",
    "KDEResult", "RGBFResult", "SPDSPResult", "TOFResult",
    "jbf_pipeline", "kde_pipeline", "mrf_pipeline", "rgbf_pipeline",
    "spdsp_pipeline", "tof_pipeline",
]
