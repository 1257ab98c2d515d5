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
           Kinect v1 sensor model, the temporal depth buffer (buffer2d),
           FileStorage XML and image IO, the entry points' device
ops/       stencils, JBF and MRF, integral images, CM / SDC / bilateral
           normals, tables, SLIC (NASP, SP, DASP; cell, capped and global
           routes), ERS, CCL normal, plane and PCA merges, plane stage,
           PCA planes, MRF sweeps and hole fill, and the kernel wrappers
           cuda_{bilateral,dt,cov,gradient,nasp}.py
models/    pipelines (kde, jbf, mrf, rgbf, spdsp, tof), streaming (run_stream)
utils/     call timing (CUDA events), device timing (profiler), golden and
           far-range gates, depth metrics, checkpoints, debug renders,
           kernel variants
cli.py     `python -m kinectdepthmapenhancement_tpu_torch enhance ...`
convert.py carries the JAX package's config, intrinsics and streaming
           state across
"""
