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
           Kinect v1 sensor model
ops/       stencils, JBF, CM normals, tables, NASP (cell, capped and global
           routes), CCL normal and plane merges, plane stage and hole fill,
           and the kernel wrappers cuda_{bilateral,dt,cov,gradient,nasp}.py
models/    kde_pipeline, jbf_pipeline
utils/     call timing (CUDA events), device timing (profiler), golden and
           far-range gates, depth metrics
convert.py carries the JAX package's config and intrinsics across
"""
