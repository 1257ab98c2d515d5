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
core/      config dataclasses, camera model, procedural test scene
ops/       stencils, JBF, CM normals, tables, NASP, CCL merge, plane stage,
           and the kernel wrappers cuda_{bilateral,dt,cov,gradient}.py
models/    kde_pipeline
utils/     CUDA-event timing
convert.py carries the JAX package's config and intrinsics across
"""
