"""The joint bilateral filter on width tiles, under explicit halo exchange.

PyTorch counterpart of the JAX package's parallel/stencil_shard.py (the
semantics of JointBilateralFilter.cu:4-83, identical to
ops.bilateral.joint_bilateral_filter):

  * colour halo = guide radius + filter radius, with a reflect-101 fixup at
    the GLOBAL image edges (the guide pre-smoothing's border mode,
    ops.bilateral.guide_bilateral);
  * depth halo = filter radius, zeros at the global edges (the JBF's pad2d
    convention: out-of-image taps are invalid anyway, z = 0 <= 50 mm);
  * the guide is computed on the haloed colour tile, so its values are
    exact wherever they can reach an output pixel of the tile;
  * the filter itself is the csrc/jbf.cu kernel (ops/cuda_bilateral.py) on
    the padded tile, and its plain version on a CPU tensor.

The output is bitwise equal to the unsharded bilateral.joint_bilateral_filter
(tests/test_torch_parallel.py on the CPU, chip_smoke.py phase 11 on the
card).
"""

from __future__ import annotations

import torch

from kinectdepthmapenhancement_tpu_torch.core.config import JBFParams
from kinectdepthmapenhancement_tpu_torch.ops import bilateral
from kinectdepthmapenhancement_tpu_torch.parallel import halo
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import Mesh

IMPLS = ("xla", "pallas")


def jbf_sharded(
    depth: torch.Tensor,
    color: torch.Tensor,
    mesh: Mesh,
    p: JBFParams = JBFParams(),
    *,
    axis: str = "x",
    impl: str = "xla",
) -> torch.Tensor:
    """Joint bilateral filter of this rank's width tile: depth f32 [B, H, ws]
    mm and color u8 [B, H, ws, 3], the 'x' coordinate s's columns of its
    data row's frames (mesh.width_tile) -> the filtered tile [B, H, ws].
    Every rank of the 'x' group calls it.  `impl` is taken for the JAX
    signature and not read (the kernel runs on every CUDA tile, as the
    port's grad_impl / cov_impl / dt_impl are not read); values other than
    the JAX package's raise, as does an axis other than "x"."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if axis != "x":
        raise ValueError(f"the width is tiled over mesh axis 'x', got {axis!r}")
    rg = p.guide_diameter // 2
    rj = p.window // 2
    ws = depth.shape[2]

    cpad = halo.exchange_width(color, rg + rj, mesh)
    cpad = halo.reflect101_at_global_edges(cpad, rg + rj, mesh)
    # guide values for columns [-rj, ws + rj) of this tile; the outer rg
    # columns of the smoothed block depend on guide_bilateral's own reflect
    # pad of the BLOCK and are dropped
    guide = bilateral.guide_bilateral(cpad, p).to(torch.float32)
    guide = guide[:, :, rg:rg + ws + 2 * rj].contiguous()

    dpad = halo.exchange_width(depth, rj, mesh).contiguous()  # zeros at global edges
    out = bilateral._jbf_core(
        dpad, guide, window=p.window, spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma, depth_sigma=p.depth_sigma,
    )
    return out[:, :, rj:rj + ws].contiguous()
