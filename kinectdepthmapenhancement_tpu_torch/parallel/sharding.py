"""The KDE step over a ('data', 'x') mesh of processes, and the dryrun.

PyTorch counterpart of the JAX package's parallel/sharding.py.  Frames are
data-parallel over 'data'; the image width is tiled over 'x'.  The JAX
package gets its spatial partition from GSPMD with the Pallas kernels off;
PyTorch has no such partitioner, so the two regimes are written out:

  * 'x' == 1, data parallel: each rank runs the whole kde_pipeline on its
    own frames (no collective), every kernel of the path on each rank;
  * 'x' > 1, spatial: each rank holds a width tile of its data row's
    frames; the JBF runs on the haloed tile (stencil_shard.jbf_sharded,
    the csrc/jbf.cu kernel), the filtered depth and the colour tiles are
    all-gathered over the 'x' group, the stages after the JBF
    (pipelines._kde_from_jbf) run on the whole frames, replicated within
    the group, and each rank keeps its own width slice of the output.

Either way the output is bitwise equal to kde_pipeline on the same frames.
`dryrun(n)` is the counterpart of the JAX dryrun and of
__graft_entry__.dryrun_multichip: n spawned ranks run one step on 96x128
frames and rank 0 holds it against an unsharded kde_pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics, default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.models.pipelines import _kde_from_jbf, kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import cuda_bilateral
from kinectdepthmapenhancement_tpu_torch.parallel import halo, multihost
from kinectdepthmapenhancement_tpu_torch.parallel.mesh import Mesh, make_mesh, wire
from kinectdepthmapenhancement_tpu_torch.parallel.stencil_shard import jbf_sharded


def disable_pallas(cfg: KDEConfig) -> KDEConfig:
    """cfg with every kernel route set to its plain ("xla") twin, as the JAX
    package's disable_pallas: GSPMD cannot partition a pallas_call, so its
    spatially sharded step must never reach one.  The port's spatial route
    does not call it: its kernels run on each rank's own tiles and whole
    frames, so no partitioner ever meets them."""
    return dataclasses.replace(
        cfg,
        normals=dataclasses.replace(cfg.normals, cov_impl="xla", dt_impl="xla"),
        nasp=dataclasses.replace(cfg.nasp, grad_impl="xla", stats_impl="xla"),
    )


def sharded_kde_step(mesh: Mesh, intr: Intrinsics, cfg: KDEConfig):
    """Returns the batched KDE step on this rank's local blocks: depth f32
    [b, H, ws] and color u8 [b, H, ws, 3] on mesh.device -> optimized points
    f32 [b, H, ws, 3], where b is this data row's frames and ws = W / x its
    width tile (the whole width at x == 1).  The layout of the JAX step's
    P("data", None, "x", None) output.  Every rank of the mesh calls it."""

    def check(depth_b, color_b):
        for t in (depth_b, color_b):
            if t.device != mesh.device:
                raise ValueError(f"a block on {t.device}; this rank's device is {mesh.device}")

    if mesh.x == 1:
        def local_step(depth_b, color_b):
            check(depth_b, color_b)
            return kde_pipeline(depth_b, color_b, intr, cfg).optimized_points

        return local_step

    def spatial_step(depth_t, color_t):
        check(depth_t, color_t)
        jbf_t = jbf_sharded(depth_t, color_t, mesh, cfg.jbf)
        result = _kde_from_jbf(halo.gather_width(jbf_t, mesh), halo.gather_width(color_t, mesh),
                               intr, cfg)
        return mesh.width_tile(result.optimized_points).contiguous()

    return spatial_step


def gather_global(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch [data * b, H, W, ...] on every rank from each rank's
    output block [b, H, ws, ...] (dist.all_gather over the world; rank
    d * x + s holds rows d's frames, tile s)."""
    if mesh.world_size == 1:
        return local
    mine = wire(local.contiguous(), None)
    parts = [torch.empty_like(mine) for _ in range(mesh.world_size)]
    dist.all_gather(parts, mine)
    rows = [torch.cat(parts[d * mesh.x:(d + 1) * mesh.x], dim=2) for d in range(mesh.data)]
    return torch.cat(rows, dim=0).to(local.device)


def _dryrun_rank(device) -> dict:
    """One rank of dryrun(): the JAX dryrun's mesh and inputs (one random
    96x128 frame per data row, grid 3x4), one step, parity on rank 0."""
    n = dist.get_world_size()
    spatial = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n, spatial=spatial, device=device)
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    rng = np.random.default_rng(0)
    batch = mesh.data
    depth = rng.uniform(500.0, 4000.0, size=(batch, h, w)).astype(np.float32)
    color = rng.integers(0, 255, size=(batch, h, w, 3), dtype=np.uint8)

    d_local = multihost.local_batch_to_global(mesh, [depth[mesh.d]])
    c_local = multihost.local_batch_to_global(mesh, [color[mesh.d]], extra_dims=1)
    step = sharded_kde_step(mesh, intr, cfg)
    before = cuda_bilateral.launches
    out = step(mesh.width_tile(d_local.local), mesh.width_tile(c_local.local))
    launches = cuda_bilateral.launches - before
    full = gather_global(out, mesh)
    if tuple(full.shape) != (batch, h, w, 3):
        raise RuntimeError(f"dryrun: output {tuple(full.shape)}, want {(batch, h, w, 3)}")
    line = None
    if mesh.rank == 0:
        want = kde_pipeline(torch.from_numpy(depth).to(mesh.device),
                            torch.from_numpy(color).to(mesh.device), intr, cfg).optimized_points
        if not torch.equal(full, want):
            bad = int((full != want).any(-1).sum())
            raise RuntimeError(f"dryrun: the sharded step differs from kde_pipeline on {bad} "
                               "pixels")
        line = (f"dryrun_multichip ok: mesh={mesh.shape} out={tuple(full.shape)} "
                f"backend={dist.get_backend()} device={mesh.device} parity=ok (bitwise)")
    return {"line": line, "jbf_launches": launches}


def dryrun(n_devices: int, device=None, backend: Optional[str] = None,
           store_dir: Optional[str] = None) -> dict:
    """One sharded KDE step on `n_devices` spawned ranks (multihost.spawn)
    on tiny shapes, held bitwise against an unsharded kde_pipeline on rank
    0; prints rank 0's "dryrun_multichip ok: ... parity=ok" line and
    returns it with each rank's JBF launches.  The ranks run on the card by
    default (NCCL, one card a rank: more ranks than cards raise, no silent
    pass); backend="gloo" lets ranks share a card (rank r on card r modulo
    the count), device="cpu" runs them on the CPU under gloo."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun on the card: no CUDA device is available")
        count = torch.cuda.device_count()
        if (backend or "nccl") == "nccl" and n_devices > count:
            raise RuntimeError(f"need {n_devices} devices, have {count} on backend nccl")
    ranks = multihost.spawn(_dryrun_rank, n_devices, args=(str(dev),), device=str(dev),
                            backend=backend, store_dir=store_dir)
    print(ranks[0]["line"])
    return {"line": ranks[0]["line"], "jbf_launches": [r["jbf_launches"] for r in ranks]}
