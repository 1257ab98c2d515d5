"""Multi-process execution: process-group initialisation, the global mesh,
data-parallel batches, and a launcher of one process per rank.

PyTorch counterpart of the JAX package's parallel/multihost.py.  Frames are
embarrassingly parallel, so the batch spans processes: each rank feeds its
own frames, and collectives materialise only for reductions such as
global_mean.  initialize() reads torch's own environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, as torchrun
sets them) where the JAX package reads JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID.  Everything degrades to a single
process.  spawn() starts one process per rank on this host, with a file://
store, a timeout on the process group and a deadline on the whole run:
the dryrun, the tests and chip_smoke.py run their ranks through it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_device, wire

DEFAULT_TIMEOUT_S = 120.0


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """torch.distributed.init_process_group from the arguments or torch's
    env names (init_method defaults to tcp://MASTER_ADDR:MASTER_PORT).
    Returns True if a process group was initialised, False for the
    single-process case: no address, no world size, or a world size of 1
    read from the environment (an explicit world_size=1 initialises).

    backend defaults to "nccl" when this rank's device (rank_device(device):
    the card of its local rank by default) is CUDA, and "gloo" on the CPU.
    NCCL takes one card per rank: a host with more local ranks
    (LOCAL_WORLD_SIZE, else the world size) than cards raises here, before
    any rank can hang; gloo ranks may share a card."""
    env = os.environ
    explicit_size = world_size is not None
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if not init_method or world_size is None or (world_size == 1 and not explicit_size):
        return False
    if rank is None:
        raise ValueError("a multi-process world needs this process's rank (RANK)")
    if backend is None:
        backend = "nccl" if torch.device("cuda" if device is None else device).type == "cuda" \
            else "gloo"
    if backend == "nccl":
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {local_world} ranks on this host, {cards} "
                "card(s); run fewer ranks, or backend='gloo' to share a card")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def global_mesh(spatial: int = 1, device=None) -> Mesh:
    """('data', 'x') mesh over every rank of the job."""
    return make_mesh(dist.get_world_size() if dist.is_initialized() else 1,
                     spatial=spatial, device=device)


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This rank's frames of a batch sharded over 'data': `local` [b, H, W,
    ...] on the rank's device, frames [offset, offset + b) of `size`."""

    local: torch.Tensor
    size: int
    offset: int
    mesh: Mesh

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of x over the whole batch (f64 0-dim, on the rank's device):
        this rank's sum and count all-reduced over its 'data' group.  x is
        a function of this rank's frames; the ranks of one 'x' group hold
        the same frames, so they are counted once."""
        acc = torch.stack([x.to(torch.float64).sum(),
                           torch.tensor(float(x.numel()), dtype=torch.float64,
                                        device=x.device)])
        if self.mesh.data > 1:
            staged = wire(acc, self.mesh.data_group)
            dist.all_reduce(staged, group=self.mesh.data_group)
            acc = staged.to(x.device)
        return acc[0] / acc[1]


def local_batch_to_global(mesh: Mesh, arrays: Sequence, extra_dims: int = 0) -> GlobalBatch:
    """This rank's frames (numpy arrays or tensors, each [H, W] plus
    `extra_dims` trailing axes) stacked onto its device, with the global
    batch size and this rank's offset in it: the torch form of a globally
    data-sharded array.  The global batch is the 'data' rows' frames in
    row order (the counts are all-gathered over the 'data' group); the
    ranks of one 'x' group pass the same frames.  Single-process: the
    frames on the mesh's device."""
    frames = [torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a for a in arrays]
    for f in frames:
        if f.dim() != 2 + extra_dims:
            raise ValueError(f"a frame of shape {tuple(f.shape)} is not [H, W] plus "
                             f"{extra_dims} trailing axes")
    local = torch.stack(frames).to(mesh.device)
    counts = [local.shape[0]]
    if mesh.data > 1:
        mine = wire(torch.tensor([local.shape[0]], dtype=torch.int64, device=mesh.device),
                    mesh.data_group)
        parts = [torch.empty_like(mine) for _ in range(mesh.data)]
        dist.all_gather(parts, mine, group=mesh.data_group)
        counts = [int(p) for p in parts]
    return GlobalBatch(local=local, size=sum(counts), offset=sum(counts[:mesh.d]), mesh=mesh)


def _spawned_rank(rank, world_size, init_method, device, backend, timeout_s, fn, args, out):
    """One rank of spawn(): initialise, run fn(*args), report to `out`."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        initialize(init_method, world_size, rank, backend=backend, device=device,
                   timeout_s=timeout_s)
        try:
            # by value: torch's queue pickler would share tensor storage
            # through this process, which exits before the parent reads it
            out.put((rank, True, pickle.dumps(fn(*args))))
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: its traceback goes to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn(
    fn: Callable,
    world_size: int,
    args: tuple = (),
    *,
    device=None,
    backend: Optional[str] = None,
    store_dir: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> List:
    """Run fn(*args) in `world_size` fresh processes (the spawn start
    method), one per rank, each with torch.distributed initialised
    (initialize(), on `device` and `backend`) over a file:// store in
    `store_dir` (a new temporary directory by default); returns each
    rank's result in rank order.  fn must be a module-level function and
    its result picklable (CPU tensors, numpy arrays).  A rank that raises
    fails the run with its traceback; every rank still running when
    `timeout_s` has passed is killed and the run fails."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        out = ctx.Queue()
        procs = [ctx.Process(target=_spawned_rank, args=(
            r, world_size, init_method, device, backend, timeout_s, fn, args, out))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        results, errors = {}, {}
        stop = deadline  # after the first failure: a moment for the others' reports
        try:
            # drain the queue before joining (a writer blocks on a full pipe)
            while len(results) + len(errors) < world_size and time.monotonic() < stop:
                try:
                    rank, ok, value = out.get(timeout=min(max(stop - time.monotonic(), 0.0), 0.5))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):  # died without a report (a crash)
                        if p.exitcode not in (None, 0) and r not in results and r not in errors:
                            errors[r] = f"exited with code {p.exitcode} before reporting"
                            stop = min(stop, time.monotonic() + 5.0)
                    continue
                if ok:
                    results[rank] = pickle.loads(value)  # written by our own rank
                else:
                    errors[rank] = value
                    stop = min(stop, time.monotonic() + 5.0)
        finally:
            # ranks that reported exit on their own; the rest are killed (the
            # others may wait on a failed rank in a collective)
            done = len(results) == world_size
            end = time.monotonic() + (30.0 if done else 2.0)
            for p in procs:
                p.join(timeout=max(end - time.monotonic(), 0.0))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            out.close()
    if errors:
        raise RuntimeError("spawn: a rank failed\n" + "\n".join(
            f"rank {r}:\n{errors[r]}" for r in sorted(errors)))
    if len(results) < world_size:
        missing = sorted(set(range(world_size)) - set(results))
        raise RuntimeError(f"spawn: rank(s) {missing} did not report within {timeout_s:g} s")
    return [results[r] for r in range(world_size)]
