"""PyTorch port: parallel/multihost.py, the counterparts of
tests/test_multihost.py: initialize() from torch's env names (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK) with the single-process fallback, the
arguments over the environment, NCCL refused with more local ranks than
cards, global_mesh and local_batch_to_global single-process, and a real
2-process gloo run (multihost.spawn) whose global_mean is 1.5; spawn's
failure paths (a rank that raises, a rank that hangs past the deadline).
Bars: exact (the counts and means are of small integers)."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kinectdepthmapenhancement_tpu_torch.parallel import multihost

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture
def fake_init(clean_env):
    calls = {}

    def fake(backend, init_method, world_size, rank, timeout):
        calls.update(backend=backend, init=init_method, n=world_size, rank=rank)

    clean_env.setattr(dist, "init_process_group", fake)
    return calls


def test_initialize_no_env_is_single_process(clean_env):
    """No address, no world size: the single-process case (exact)."""
    assert multihost.initialize() is False
    assert not dist.is_initialized()


def test_initialize_world_size_one_is_single_process(clean_env):
    """WORLD_SIZE=1 from the environment: the single-process case (exact)."""
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", "1234")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("RANK", "0")
    assert multihost.initialize() is False


def test_initialize_env_parsed_and_forwarded(fake_init, clean_env):
    """MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK reach
    init_process_group unchanged, gloo on the CPU (exact)."""
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_env.setenv("MASTER_PORT", "8476")
    clean_env.setenv("WORLD_SIZE", "4")
    clean_env.setenv("RANK", "2")
    assert multihost.initialize(device="cpu") is True
    assert fake_init == {"backend": "gloo", "init": "tcp://10.0.0.1:8476", "n": 4, "rank": 2}


def test_initialize_args_override_env(fake_init, clean_env):
    """Arguments win over the environment (exact)."""
    clean_env.setenv("MASTER_ADDR", "ignored")
    clean_env.setenv("MASTER_PORT", "1")
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("RANK", "7")
    assert multihost.initialize("tcp://10.1.1.1:9", 2, 1, device="cpu") is True
    assert fake_init == {"backend": "gloo", "init": "tcp://10.1.1.1:9", "n": 2, "rank": 1}
    # an explicit world size of 1 initialises (the env's does not)
    assert multihost.initialize("tcp://10.1.1.1:9", 1, 0, device="cpu") is True
    assert fake_init["n"] == 1


def test_initialize_nccl_with_more_local_ranks_than_cards_raises(fake_init):
    """Refused before init_process_group, so no rank hangs."""
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        multihost.initialize("tcp://127.0.0.1:1", torch.cuda.device_count() + 1, 0,
                             backend="nccl")
    assert fake_init == {}


def test_global_mesh_single_process():
    """Without a process group: a 1 x 1 mesh on the named device, no
    groups; spatial=2 does not divide the world of 1 and raises (exact)."""
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "x": 1}
    assert (mesh.world_size, mesh.x_group, mesh.data_group) == (1, None, None)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.global_mesh(spatial=2, device="cpu")


def test_local_batch_to_global_single_process():
    """This rank's frames stacked on its device, size 8 at offset 0, the
    frames unchanged and their mean 3.5; a frame with the wrong number of
    axes raises (exact)."""
    mesh = multihost.global_mesh(device="cpu")
    frames = [np.full((6, 8), float(i), np.float32) for i in range(8)]
    batch = multihost.local_batch_to_global(mesh, frames)
    assert (batch.size, batch.offset, tuple(batch.local.shape)) == (8, 0, (8, 6, 8))
    np.testing.assert_array_equal(batch.local.numpy(), np.stack(frames))
    assert float(batch.global_mean(batch.local)) == 3.5
    colors = [np.zeros((6, 8, 3), np.uint8)] * 2
    assert multihost.local_batch_to_global(mesh, colors, extra_dims=1).local.shape == (2, 6, 8, 3)
    with pytest.raises(ValueError, match="trailing axes"):
        multihost.local_batch_to_global(mesh, colors)


def _two_rank_worker():
    """Each rank contributes one frame of value rank + 1 (tests/
    multihost_worker.py) and reduces the global mean."""
    mesh = multihost.global_mesh(device="cpu")
    frame = np.full((8, 16), float(mesh.rank + 1), np.float32)
    batch = multihost.local_batch_to_global(mesh, [frame])
    return {"world": dist.get_world_size(), "shape": mesh.shape, "size": batch.size,
            "offset": batch.offset, "mean": float(batch.global_mean(batch.local))}


def test_two_process_gloo_run(tmp_path):
    """A real 2-process run: torch.distributed initialised on each rank,
    the global batch of 2 frames, the all-reduced mean 1.5 on both."""
    got = multihost.spawn(_two_rank_worker, 2, device="cpu", store_dir=str(tmp_path),
                          timeout_s=60)
    for rank, r in enumerate(got):
        assert r == {"world": 2, "shape": {"data": 2, "x": 1}, "size": 2, "offset": rank,
                     "mean": 1.5}


def _fail_on_rank_one():
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()  # waits on rank 1, which never comes


def _hang():
    time.sleep(600)


def test_spawn_reports_a_failing_rank_and_stops_the_rest(tmp_path):
    """A rank that raises fails the run with its traceback; the rank
    waiting on it in a barrier is stopped, well inside the deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        multihost.spawn(_fail_on_rank_one, 2, device="cpu", store_dir=str(tmp_path),
                        timeout_s=60)
    assert time.monotonic() - t0 < 45


def test_spawn_kills_ranks_past_the_deadline(tmp_path):
    """Ranks that never report are killed at the deadline (5 s) and the run
    fails."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not report"):
        multihost.spawn(_hang, 2, device="cpu", store_dir=str(tmp_path), timeout_s=5)
    assert time.monotonic() - t0 < 30
