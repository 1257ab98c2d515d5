"""PyTorch port: the temporal depth buffer (core/buffer2d.py), checkpoints
(utils/checkpoint.py, convert.stream_state_from_jax) and the streaming
runner (models/streaming.py) on the CPU.

Tolerances, and why:
  * buffer2d.update / accumulate against the JAX package: weights EXACT,
    depths rtol 1e-6 (XLA on the CPU may contract the weighted average's
    a*b + c*d into an FMA, the port rounds each operation; measured: at
    most 4.9e-4 mm apart after five frames, relative 2e-7);
  * synthetic_noise: its statistics, not its bits (a torch.Generator
    against jax.random): every sample within +-variance of the truth, the
    mean of noise/variance within 0.02 of 0 and its standard deviation
    within 0.02 of 1/sqrt(3), as the JAX package's draws are;
  * checkpoints: EXACT round trips, across the two packages both ways;
  * run_stream at 96x128 (grid 3x4) on the CPU: each chunk's points EQUAL
    to kde_pipeline on the same [B, H, W] batch, and the final buffer and
    metrics EQUAL to a hand fold of buffer2d.update and
    metrics.mean_3d_error in frame order (the same operations);
  * a run stopped at max_frames and resumed from its checkpoint EQUAL to
    the uninterrupted run (the same chunks);
  * batch invariance: the bars of tests/test_streaming.py:70-88 (metric
    sums rtol 1e-5, buffer depth rtol 1e-6; measured: sums 2e-8 apart,
    the chunks sum in another order; buffers equal).
No JAX run_stream or kde_pipeline runs here (each is a minute of XLA
compile on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core import buffer2d as jbuf
from kinectdepthmapenhancement_tpu.utils import checkpoint as jckpt
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.core import buffer2d
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models import pipelines, streaming
from kinectdepthmapenhancement_tpu_torch.utils import checkpoint, metrics

torch.set_num_threads(2)

H, W = 96, 128
INTR = default_kinect_intrinsics(W, H)
CFG = dataclasses.replace(KDEConfig(), grid=GridParams(3, 4))


def _frames(gt, n, seed=0):
    """tests/test_streaming.py:13-17: the Kinect noise model, from a seed."""
    rng = np.random.default_rng(seed)
    var = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    for _ in range(n):
        yield (gt + rng.uniform(-1, 1, gt.shape) * var).astype(np.float32)


def _scene(seed):
    color, _, gt = make_noisy_scene(H, W, INTR, seed=seed)
    return color, gt


def _stack_frames(seed=0):
    """Five frames with holes and a disagreeing frame (a 5% depth jump on
    a band), so each branch of the update rule fires."""
    _, gt = _scene(1)
    frames = np.stack(list(_frames(gt, 5, seed)))
    rng = np.random.default_rng(seed)
    frames[rng.random(frames.shape) < 0.05] = 0.0
    frames[3, 10:30] *= 1.05
    return frames


def test_buffer_update_and_accumulate_match_jax():
    frames = _stack_frames()
    want = jbuf.accumulate(jbuf.init(H, W), jnp.asarray(frames))
    got = buffer2d.accumulate(buffer2d.init(H, W), torch.from_numpy(frames))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-6)
    assert got.weight.max() == 5.0 and (got.weight.numpy() == 3.0).any()  # a dropped sample
    one = buffer2d.update(buffer2d.init(H, W), torch.from_numpy(frames[0]))
    jone = jbuf.update(jbuf.init(H, W), jnp.asarray(frames[0]))
    np.testing.assert_array_equal(one.depth.numpy(), np.asarray(jone.depth))
    ins = buffer2d.insert(got, torch.from_numpy(frames[1]))
    assert torch.equal(ins.depth, torch.from_numpy(frames[1])) and bool((ins.weight == 1).all())


def test_synthetic_noise_statistics():
    _, gt = _scene(1)
    gt = np.where(gt > 0, gt, 1000.0).astype(np.float32)
    var = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    g = torch.Generator().manual_seed(0)
    got = buffer2d.synthetic_noise(torch.from_numpy(gt), g).numpy()
    want = np.asarray(jbuf.synthetic_noise(jax.random.PRNGKey(0), jnp.asarray(gt)))
    for noisy in (got, want):
        u = (noisy.astype(np.float64) - gt) / var
        assert np.abs(u).max() <= 1.0 + 1e-3
        assert abs(u.mean()) < 0.02 and abs(u.std() - 1 / np.sqrt(3)) < 0.02
    again = buffer2d.synthetic_noise(torch.from_numpy(gt), torch.Generator().manual_seed(0))
    assert np.array_equal(again.numpy(), got)


def _state(seed=3):
    rng = np.random.default_rng(seed)
    buf = buffer2d.DepthBuffer(
        depth=torch.from_numpy(rng.uniform(0, 4000, (6, 5)).astype(np.float32)),
        weight=torch.from_numpy(rng.integers(0, 9, (6, 5)).astype(np.float32)))
    return checkpoint.StreamState(frame_index=7, buffer=buf,
                                  metric_sums={"kde_error_mm": 1.5, "kde_checksum": 0.25},
                                  metric_counts={"kde_error_mm": 3, "kde_checksum": 2})


def _same_state(a, b):
    assert a.frame_index == b.frame_index
    assert a.metric_sums == b.metric_sums and a.metric_counts == b.metric_counts
    np.testing.assert_array_equal(np.asarray(a.buffer.depth), np.asarray(b.buffer.depth))
    np.testing.assert_array_equal(np.asarray(a.buffer.weight), np.asarray(b.buffer.weight))


def test_checkpoint_roundtrip_and_across_packages(tmp_path):
    st = _state()
    p = str(tmp_path / "port.npz")
    checkpoint.save(p, st)
    _same_state(checkpoint.load(p), st)
    assert checkpoint.load(str(tmp_path / "none.npz")) is None
    # the port's checkpoint resumes in the JAX package, and the other way round
    _same_state(jckpt.load(p), st)
    q = str(tmp_path / "jax.npz")
    jckpt.save(q, jckpt.StreamState(
        frame_index=7, buffer=jbuf.DepthBuffer(jnp.asarray(st.buffer.depth.numpy()),
                                               jnp.asarray(st.buffer.weight.numpy())),
        metric_sums=dict(st.metric_sums), metric_counts=dict(st.metric_counts)))
    _same_state(checkpoint.load(q), st)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)


def test_stream_state_from_jax():
    st = _state(4)
    jst = jckpt.StreamState(
        frame_index=st.frame_index,
        buffer=jbuf.DepthBuffer(jnp.asarray(st.buffer.depth.numpy()),
                                jnp.asarray(st.buffer.weight.numpy())),
        metric_sums=dict(st.metric_sums), metric_counts=dict(st.metric_counts))
    got = convert.stream_state_from_jax(jst, device="cpu")
    _same_state(got, st)
    assert got.buffer.depth.dtype == torch.float32
    with pytest.raises(TypeError):
        convert.stream_state_from_jax(st.buffer, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            convert.stream_state_from_jax(jst)


def _run(gt, color, n, **kw):
    seen = []
    kw.setdefault("on_outputs", lambda start, pts: seen.append((start, pts)))
    state = streaming.run_stream(_frames(gt, n), color, INTR, cfg=CFG, device="cpu", **kw)
    return state, seen


def test_run_stream_equals_hand_fold():
    color, gt = _scene(1)
    state, seen = _run(gt, color, 5, batch=2)
    frames = np.stack(list(_frames(gt, 5)))
    assert [s for s, _ in seen] == [0, 2, 4]
    buf = buffer2d.init(H, W)
    err_sum, n_sum = 0.0, 0
    for start, pts in seen:
        d = torch.from_numpy(frames[start:start + pts.shape[0]])
        c = torch.from_numpy(color)[None].expand(d.shape[0], -1, -1, -1).contiguous()
        want = pipelines.kde_pipeline(d, c, INTR, CFG).optimized_points
        assert torch.equal(pts, want)
        chunk_err = torch.zeros(())
        for i in range(d.shape[0]):
            buf = buffer2d.update(buf, d[i])
            err, n = metrics.mean_3d_error(want[i], projective_to_real(buf.depth, INTR))
            chunk_err = chunk_err + err * n.to(torch.float32)
            n_sum += int(n)
        err_sum += float(chunk_err)
    assert state.frame_index == 5
    assert torch.equal(state.buffer.depth, buf.depth) and torch.equal(state.buffer.weight, buf.weight)
    assert state.metric_sums["kde_error_mm"] == err_sum
    assert state.metric_counts["kde_error_mm"] == n_sum
    err = streaming.mean_metric(state, "kde_error_mm")
    assert np.isfinite(err) and err < 50.0


def test_run_stream_resumes_from_checkpoint(tmp_path):
    """tests/test_streaming.py:20-42 on the port, plus: stopped at
    max_frames and resumed, the run equals the uninterrupted one."""
    color, gt = _scene(1)
    ckpt = str(tmp_path / "stream.npz")
    first, _ = _run(gt, color, 6, batch=2, checkpoint_path=ckpt, checkpoint_every=2,
                    max_frames=2)
    assert first.frame_index == 2
    resumed, seen = _run(gt, color, 6, batch=2, checkpoint_path=ckpt, checkpoint_every=2)
    assert resumed.frame_index == 6 and [s for s, _ in seen] == [2, 4]
    whole, _ = _run(gt, color, 6, batch=2)
    _same_state(resumed, whole)
    assert float(resumed.buffer.weight.max()) >= 4.0


def test_stream_kde_only_serving():
    """tests/test_streaming.py:45-63 on the port."""
    color, gt = _scene(3)
    state, seen = _run(gt, color, 5, batch=2, kde_only=True)
    assert state.frame_index == 5
    assert state.metric_counts["kde_checksum"] == 5
    assert [(s, tuple(p.shape)) for s, p in seen] == [
        (0, (2, H, W, 3)), (2, (2, H, W, 3)), (4, (1, H, W, 3))]
    assert float(state.buffer.weight.max()) == 0.0


def test_stream_batch_size_invariant():
    color, gt = _scene(2)
    s1, _ = _run(gt, color, 5, batch=1)
    s3, _ = _run(gt, color, 5, batch=3)
    assert s1.frame_index == s3.frame_index == 5
    assert s1.metric_counts == s3.metric_counts
    np.testing.assert_allclose(s1.metric_sums["kde_error_mm"], s3.metric_sums["kde_error_mm"],
                               rtol=1e-5)
    np.testing.assert_allclose(s1.buffer.depth.numpy(), s3.buffer.depth.numpy(), rtol=1e-6)


def test_default_device_is_the_card():
    """device=None means "cuda": without a card it raises, never falls back."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            streaming.run_stream(iter([]), np.zeros((4, 4, 3), np.uint8), INTR)
    assert resolve_device("cpu") == torch.device("cpu")
