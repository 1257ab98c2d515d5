"""PyTorch port: depth-to-colour registration (core/registration.py) against
the JAX package's, on the five cases of tests/test_registration.py:15-95
and a 96x128 frame of random depth with many z-buffer collisions.

The JAX function runs eagerly (no jax.jit), so XLA fuses none of its
operations but the matmul; the port's rigid transform is three rounded
multiply-adds a component.  Bars, and why:
  * which colour pixels receive depth, EQUAL, except at counted half-pixel
    ties: pixels that a source point whose JAX coordinate lies within
    golden.TIE_PX of .5 can reach (each such point is printed with its distance
    from .5, each differing pixel counted; none may differ in the five
    cases, a handful at 96x128);
  * the z map EQUAL where R is the identity or a pure translation, where
    every product is exact; with a rotation, within 1 ulp: XLA's CPU dot
    sums the x and y components of p @ R.T in order but the z component
    as a chain of fused multiply-adds (measured on 5000 points: every x
    and y equal to the sequential sum, every z to the FMA chain), which the
    port does not reproduce on purpose (the card and the CPU must agree);
  * each case also against tests/test_registration.py's own bar (the
    NumPy replay, rtol 1e-5, or the exact values it names).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core import registration as jreg
from kinectdepthmapenhancement_tpu.core.camera import Intrinsics as JIntrinsics
from kinectdepthmapenhancement_tpu_torch.core.camera import Intrinsics
from kinectdepthmapenhancement_tpu_torch.core.registration import (
    Extrinsics,
    intrinsics_from_zpd_zpps,
    register_depth_to_color,
)
from kinectdepthmapenhancement_tpu_torch.utils import golden


def _jax_coordinates(depth, intr_d, intr_c, rot, t):
    """The JAX function's projected coordinates (uc, vc) of every source
    point and whether it splats, by its own eager operations
    (core/registration.py:77-92)."""
    h, w = depth.shape
    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = jnp.asarray(depth)
    x = (u - intr_d.cx) / intr_d.fx * z
    y = (intr_d.cy - v) / intr_d.fy * z
    pc = jnp.stack([x, y, z], axis=-1).reshape(-1, 3) @ jnp.asarray(rot).T + jnp.asarray(t)
    valid = (z.reshape(-1) > 0.0) & (pc[:, 2] > 1.0)
    safe_z = jnp.where(valid, pc[:, 2], 1.0)
    uc = np.asarray(pc[:, 0] / safe_z * intr_c.fx + intr_c.cx)
    vc = np.asarray(intr_c.cy - pc[:, 1] / safe_z * intr_c.fy)
    return uc, vc, np.asarray(valid)


def _compare(depth, intr_d, intr_c, rot, t, exact_z):
    """Run both packages and hold the port to the JAX output as the module
    docstring says; returns (port output, pixels that differ at ties)."""
    h, w = depth.shape
    extr = Extrinsics(torch.from_numpy(rot), torch.from_numpy(t))
    got = register_depth_to_color(torch.from_numpy(depth), intr_d, intr_c, extr).numpy()
    np.testing.assert_array_equal(
        register_depth_to_color(torch.from_numpy(depth), intr_d, intr_c, extr).numpy(), got)
    want = np.asarray(jreg.register_depth_to_color(
        jnp.asarray(depth), JIntrinsics(*intr_d), JIntrinsics(*intr_c),
        jreg.Extrinsics(jnp.asarray(rot), jnp.asarray(t))))
    assert got.dtype == np.float32 and got.shape == want.shape
    # the pixels a near-tie source point can land on, either way it rounds
    uc, vc, valid = _jax_coordinates(depth, intr_d, intr_c, rot, t)
    touched = golden.tie_pixels(uc[valid], vc[valid], h, w)
    du, dv = np.abs(np.abs(uc % 1.0) - 0.5), np.abs(np.abs(vc % 1.0) - 0.5)
    near = valid & ((du < golden.TIE_PX) | (dv < golden.TIE_PX))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    differ = ((got > 0) != (want > 0)) | (ulp > (0 if exact_z else 1))
    assert not (differ & ~touched).any(), np.argwhere(differ & ~touched)[:5]
    for vi, ui in np.argwhere(differ):
        print(f"half-pixel tie at colour pixel ({vi}, {ui}): port z {got[vi, ui]}, "
              f"JAX z {want[vi, ui]}")
    for i in np.nonzero(near)[0]:
        print(f"near-tie source pixel {divmod(int(i), w)}: JAX coordinate ({uc[i]:.7f}, "
              f"{vc[i]:.7f}), distance from .5 ({du[i]:.3g}, {dv[i]:.3g})")
    if not exact_z:
        print(f"z: {int((ulp > 0).sum())} of {h * w} pixels 1 ulp apart")
    return got, int(differ.sum())


def test_intrinsics_from_zpd_zpps():
    intr = intrinsics_from_zpd_zpps(120.0, 0.1041943679, 640, 480)
    assert tuple(intr) == tuple(jreg.intrinsics_from_zpd_zpps(120.0, 0.1041943679, 640, 480))
    assert abs(intr.fx - 575.8) < 0.1 and intr.fx == intr.fy
    assert intr.cx == 320.0 and intr.cy == 240.0


def test_identity_registration_roundtrip():
    intr = Intrinsics(100.0, 100.0, 32.0, 24.0)
    rng = np.random.default_rng(0)
    depth = rng.uniform(500.0, 3000.0, (48, 64)).astype(np.float32)
    depth[10:14, 20:26] = 0.0
    eye = Extrinsics.identity()
    assert eye.rotation.dtype == torch.float32 and eye.translation.shape == (3,)
    got, ties = _compare(depth, intr, intr, eye.rotation.numpy(), eye.translation.numpy(), True)
    assert ties == 0
    np.testing.assert_allclose(got, depth, rtol=1e-6)


def test_baseline_shift_of_frontoparallel_plane():
    intr = Intrinsics(100.0, 100.0, 32.0, 24.0)
    z, tx = 2000.0, -400.0
    depth = np.full((48, 64), z, np.float32)
    got, ties = _compare(depth, intr, intr, np.eye(3, dtype=np.float32),
                         np.array([tx, 0.0, 0.0], np.float32), True)
    assert ties == 0
    disparity = int(round(100.0 * tx / z))
    filled = got > 0
    assert filled[:, : 64 + disparity].all() and not filled[:, 64 + disparity:].any()
    np.testing.assert_allclose(got[filled], z, rtol=1e-6)


def test_zbuffer_near_surface_wins():
    intr = Intrinsics(100.0, 100.0, 2.0, 2.0)
    depth = np.zeros((4, 4), np.float32)
    depth[1, 1], depth[1, 2] = 1000.0, 500.0
    got, ties = _compare(depth, intr, intr, np.eye(3, dtype=np.float32),
                         np.array([-5.0, 0.0, 0.0], np.float32), True)
    assert ties == 0 and got[1, 1] == 500.0


def test_rotation_preserves_point_cloud():
    intr_d, intr_c = Intrinsics(120.0, 120.0, 32.0, 24.0), Intrinsics(110.0, 110.0, 30.0, 22.0)
    rot, t = golden.rotation_y(3.0), np.array([25.0, -10.0, 5.0], np.float32)
    depth = np.random.default_rng(3).uniform(800.0, 4000.0, (48, 64)).astype(np.float32)
    got, ties = _compare(depth, intr_d, intr_c, rot, t, False)
    assert ties == 0
    # tests/test_registration.py:60-95's NumPy replay
    h, w = depth.shape
    best = np.full((h, w), np.inf)
    for v in range(h):
        for u in range(w):
            z = depth[v, u]
            pc = rot @ np.array([(u - intr_d.cx) / intr_d.fx * z,
                                 (intr_d.cy - v) / intr_d.fy * z, z]) + t
            if pc[2] <= 1.0:
                continue
            uc = int(round(pc[0] / pc[2] * intr_c.fx + intr_c.cx))
            vc = int(round(intr_c.cy - pc[1] / pc[2] * intr_c.fy))
            if 0 <= uc < w and 0 <= vc < h:
                best[vc, uc] = min(best[vc, uc], pc[2])
    np.testing.assert_allclose(got, np.where(np.isfinite(best), best, 0.0), rtol=1e-5, atol=1e-2)


def test_collisions_at_96x128_and_out_shape():
    """Random depth through a 2 degree rotation and a 25 mm baseline: many
    splats collide; half-pixel ties are counted, not hidden (at most a
    handful of the 12288 pixels); an out_shape crops the colour grid."""
    intr = Intrinsics(115.0, 115.0, 64.0, 48.0)
    rot, t = golden.rotation_y(2.0), np.array([25.0, 0.0, 0.0], np.float32)
    depth = np.random.default_rng(7).uniform(500.0, 5000.0, (96, 128)).astype(np.float32)
    depth[np.random.default_rng(8).random(depth.shape) < 0.1] = 0.0
    got, ties = _compare(depth, intr, intr, rot, t, False)
    print(f"96x128: {ties} colour pixels differ at half-pixel ties")
    assert ties <= 8
    crop = register_depth_to_color(torch.from_numpy(depth), intr, intr,
                                   Extrinsics(torch.from_numpy(rot), torch.from_numpy(t)),
                                   out_shape=(64, 100)).numpy()
    want = np.asarray(jreg.register_depth_to_color(
        jnp.asarray(depth), JIntrinsics(*intr), JIntrinsics(*intr),
        jreg.Extrinsics(jnp.asarray(rot), jnp.asarray(t)), out_shape=(64, 100)))
    assert crop.shape == (64, 100)
    np.testing.assert_array_equal(crop > 0, want > 0)


def test_640x480_against_jax_fixture():
    """chip_smoke.py phase 10 (d)'s frame on the CPU: make_noisy_scene(480,
    640, seed=0)'s noisy depth through a 2 degree rotation and a 25 mm
    baseline, against the JAX output committed by tests/gen_torch_fixtures.py
    registration (golden.registration_gates: filled pixels equal and z
    within 1 ulp off the half-pixel ties, which are counted)."""
    from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene

    intr = default_kinect_intrinsics(640, 480)
    _, noisy, _ = make_noisy_scene(480, 640, intr, seed=0)
    rot, t = golden.registration_extrinsics()
    got = register_depth_to_color(torch.from_numpy(noisy), intr, intr,
                                  Extrinsics(torch.from_numpy(rot), torch.from_numpy(t))).numpy()
    gates = golden.registration_gates(got, golden.load_jax_registration())
    print(gates)
    assert not golden.failures(gates)
    assert gates["filled_differ_at_ties"][0] <= 8
