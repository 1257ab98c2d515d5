"""PyTorch port: the plane stage where it acts (ROADMAP C2, and C3's SDC
reading on a frame where the stage moves pixels), on the CPU at 96x128.

kde_pipeline with plane_merge=True, and with plane_merge=True,
fill_holes=4, under normals.method "cm" and "sdc", on
make_banded_scene(96, 128, seed=0, hole_fraction=0.15) (grid 3x4), against
the JAX package's runs (tests/golden/kde_jax_planes_seed0.npz,
tests/gen_torch_fixtures.py planes).  On this far-range banded frame the
plane stage moves most pixels (the noisy test scene of the other tests
moves none).

Bars (golden.plane_stage_gates, which chip_smoke.py phase 10 (b) applies
at 640x480 on the card): the pixels the stage moved (output more than
golden.MOVED_MM = 0.01 mm from the depth bilateral of the JBF points
alone; below that the two are one computation rounded in another order)
counted within 1% and their masks equal on > 0.99 of pixels; the filled
holes equal on > 0.995; the merged partitions agree on > 0.995; the
optimized depth within 1 mm on > 0.99 of pixels, its 99.9% quantile
below 120 mm (kde_gates' bars), its RMSE to ground truth within 1%.  Measured tighter, and held here: under
cm the merged labels EQUAL and the optimized depth within 0.01 mm
everywhere (XLA's FMA contractions through the projection: at most
0.0034 mm); under SDC, whose normals are ill-conditioned in f32
summed-area tables summed in another order (ROADMAP Queue C, SDC), the
merged labels equal on > 0.999 of pixels and the depth within 1 mm on
> 0.999.
"""

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_banded_scene
from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu_torch.utils import golden

torch.set_num_threads(2)

H, W = 96, 128
INTR = default_kinect_intrinsics(W, H)
CONFIGS = golden.plane_configs(GridParams(rows=3, cols=4))


@pytest.mark.parametrize("name", golden.PLANE_RUNS)
def test_plane_stage_against_jax(name):
    color, sensor, gt = make_banded_scene(H, W, INTR, seed=0, hole_fraction=0.15)
    cfg = CONFIGS[name]
    res = kde_pipeline(torch.from_numpy(sensor), torch.from_numpy(color), INTR, cfg)
    got = golden.plane_stage_maps(res, sensor, INTR, cfg)
    want = golden.load_jax_planes("96x128", name)
    gates = golden.plane_stage_gates(got, want, gt)
    dz = np.abs(got["optimized_z"] - want["optimized_z"])
    labels = float((got["merged_labels"] == want["merged_labels"]).mean())
    print(f"{name}: moved {int(got['moved'].sum())} (JAX {int(want['moved'].sum())}), "
          f"labels equal on {labels:.6f}, max |dz| {float(dz.max()):.4g} mm; {gates}")
    assert not golden.failures(gates)
    assert int(want["moved"].sum()) > 0.5 * H * W  # the stage acts on this frame
    if name.startswith("cm"):
        assert labels == 1.0
        assert float(dz.max()) < 0.01
    else:
        assert labels > 0.999
        assert float((dz < 1.0).mean()) > 0.999


def test_depth_bilateral_flushes_subnormal_weights():
    """plane.depth_bilateral against the JAX op where a hole's only support
    has subnormal weights: valid depth 1.36-1.44 m beside z = 0 gives
    exp(-z^2 / (2 * 100^2)) below FLT_MIN, which XLA flushes to 0 (no
    support: the hole stays 0).  Found at 640x480 on the far-range frame,
    where the port had filled 222 hole pixels the JAX package
    leaves empty.  The empty pixels must be the JAX op's, the rest within
    rtol 2.5e-7 (2 ulps: XLA's FMA contractions)."""
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import normalized_rays as jrays
    from kinectdepthmapenhancement_tpu.core.config import ProjectionParams
    from kinectdepthmapenhancement_tpu.ops import plane as jplane
    from kinectdepthmapenhancement_tpu_torch.core.camera import normalized_rays
    from kinectdepthmapenhancement_tpu_torch.ops import plane

    h, w = 16, 20
    intr = default_kinect_intrinsics(w, h)
    rng = np.random.default_rng(0)
    z = rng.uniform(1360.0, 1440.0, (h, w)).astype(np.float32)
    z[6:12, 5:15] = 0.0
    z[0, 0] = 3000.0
    pts = (normalized_rays(intr, h, w) * torch.from_numpy(z)[..., None])[None]
    got = plane.depth_bilateral(pts, normalized_rays(intr, h, w))[0].numpy()
    want = np.asarray(jplane.depth_bilateral(jnp.asarray(pts[0].numpy()), jrays(intr, h, w),
                                             ProjectionParams()))
    np.testing.assert_array_equal(got[..., 2] == 0.0, want[..., 2] == 0.0)
    assert (got[8:10, 8:12, 2] == 0.0).all()  # inner holes: every weight subnormal or 0
    np.testing.assert_allclose(got, want, rtol=2.5e-7)
