"""PyTorch port: the composed KDE slice at 96x128 (grid 3x4) on the CPU,
against one JAX kde_pipeline run and against both committed golden oracle
fixtures (read-only), at the thresholds of tests/test_oracle_pipeline.py:
JBF rtol 2e-4 / atol 0.25 mm; normal flags > 99.5% and directions > 99.5%
(|n.n'| > 0.999); NASP labels > 99.5%; merged partition > 99.5%; optimized
points within 1 mm on > 99% of pixels with the 99.9th percentile < 120 mm.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models import pipelines as jpipe
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.models import pipelines as tpipe
from kinectdepthmapenhancement_tpu_torch.ops import (
    cuda_bilateral,
    cuda_cov,
    cuda_dt,
    cuda_gradient,
    cuda_nasp,
)
from kinectdepthmapenhancement_tpu_torch.utils import golden

torch.set_num_threads(2)


def _scene():
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    return intr, color, noisy, GridParams(rows=3, cols=4)


def _port(max_resid=0.0025):
    intr, color, noisy, grid = _scene()
    cfg = dataclasses.replace(KDEConfig(), grid=grid, max_plane_residual=max_resid)
    res = tpipe.kde_pipeline(
        torch.from_numpy(noisy), torch.from_numpy(color),
        convert.intrinsics_from_jax(intr), convert.config_from_jax(cfg),
    )
    return {f: getattr(res, f).numpy() for f in res._fields}


@pytest.fixture(scope="module")
def jax_kde():
    """One JAX kde_pipeline run, jitted exactly as test_oracle_pipeline.py
    does (the persistent compile cache is shared with it)."""
    intr, color, noisy, grid = _scene()
    cfg = dataclasses.replace(KDEConfig(), grid=grid)
    res = jax.jit(lambda d, c: jpipe.kde_pipeline(d, c, intr, cfg))(
        jnp.asarray(noisy), jnp.asarray(color)
    )
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def test_kde_matches_jax_pipeline(jax_kde):
    got = _port()
    want = dict(jax_kde, jbf=jax_kde["jbf_depth"])
    gates = golden.kde_gates(got, want)
    assert not golden.failures(gates), gates
    # with identical seeds downstream, the integer handoffs agree exactly
    # wherever the inputs do; the merged sizes are integer counts
    assert (got["nasp_labels"] == want["nasp_labels"]).mean() > 0.999
    np.testing.assert_allclose(got["jbf_depth"], want["jbf_depth"], rtol=0, atol=2e-3)


@pytest.mark.parametrize("refexact", [False, True], ids=["default", "refexact"])
def test_kde_golden_fixture_gates(refexact):
    got = _port(float("inf") if refexact else 0.0025)
    want = golden.load_fixture(refexact)
    gates = (golden.kde_refexact_gates if refexact else golden.kde_gates)(got, want)
    assert not golden.failures(gates), gates


def test_kde_batched_equals_per_frame():
    """kde_pipeline takes [B, H, W]: a batch of two frames gives exactly the
    per-frame results, and [H, W] input gives unbatched outputs."""
    intr, color, noisy, grid = _scene()
    cfg = convert.config_from_jax(dataclasses.replace(KDEConfig(), grid=grid))
    ti = convert.intrinsics_from_jax(intr)
    c = torch.from_numpy(color)
    d = torch.from_numpy(noisy)
    c2 = torch.stack([c, torch.flip(c, dims=[1])])
    d2 = torch.stack([d, torch.flip(d, dims=[1])])
    def launches():
        mods = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)
        return [m.launches for m in mods] + list(cuda_nasp.launches.values())

    before = launches()
    both = tpipe.kde_pipeline(d2, c2, ti, cfg)
    for i in range(2):
        one = tpipe.kde_pipeline(d2[i], c2[i], ti, cfg)
        assert one.optimized_points.shape == (96, 128, 3)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b)
    # on the CPU every stage takes the plain versions: no kernel launches
    assert before == launches()


def test_kde_unported_options_raise():
    """Every normal method of the JAX package runs (cm here; sdc and
    bilateral: tests/test_torch_normal_methods.py); a method neither
    package has raises ValueError, as the JAX package's generate_normal_map
    does."""
    intr, color, noisy, grid = _scene()
    ti = convert.intrinsics_from_jax(intr)
    cfg = dataclasses.replace(KDEConfig(), grid=grid)
    cfg = dataclasses.replace(cfg, normals=dataclasses.replace(cfg.normals, method="pca"))
    with pytest.raises(ValueError, match="unknown normal method"):
        tpipe.kde_pipeline(
            torch.from_numpy(noisy), torch.from_numpy(color), ti, convert.config_from_jax(cfg)
        )
