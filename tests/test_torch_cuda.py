"""PyTorch port: the CUDA kernels against their plain PyTorch versions on
the card.  Marked `cuda`; each test skips without a CUDA device (decided in
a fixture, never at import).  Run on the card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(tests/conftest.py configures JAX, which the card's machine need not have;
this file imports only the port.)

Bars: chamfer DT, covariance sweep and seed gradient bitwise; JBF within
1e-3 mm (bitwise where expf matches).  chip_smoke.py runs the same checks at
the 640x480 path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu_torch.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu_torch.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu_torch.ops import (
    bilateral,
    cuda_bilateral,
    cuda_cov,
    cuda_dt,
    cuda_gradient,
    normals,
    slic,
)

pytestmark = pytest.mark.cuda
H, W = 96, 128
GRID = GridParams(rows=3, cols=4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(dev):
    intr = default_kinect_intrinsics(W, H)
    scenes = [make_noisy_scene(H, W, intr, seed=s) for s in (0, 3)]
    color = torch.from_numpy(np.stack([s[0] for s in scenes])).to(dev)
    depth = torch.from_numpy(np.stack([s[1] for s in scenes])).to(dev)
    cfg = KDEConfig()
    guide = bilateral.guide_bilateral(color, cfg.jbf).float().contiguous()
    points = projective_to_real(depth, intr)
    vm = (points / 1000.0).contiguous()
    nmap = normals.generate_normal_map(points, cfg.normals)
    cf = color.float()
    return dict(
        intr=intr, color=color, depth=depth, guide=guide, vm=vm,
        dci=normals.dci_map(vm, 0.05).contiguous(),
        rect=normals.smoothing_map(vm, cfg.normals).to(torch.int32).contiguous(),
        csub=slic._subgrid_extract(cf, GRID, H, W, 8).contiguous(),
        nsub=slic._subgrid_extract(nmap, GRID, H, W, 8).contiguous(),
    )


def test_jbf_kernel_matches_plain(inputs):
    p = KDEConfig().jbf
    kw = dict(window=p.window, spatial_sigma=p.spatial_sigma,
              color_sigma=p.color_sigma, depth_sigma=p.depth_sigma)
    got = cuda_bilateral.jbf(inputs["depth"], inputs["guide"], **kw)
    want = cuda_bilateral.jbf_plain(inputs["depth"], inputs["guide"], **kw)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("iters", [26, 40])
def test_dt_kernel_bitwise(inputs, iters):
    got = cuda_dt.distance_transform(inputs["dci"], iters)
    assert torch.equal(got, cuda_dt.distance_transform_plain(inputs["dci"], iters))


def test_cov_kernel_bitwise(inputs):
    cnt, cov = cuda_cov.cm_covariances(inputs["vm"], inputs["rect"])
    pc, pv = cuda_cov.cm_covariances_plain(inputs["vm"], inputs["rect"])
    assert torch.equal(cnt, pc) and torch.equal(cov, pv)


@pytest.mark.parametrize("nasp", [True, False], ids=["nasp", "color_only"])
def test_seed_gradient_kernel_bitwise(inputs, nasp):
    n = inputs["nsub"] if nasp else None
    got = cuda_gradient.seed_gradient(inputs["csub"], n)
    assert torch.equal(got, cuda_gradient.seed_gradient_plain(inputs["csub"], n))


def test_wrappers_reject_bad_tensors(inputs):
    with pytest.raises(TypeError):
        cuda_dt.distance_transform(inputs["dci"].float(), 26)
    strided = inputs["vm"].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    with pytest.raises(ValueError):  # same shape, not contiguous
        cuda_cov.cm_covariances(strided, inputs["rect"])


def test_pipeline_launches_every_kernel(inputs):
    cfg = dataclasses.replace(KDEConfig(), grid=GRID)
    mods = (cuda_bilateral, cuda_dt, cuda_cov, cuda_gradient)
    before = [m.launches for m in mods]
    res = kde_pipeline(inputs["depth"], inputs["color"], inputs["intr"], cfg)
    torch.cuda.synchronize()
    assert all(m.launches > b for m, b in zip(mods, before))
    assert bool(torch.isfinite(res.optimized_points).all())
