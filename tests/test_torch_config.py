"""PyTorch port: config dataclasses, state conversion, camera and test scene
against the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core import camera as jcam
from kinectdepthmapenhancement_tpu.core import config as jconfig
from kinectdepthmapenhancement_tpu.core import testdata as jtestdata
from kinectdepthmapenhancement_tpu_torch import convert
from kinectdepthmapenhancement_tpu_torch.core import camera as tcam
from kinectdepthmapenhancement_tpu_torch.core import config as tconfig
from kinectdepthmapenhancement_tpu_torch.core import testdata as ttestdata

torch.set_num_threads(2)


def _dataclasses(module):
    return {
        name: obj
        for name, obj in vars(module).items()
        if isinstance(obj, type) and dataclasses.is_dataclass(obj)
    }


def test_config_fields_and_defaults_match_jax():
    jcls, tcls = _dataclasses(jconfig), _dataclasses(tconfig)
    assert sorted(jcls) == sorted(tcls)
    for name, jc in jcls.items():
        jf = [(f.name, f.default) for f in dataclasses.fields(jc)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls[name])]
        # nested defaults compare by value: the port's own dataclass instances
        jf = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d) for n, d in jf]
        tf = [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d) for n, d in tf]
        assert jf == tf, name
    assert tconfig.GridParams().num_clusters == jconfig.GridParams().num_clusters


def test_config_from_jax_round_trips():
    jcfg = dataclasses.replace(
        jconfig.KDEConfig(),
        grid=jconfig.GridParams(rows=3, cols=4),
        nasp=jconfig.SLICParams(11.0, 49.0, 51.0, 149.0, 1, stats_impl="xla"),
        max_plane_residual=float("inf"),
    )
    tcfg = convert.config_from_jax(jcfg)
    assert type(tcfg) is tconfig.KDEConfig
    assert type(tcfg.grid) is tconfig.GridParams and type(tcfg.nasp) is tconfig.SLICParams
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for name, jc in _dataclasses(jconfig).items():
        if name == "SLICParams":
            continue  # no all-default constructor
        assert dataclasses.asdict(convert.config_from_jax(jc())) == dataclasses.asdict(jc())


def test_config_from_jax_rejects_unknown_and_mismatched():
    @dataclasses.dataclass(frozen=True)
    class NotInPort:
        a: int = 1

    @dataclasses.dataclass(frozen=True)
    class GridParams:  # same name as the port's, one field short
        rows: int = 15

    with pytest.raises(TypeError):
        convert.config_from_jax(NotInPort())
    with pytest.raises(ValueError):
        convert.config_from_jax(GridParams())
    with pytest.raises(TypeError):
        convert.config_from_jax(jconfig.KDEConfig)


def test_intrinsics_from_jax():
    ji = jcam.default_kinect_intrinsics(128, 96)
    ti = convert.intrinsics_from_jax(ji)
    assert tuple(ti) == tuple(ji) and type(ti) is tcam.Intrinsics
    np.testing.assert_array_equal(ti.matrix, ji.matrix)
    with pytest.raises(TypeError):
        convert.intrinsics_from_jax((1.0, 2.0, 3.0, 4.0))


@pytest.mark.parametrize("hw", [(96, 128), (48, 80)])
def test_camera_functions_allclose(hw):
    """normalized_rays / projective_to_real / real_to_projective, rtol 1e-6."""
    h, w = hw
    ji = jcam.default_kinect_intrinsics(w, h)
    ti = convert.intrinsics_from_jax(ji)
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.0, 4000.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0

    np.testing.assert_allclose(
        tcam.normalized_rays(ti, h, w).numpy(), np.asarray(jcam.normalized_rays(ji, h, w)),
        rtol=1e-6, atol=0,
    )
    tp = tcam.projective_to_real(torch.from_numpy(depth)[None], ti)[0].numpy()
    jp = np.array(jcam.projective_to_real(jnp.asarray(depth), ji))  # writable copy
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        tcam.real_to_projective(torch.from_numpy(jp), ti).numpy(),
        np.asarray(jcam.real_to_projective(jnp.asarray(jp), ji)),
        rtol=1e-6, atol=1e-4,
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_make_noisy_scene_byte_identical(seed):
    h, w = 96, 128
    ji = jcam.default_kinect_intrinsics(w, h)
    want = jtestdata.make_noisy_scene(h, w, ji, seed=seed)
    got = ttestdata.make_noisy_scene(h, w, convert.intrinsics_from_jax(ji), seed=seed)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape
        assert g.tobytes() == wnt.tobytes()
