"""PyTorch port: the package surface (__init__.py, models/__init__.py).

The port re-exports the names the JAX package re-exports: the camera and
config names of kinectdepthmapenhancement_tpu/__init__.py:21-36 and
__version__, and the pipelines and result types of its models/__init__.py
(`__all__` equal), plus, at the top level, those pipelines (so
`from kinectdepthmapenhancement_tpu_torch import KDEConfig, kde_pipeline`
works).  Each name is the port's own object.  Importing the package in a
fresh process builds no kernel, loads no library and initialises no CUDA
context.
"""

import os
import subprocess
import sys

import kinectdepthmapenhancement_tpu as jpkg
import kinectdepthmapenhancement_tpu.models as jmodels
import kinectdepthmapenhancement_tpu_torch as tpkg
import kinectdepthmapenhancement_tpu_torch.models as tmodels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOP = ("Intrinsics", "default_kinect_intrinsics", "normalized_rays", "projective_to_real",
           "real_to_projective", "KDEConfig", "RGBFConfig", "SPDSPConfig", "SLICParams",
           "PipelineConfig")


def test_names_match_the_jax_package():
    assert tmodels.__all__ == jmodels.__all__
    assert tpkg.__all__ == list(JAX_TOP) + jmodels.__all__
    assert tpkg.__version__ == jpkg.__version__
    for name in JAX_TOP:
        assert hasattr(jpkg, name), name
    for name in tpkg.__all__:
        obj = getattr(tpkg, name)
        assert obj.__module__.startswith("kinectdepthmapenhancement_tpu_torch."), name
        assert getattr(jpkg, name, None) is not obj
    for name in tmodels.__all__:
        assert getattr(tmodels, name) is getattr(tpkg, name)
        assert getattr(jmodels, name).__name__ == getattr(tmodels, name).__name__


def test_import_builds_nothing():
    code = (
        "import torch\n"
        "from kinectdepthmapenhancement_tpu_torch import KDEConfig, kde_pipeline, Intrinsics\n"
        "from kinectdepthmapenhancement_tpu_torch.models import tof_pipeline\n"
        "import kinectdepthmapenhancement_tpu_torch.cli, kinectdepthmapenhancement_tpu_torch.native\n"
        "import kinectdepthmapenhancement_tpu_torch.utils.evaluate\n"
        "from kinectdepthmapenhancement_tpu_torch import _build, native\n"
        "import sys\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert _build._lib is None and native._lib is None\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kinectdepthmapenhancement_tpu.'))\n"
        "               for m in sys.modules), 'the port imported JAX'\n"
        "print(KDEConfig().grid, kde_pipeline.__module__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "kinectdepthmapenhancement_tpu_torch.models.pipelines" in out.stdout
