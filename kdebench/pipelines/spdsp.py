"""SPDSP: spdsp_pipeline (the colour and depth SLICs, DASP variant, 5
iterations each -> edge-refined superpixels -> PCA planes and pseudo-depth
on the ERS labels' index -> 20 MRF sweeps), the pipeline run_stream runs
with an SPDSPConfig as `cfg`, on the raw depth's points.

A configuration's overrides of SPDSPConfig sit under its "spdsp" key.  The
reference's copies this pipeline adds to reference.FILES: the ERS stage and
the pipeline itself (reference file -> (the port's file, the commit it was
copied at)).
"""

from __future__ import annotations

from kdebench.harness import _replace

FILES = {
    "ops/ers.py": ("ops/ers.py", "327a054e3e58fb5792ecd7a04055f13060463e42"),
    "models/spdsp.py": ("models/pipelines.py", "327a054e3e58fb5792ecd7a04055f13060463e42"),
}


def port_kwargs(overrides: dict) -> dict:
    """run_stream's keyword arguments: the port's SPDSPConfig with the
    configuration's overrides (nested parameter groups as dicts)."""
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    return {"cfg": _replace(pc.SPDSPConfig(), overrides)}


def reference(depths, colors, intrinsics: dict, overrides: dict):
    """The plain reference's optimized points [B, H, W, 3] (mm) of depths
    [B, H, W] f32 mm and colors [B, H, W, 3] u8."""
    import kdebench.reference as ref
    from kdebench.reference.core import config as rc
    from kdebench.reference.models import spdsp

    return spdsp.enhance(depths, colors, ref.Intrinsics(**intrinsics),
                         _replace(rc.SPDSPConfig(), overrides))
