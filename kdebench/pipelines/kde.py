"""KDE: kde_pipeline (JBF, CM normals, NASP, CCL merge, plane
projection), the pipeline run_stream runs with `cfg`.

A configuration's overrides of KDEConfig sit under its "kde" key.  The
reference's copies of this pipeline's files are reference.FILES itself,
so it adds none.
"""

from __future__ import annotations

from kdebench.harness import _replace

FILES: dict = {}


def port_kwargs(overrides: dict) -> dict:
    """run_stream's keyword arguments: the port's KDEConfig with the
    configuration's overrides (nested parameter groups as dicts)."""
    from kinectdepthmapenhancement_tpu_torch.core import config as pc

    return {"cfg": _replace(pc.KDEConfig(), overrides)}


def reference(depths, colors, intrinsics: dict, overrides: dict):
    """The plain reference's enhanced points [B, H, W, 3] (mm) of depths
    [B, H, W] f32 mm and colors [B, H, W, 3] u8."""
    import kdebench.reference as ref
    from kdebench.reference.core import config as rc

    return ref.enhance(depths, colors, ref.Intrinsics(**intrinsics),
                       _replace(rc.KDEConfig(), overrides))
