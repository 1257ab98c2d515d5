from kinectdepthmapenhancement_tpu_torch.models.pipelines import (
    KDEResult,
    RGBFResult,
    SPDSPResult,
    TOFResult,
    jbf_pipeline,
    kde_pipeline,
    mrf_pipeline,
    rgbf_pipeline,
    spdsp_pipeline,
    tof_pipeline,
)

__all__ = [
    "KDEResult", "RGBFResult", "SPDSPResult", "TOFResult",
    "jbf_pipeline", "kde_pipeline", "mrf_pipeline", "rgbf_pipeline",
    "spdsp_pipeline", "tof_pipeline",
]
