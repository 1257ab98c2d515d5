"""Frozen configuration for every pipeline.

The reference hard-codes every parameter either as per-class `static const`
(e.g. JointBilateralFilter.cpp:3-6) or inline at the pipeline call sites
(RegionGrowingBilateralFilter.cpp:28-29, KinectDepthEnhancement.cpp:67,
SPDepthSuperResolution.cpp:59-60).  Here they are named, frozen dataclasses;
the defaults reproduce the reference's values exactly.

All dataclasses are hashable/frozen so they can be static jit arguments.

PyTorch port: a field-for-field copy of kinectdepthmapenhancement_tpu's
core/config.py (same names, same defaults; convert.config_from_jax carries
an instance across).  `stats_impl` is read, with the JAX package's
meaning: "auto" and "pallas" route NASP's statistics and the cell index
through the kernel wrappers of ops/cuda_nasp.py, "xla" through their plain
versions on every device (ops/slic.py).  `grad_impl`, `cov_impl` and
`dt_impl` are kept for the correspondence but not read: those wrappers
always take the kernel on the card.  Every wrapper takes its plain PyTorch
version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JBFParams:
    """Joint bilateral filter constants (JointBilateralFilter.cpp:3-6)."""

    window: int = 5
    spatial_sigma: float = 70.0
    color_sigma: float = 50.0
    depth_sigma: float = 20.0
    # cv::gpu::bilateralFilter(color, d=5, sigmaColor=30, sigmaSpace=30)
    # pre-smoothing of the guide image (JointBilateralFilter.cu:285).
    guide_diameter: int = 5
    guide_color_sigma: float = 30.0
    guide_spatial_sigma: float = 30.0


@dataclasses.dataclass(frozen=True)
class MRFParams:
    """Markov-random-field smoother constants (MarkovRandomField.cpp:3-6)."""

    window: int = 5
    color_sigma: float = 50.0    # NOTE: multiplies the squared colour diff
    smooth_sigma: float = 150.0  # exp(-sigma_c * dc^2), MarkovRandomField.cu:27-31


@dataclasses.dataclass(frozen=True)
class SLICParams:
    """One SLIC segmentation call (sigma set + iterations).

    The color/spatial/depth/normal sigmas weight the distance terms; see
    DepthAdaptiveSuperpixel.cu:206-219 and NormalAdaptiveSuperpixel.cu:223-258.
    """

    color_sigma: float
    spatial_sigma: float
    depth_sigma: float = 0.0
    normal_sigma: float = 0.0
    iterations: int = 1
    # seed-gradient backend: "auto" picks the fused Pallas kernel
    # (ops/pallas_gradient.py, bitwise-equal) on TPU and the XLA path
    # elsewhere; "xla" / "pallas" force one ("pallas" runs in interpret mode
    # off-TPU).  Sharded pipelines force "xla" at spatial > 1: a pallas_call
    # cannot be partitioned by GSPMD (see parallel/sharding.py).
    grad_impl: str = "auto"
    # NASP cluster-statistics backend: "auto" picks the fused Pallas cell-sums
    # kernel (ops/pallas_nasp.py; same sums up to f32 accumulation order) on
    # TPU for single-iteration cell-local segmentations, the one-hot-matmul
    # XLA route elsewhere.  Same sharding rule as grad_impl.
    stats_impl: str = "auto"
    # Later-iteration (2+) label-index route.  "auto": run the capped
    # cell-space fast path guarded by a runtime locality check with an exact
    # lax.cond fallback to the global [H*W, K]-one-hot route (identical
    # results always); "cell": capped path unconditionally (for vmapped
    # serving, where a batched cond would execute both branches — exact
    # whenever labels stay within the [-(r+1), r]^2 cell neighbourhood,
    # which the per-iteration update window enforces in practice); "global":
    # the unconditional reference-shaped route.  See ops/slic.py::segment.
    locality: str = "auto"


@dataclasses.dataclass(frozen=True)
class ERSParams:
    """Edge-refined superpixel constants (EdgeRefinedSuperpixel.cpp:4-7)."""

    window: int = 7
    spatial_sigma: float = 30.0
    color_sigma: float = 50.0
    depth_sigma: float = 70.0


@dataclasses.dataclass(frozen=True)
class ProjectionParams:
    """Plane projection / optimisation constants (Projection_GPU.cpp:3-5)."""

    window: int = 7
    spatial_sigma: float = 20.0
    depth_sigma: float = 100.0
    # mrf_optimization constants (Projection_GPU.cu:300-303 call site)
    mrf_window: int = 5
    mrf_k: float = 0.5
    mrf_smooth_sigma: float = 1.0
    mrf_iterations: int = 20


@dataclasses.dataclass(frozen=True)
class CCLParams:
    """Superpixel-merging predicate (LabelEquivalenceSeg.cu:37-43)."""

    normal_angle_max: float = 3.141592653 / 8.0
    plane_offset_max: float = 150.0
    iterations: int = 10  # reference runs a fixed 10 scan/analysis rounds


@dataclasses.dataclass(frozen=True)
class CCLPCAParams:
    """PCA variant of the merge predicate (LabelEquivalenceSegPCA.cu:28-35)."""

    normal_angle_max: float = 3.141592653 / 8.0
    plane_offset_max: float = 700.0
    iterations: int = 10


@dataclasses.dataclass(frozen=True)
class NormalParams:
    """Normal-map generation (NormalEstimation/*).

    method: "sdc" | "cm" | "bilateral" (NormalMapGenerator.h:28).  KDE uses
    "cm" (KinectDepthEnhancement.cpp:53); the class default is "bilateral"
    (NormalMapGenerator.cpp:15).
    SAMG constants from SmoothingAreaMapGenerator.cpp:15-16.
    """

    method: str = "cm"
    max_depth_change_factor: float = 0.05  # metres
    normal_smoothing_size: float = 20.0    # pixels
    # covariance-sweep backend for the CM method: "auto" picks the fused
    # Pallas kernel (ops/pallas_cov.py, bit-exact, ~8x faster) on TPU and the
    # portable XLA path elsewhere; "xla" / "pallas" force one.
    cov_impl: str = "auto"
    # Reference's chamfer DT is exact two-pass host code; we run a bounded
    # device-side min-plus relaxation instead.  The smoothing map is clamped to
    # <= normal_smoothing_size + z/10, so distances beyond ~24 px never matter;
    # dt_iterations sweeps of 1-step relaxation cover a radius of dt_iterations.
    dt_iterations: int = 26
    # chamfer-DT backend: "auto" runs all iterations in one VMEM-resident
    # Pallas launch on TPU (ops/pallas_dt.py, bitwise-equal — min-plus is
    # exact and order-insensitive in f32); same sharding rule as cov_impl.
    dt_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Superpixel grid: 15 rows x 20 cols = 300 clusters (main.cpp:30-31)."""

    rows: int = 15
    cols: int = 20

    @property
    def num_clusters(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Shared base: grid + component constants."""

    grid: GridParams = GridParams()
    jbf: JBFParams = JBFParams()
    mrf: MRFParams = MRFParams()
    ers: ERSParams = ERSParams()
    projection: ProjectionParams = ProjectionParams()
    normals: NormalParams = NormalParams()
    ccl: CCLParams = CCLParams()
    ccl_pca: CCLPCAParams = CCLPCAParams()


@dataclasses.dataclass(frozen=True)
class RGBFConfig(PipelineConfig):
    """RegionGrowingBilateralFilter preset (RegionGrowingBilateralFilter.cpp:28-29)."""

    color_slic: SLICParams = SLICParams(200.0, 40.0, 0.0, 0.0, 1)
    depth_slic: SLICParams = SLICParams(100.0, 20.0, 200.0, 0.0, 1)


@dataclasses.dataclass(frozen=True)
class KDEConfig(PipelineConfig):
    """KinectDepthEnhancement ("PROPOSED") preset (KinectDepthEnhancement.cpp:67).

    NASP sigma order at the call site is (color, spatial, depth, normal) =
    (10, 50, 50, 150) with 1 iteration.
    """

    nasp: SLICParams = SLICParams(10.0, 50.0, 50.0, 150.0, 1)
    # variance_optimization gates (Projection_GPU.cu:203-208)
    min_cluster_size: int = 1300
    agree_tight: float = 0.01
    agree_loose: float = 0.03
    # Plane-confidence gate (spec EXTENSION over the reference; see
    # ops/plane.py::plane_fit_residual): snap to a merged plane only when it
    # explains the cluster's own depths to a relative RMS residual below
    # this.  Post-JBF noise sits at 0.05-0.2% of z; mis-merged planes on
    # textured scenes sit at >= 0.6%.  0 disables snapping entirely;
    # float('inf') restores exact reference behaviour.
    max_plane_residual: float = 0.0025
    # Label-consistent plane hole-fill (spec EXTENSION; ops/plane.py::
    # plane_hole_fill): dilate (merged label, plane) this many steps into
    # invalid-depth pixels surrounded by ONE trusted cluster and project the
    # ray onto the plane.  Targets the TOF scenario's coherent dropouts
    # (EVAL_FAR.md sparse variant).  0 (default) = off, reference-exact.
    fill_holes: int = 0
    # Plane-consistency merge (spec EXTENSION; ops/ccl.py::merge_planes):
    # replace the reference's normal-similarity CCL merge with a merge of
    # adjacent superpixels whose least-squares planes mutually explain each
    # other's members to < pm_tau relative RMS.  On far-range banded depth
    # the normal merge over-merges (quantization-biased normals) and the
    # residual gate then disables the projection stage entirely; this merge
    # recovers the true surfaces (EVAL_FAR.md round 5).  False (default) =
    # reference merge.
    plane_merge: bool = False
    pm_tau: float = 0.0035


@dataclasses.dataclass(frozen=True)
class SPDSPConfig(PipelineConfig):
    """SPDepthSuperResolution preset (SPDepthSuperResolution.cpp:59-60)."""

    color_slic: SLICParams = SLICParams(200.0, 10.0, 0.0, 0.0, 5)
    depth_slic: SLICParams = SLICParams(0.0, 10.0, 200.0, 0.0, 5)
    # Plane-confidence gate for the 20-sweep MRF stage (spec EXTENSION, same
    # rationale as KDEConfig.max_plane_residual): a cluster's PCA plane is
    # trusted only when its fit thickness sqrt(smallest eigenvalue) is below
    # this fraction of the cluster depth.  inf restores reference behaviour.
    max_plane_residual: float = 0.0025


@dataclasses.dataclass(frozen=True)
class TOFConfig(SPDSPConfig):
    """TOFDepthInterpolation preset (TOFDepthInterpolation.cpp:62-63).

    Same segmentation sigmas as SPDSP; merges with the PCA predicate and
    projects without iterative optimisation (Projection_PCA.cu:109-131).
    """
