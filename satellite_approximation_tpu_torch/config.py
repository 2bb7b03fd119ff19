"""Typed configuration of the port: the detection pipeline's constants and
the solver settings (``satellite_approximation_tpu/config.py``).

The reference hardcodes its algorithm constants at compile time
(automatic_detection.cpp:33-36; CloudMask.cpp:47-53; CloudShadowMatching.cpp:139,154;
ProbabilityRefinement.cpp:37-41,193-194; PotentialShadowMask.cpp:32-39); here
they are frozen dataclasses. Backend values that read ``"jax"`` in the JAX
package read ``"torch"`` here."""

from __future__ import annotations

import dataclasses

# full-tile-class gate in pixels, read only by models/detection/placement
# (big_scene); placement.place decides from it where detect's stages run
BIG_SCENE_PIXELS = 16_000_000


@dataclasses.dataclass(frozen=True)
class CloudMaskConfig:
    """Cloud mask generation (reference CloudMask.cpp:17-61)."""

    clp_blur_sigma: float = 4.0  # CloudMask.cpp:21
    clp_threshold: float = 0.5  # CloudMask.cpp:23
    cld_threshold: float = 0.2  # CloudMask.cpp:23
    post_blur_sigma: float = 1.0  # CloudMask.cpp:26 (GenerateCloudMask only)
    post_blur_threshold: float = 0.1  # CloudMask.cpp:26
    dilation_radius: int = 15  # CloudMask.cpp:47
    close_radius: int = 5  # CloudMask.cpp:52
    cleanup_blur_ksize: int = 11  # CloudMask.cpp:57


@dataclasses.dataclass(frozen=True)
class ShadowMaskConfig:
    """Potential shadow mask (reference PotentialShadowMask.cpp:21-51)."""

    cloud_cover_lo: float = 0.07  # linearStep p0.x (PotentialShadowMask.cpp:33)
    cloud_cover_hi: float = 0.2  # linearStep p1.x
    percentile_lo: float = 0.4  # linearStep p0.y
    percentile_hi: float = 0.7  # linearStep p1.y
    nir_difference_threshold: float = 0.02  # PotentialShadowMask.cpp:37
    blur_sigma: float = 1.0  # PotentialShadowMask.cpp:38
    blur_threshold: float = 0.1  # PotentialShadowMask.cpp:38


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Cloud-shadow ray-cast matching (reference CloudShadowMatching.cpp)."""

    height_min_km: float = 0.2  # CloudShadowMatching.cpp:139
    height_max_km: float = 12.0  # CloudShadowMatching.cpp:139
    height_step_km: float = 0.025  # CloudShadowMatching.cpp:139
    min_similarity: float = 0.3  # CloudShadowMatching.cpp:154
    min_support_pixels: int = 5  # CloudShadowMatching.cpp:93
    trim_lo: float = 0.1  # CloudShadowMatching.cpp:195
    trim_hi: float = 0.9
    # "native" (C++ scan) / "torch" (device sweep): force one backend
    # (equality-tested pair); "auto": placement.native_matching decides.
    backend: str = "auto"
    # device sweep: most heights per batched pass (473 in all); the sweep
    # also bounds a pass by its window cells, so this only caps small buckets
    # (``jax_height_chunk`` in the JAX package).
    height_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RefinementConfig:
    """Probability refinement (reference ProbabilityRefinement.cpp)."""

    alpha_a: float = 17.0  # ProbabilityRefinement.cpp:17
    alpha_b: float = 0.007
    beta_min_distance: float = 5.0  # ProbabilityRefinement.cpp:37-41
    beta_max_distance: float = 80.0
    beta_mid_percentile: float = 0.2
    beta_min_factor: float = 0.15
    # 2 * M_2_SQRTPI = 4/sqrt(pi) ~ 2.2568 (ProbabilityRefinement.cpp:41)
    beta_area_correction: float = 2.2567583341910251
    histogram_divisions: tuple[int, ...] = (8, 16, 32, 64, 128)  # :192
    histogram_weights: tuple[float, ...] = (
        16.0 / 31.0,
        8.0 / 31.0,
        4.0 / 31.0,
        2.0 / 31.0,
        1.0 / 31.0,
    )
    surface_resolution: int = 256  # :206
    # "host": numpy/scipy for every stage (reference-exact; full-tile-class
    #   rasters take the bit-exact native C++ passes where the library is).
    # "torch": the device backend (models/detection/refinement_torch) for
    #   every stage, equality-tested against "host".
    # "auto" (default): placement.place decides, stage by stage.
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Full pipeline constants (reference automatic_detection.cpp:33-36)."""

    min_cloud_size_for_ray_casting: int = 3
    distance_to_sun_km: float = 1.5e9
    distance_to_view_km: float = 785.0
    probability_threshold: float = 0.15
    cloud_mask: CloudMaskConfig = CloudMaskConfig()
    shadow_mask: ShadowMaskConfig = ShadowMaskConfig()
    matching: MatchingConfig = MatchingConfig()
    refinement: RefinementConfig = RefinementConfig()


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Masked Laplace/Poisson solver settings.

    The reference uses Eigen CG with tol=1e-6 and max_iters = n/2 for Poisson
    and Eigen's defaults (machine eps) for Laplace. Here the matrix-free CG
    runs in f32 inside a double-float refinement loop.
    """

    tolerance: float = 1e-6
    max_iterations: int | None = None
    refinement_steps: int = 2
    use_multigrid: bool = True
    mg_threshold_pixels: int = 256 * 256  # below this plain CG wins
    # "auto": the device path when the f64 inputs are exactly f32-representable
    # (every u8/u16-derived raster); "force": always, rounding inputs to f32;
    # "never": host-assembled f64 right-hand side.
    device_assembly: str = "auto"
    # Multi-device routing of multigrid-scale solves (parallel/fill.sharded_fill):
    # a parallel.ShardMesh shards over its shards (several may share a device;
    # parallel.auto_fill_mesh builds one over every visible card); "auto",
    # None or "off" solve on one device. Anything else raises ValueError
    # (parallel/mesh.resolve_mesh).
    mesh: object = "auto"


DEFAULT_DETECTION = DetectionConfig()
DEFAULT_SOLVER = SolverConfig()

