# Frozen copy of satellite_approximation_tpu_torch/config.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Typed configuration of the port: the detection pipeline's constants and
the solver settings (``satellite_approximation_tpu/config.py``).

The reference hardcodes its algorithm constants at compile time
(automatic_detection.cpp:33-36; CloudMask.cpp:47-53; CloudShadowMatching.cpp:139,154;
ProbabilityRefinement.cpp:37-41,193-194; PotentialShadowMask.cpp:32-39); here
they are frozen dataclasses. Backend values that read ``"jax"`` in the JAX
package read ``"torch"`` here."""

from __future__ import annotations

import dataclasses

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


DEFAULT_DETECTION = DetectionConfig()
