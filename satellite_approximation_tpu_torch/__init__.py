"""satellite_approximation_tpu_torch — the PyTorch/CUDA port of
``satellite_approximation_tpu``.

Two cores are ported. The masked fill: Laplace and Poisson editing as
matrix-free masked stencil solves (multigrid-preconditioned CG inside a
double-float refinement loop), with the multigrid smoother and the
refinement residuals as hand-written CUDA kernels for Hopper
(``ops/stencil_kernels.py``, ``csrc/``). And cloud and cloud-shadow
detection for Sentinel-2 (``models/detection``, ``ops``): plain torch ops on
the rasters' device, with host routes through the C++ library of
``native``. It imports torch, numpy, scipy and PIL, never jax and never the
JAX package.

Every entry point takes ``device=``; ``None`` means the CUDA device and
raises when there is none. ``device="cpu"`` runs the kernels' plain PyTorch
versions.
"""

from .device import resolve_device
from .models.detection.pipeline import (
    CloudParams,
    SkipShadowDetection,
    Status,
    detect,
    detect_clouds,
    detect_in_folder,
    detect_single_folder,
    get_diagonal_distance,
)
from .models.laplace import (
    apply_laplace,
    find_connected_components,
    fill_missing_portion_smooth_boundary,
    filling_missing_portions_smooth_boundaries,
)
from .models.poisson import PerfInfo, blend_images_poisson, highlight_area_replaced
from .utils.log import LogLevel, log_location, set_log_level

__version__ = "0.1.0"

__all__ = [
    "CloudParams",
    "LogLevel",
    "PerfInfo",
    "SkipShadowDetection",
    "Status",
    "apply_laplace",
    "blend_images_poisson",
    "detect",
    "detect_clouds",
    "detect_in_folder",
    "detect_single_folder",
    "find_connected_components",
    "get_diagonal_distance",
    "fill_missing_portion_smooth_boundary",
    "filling_missing_portions_smooth_boundaries",
    "highlight_area_replaced",
    "log_location",
    "resolve_device",
    "set_log_level",
]
