"""satellite_approximation_tpu_torch — the PyTorch/CUDA port of
``satellite_approximation_tpu``.

This slice ports the masked fill: Laplace and Poisson editing as matrix-free
masked stencil solves (multigrid-preconditioned CG inside a double-float
refinement loop), with the multigrid smoother and the refinement residuals
as hand-written CUDA kernels for Hopper (``ops/stencil_kernels.py``,
``csrc/``). It imports torch and numpy, never jax and never the JAX package.

Every entry point takes ``device=``; ``None`` means the CUDA device and
raises when there is none. ``device="cpu"`` runs the kernels' plain PyTorch
versions.
"""

from .device import resolve_device
from .models.laplace import (
    apply_laplace,
    fill_missing_portion_smooth_boundary,
    filling_missing_portions_smooth_boundaries,
)
from .models.poisson import PerfInfo, blend_images_poisson, highlight_area_replaced
from .utils.log import LogLevel, log_location, set_log_level

__version__ = "0.1.0"

__all__ = [
    "LogLevel",
    "PerfInfo",
    "apply_laplace",
    "blend_images_poisson",
    "fill_missing_portion_smooth_boundary",
    "filling_missing_portions_smooth_boundaries",
    "highlight_area_replaced",
    "log_location",
    "resolve_device",
    "set_log_level",
]
