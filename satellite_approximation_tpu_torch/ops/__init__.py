"""Raster primitives of the port: the counterparts of the JAX package's
``ops`` (blur, masks, morphology, pit fill, connected components,
statistics, geometry), as plain torch ops on tensors that run where the
tensor lies, beside the fused smoother from a given iterate, the counterpart
of ``satellite_approximation_tpu.ops.fused_jacobi_tpu`` (the port routes by
the operands' device, so ``pallas_available`` has no counterpart)."""

from __future__ import annotations

import torch

from . import geometry, image
from .blur import gaussian_blur, strip_kernel
from .components import Region, connected_components, partition_regions
from .masks import SCL, cover_count, cover_percentage, normalize, scl_mask, threshold
from .morphology import close, cv_gaussian_blur, dilate, ellipse_kernel, erode
from .pitfill import pit_fill
from .stats import linear_step, masked_percentile, percentile, trimmed_average
from .stencil_kernels import invm_for_kernel, jacobi


def fused_jacobi(u: torch.Tensor, b: torch.Tensor, umask: torch.Tensor, deg: torch.Tensor,
                 sweeps: int = 8, omega=0.8, emit_residual: bool = False):
    """K weighted-Jacobi sweeps of the masked 5-point system from ``u``: u/b
    (C, H, W) f32 or bf16, umask/deg (H, W). ``omega`` is a scalar weight
    (damped Jacobi) or a K-tuple of per-sweep weights (Chebyshev
    smoothing). With ``emit_residual`` (K + 1 <= 8) also returns
    r = (b - A u) * m. On CUDA operands this is the ``jacobi`` kernel."""
    omegas = tuple(omega) if isinstance(omega, tuple) else (float(omega),) * sweeps
    if len(omegas) != sweeps:
        raise ValueError(f"fused_jacobi: {len(omegas)} weights for {sweeps} sweeps")
    invm = invm_for_kernel(umask, deg).to(u.dtype)
    return jacobi(u, b.to(u.dtype), invm, omegas, emit_residual)


__all__ = [
    "SCL",
    "Region",
    "close",
    "connected_components",
    "cover_count",
    "cover_percentage",
    "cv_gaussian_blur",
    "dilate",
    "ellipse_kernel",
    "erode",
    "fused_jacobi",
    "gaussian_blur",
    "geometry",
    "image",
    "linear_step",
    "masked_percentile",
    "normalize",
    "partition_regions",
    "percentile",
    "pit_fill",
    "scl_mask",
    "strip_kernel",
    "threshold",
    "trimmed_average",
]
