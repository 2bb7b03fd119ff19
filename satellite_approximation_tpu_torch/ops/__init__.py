"""Raster primitives of the port. So far: the fused smoother from a given
iterate, the counterpart of ``satellite_approximation_tpu.ops.fused_jacobi_tpu``
(the port routes by the operands' device, so ``pallas_available`` has no
counterpart)."""

from __future__ import annotations

import torch

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


__all__ = ["fused_jacobi"]
