"""JAX-side oracles shared by the port's parity tests (tests/test_torch_*.py
that import JAX; tests/test_torch_gpu.py imports none of this)."""

import jax.numpy as jnp

from satellite_approximation_tpu.models import fill as JF


def cascade_residual(img, x_hi, x_lo, um, dg):
    """fill._fused_refine_solve's laplace-mode residual (the XLA cascade)."""
    umf = um.astype(jnp.float32)
    k = (4.0 - dg.astype(jnp.float32)) * umf
    y_hi = img * (1.0 - umf) + x_hi
    s, c = JF._cascade(list(JF._shift_taps(y_hi)) + [-4.0 * x_hi, k * x_hi])
    l1, l2, l3, l4 = JF._shift_taps(x_lo)
    lo = l1 + l2 + l3 + l4 - 4.0 * x_lo + k * x_lo
    return (s + (c + lo)) * umf
