"""Device-side Laplace / Poisson fill: the production solve path, in PyTorch.

Port of ``satellite_approximation_tpu/models/fill.py``. The image (f32) and
the mask go to the device once; the right-hand side, the warm start, the
degrees and the multigrid hierarchy are built there, and the refinement loop
recomputes b from the image in every residual pass, so b never persists.

The solution is a double-float pair (x_hi, x_lo) of f32 rasters (~2^-48
relative precision) and each residual is an error-free TwoSum cascade over
the stencil terms. The H100 has native f64; the pair is kept so that the
port matches the reference bit for bit, and whether a plain-f64 residual
pays is for a measurement to decide. In laplace mode both residuals (entry
and every pass) run in the hand-written CUDA kernels
``stencil_kernels.residual_entry`` / ``residual_pair``; the poisson and rhs
cascades stay torch ops. The cascade helpers (the JAX module's ``_two_sum``,
``_shift_taps`` and ``_cascade``) live in ``ops/stencil_kernels.py``, which
the kernels' plain versions share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..ops.stencil_kernels import (
    _shift_taps,
    cascade,
    invm_for_kernel,
    residual_entry,
    residual_pair,
    two_sum,
)
from ..utils import profiling
from . import multigrid
from .cg import (
    CGResult,
    _cg_core,
    bands_per_chunk,
    chunk_elements,
    neighbor_degree_tensor,
    shift_sum,
)

_TINY64 = np.finfo(np.float64).tiny
# integer rasters (the Sentinel-2 case) upload in their own dtype — half the
# host-to-device bytes of f32 for u16 — and are cast to f32 on the device
_UPLOAD_DTYPES = (np.uint8, np.uint16, np.int16, np.int32)


def _composite(img32: torch.Tensor, x_hi: torch.Tensor, x_lo: torch.Tensor, umask: torch.Tensor):
    """Known pixels from the image, x_hi + x_lo over the mask, f32. Updates
    ``x_hi`` in place — its buffer becomes the output — so a full-tile chunk
    needs no extra raster for the composite."""
    umf = umask.to(torch.float32)
    return x_hi.add_(x_lo).mul_(umf).add_(img32 * (1.0 - umf))


def _gather_masked(x_hi, x_lo, iy, ix) -> torch.Tensor:
    """Solved f64 values at the unknown pixels, (C, n): the pair recombines
    in f64 on the gathered vector only."""
    return x_hi[:, iy, ix].to(torch.float64) + x_lo[:, iy, ix].to(torch.float64)


def _recombine64(x_hi, x_lo) -> torch.Tensor:
    """Double-float pair -> f64, for the callers whose surface is f64."""
    return x_hi.to(torch.float64) + x_lo.to(torch.float64)


def _norm64(x32: torch.Tensor) -> torch.Tensor:
    """||x|| per band: squares in f32, their sum in f64."""
    return (x32 * x32).to(torch.float64).sum(dim=(-2, -1)).sqrt()


def _fused_refine_solve(
    img32,
    rep32,
    umask,
    deg,
    hier,
    tolerance,
    max_iterations,
    refinement_steps,
    precond_dtype,
    use_multigrid,
    mode="laplace",
):
    """Compensated-f32 residual refinement around an inner f32 (P)CG.

    ``mode`` selects the right-hand side, recomputed in every residual pass:

    * "laplace": b = Dirichlet sums of the known neighbours in ``img32``;
      x0 = img32 over the mask;
    * "poisson": b = guidance divergence of ``rep32`` + the Dirichlet sums of
      ``img32``; x0 = rep32 over the mask;
    * "rhs": ``img32`` is the f64 right-hand side and ``rep32`` the f64 warm
      start (split into hi/lo once).

    Key identities: known and unknown supports are disjoint, so known + x_hi
    is exact, and deg*x = 4x - k*x with k = 4 - deg in {0, 1, 2} makes both
    products exact. Each pass reads the per-band residual norms to the host
    (one sync) to decide whether to go on.

    Returns (x_hi, x_lo, iterations, rnorm, bnorm) with the norms per band as
    host f64 arrays.
    """
    with profiling.span("fill.entry_residual"):
        umf = umask.to(torch.float32)
        k = (4.0 - deg.to(torch.float32)) * umf  # in {0, 1, 2} on unknowns

        if mode == "rhs":
            b_hi = img32.to(torch.float32)
            b_lo = (img32 - b_hi.to(torch.float64)).to(torch.float32)
            b_hi = b_hi * umf
            b_lo = b_lo * umf
            x_hi = rep32.to(torch.float32)
            x_lo = (rep32 - x_hi.to(torch.float64)).to(torch.float32)
            x_hi = x_hi * umf
            x_lo = x_lo * umf
        else:
            img32 = img32.to(torch.float32)
            g = rep32.to(torch.float32) if mode == "poisson" else None
            x_hi = (img32 if g is None else g) * umf
            x_lo = torch.zeros_like(x_hi)

        if mode == "laplace":
            # the kernel route: entry residual and b from the image, then one
            # residual kernel per pass
            invm0 = invm_for_kernel(umask, deg)
            r_hi, b_full = residual_entry(img32, invm0)
            bnorm = _norm64(b_full)
            rnorm = _norm64(r_hi)
            del b_full

            def residual(x_hi, x_lo):
                r = residual_pair(img32, x_hi, x_lo, invm0)
                return r, _norm64(r)

        else:
            known = None if mode == "rhs" else img32 * (1.0 - umf)

            def residual(x_hi, x_lo):
                """r = (b - A(x_hi + x_lo)) * m: one exact cascade over the hi
                terms; the lo terms contribute at eps^2 and sum in plain f32."""
                if mode == "rhs":
                    hi_terms = list(_shift_taps(x_hi)) + [b_hi, -4.0 * x_hi, k * x_hi]
                    lo_extra = b_lo
                else:
                    y_hi = known + x_hi  # disjoint supports: exact
                    hi_terms = list(_shift_taps(y_hi)) + [-4.0 * x_hi, k * x_hi]
                    hi_terms += [-t for t in _shift_taps(g)] + [4.0 * g, -(k * g)]
                    lo_extra = None
                s, c = cascade(hi_terms)
                l1, l2, l3, l4 = _shift_taps(x_lo)
                lo = l1 + l2 + l3 + l4 - 4.0 * x_lo + k * x_lo
                if lo_extra is not None:
                    lo = lo + lo_extra
                r = (s + (c + lo)) * umf
                return r, _norm64(r)

            if mode == "rhs":
                bnorm = _norm64(b_hi)
            else:
                # ||b|| in plain f32 (f64-accumulated): it only scales the target
                b = shift_sum(known) + (4.0 - k) * g - shift_sum(g)
                bnorm = _norm64(b * umf)
                del b
            r_hi, rnorm = residual(x_hi, x_lo)

        if use_multigrid:
            tol_floor = (
                multigrid.INNER_TOL_FLOOR_F32
                if precond_dtype == torch.float32
                else multigrid.INNER_TOL_FLOOR
            )
            prebuilt = multigrid.prebuild(hier, precond_dtype)
        else:
            tol_floor = 5e-8
            prebuilt = None

        bnorm = bnorm.cpu().numpy()
        rnorm = rnorm.cpu().numpy()
    target = np.maximum(tolerance * bnorm, _TINY64)
    step = 0
    iters = 0
    while step < refinement_steps and (rnorm > target).any():
        with profiling.span("fill.pass"):
            needed = np.min(target / np.maximum(rnorm, 1e-300))
            inner_tol = np.float32(np.clip(0.5 * needed, tol_floor, 0.5))
            z32 = torch.zeros_like(r_hi)
            if use_multigrid:
                d, it, _ = multigrid._pcg_core(
                    r_hi, z32, inner_tol, hier, max_iterations=max_iterations,
                    precond_dtype=precond_dtype, prebuilt=prebuilt,
                )
            else:
                d, it, _ = _cg_core(r_hi, z32, umask, deg, inner_tol, max_iterations)
            x_hi, e = two_sum(x_hi, d * umf)
            x_lo = x_lo + e
            del d, e
            # the fetch of the norms is the pass's one sync, so the span's
            # host time bounds the residual's device time from above
            with profiling.span("fill.residual", cells=x_hi.numel(),
                                guidance=int(mode == "poisson")):
                r_hi, rnorm = residual(x_hi, x_lo)
                rnorm = rnorm.cpu().numpy()
            profiling.count("pcg_iterations", it)
        step += 1
        iters += it
    return x_hi, x_lo, iters, rnorm, bnorm


def _upload(x, s: int, e: int, device: torch.device) -> torch.Tensor:
    """Bands s:e of a host or device raster stack, as f32 on ``device``."""
    part = x[s:e]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device).to(torch.float32).contiguous()


def _host_stack(x):
    """Keep integer rasters in their dtype for the upload, else f32."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return x if x.dtype in _UPLOAD_DTYPES else np.asarray(x, np.float32)


def laplace_fill(
    image,
    umask,
    tolerance: float = 1e-6,
    refinement_steps: int = 3,
    max_iterations: int = 200,
    device_output: bool = True,
    max_chunk_elements: int | None = None,
    band_sink=None,
    masked_values_output: bool = False,
    use_multigrid: bool = True,
    replacement=None,
    device=None,
) -> CGResult:
    """Fill ``image`` where ``umask`` is True by solving the Laplace system
    with multigrid-preconditioned CG; returns the composited image.

    ``image`` is (C, H, W) or (H, W), numpy or tensor, any real dtype;
    ``umask`` is (H, W) bool. Bands solve in chunks sized from the free
    device memory (or ``max_chunk_elements`` band-pixels) by
    :func:`cg.bands_per_chunk`; the hierarchy is shared across chunks.

    ``band_sink``: optional ``fn(start, end, filled_chunk)`` that takes each
    filled chunk as it completes; chunks are then not kept and ``x`` is None.

    ``masked_values_output``: return only the solved values at the unknown
    pixels, a host (C, n) f64 array in ``np.nonzero`` order. Mutually
    exclusive with ``band_sink``.

    ``use_multigrid=False`` solves with plain f32 CG (no hierarchy), for
    small unknown sets; pass a CG-sized ``max_iterations`` with it.

    ``replacement``: optional guidance image of the same shape; switches to
    Poisson editing (guidance-divergence RHS, warm start from the
    replacement). Known pixels of the output still come from ``image``.

    ``device_output=False`` returns numpy instead of a device tensor.
    """
    if masked_values_output and band_sink is not None:
        raise ValueError("masked_values_output and band_sink are mutually exclusive")
    dev = resolve_device(device)
    img = _host_stack(image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    rep = None
    if replacement is not None:
        rep = _host_stack(replacement)
        rep = rep[None] if squeeze else rep
    mode = "laplace" if replacement is None else "poisson"
    with profiling.span("fill.upload"):
        umask_t = as_tensor(umask, dev, torch.bool)

    c, h, w = img.shape
    step = bands_per_chunk(h, w, max_chunk_elements or chunk_elements(dev))
    deg = neighbor_degree_tensor(h, w, dev)
    hier = None
    if use_multigrid:
        with profiling.span("fill.hierarchy", hierarchy_builds=0):
            hier = multigrid._device_hierarchy(umask_t, deg, dev)

    masked_vals = []
    single_chunk = step >= c
    filled = (
        None
        if (single_chunk or band_sink is not None or masked_values_output)
        else torch.empty((c, h, w), dtype=torch.float32, device=dev)
    )
    total_iters = 0
    err = 0.0
    for s in range(0, c, step):
        e = min(s + step, c)
        with profiling.span("fill.chunk", bands=e - s):
            with profiling.span("fill.upload"):
                chunk = _upload(img, s, e, dev)
                rchunk = chunk if rep is None else _upload(rep, s, e, dev)
            x_hi, x_lo, iters, rnorm, bnorm = _fused_refine_solve(
                chunk, rchunk, umask_t, deg, hier, tolerance,
                max_iterations=max_iterations,
                refinement_steps=max(refinement_steps, 1),
                precond_dtype=multigrid.PRECOND_DTYPE,
                use_multigrid=use_multigrid,
                mode=mode,
            )
            del rchunk
            total_iters += iters
            err = max(err, float(np.max(rnorm / np.maximum(bnorm, 1e-300))))
            if masked_values_output:
                # the indices live past the solve only, so that its peak
                # does not grow with the unknowns
                iy, ix = torch.nonzero(umask_t, as_tuple=True)
                with profiling.span("fill.fetch"):
                    masked_vals.append(_gather_masked(x_hi, x_lo, iy, ix).cpu().numpy())
                del chunk, x_hi, x_lo, iy, ix
                continue
            out = _composite(chunk, x_hi, x_lo, umask_t)
            del chunk, x_hi, x_lo
            if band_sink is not None:
                band_sink(s, e, out)
            elif single_chunk:
                filled = out
            else:
                filled[s:e] = out
            del out
    if masked_values_output:
        with profiling.span("fill.join"):
            vals = np.concatenate(masked_vals, axis=0)
        return CGResult(vals[0] if squeeze else vals, total_iters, err)
    if squeeze and filled is not None:
        filled = filled[0]
    if not device_output and filled is not None:
        with profiling.span("fill.fetch"):
            filled = filled.cpu().numpy()
    return CGResult(filled, total_iters, err)
