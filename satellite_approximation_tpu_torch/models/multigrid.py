"""Mask-aware geometric multigrid for the masked Poisson systems, in PyTorch.

Port of ``satellite_approximation_tpu/models/multigrid.py``; its module
docstring gives the design and the measurements behind it:

* hierarchy: unknown masks coarsen by 2x2 ALL-pooling (a coarse cell is
  unknown only when its whole 2x2 fine block is), with the saturation
  ladder for all-unknown inputs;
* operator on every level: the rediscretized masked 5-point stencil;
  restriction is the 2x2 block sum (rows, then columns) and prolongation
  its transpose, the piecewise-constant block broadcast;
* smoother: K Chebyshev-weighted Jacobi sweeps, natural order before the
  coarse correction and reversed after it;
* coarsest level: the dense inverse of its operator (one mat-vec), or a
  budgeted CG when the coarsest grid is too large for it;
* MG-preconditioned CG with the Fletcher-Reeves beta when the coarse solve
  is exact, Polak-Ribiere otherwise, and A·z recovered from the top
  post-smooth's residual when the V-cycle runs in f32.

On every level above the coarsest, the V-cycle smooths with the hand-written
CUDA kernels (``ops/stencil_kernels.jacobi_zero`` before the coarse
correction, ``jacobi_corr`` with the correction fused in after it); on the
CPU their plain PyTorch versions run. Those plain versions are the JAX
module's ``_smooth``/``_smooth_residual`` XLA sweeps (from zero, and after
the correction add), and ``stencil_kernels.prolong`` is its ``_prolong``.
The V-cycle always starts from u = 0, as every call site of the JAX V-cycle
does, so the nonzero-start smoother has no caller here. Loops are Python loops: the PCG stopping test reads one
flag to the host per iteration.
"""

from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_tensor, resolve_device
from ..ops.stencil_kernels import invm_for_kernel, jacobi_corr, jacobi_zero
from .cg import CGResult, masked_laplacian, neighbor_degree, neighbor_degree_tensor

_OMEGA = 0.8
_PRE_SMOOTH = 7
_POST_SMOOTH = 7
_COARSE_ITERS = 64
_MIN_SIZE = 24
# "chebyshev": each sweep its own weight from the Chebyshev nodes on
# [LAMBDA_MAX/alpha, LAMBDA_MAX]; "jacobi": fixed-omega damped Jacobi
SMOOTHER = "chebyshev"
_CHEB_ALPHA = 4.0
_LAMBDA_MAX = 2.0  # Gershgorin bound of D^-1 A for the masked 5-point stencil

# Per-pass tolerance floors of the inner PCG (the double-float outer loop
# carries the rest): f32 preconditioner, and a reduced-precision one.
INNER_TOL_FLOOR = 1e-4
INNER_TOL_FLOOR_F32 = 3e-7
# V-cycle storage dtype (the kernels compute in f32 either way). The JAX
# package switches to bf16 on grids <= 4096; that switch was measured on a
# TPU, and the port keeps f32 until an H100 measurement decides it.
PRECOND_DTYPE = torch.float32

# Dense-coarse-solve cap, in coarsest-grid cells (a 4096^2 f32 inverse).
_DENSE_COARSE_MAX = 4096


def _smoother_omegas(k: int) -> tuple[float, ...]:
    """Per-sweep weights: the reciprocals of the K Chebyshev nodes on the
    smoothing interval (natural order pre-smoothing, reversed post)."""
    if SMOOTHER != "chebyshev":
        return (_OMEGA,) * k
    lo, hi = _LAMBDA_MAX / _CHEB_ALPHA, _LAMBDA_MAX
    mid, rad = (hi + lo) / 2.0, (hi - lo) / 2.0
    thetas = [mid + rad * math.cos(math.pi * (2 * j - 1) / (2 * k)) for j in range(1, k + 1)]
    return tuple(1.0 / t for t in thetas)


def _allpool(m: torch.Tensor) -> torch.Tensor:
    """2x2 ALL-pool of a bool mask; odd sizes pad with False (known)."""
    h, w = m.shape
    mp = F.pad(m, (0, w % 2, 0, h % 2))
    return (mp[0::2, 0::2] & mp[0::2, 1::2]) & (mp[1::2, 0::2] & mp[1::2, 1::2])


def _build_levels(m0: torch.Tensor):
    """Coarse (umask, deg) levels, computed on the mask's device. Once a
    level has no known cell (only possible for an all-unknown input) every
    level from there on takes deg = 4 (an implicit Dirichlet ring outside
    the image) so the coarse operator stays nonsingular."""
    out = []
    m = m0
    sat = torch.zeros((), dtype=torch.bool, device=m0.device)
    while min(m.shape) > _MIN_SIZE:
        m2 = _allpool(m)
        sat = sat | m2.all()
        h2, w2 = m2.shape
        deg2 = torch.where(sat, 4.0, neighbor_degree_tensor(h2, w2, m0.device))
        out.append((m2, deg2))
        m = m2
    return tuple(out)


def build_hierarchy(umask: np.ndarray, deg: np.ndarray):
    """Host (numpy) builder: (umask, deg) per level, finest first — the
    reference the device builder :func:`_build_levels` is held against."""
    levels = [(np.asarray(umask, bool), np.asarray(deg, np.float32))]
    m = np.asarray(umask, bool)
    while min(m.shape) > _MIN_SIZE:
        h, w = m.shape
        ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
        mp = np.zeros((ph, pw), dtype=bool)
        mp[:h, :w] = m
        pooled = mp.reshape(ph // 2, 2, pw // 2, 2).all(axis=(1, 3))
        if pooled.all():
            m = pooled
            while True:
                levels.append((m, np.full(m.shape, 4.0, dtype=np.float32)))
                if min(m.shape) <= _MIN_SIZE:
                    break
                h2, w2 = m.shape
                m = np.ones(((h2 + 1) // 2, (w2 + 1) // 2), dtype=bool)
            return levels
        m = pooled
        levels.append((m, neighbor_degree(m.shape)))
    return levels


class Hierarchy(NamedTuple):
    """(umask, deg) per level, finest first, plus the dense inverse of the
    coarsest operator (None when the coarsest grid exceeds
    ``_DENSE_COARSE_MAX`` cells)."""

    levels: tuple
    coarse_inv: Optional[torch.Tensor]


def _dense_coarse_inverse(m: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """inv(A) of the coarsest masked 5-point operator, dense f32. Rows and
    columns of known cells are identity (their residual is zero)."""
    hc, wc = m.shape
    n = hc * wc
    mflat = m.reshape(-1)
    diag = torch.where(mflat, deg.reshape(-1).to(torch.float32), 1.0)
    a = torch.diag(diag)
    idx = torch.arange(n, device=m.device).reshape(hc, wc)

    def link(p, q, ok):
        val = torch.where(ok, -1.0, 0.0)
        a.index_put_((p, q), val, accumulate=True)
        a.index_put_((q, p), val, accumulate=True)

    link(idx[:-1, :].reshape(-1), idx[1:, :].reshape(-1), (m[:-1, :] & m[1:, :]).reshape(-1))
    link(idx[:, :-1].reshape(-1), idx[:, 1:].reshape(-1), (m[:, :-1] & m[:, 1:]).reshape(-1))
    return torch.linalg.inv(a)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """R = P^T: 2x2 block sum to the coarser grid after padding odd sizes to
    even — rows first, then columns (the reference's pair order)."""
    h, w = r.shape[-2], r.shape[-1]
    rp = F.pad(r, (0, w % 2, 0, h % 2))
    rows = rp[..., 0::2, :] + rp[..., 1::2, :]
    return rows[..., :, 0::2] + rows[..., :, 1::2]


def _coarse_solve(b, um, deg, coarse_inv):
    """e with A e = b on the coarsest level's unknowns, from e = 0: one dense
    mat-vec, or a CG budgeted by the grid's diameter (oversized coarse
    grids only; a fixed budget starves a large all-unknown coarsest level)."""
    umf = um.to(b.dtype)
    r = b * umf
    if coarse_inv is not None:
        n = um.shape[-2] * um.shape[-1]
        rb = r.reshape(*r.shape[:-2], n).to(torch.float32)
        e = (rb @ coarse_inv.T).to(b.dtype).reshape(r.shape)
        return e * umf
    x = torch.zeros_like(b)
    p = r
    rs = torch.sum(r * r, dim=(-2, -1))
    for _ in range(max(_COARSE_ITERS, 4 * max(um.shape))):
        ap = masked_laplacian(p, um, deg)
        pap = torch.sum(p * ap, dim=(-2, -1))
        alpha = torch.where(pap > 0, rs / torch.where(pap > 0, pap, 1.0), 0.0)
        a = alpha[..., None, None]
        x = x + a * p
        r = r - a * ap
        rs_new = torch.sum(r * r, dim=(-2, -1))
        beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[..., None, None] * p
        rs = rs_new
    return x


class Prebuilt(NamedTuple):
    """A hierarchy in the V-cycle's storage dtype: (umask, deg) per level and
    the kernels' invm operand of every level above the coarsest. Built once
    per solve, outside the iteration loops."""

    levels: tuple
    invms: tuple
    coarse_inv: Optional[torch.Tensor]


def prebuild(hier: Hierarchy, dtype: torch.dtype) -> Prebuilt:
    levels = tuple((m, d.to(dtype)) for m, d in hier.levels)
    invms = tuple(invm_for_kernel(m, d).to(dtype) for m, d in levels[:-1])
    return Prebuilt(levels, invms, hier.coarse_inv)


def _v_cycle(pb: Prebuilt, b: torch.Tensor, lvl: int = 0, emit_top_residual: bool = False):
    """One V-cycle from u = 0 on level ``lvl``: returns u, or with
    ``emit_top_residual`` (u, (b - A u) * m) — the residual comes out of
    the top post-smooth kernel, and PCG turns it into A·u."""
    um, deg = pb.levels[lvl]
    if lvl == len(pb.levels) - 1:
        e = _coarse_solve(b, um, deg, pb.coarse_inv)
        if emit_top_residual:  # single-level hierarchies: the coarse solve is the top
            return e, (b - masked_laplacian(e, um, deg)) * um.to(e.dtype)
        return e
    pre = _smoother_omegas(_PRE_SMOOTH)
    post = tuple(reversed(_smoother_omegas(_POST_SMOOTH)))
    invm = pb.invms[lvl]
    u, r = jacobi_zero(b, invm, pre, emit_residual=True)
    um_c = pb.levels[lvl + 1][0]
    r_c = _restrict(r) * um_c.to(r.dtype)
    e_c = _v_cycle(pb, r_c, lvl + 1)
    return jacobi_corr(u, b, invm, e_c, post, emit_residual=emit_top_residual)


def _pcg_core(b, x0, tol, hier: Hierarchy, max_iterations: int,
              precond_dtype=torch.float32, prebuilt: Prebuilt | None = None):
    """MG-preconditioned CG over (..., H, W) batches, from ``x0``, until every
    band has ||r||^2 <= tol^2 ||b||^2 or ``max_iterations``. Returns
    (x, iterations, ||r||^2 / ||b||^2 per band)."""
    levels, coarse_inv = hier.levels, hier.coarse_inv
    um0, deg0 = levels[0]
    pb = prebuilt if prebuilt is not None else prebuild(hier, precond_dtype)
    # A·z from the top post-smooth only when the V-cycle runs in f32: a
    # reduced-precision az would leave its rounding in the r recurrence
    use_az = precond_dtype == torch.float32

    def precond(r):
        if not use_az:
            return _v_cycle(pb, r.to(precond_dtype)).to(r.dtype), None
        z, res = _v_cycle(pb, r.to(precond_dtype), emit_top_residual=True)
        return z.to(r.dtype), r - res.to(r.dtype)

    def dots(a, c):
        return torch.sum(a * c, dim=(-2, -1))

    tiny = torch.finfo(b.dtype).tiny
    umf = um0.to(b.dtype)
    b = b * umf
    x = x0 * umf
    r = (b - masked_laplacian(x, um0, deg0)) * umf
    z, az = precond(r)
    p = z
    ap = az if use_az else masked_laplacian(p, um0, deg0)
    rz = dots(r, z)
    bs = dots(b, b)
    tt = float(np.float32(tol) * np.float32(tol))
    threshold = torch.clamp_min(tt * bs, tiny)
    it = 0
    while it < max_iterations and bool((dots(r, r) > threshold).any()):
        pap = dots(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        a = alpha[..., None, None]
        x = x + a * p
        r_new = r - a * ap
        z_new, az_new = precond(r_new)
        rz_new = dots(r_new, z_new)
        if coarse_inv is not None:
            # with the exact dense coarse solve the V-cycle is a fixed linear
            # operator: Fletcher-Reeves is valid, one full-raster dot fewer
            beta_num = rz_new
        else:
            # flexible (Polak-Ribiere): robust to the coarse CG's nonlinearity
            beta_num = rz_new - dots(r, z_new)
        beta = torch.where(rz > 0, beta_num / torch.where(rz > 0, rz, 1.0), 0.0)
        bc = beta[..., None, None]
        p = z_new + bc * p
        ap = az_new + bc * ap if use_az else masked_laplacian(p, um0, deg0)
        r, z, rz = r_new, z_new, rz_new
        it += 1
    return x, it, dots(r, r) / torch.clamp_min(bs, tiny)


# Repeated solves on one mask (multi-date fills, refinement passes, chunks)
# reuse its hierarchy. LRU, keyed by the mask's exact bits and device.
_HIERARCHY_CACHE: OrderedDict = OrderedDict()
_HIERARCHY_CACHE_CAP = 8


def _mask_key(umask, device: torch.device):
    """(device, shape, the mask's bits packed 8 to a byte in np.packbits
    order). A tensor mask is packed on its own device, so only an eighth of
    it crosses to the host (15 MB for a full tile instead of 120 MB)."""
    if isinstance(umask, torch.Tensor):
        flat = umask.reshape(-1).to(torch.uint8)
        flat = F.pad(flat, (0, (-flat.numel()) % 8))
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=flat.device)
        packed = (flat.reshape(-1, 8) << shifts).sum(dim=1, dtype=torch.uint8)
        return (str(device), tuple(umask.shape), packed.cpu().numpy().tobytes())
    m = np.asarray(umask, dtype=bool)
    return (str(device), m.shape, np.packbits(m).tobytes())


def _device_hierarchy(umask, deg: torch.Tensor, device: torch.device) -> Hierarchy:
    """:class:`Hierarchy` on ``device``: level 0 is (umask, the caller's
    ``deg``), coarse levels are built on the device, cached per mask."""
    key = _mask_key(umask, device)
    cached = _HIERARCHY_CACHE.get(key)
    if cached is not None:
        _HIERARCHY_CACHE.move_to_end(key)
        # coarse levels depend on the mask alone; a single-level hierarchy's
        # dense inverse depends on level 0's deg too
        levels = ((cached.levels[0][0], deg),) + cached.levels[1:]
        coarse_inv = cached.coarse_inv
        if len(levels) == 1 and coarse_inv is not None:
            coarse_inv = _dense_coarse_inverse(levels[0][0], deg)
        return Hierarchy(levels, coarse_inv)
    umask_t = as_tensor(umask, device, torch.bool)
    levels = ((umask_t, deg),) + _build_levels(umask_t)
    m_c, d_c = levels[-1]
    coarse_inv = _dense_coarse_inverse(m_c, d_c) if m_c.numel() <= _DENSE_COARSE_MAX else None
    hier = Hierarchy(levels, coarse_inv)
    _HIERARCHY_CACHE[key] = hier
    while len(_HIERARCHY_CACHE) > _HIERARCHY_CACHE_CAP:
        _HIERARCHY_CACHE.popitem(last=False)
    return hier


def solve(
    b,
    umask,
    deg=None,
    x0=None,
    tolerance: float = 1e-6,
    refinement_steps: int = 2,
    max_iterations: int = 200,
    device_output: bool = False,
    device=None,
) -> CGResult:
    """MG-preconditioned CG inside the double-float refinement loop: solve
    A x = b on ``umask``'s unknowns to ``tolerance`` relative residual.
    ``b`` is (H, W) or (C, H, W), numpy or tensor; the solution carries
    ~2^-48 relative precision, so tolerances below ~1e-14 cannot converge
    (the returned ``error`` reports what was reached)."""
    from .fill import _fused_refine_solve, _recombine64

    if tolerance < 1e-13:
        warnings.warn(
            f"tolerance={tolerance:g} is below the double-float solver's ~1e-14 relative "
            "precision floor; convergence will stall there",
            stacklevel=2,
        )
    dev = resolve_device(device)
    b64 = as_tensor(b, dev, torch.float64)
    squeeze = b64.dim() == 2
    if squeeze:
        b64 = b64[None]
    h, w = b64.shape[-2:]
    deg_t = neighbor_degree_tensor(h, w, dev) if deg is None else as_tensor(deg, dev, torch.float32)
    # the hierarchy rediscretizes with in-image degrees; a custom fine-level
    # deg only changes the fine operator
    hier = _device_hierarchy(umask, deg_t, dev)
    umask_t = hier.levels[0][0]
    umf = umask_t.to(torch.float64)
    x064 = torch.zeros_like(b64) if x0 is None else as_tensor(x0, dev, torch.float64).reshape(
        b64.shape
    ) * umf
    x_hi, x_lo, iters, rnorm, bnorm = _fused_refine_solve(
        b64, x064, umask_t, deg_t, hier, tolerance,
        max_iterations=max_iterations,
        refinement_steps=max(refinement_steps, 1),
        precond_dtype=PRECOND_DTYPE, use_multigrid=True, mode="rhs",
    )
    x = _recombine64(x_hi, x_lo)
    x = x[0] if squeeze else x
    rel = float(np.max(rnorm / np.maximum(bnorm, 1e-300)))
    return CGResult(x if device_output else x.cpu().numpy(), iters, rel)
