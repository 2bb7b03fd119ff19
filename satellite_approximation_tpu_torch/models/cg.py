"""Matrix-free masked-Laplacian conjugate gradient, in PyTorch.

Port of ``satellite_approximation_tpu/models/cg.py``. The operator

    A(u)[p] = deg[p] * u[p] - sum_{q in N4(p), q unknown} u[q]

is never materialized: it is five shifted adds over (..., H, W) tensors, with
the bands as a leading batch dimension. CG runs in f32; the outer
double-float refinement loop (models/fill.py) restores f64-grade accuracy.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..ops.stencil_kernels import _shift_taps

_TINY32 = torch.finfo(torch.float32).tiny

# Bytes of solver state per band-pixel while a multigrid chunk solves: the f32
# rasters of the refinement pair and its residual, the PCG vectors, the
# V-cycle's level-0 smoother outputs and the coarser levels (~1/3 more), with
# margin. Chunks are sized from the free device memory, not from a fixed
# element count.
_STATE_BYTES_PER_ELEMENT = 128

# A band of this many pixels keeps the card busy alone: more bands in its
# chunk gain no rate (10980² bands solve as fast in one-band chunks as in
# two-band ones on an H100) and each holds its own solver state.
BAND_BATCH_PIXELS = 1 << 26


def free_device_bytes(device: torch.device) -> int:
    """Device memory a solve may take: the free bytes CUDA reports plus the
    caching allocator's reserved but unused blocks, so that the chunks do
    not depend on what earlier calls left reserved."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def chunk_elements(device: torch.device) -> int:
    """Band-pixels one chunk may hold: 80% of :func:`free_device_bytes` over
    the state bytes per pixel; unbounded on the CPU (one chunk)."""
    if device.type != "cuda":
        return sys.maxsize
    return max(int(0.8 * free_device_bytes(device)) // _STATE_BYTES_PER_ELEMENT, 1)


def bands_per_chunk(h: int, w: int, limit: int) -> int:
    """Bands of (h, w) rasters one chunk holds within ``limit`` band-pixels,
    at least one; one alone once a band has :data:`BAND_BATCH_PIXELS`."""
    if h * w >= BAND_BATCH_PIXELS:
        return 1
    return max(int(limit) // (h * w), 1)


def neighbor_degree(shape: tuple[int, int]) -> np.ndarray:
    """Number of in-image 4-neighbours per pixel: 4 interior, 3 edge,
    2 corner."""
    deg = np.full(shape, 4.0, dtype=np.float32)
    deg[0, :] -= 1
    deg[-1, :] -= 1
    deg[:, 0] -= 1
    deg[:, -1] -= 1
    return deg


def neighbor_degree_tensor(h: int, w: int, device: torch.device) -> torch.Tensor:
    """:func:`neighbor_degree` built on ``device`` (no host raster upload)."""
    ii = torch.arange(h, device=device)[:, None]
    jj = torch.arange(w, device=device)[None, :]
    edge = (
        (ii == 0).float() + (ii == h - 1).float() + (jj == 0).float() + (jj == w - 1).float()
    )
    return 4.0 - edge


def shift_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the four in-image neighbours (zero outside), batched over
    leading axes, in the order up, down, left, right."""
    up, down, left, right = _shift_taps(x)
    return ((up + down) + left) + right


def masked_laplacian(u: torch.Tensor, umask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """A(u) restricted to the unknown set: deg*u - sum of unknown neighbours.
    ``u`` is (..., H, W); ``umask``/``deg`` are (H, W)."""
    um = umask.to(u.dtype)
    au = deg.to(u.dtype) * u - shift_sum(u * um)
    return au * um


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-band dot over the pixel axes, f32 accumulate."""
    return torch.sum(a * b, dim=(-2, -1))


def _threshold(tolerance, bs: torch.Tensor) -> torch.Tensor:
    """tol^2 * ||b||^2 in f32 (tol^2 rounded to f32 first, as the reference
    computes it), floored at the smallest normal f32."""
    tt = float(np.float32(tolerance) * np.float32(tolerance))
    return torch.clamp_min(tt * bs, _TINY32)


@dataclasses.dataclass
class CGResult:
    x: object  # np.ndarray or torch.Tensor
    iterations: int
    error: float  # final relative residual ||b - Ax|| / ||b|| (f64, true)


def _cg_core(b, x0, umask, deg, tolerance, max_iterations: int):
    """Batched CG over (..., H, W); all bands share A and iterate until every
    band satisfies ||r||^2 <= tol^2 ||b||^2 (Eigen's criterion) or
    ``max_iterations``. The stopping test reads one flag to the host per
    iteration."""
    um = umask.to(b.dtype)
    b = b * um
    x = x0 * um
    r = b - masked_laplacian(x, umask, deg)
    p = r
    rs = _dots(r, r)
    bs = _dots(b, b)
    threshold = _threshold(tolerance, bs)
    it = 0
    while it < max_iterations and bool((rs > threshold).any()):
        ap = masked_laplacian(p, umask, deg)
        pap = _dots(p, ap)
        alpha = torch.where(pap > 0, rs / torch.where(pap > 0, pap, 1.0), 0.0)
        a = alpha[..., None, None]
        x = x + a * p
        r = r - a * ap
        rs_new = _dots(r, r)
        beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[..., None, None] * p
        rs = rs_new
        it += 1
    return x, it, torch.sqrt(rs / torch.clamp_min(bs, _TINY32))


def solve_banded_chunks(solve_fn, b, device=None, **kwargs) -> CGResult:
    """Split a (C, H, W) system into band chunks that fit device memory and
    solve them in turn; ``solve_fn(b_chunk, device=..., **kwargs)``."""
    dev = resolve_device(device)
    c, h, w = b.shape
    step = bands_per_chunk(h, w, chunk_elements(dev))
    if step >= c:
        return solve_fn(b, device=dev, **kwargs)
    xs = []
    iters = 0
    err = 0.0
    x0 = kwargs.pop("x0", None)
    for s in range(0, c, step):
        e = min(s + step, c)
        sub_kwargs = dict(kwargs)
        if x0 is not None:
            sub_kwargs["x0"] = x0[s:e]
        res = solve_fn(b[s:e], device=dev, **sub_kwargs)
        xs.append(res.x)
        iters += res.iterations
        err = max(err, res.error)
    if any(isinstance(x, torch.Tensor) for x in xs):
        x_all = torch.cat([torch.as_tensor(x) for x in xs], dim=0)
    else:
        x_all = np.concatenate(xs, axis=0)
    return CGResult(x_all, iters, err)


def solve_masked_poisson(
    b,
    umask,
    x0=None,
    deg=None,
    tolerance: float = 1e-6,
    max_iterations: int | None = None,
    refinement_steps: int = 2,
    device_output: bool = False,
    device=None,
) -> CGResult:
    """Solve A u = b over the unknown set ``umask`` with plain f32 CG inside
    the double-float refinement loop.

    ``b`` may be (H, W) or (C, H, W); bands solve together.
    ``max_iterations`` defaults to n_unknowns/2, the reference's Poisson
    default.
    """
    from .fill import _fused_refine_solve, _recombine64

    dev = resolve_device(device)
    b64 = as_tensor(b, dev, torch.float64)
    squeeze = b64.dim() == 2
    if squeeze:
        b64 = b64[None]
    umask_t = as_tensor(umask, dev, torch.bool)
    h, w = umask_t.shape
    deg_t = (
        neighbor_degree_tensor(h, w, dev) if deg is None else as_tensor(deg, dev, torch.float32)
    )
    n_unknowns = int(umask_t.sum())
    if max_iterations is None:
        max_iterations = max(n_unknowns // 2, 1)
    if n_unknowns == 0:
        x = torch.zeros(b64.shape, dtype=torch.float64, device=dev)
        x = x[0] if squeeze else x
        return CGResult(x if device_output else x.cpu().numpy(), 0, 0.0)

    umf = umask_t.to(torch.float64)
    x064 = torch.zeros_like(b64) if x0 is None else as_tensor(x0, dev, torch.float64).reshape(
        b64.shape
    ) * umf
    x_hi, x_lo, iters, rnorm, bnorm = _fused_refine_solve(
        b64, x064, umask_t, deg_t, None, tolerance,
        max_iterations=max_iterations,
        refinement_steps=max(refinement_steps, 1),
        precond_dtype=torch.float32, use_multigrid=False, mode="rhs",
    )
    x = _recombine64(x_hi, x_lo)
    x = x[0] if squeeze else x
    rel = float(np.max(rnorm / np.maximum(bnorm, 1e-300)))
    return CGResult(x if device_output else x.cpu().numpy(), iters, rel)
