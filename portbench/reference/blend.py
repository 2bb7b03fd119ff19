"""The plain reference of the Poisson blend, in plain PyTorch.

The blend of a replacement (guidance) stack ``g`` into ``images`` (C, H, W)
over the invalid mask U (H, W) solves, for every pixel p of U (border pixels
included),

    |N(p)| u_p - sum_{q in N(p) & U} u_q
        = sum_{q in N(p)} (g_p - g_q) + sum_{q in N(p) - U} images_q

with N(p) the in-image 4-neighbourhood, and keeps every pixel off U as it
is: the mask overload of Poisson image editing (Perez et al.) in the
upstream ``source/poisson.cpp:145-290``. This module works the system out
again from the raw inputs, judges a blended stack by the relative residual
of that system in float64, and solves it itself with plain conjugate
gradients warm-started from the replacement, in any precision (the control
runs it in float32). It imports nothing of the program under test.

Where it departs from ``poisson.cpp:145-290``:

* it solves every band at once (one CG over the stack, each band with its
  own step lengths and stopping test), where the upstream loops over the
  channels with one Eigen solver;
* it stops when every band's recursively updated residual is at most
  ``tolerance`` times its ||b|| (Eigen's criterion, applied per band) or at
  ``max_iterations``, without Eigen's diagonal preconditioner;
* it writes no ``PerfInfo`` CSV and logs nothing.

No matrix product or convolution runs here, so TF32 cannot enter; both of
PyTorch's TF32 switches are held False while it computes all the same.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def unknowns(invalid: torch.Tensor) -> torch.Tensor:
    """The unknown set: the invalid mask as it is, border pixels included."""
    return invalid.clone()


def _neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the four in-image neighbours of (..., H, W), zero outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., :h, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :w] + p[..., 1:-1, 2:]


def degree(h: int, w: int, dtype, device) -> torch.Tensor:
    """|N(p)|: the in-image neighbours of each pixel (4 inside, 3 on an
    edge, 2 in a corner)."""
    return _neighbour_sum(torch.ones((h, w), dtype=dtype, device=device))


def rhs(band: torch.Tensor, guide: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """b on the unknowns: the guidance's gradients towards every in-image
    neighbour plus the known neighbours' values."""
    deg = degree(*band.shape[-2:], band.dtype, band.device)
    grads = deg * guide - _neighbour_sum(guide)
    return (grads + _neighbour_sum(torch.where(um, 0.0, band))) * um


def apply(x: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """A x on the unknowns: |N(p)| x_p - the sum of the unknown neighbours."""
    deg = degree(*x.shape[-2:], x.dtype, x.device)
    xm = torch.where(um, x, 0.0)
    return (deg * xm - _neighbour_sum(xm)) * um


def judge(images: np.ndarray, replacement: np.ndarray, invalid: np.ndarray, out: np.ndarray,
          device) -> dict:
    """Readings of one blended stack against the system of ``images``,
    ``replacement`` and ``invalid``, band by band in float64 on ``device``:

    * ``residual``: the largest ||b - A x|| / ||b|| over the bands, x the
      blended values on the unknowns (inf where a value is not finite);
    * ``known_changed``: pixels off the unknown set whose value differs
      from the input (an exact comparison).
    """
    with _no_tf32():
        um = unknowns(torch.as_tensor(np.asarray(invalid, bool), device=device))
        worst, changed = 0.0, 0
        for c in range(images.shape[0]):
            img = torch.as_tensor(np.asarray(images[c], np.float64), device=device)
            guide = torch.as_tensor(np.asarray(replacement[c], np.float64), device=device)
            got = torch.as_tensor(np.asarray(out[c], np.float64), device=device)
            changed += int(((got != img) & ~um).sum())
            x = torch.where(um, got, 0.0)
            if not bool(torch.isfinite(x).all()):
                worst = float("inf")
                continue
            b = rhs(img, guide, um)
            bn = float(torch.linalg.vector_norm(b))
            rn = float(torch.linalg.vector_norm(b - apply(x, um)))
            worst = max(worst, rn / bn if bn > 0 else (0.0 if rn == 0 else float("inf")))
    return {"residual": worst, "known_changed": changed}


def solve(images: np.ndarray, replacement: np.ndarray, invalid: np.ndarray, dtype, device,
          tolerance: float, max_iterations: int) -> np.ndarray:
    """The blended stack by plain CG on every band at once, in ``dtype``,
    from the replacement's values on the unknowns, until every band's
    ||r|| <= tolerance ||b|| or ``max_iterations``; known pixels are copied
    through from ``images``."""
    with _no_tf32():
        um = unknowns(torch.as_tensor(np.asarray(invalid, bool), device=device))
        img = torch.as_tensor(np.asarray(images), device=device).to(dtype)
        guide = torch.as_tensor(np.asarray(replacement), device=device).to(dtype)
        b = rhs(img, guide, um)
        x = torch.where(um, guide, 0.0)
        r = b - apply(x, um)
        p = r.clone()
        rs = (r * r).sum(dim=(-2, -1))
        stop = (tolerance ** 2) * (b * b).sum(dim=(-2, -1))
        for _ in range(max_iterations):
            if bool((rs <= stop).all()):
                break
            ap = apply(p, um)
            pap = (p * ap).sum(dim=(-2, -1))
            alpha = torch.where(pap > 0, rs / torch.where(pap > 0, pap, 1.0), 0.0)[:, None, None]
            x += alpha * p
            r -= alpha * ap
            rs_new = (r * r).sum(dim=(-2, -1))
            beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)[:, None, None]
            p = r + beta * p
            rs = rs_new
        return torch.where(um, x, img).to(torch.float64).cpu().numpy()
