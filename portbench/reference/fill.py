"""The plain reference of the Laplace gap fill, in plain PyTorch.

The fill of bands ``images`` (C, H, W) over the invalid mask (H, W) solves,
for every unknown pixel p (an invalid pixel off the image border),

    4 u_p - sum_{q in N4(p), q unknown} u_q = sum_{q in N4(p), q known} images_q

and keeps every other pixel as it is. This module works the unknown set and
the system out again from the raw inputs, judges a filled stack by the
relative residual of that system in float64, and solves it itself with
plain conjugate gradients, in any precision (the control runs it in float32).
It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def unknowns(invalid: torch.Tensor) -> torch.Tensor:
    """The invalid pixels off the image border (the border stays known)."""
    u = invalid.clone()
    u[0, :] = False
    u[-1, :] = False
    u[:, 0] = False
    u[:, -1] = False
    return u


def _neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the four in-image neighbours of (..., H, W), zero outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return p[..., :h, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :w] + p[..., 1:-1, 2:]


def rhs(band: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """b: the sum of the known neighbours' values, on the unknowns."""
    return _neighbour_sum(torch.where(um, 0.0, band)) * um


def apply(x: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """A x on the unknowns: 4 x - the sum of the unknown neighbours."""
    xm = torch.where(um, x, 0.0)
    return (4.0 * xm - _neighbour_sum(xm)) * um


def judge(images: np.ndarray, invalid: np.ndarray, filled: np.ndarray, device) -> dict:
    """Readings of one filled stack against the system of ``images`` and
    ``invalid``, band by band in float64 on ``device``:

    * ``residual``: the largest ||b - A x|| / ||b|| over the bands, x the
      filled values on the unknowns (inf where a value is not finite);
    * ``known_changed``: pixels off the unknown set whose value differs
      from the input (an exact comparison).
    """
    inv = torch.as_tensor(np.asarray(invalid, bool), device=device)
    um = unknowns(inv)
    worst, changed = 0.0, 0
    for c in range(images.shape[0]):
        img = torch.as_tensor(np.asarray(images[c], np.float64), device=device)
        out = torch.as_tensor(np.asarray(filled[c], np.float64), device=device)
        changed += int(((out != img) & ~um).sum())
        x = torch.where(um, out, 0.0)
        if not bool(torch.isfinite(x).all()):
            worst = float("inf")
            continue
        b = rhs(img, um)
        bn = float(torch.linalg.vector_norm(b))
        rn = float(torch.linalg.vector_norm(b - apply(x, um)))
        worst = max(worst, rn / bn if bn > 0 else (0.0 if rn == 0 else float("inf")))
    return {"residual": worst, "known_changed": changed}


def solve(images: np.ndarray, invalid: np.ndarray, dtype, device, tolerance: float,
          max_iterations: int) -> np.ndarray:
    """The filled stack by plain CG on every band at once, in ``dtype``,
    from the input values, until every band's ||r|| <= tolerance ||b|| or
    ``max_iterations``; known pixels are copied through. In float32 the
    true residual stalls orders of magnitude above 1e-9."""
    inv = torch.as_tensor(np.asarray(invalid, bool), device=device)
    um = unknowns(inv)
    img = torch.as_tensor(np.asarray(images), device=device).to(dtype)
    b = rhs(img, um)
    x = torch.where(um, img, 0.0)
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
