"""Sharded matrix-free CG (``satellite_approximation_tpu/parallel/solver.py``).

Bands shard over the 'b' mesh axis (independent systems); image rows over
'x'. Each CG iteration does one halo exchange for the stencil and sums its
dot products over the 'x' shards; the loop runs while any band of any shard
is above its threshold, so every shard takes the same number of steps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .collectives import (
    any_true, axis_index, gather, map_lines, psum, shard, smap, unzip,
)
from .halo import halo_pad_rows
from .mesh import ShardMesh

_TINY = float(np.finfo(np.float32).tiny)
_BANDS_ROWS = ("b", "x", None)
_ROWS = ("x", None)


def neighbour_sum_rows(mesh: ShardMesh, x, axis: str = "x"):
    """Per shard, the sum of the four neighbours in the order up, down,
    left, right: ghost rows from the shards along ``axis``, zero columns
    (the image's left and right edges lie in every shard)."""
    padded = map_lines(mesh, x, axis, halo_pad_rows)

    def local(p, v):
        h, w = v.shape[-2:]
        wpad = F.pad(v, (1, 1))
        return p[..., 0:h, :] + p[..., 2 : h + 2, :] + wpad[..., :, 0:w] + wpad[..., :, 2 : w + 2]

    return smap(local, padded, x)


def stencil_rows(mesh: ShardMesh, u, um, deg, axis: str = "x"):
    """A(u) = deg * u - sum of unknown 4-neighbours, on unknowns, over a row
    mesh: ``u`` (..., H_local, W) shards, ``um`` / ``deg`` (H_local, W)."""
    masked = smap(torch.mul, u, um)
    s = neighbour_sum_rows(mesh, masked, axis)
    return smap(lambda v, s_, m, d: (d * v - s_) * m, u, s, um, deg)


def dots(mesh: ShardMesh, p, q, axes):
    """Per-band dot products over the pixel axes, summed over ``axes``."""
    return psum(mesh, smap(lambda a, c: torch.sum(a * c, dim=(-2, -1)), p, q), axes)


def _threshold(tol: float, bs):
    tt = float(np.float32(tol) * np.float32(tol))
    return smap(lambda s: torch.clamp_min(tt * s, _TINY), bs)


def cg_update(x, r, p, ap, rs, pap):
    """One CG step per band: alpha = rs / pAp (0 where pAp <= 0), then
    x + alpha p and r - alpha Ap."""
    alpha = torch.where(pap > 0, rs / torch.where(pap > 0, pap, 1.0), 0.0)
    a = alpha[..., None, None]
    return x + a * p, r - a * ap


def cg_direction(z, p, rs, num):
    """The next search direction z + beta p, beta = num / rs (0 where
    rs <= 0)."""
    beta = torch.where(rs > 0, num / torch.where(rs > 0, rs, 1.0), 0.0)
    return z + beta[..., None, None] * p


def _cg_body(mesh: ShardMesh, b, x0, um, deg, tol: float, max_iters: int, axis: str):
    """CG over row shards; dots summed over ``axis``, the continue flag over
    every shard."""
    b = smap(torch.mul, b, um)
    x = smap(torch.mul, x0, um)
    r = smap(torch.sub, b, stencil_rows(mesh, x, um, deg, axis))
    p = r
    rs = dots(mesh, r, r, axis)
    threshold = _threshold(tol, dots(mesh, b, b, axis))

    it = 0
    while it < max_iters and any_true(mesh, smap(torch.gt, rs, threshold)):
        ap = stencil_rows(mesh, p, um, deg, axis)
        pap = dots(mesh, p, ap, axis)
        x, r = unzip(smap(cg_update, x, r, p, ap, rs, pap), 2)
        rs_new = dots(mesh, r, r, axis)
        p = smap(cg_direction, r, p, rs, rs_new)
        rs = rs_new
        it += 1
    return x, it, rs


def sharded_masked_cg(b, x0, umask, deg, mesh: ShardMesh, tolerance: float = 1e-6,
                      max_iterations: int = 1000):
    """Solve the masked Poisson system over a ('b', 'x') mesh.

    ``b`` / ``x0`` are (C, H, W), C split over 'b' and H over 'x'; ``umask``
    / ``deg`` are (H, W), split over 'x'. Returns (x, iterations, final
    ||r||^2 per band): x a (C, H, W) f32 tensor and ||r||^2 a (C,) tensor,
    both gathered on the mesh's first device."""
    mesh.require_one_process("sharded_masked_cg")
    f32 = torch.float32
    b_s = shard(mesh, b, _BANDS_ROWS, f32)
    x0_s = shard(mesh, x0, _BANDS_ROWS, f32)
    um = shard(mesh, umask, _ROWS, f32)
    deg_s = shard(mesh, deg, _ROWS, f32)
    x, it, rs = _cg_body(mesh, b_s, x0_s, um, deg_s, tolerance, max_iterations, "x")
    return gather(mesh, x, _BANDS_ROWS), it, gather(mesh, rs, ("b",))


def sharded_training_step(mesh: ShardMesh):
    """One full step of the flagship workload over the mesh: the Poisson
    right-hand side (guidance divergence and boundary injection,
    poisson.cpp:234-254) and a fixed-budget sharded CG solve. Returns
    ``step(inputs, repl, umask) -> (out, ||r||^2 per band)``, inputs
    (C, H, W) and umask (H, W), the outputs gathered on the first device.
    Used by the multi-device dry run."""
    mesh.require_one_process("sharded_training_step")

    def step(inputs, repl, umask):
        f32 = torch.float32
        inp = shard(mesh, inputs, _BANDS_ROWS, f32)
        rep = shard(mesh, repl, _BANDS_ROWS, f32)
        um = shard(mesh, umask, _ROWS, f32)
        n = mesh.shape["x"]

        def degree(m, idx):
            # in-image neighbour count: the image's top and bottom rows lie
            # in the first and last shard only
            h, w = m.shape
            deg = torch.full((h, w), 4.0, dtype=m.dtype, device=m.device)
            deg[:, 0] -= 1.0
            deg[:, -1] -= 1.0
            if idx == 0:
                deg[0, :] -= 1.0
            if idx == n - 1:
                deg[h - 1, :] -= 1.0
            return deg

        deg = smap(degree, um, axis_index(mesh, "x"))
        grad_sum = smap(lambda d, g, s: d * g - s, deg, rep, neighbour_sum_rows(mesh, rep))
        known = smap(lambda v, m: v * (1.0 - m), inp, um)
        b = smap(lambda g, s, m: (g + s) * m, grad_sum, neighbour_sum_rows(mesh, known), um)
        x0 = smap(torch.mul, rep, um)
        x, _, rs = _cg_body(mesh, b, x0, um, deg, 1e-5, 64, "x")
        out = smap(lambda v, xx, m: v * (1.0 - m) + xx * m, inp, x, um)
        return gather(mesh, out, _BANDS_ROWS), gather(mesh, rs, ("b",))

    return step
