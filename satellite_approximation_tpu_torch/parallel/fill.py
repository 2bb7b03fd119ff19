"""Image fill over a mesh of shards (``satellite_approximation_tpu/parallel/fill.py``).

The image-in / image-out contract of ``models/fill.laplace_fill`` over a
:class:`ShardMesh`: assemble the masked Laplace (or Poisson-editing)
right-hand side in f64 on the host, solve it with the sharded MG-PCG and
its f64 refinement (:mod:`.mg`), and composite the known pixels back.
Rows shard over 'x' (or rows over 'y' and columns over 'x' on a 2-D mesh),
bands over 'b'.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import as_tensor
from ..models.cg import free_device_bytes, neighbor_degree
from .mesh import ShardMesh
from .mg import sharded_mg_solve, sharded_mg_solve_2d

# Bytes of sharded solver state a band-pixel, spread over the shards: the
# f64 right-hand side, iterate and residual of the refinement, the f32 PCG
# vectors, the distributed levels and their halo-padded copies, with margin
# (four shards of one 10980^2 band peak near 160 B a band-pixel on one card).
_STATE_BYTES_PER_ELEMENT = 192
# On the mesh's first device: a chunk's gathered f64 solution, its image and
# the composite's temporaries.
_GATHER_BYTES_PER_ELEMENT = 32


def _shift_sum_np(x: np.ndarray) -> np.ndarray:
    """Sum of in-image 4-neighbours (zero outside), host-side."""
    h, w = x.shape[-2], x.shape[-1]
    p = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])
    return (
        p[..., 0:h, 1 : w + 1]
        + p[..., 2 : h + 2, 1 : w + 1]
        + p[..., 1 : h + 1, 0:w]
        + p[..., 1 : h + 1, 2 : w + 2]
    )


def chunk_bands(mesh: ShardMesh, c: int, h: int, w: int,
                max_chunk_elements: int | None = None) -> int:
    """Bands one sharded solve may hold, a multiple of the mesh's 'b' axis.

    Each CUDA device of the mesh holds its shards' share of the solver state
    (:data:`_STATE_BYTES_PER_ELEMENT` a band-pixel) in 80 % of its free
    memory; the first device also holds the whole f64 composite and a
    chunk's gathered solution and image. ``max_chunk_elements`` (band-pixels)
    replaces the estimate; on the CPU the bands solve in one chunk."""
    bdim = mesh.shape["b"]
    limit = max_chunk_elements
    if limit is None:
        limit = sys.maxsize
        devs = list(mesh.devices.reshape(-1))
        for d in mesh.distinct_devices():
            if d.type != "cuda":
                continue
            free = 0.8 * free_device_bytes(d)
            cost = _STATE_BYTES_PER_ELEMENT * devs.count(d) / mesh.size
            if d == mesh.first_device:
                free -= 8 * c * h * w
                cost += _GATHER_BYTES_PER_ELEMENT
            limit = min(limit, int(max(free, 0) / cost))
    per = max(int(limit) // (h * w) // bdim, 1) * bdim
    return min(per, -(-c // bdim) * bdim)


def _solve_chunk(img, replacement, um, deg, mesh, tolerance, max_iterations):
    """One band chunk: the f64 right-hand side and warm start on the host,
    zero bands to a multiple of 'b', the sharded solve; returns its f64
    solution (C, H, W) on the mesh's first device."""
    umf = um.astype(np.float64)
    dirichlet = _shift_sum_np(img * (1.0 - umf)) * umf
    if replacement is None:
        b = dirichlet
        x0 = img * umf
    else:
        b = (deg.astype(np.float64) * replacement - _shift_sum_np(replacement)) * umf + dirichlet
        x0 = replacement * umf

    # the band axis must divide over 'b': zero bands pad it (their systems
    # are converged from the start) and are cut off after
    bdim = mesh.shape["b"]
    c = b.shape[0]
    cp = -(-c // bdim) * bdim
    if cp != c:
        zpad = [(0, cp - c), (0, 0), (0, 0)]
        b = np.pad(b, zpad)
        x0 = np.pad(x0, zpad)

    solve = sharded_mg_solve_2d if "y" in mesh.axis_names else sharded_mg_solve
    # b and x0 go to the solver in f64: its refinement certifies the f64
    # system, not its f32 rounding
    x, iters, rel = solve(b, x0, um, deg, mesh, tolerance=tolerance,
                          max_iterations=max_iterations)
    return x[:c], iters, float(np.max(np.asarray(rel)[:c]))


def sharded_fill(image, umask, mesh: ShardMesh, replacement=None, tolerance: float = 1e-6,
                 max_iterations: int = 100, max_chunk_elements: int | None = None):
    """Fill ``image`` where ``umask`` is True, distributed over ``mesh``.

    ``image``: (C, H, W) or (H, W); ``umask``: (H, W) bool. With
    ``replacement`` the system is Poisson editing (guidance-divergence
    right-hand side and Dirichlet boundary, poisson.cpp:103-123; warm start
    from the replacement, :231-257); without it, the Laplace fill
    (laplace.cpp:71-106; warm start from the image). Bands solve in chunks
    that fit the mesh's devices (:func:`chunk_bands`); the host assembles
    one chunk's f64 system at a time.

    Returns (filled, iterations, max relative residual). ``filled`` is ONE
    f64 tensor of ``image``'s shape on the mesh's first device: the solve
    gathers its shards before it cuts the padding off, so the composite is
    made whole there. Iterations add up over the chunks."""
    mesh.require_one_process("sharded_fill")
    img = np.asarray(image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    rep = None
    if replacement is not None:
        rep = np.asarray(replacement)
        if squeeze:
            rep = rep[None]
    um = np.asarray(umask, bool)
    deg = neighbor_degree(um.shape)
    c, h, w = img.shape
    step = chunk_bands(mesh, c, h, w, max_chunk_elements)
    dev = mesh.first_device
    umf_t = as_tensor(um.astype(np.float64), dev)
    filled = None if step >= c else torch.empty((c, h, w), dtype=torch.float64, device=dev)
    iters, rel = 0, 0.0
    for s in range(0, c, step):
        e = min(s + step, c)
        chunk = np.asarray(img[s:e], np.float64)
        x, it, r = _solve_chunk(chunk, None if rep is None else np.asarray(rep[s:e], np.float64),
                                um, deg, mesh, tolerance, max_iterations)
        iters += it
        rel = max(rel, r)
        out = as_tensor(chunk, dev) * (1.0 - umf_t) + x * umf_t
        if filled is None:
            filled = out
        else:
            filled[s:e] = out
        del x, out
    if squeeze:
        filled = filled[0]
    return filled, iters, rel
