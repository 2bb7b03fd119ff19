"""Sharded detection stencils (``satellite_approximation_tpu/parallel/stencils.py``).

* :func:`sharded_gaussian_blur`: the separable blur (``ops/blur.gaussian_blur``;
  reference GaussianBlur.cpp:26-160) with image rows sharded over the
  mesh's 'x' axis. The horizontal pass is local; the vertical pass takes a
  radius-deep ghost slab from each neighbour once, and the shards at the
  image's top and bottom put the reference's asymmetric reflect in their
  ghost rows. Bit-equal to the single-device blur.
* :func:`sharded_pit_fill`: the pit-fill fixpoint (``ops/pitfill``;
  reference PitFillAlgorithm.cpp:28-154) with one ghost-row exchange per
  sweep and a change flag over every shard. The from-above fixpoint is
  unique, so the result is bit-equal to the single-device pit fill.

Both work on the shards along 'x' of the mesh's first index on every other
axis (the JAX package replicates them over 'b') and return one tensor on
the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_tensor
from ..ops.blur import _blur_axis, strip_kernel
from .collectives import all_gather, any_true, lines
from .halo import halo_pad_rows
from .mesh import ShardMesh

_FIRST_BUDGET = 8  # sweeps before the first look at the change flag
_MAX_BUDGET = 64  # sweeps between two looks, at most


def _row_line(mesh: ShardMesh, x: torch.Tensor | np.ndarray) -> list:
    """``x``'s rows split over the shards along 'x' (rows must divide), f32."""
    devs = mesh.devices.reshape(-1)[lines(mesh, "x")[0]]
    h = x.shape[-2]
    hl = h // len(devs)
    return [as_tensor(x[..., k * hl : (k + 1) * hl, :], dev, torch.float32)
            for k, dev in enumerate(devs)]


def _vertical_blur_sharded(shards: list, kernel: np.ndarray) -> list:
    """Vertical pass of the strip blur over row shards, as ``ops/blur._blur_axis``:
    the same taps, summation order and asymmetric reflect (leading mirror
    about pixel 0 excluding the edge, trailing including it)."""
    radius = len(kernel) - 1
    if radius == 0:
        return [s * float(kernel[0]) for s in shards]
    padded = halo_pad_rows(shards, depth=radius)
    n = len(shards)
    out = []
    for i, (x, xp) in enumerate(zip(shards, padded)):
        hl = x.shape[-2]
        top = torch.flip(x[..., 1 : radius + 1, :], (-2,)) if i == 0 else xp[..., :radius, :]
        bot = (torch.flip(x[..., hl - radius : hl, :], (-2,)) if i == n - 1
               else xp[..., hl + radius :, :])
        xp = torch.cat([top, x, bot], dim=-2)

        def take(offset, xp=xp, hl=hl):
            return xp[..., radius + offset : radius + offset + hl, :]

        acc = float(kernel[0]) * take(0)
        for k in range(1, radius + 1):
            acc = acc + float(kernel[k]) * (take(k) + take(-k))
        out.append(acc)
    return out


def sharded_gaussian_blur(image, sigma: float, mesh: ShardMesh) -> torch.Tensor:
    """Reference-exact Gaussian blur of a (H, W) or (C, H, W) image with rows
    sharded over ``mesh``'s 'x' axis. Rows must split evenly over the shards
    with at least radius + 1 = int(2 * sigma) + 2 rows a shard."""
    mesh.require_one_process("sharded_gaussian_blur")
    kernel = strip_kernel(float(sigma))
    radius = len(kernel) - 1
    squeeze = image.ndim == 2
    h = image.shape[-2]
    xdim = mesh.shape["x"]
    if h % xdim or h // xdim < radius + 1:
        raise ValueError(
            f"rows ({h}) must split evenly over {xdim} shards with >= {radius + 1} rows per shard"
        )
    shards = _row_line(mesh, image if not squeeze else image[None])
    horiz = [_blur_axis(s, kernel, axis=s.ndim - 1) for s in shards]
    out = all_gather(_vertical_blur_sharded(horiz, kernel), -2, mesh.first_device)
    return out[0] if squeeze else out


def _sweep(orig: torch.Tensor, framed: torch.Tensor, border: float) -> torch.Tensor:
    """max(orig, min over the 8-neighbourhood) from ``framed``, the shard's
    rows between its ghost rows; the columns outside hold ``border``."""
    h, w = orig.shape
    p = F.pad(framed, (1, 1), value=border)
    tmp = torch.minimum(torch.minimum(p[:, 0:w], p[:, 1 : w + 1]), p[:, 2 : w + 2])
    inner = torch.minimum(tmp[0:h], tmp[2 : h + 2])
    inner = torch.minimum(inner, p[1 : h + 1, 0:w])
    inner = torch.minimum(inner, p[1 : h + 1, 2 : w + 2])
    return torch.maximum(inner, orig)


def sharded_pit_fill(image, border_value: float, mesh: ShardMesh,
                     max_sweeps: int = 100_000) -> torch.Tensor:
    """Pit-fill fixpoint of a (H, W) raster with rows sharded over 'x':
    F <- max(original, min over the 8-neighbourhood of F) from all ones,
    out-of-image neighbours fixed at ``border_value``, until a sweep changes
    nothing (or ``max_sweeps``). Each sweep exchanges one ghost row a side;
    the change flag over every shard is read once per budget of 8, 16, 32,
    then 64 sweeps (a sweep at the fixpoint changes nothing, so the
    surplus sweeps never change the result)."""
    mesh.require_one_process("sharded_pit_fill")
    h = image.shape[0]
    xdim = mesh.shape["x"]
    if h % xdim:
        raise ValueError(f"rows ({h}) must split evenly over {xdim} shards")
    border = float(np.float32(border_value))
    orig = _row_line(mesh, image)
    f = [torch.ones_like(o) for o in orig]
    done, budget = 0, _FIRST_BUDGET
    while done < max_sweeps:
        count = min(budget, max_sweeps - done)
        for _ in range(count):
            framed = halo_pad_rows(f, boundary_value=border)
            prev, f = f, [_sweep(o, p, border) for o, p in zip(orig, framed)]
        done += count
        if not any_true(mesh, [a != b for a, b in zip(f, prev)]):
            break
        budget = min(2 * budget, _MAX_BUDGET)
    return all_gather(f, -2, mesh.first_device)
