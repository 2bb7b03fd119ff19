"""Sharded tensors and the collectives between their shards.

A sharded tensor is a *grid*: a numpy object array in its mesh's shape that
holds one tensor per shard, each on that shard's device. A *spec* says how
a global tensor maps onto the grid, as ``jax.sharding.PartitionSpec`` does:
one entry per tensor dimension (trailing ones may be left out), each a mesh
axis name, a tuple of names, or None for a dimension every shard holds
whole. Mesh axes that a spec does not name replicate the tensor.

The collectives stand in for ``psum``, ``pmax``, ``all_gather`` and the
shard-uniform loop flags of ``shard_map``. A reduction adds (or takes the
maximum of) the shards' partial values in shard order on the first shard's
device and hands every shard the same value, so that every shard takes the
same branch. Copies between CUDA devices are issued without a host
synchronisation; the one host read is :func:`any_true`, the stopping flag
that a loop reads once per iteration.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..device import as_tensor
from .mesh import ShardMesh


def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: no copy when it is there, an asynchronous copy
    between CUDA devices."""
    return t.to(device, non_blocking=t.device.type == "cuda" and device.type == "cuda")


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device (the hand-written kernels
    launch on the current device's stream); a no-op on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def axis_index(mesh: ShardMesh, axis: str) -> np.ndarray:
    """A grid of each shard's index along ``axis`` (``lax.axis_index``)."""
    out = np.empty(mesh.dims, dtype=object)
    k = mesh.axis_names.index(axis)
    for idx in np.ndindex(mesh.dims):
        out[idx] = idx[k]
    return out


def smap(fn, *grids) -> np.ndarray:
    """``fn`` applied shard by shard: out[i] = fn(grids[0][i], grids[1][i], ...)."""
    out = np.empty(grids[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(g[idx] for g in grids))
    return out


def unzip(grid: np.ndarray, n: int) -> tuple[np.ndarray, ...]:
    """A grid of n-tuples as n grids."""
    return tuple(smap(lambda t, i=i: t[i], grid) for i in range(n))


def lines(mesh: ShardMesh, axes) -> np.ndarray:
    """Flat shard indices, one row for each group of shards that differ
    only along ``axes`` (a name or a tuple of names), in shard order."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.axis_names
    rest = [a for a in names if a not in axes]
    flat = np.arange(mesh.size).reshape(mesh.dims)
    perm = [names.index(a) for a in rest] + [names.index(a) for a in axes]
    return flat.transpose(perm).reshape(-1, math.prod(mesh.shape[a] for a in axes))


def map_lines(mesh: ShardMesh, grid: np.ndarray, axis, fn) -> np.ndarray:
    """``fn(list of shards)`` -> list, for every line of shards along ``axis``."""
    out = np.empty(grid.shape, dtype=object)
    src, dst = grid.reshape(-1), out.reshape(-1)
    for group in lines(mesh, axis):
        for i, t in zip(group, fn([src[i] for i in group])):
            dst[i] = t
    return out


def _reduce(mesh: ShardMesh, grid: np.ndarray, axes, op) -> np.ndarray:
    out = np.empty(grid.shape, dtype=object)
    src, dst, devs = grid.reshape(-1), out.reshape(-1), mesh.devices.reshape(-1)
    for group in lines(mesh, axes):
        acc = src[group[0]]
        for i in group[1:]:
            acc = op(acc, move(src[i], acc.device))
        for i in group:
            dst[i] = move(acc, devs[i])
    return out


def psum(mesh: ShardMesh, grid: np.ndarray, axes) -> np.ndarray:
    """Sum over ``axes`` in shard order; every shard of a group gets it."""
    return _reduce(mesh, grid, axes, torch.add)


def pmax(mesh: ShardMesh, grid: np.ndarray, axes) -> np.ndarray:
    """Elementwise maximum over ``axes``; exact in any order."""
    return _reduce(mesh, grid, axes, torch.maximum)


def any_true(mesh: ShardMesh, grid) -> bool:
    """Whether any shard's tensor (of a grid, or of a list of shards) holds
    a True: one host read."""
    shards = grid.reshape(-1) if isinstance(grid, np.ndarray) else grid
    return bool(all_gather([t.any().reshape(1) for t in shards], 0, mesh.first_device).any())


def all_gather(shards: list, dim: int, device: torch.device) -> torch.Tensor:
    """The shards of one line of the mesh joined along ``dim`` on ``device``
    (``all_gather(tiled=True)`` for one receiver)."""
    return torch.cat([move(t, device) for t in shards], dim=dim)


def _block(mesh: ShardMesh, spec, idx: dict, shape) -> tuple:
    """The slices of a global tensor of ``shape`` that the shard at mesh
    index ``idx`` holds under ``spec``."""
    out = []
    for dim, size in enumerate(shape):
        axes = spec[dim] if dim < len(spec) else None
        if axes is None:
            out.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        k, n = 0, 1
        for a in axes:
            k = k * mesh.shape[a] + idx[a]
            n *= mesh.shape[a]
        if size % n:
            raise ValueError(f"dimension {dim} of extent {size} does not split over {n} shards")
        step = size // n
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def shard(mesh: ShardMesh, x, spec, dtype: torch.dtype | None = None) -> np.ndarray:
    """Split the global ``x`` (numpy array or tensor) into a grid under
    ``spec``; each block goes to its shard's device once (replicas on one
    device share it)."""
    shape = tuple(x.shape)
    out = np.empty(mesh.dims, dtype=object)
    placed = {}
    for idx in np.ndindex(mesh.dims):
        dev = mesh.devices[idx]
        sl = _block(mesh, spec, dict(zip(mesh.axis_names, idx)), shape)
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in placed:
            placed[key] = as_tensor(x[sl], dev, dtype)
        out[idx] = placed[key]
    return out


def gather(mesh: ShardMesh, grid: np.ndarray, spec) -> torch.Tensor:
    """The global tensor of a grid, assembled on the mesh's first device:
    the explicit form of a reshard to replicated."""
    device = mesh.first_device
    first = grid.reshape(-1)[0]
    shape = list(first.shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            shape[dim] *= math.prod(mesh.shape[a] for a in axes)
    out = torch.empty(shape, dtype=first.dtype, device=device)
    done = set()
    for idx in np.ndindex(mesh.dims):
        sl = _block(mesh, spec, dict(zip(mesh.axis_names, idx)), shape)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            done.add(key)
            t = grid[idx]
            out[sl].copy_(t, non_blocking=t.device.type == "cuda" and device.type == "cuda")
    return out
