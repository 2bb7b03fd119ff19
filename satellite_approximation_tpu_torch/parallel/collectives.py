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

On a mesh that spans processes a grid holds None for every shard that
another process owns, and the functions that read another shard's tensor
take it through the mesh's transport: a line of shards (:class:`Line`) is
completed by an all-gather among the processes that own it, a reduction
adds every shard's partial in shard order on each process (bit-equal to a
one-process mesh of the same shape; the backend's own all-reduce would add
in its order), the loop flag is one all-reduce of its maximum, and
:func:`gather` assembles on every process or on one.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist

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
    """``fn`` applied shard by shard: out[i] = fn(grids[0][i], grids[1][i], ...);
    None where another process holds the shard."""
    out = np.empty(grids[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        if grids[0][idx] is not None:
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


class Line(list):
    """The shards of one line of a mesh that spans processes, in order: None
    where another process holds the shard. ``mesh`` and ``index`` (the flat
    shard indices) say whose each one is."""

    def __init__(self, shards, mesh: ShardMesh, index):
        super().__init__(shards)
        self.mesh = mesh
        self.index = [int(i) for i in index]

    def owners(self) -> list[int]:
        return [int(self.mesh.owners.flat[i]) for i in self.index]


def map_lines(mesh: ShardMesh, grid: np.ndarray, axis, fn) -> np.ndarray:
    """``fn(list of shards)`` -> list, for every line of shards along ``axis``
    (a :class:`Line` on a mesh that spans processes; every process calls
    ``fn`` for every line, in the same order)."""
    out = np.empty(grid.shape, dtype=object)
    src, dst = grid.reshape(-1), out.reshape(-1)
    for group in lines(mesh, axis):
        line = [src[i] for i in group]
        if mesh.spans_processes:
            line = Line(line, mesh, group)
        for i, t in zip(group, fn(line)):
            dst[i] = t
    return out


def complete(line: list) -> list:
    """Every shard's tensor of a line: a :class:`Line` gets the shards of the
    other processes that own part of it, by one all-gather among them (the
    shards must have one shape), each on this process's first device; any
    other list comes back as it is. A process that owns none of the line
    gets it back unchanged."""
    if not isinstance(line, Line):
        return line
    mesh, owners = line.mesh, line.owners()
    ranks = sorted(set(owners))
    if len(ranks) == 1:
        return list(line)
    tr = mesh.transport
    group = tr.group(ranks)
    if mesh.rank not in ranks:
        return list(line)
    mine = [t for t in line if t is not None]
    count = max(owners.count(r) for r in ranks)
    send = torch.stack(mine + [torch.zeros_like(mine[0])] * (count - len(mine)))
    bufs = [tr.incoming(send.shape, send.dtype) for _ in ranks]
    dist.all_gather(bufs, tr.outgoing(send), group=group)
    got = dict(zip(ranks, bufs))
    out, seen = [], dict.fromkeys(ranks, 0)
    dev = mesh.first_device
    for t, r in zip(line, owners):
        out.append(t if t is not None else move(got[r][seen[r]], dev))
        seen[r] += 1
    return out


def _reduce(mesh: ShardMesh, grid: np.ndarray, axes, op) -> np.ndarray:
    out = np.empty(grid.shape, dtype=object)
    src, dst, devs = grid.reshape(-1), out.reshape(-1), mesh.devices.reshape(-1)
    for group in lines(mesh, axes):
        parts = [src[i] for i in group]
        if mesh.spans_processes:
            parts = complete(Line(parts, mesh, group))
            if parts[0] is None:  # this process owns none of the line
                continue
        acc = parts[0]
        for t in parts[1:]:
            acc = op(acc, move(t, acc.device))
        for i in group:
            if src[i] is not None:
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
    a True: one host read. Across processes, one all-reduce of the maximum
    of each process's flag, so that every process takes the same branch."""
    shards = grid.reshape(-1) if isinstance(grid, np.ndarray) else grid
    flag = all_gather([t.any().reshape(1) for t in shards if t is not None], 0,
                      mesh.first_device).any()
    if not mesh.spans_processes:
        return bool(flag)
    flag = mesh.transport.outgoing(flag.to(torch.int32).reshape(1))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


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
    device share it). Across processes each places only its own blocks
    (each builds the same global ``x``)."""
    shape = tuple(x.shape)
    out = np.empty(mesh.dims, dtype=object)
    placed = {}
    for idx in np.ndindex(mesh.dims):
        if not mesh.owns(idx):
            continue
        dev = mesh.devices[idx]
        sl = _block(mesh, spec, dict(zip(mesh.axis_names, idx)), shape)
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in placed:
            placed[key] = as_tensor(x[sl], dev, dtype)
        out[idx] = placed[key]
    return out


def _collect(mesh: ShardMesh, grid: np.ndarray, root: int | None) -> np.ndarray | None:
    """Across processes: a grid of every shard's tensor, by one all-gather
    (``root`` None) or one gather to process ``root`` (None elsewhere).
    Every process owns as many shards, of one shape."""
    tr = mesh.transport
    flat = grid.reshape(-1)
    send = tr.outgoing(torch.stack([t for t in flat if t is not None]))
    n = dist.get_world_size()
    bufs = ([tr.incoming(send.shape, send.dtype) for _ in range(n)]
            if root is None or mesh.rank == root else None)
    if root is None:
        dist.all_gather(bufs, send)
    else:
        dist.gather(send, bufs, dst=root)
        if mesh.rank != root:
            return None
    out = np.empty(grid.shape, dtype=object)
    seen = [0] * n
    for i, owner in enumerate(mesh.owners.reshape(-1).tolist()):
        out.flat[i] = flat[i] if flat[i] is not None else bufs[owner][seen[owner]]
        seen[owner] += 1
    return out


def gather(mesh: ShardMesh, grid: np.ndarray, spec, root: int | None = None) -> torch.Tensor | None:
    """The global tensor of a grid, assembled on the mesh's first device:
    the explicit form of a reshard to replicated. Across processes it is
    assembled on every process (``root`` None) or on process ``root`` only,
    and the others get None."""
    if mesh.spans_processes:
        grid = _collect(mesh, grid, root)
        if grid is None:
            return None
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
