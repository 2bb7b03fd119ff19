"""Halo exchange for spatially sharded stencils
(``satellite_approximation_tpu/parallel/halo.py``).

Each function takes the shards of one mesh axis in order (a row block or a
column block each) and returns them padded with ``depth`` ghost rows or
columns from their neighbours. The shards at the ends of the axis get
``boundary_value`` there, exactly as ``ppermute`` plus ``where`` fills them
in the JAX package; zeros are the zero padding the masked operator wants at
the image boundary. The 5-point stencil needs no corner ghosts, so a 2-D
exchange is the row exchange plus an independent column exchange. Slabs
move with an asynchronous copy to the neighbour's device. Across
processes (a :class:`~.collectives.Line`) only the ``depth`` boundary rows
or columns cross, by point-to-point sends and receives that both sides
post in one batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import Line, move


def _check_depth(x: torch.Tensor, depth: int, dim: int) -> None:
    if depth > x.shape[dim]:
        raise ValueError(f"halo depth {depth} exceeds the shard's extent {x.shape[dim]}")


def _pad_across(line: Line, depth: int, boundary_value: float, dim: int) -> list:
    """:func:`_pad` over a line that spans processes; None stays None. The
    shards of a line have one shape. Boundary k (between shards k and
    k + 1) uses tags 2k (downwards) and 2k + 1 (upwards)."""
    mesh, owner = line.mesh, line.owners()
    me, tr = mesh.rank, mesh.transport
    n = len(line)
    for x in line:
        if x is not None:
            _check_depth(x, depth, dim)
    ops, got = [], {}

    def slab(x):
        return tr.incoming(x.narrow(dim, 0, depth).shape, x.dtype)

    for k in range(n - 1):
        a, b = owner[k], owner[k + 1]
        if a == b or me not in (a, b):
            continue
        if me == a:  # send shard k's last rows down, receive shard k + 1's first rows
            x = line[k]
            got[k + 1, "first"] = slab(x)
            ops += [dist.P2POp(dist.isend, tr.outgoing(x.narrow(dim, x.shape[dim] - depth, depth)),
                               b, tag=2 * k),
                    dist.P2POp(dist.irecv, got[k + 1, "first"], b, tag=2 * k + 1)]
        else:
            x = line[k + 1]
            got[k, "last"] = slab(x)
            ops += [dist.P2POp(dist.irecv, got[k, "last"], a, tag=2 * k),
                    dist.P2POp(dist.isend, tr.outgoing(x.narrow(dim, 0, depth)), a, tag=2 * k + 1)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def ghost(x, i, end):
        # rows of shard i next to x: its last rows above x, its first below
        if (i, end) in got:
            return move(got[i, end], x.device)
        y = line[i]
        return move(y.narrow(dim, y.shape[dim] - depth, depth) if end == "last"
                    else y.narrow(dim, 0, depth), x.device)

    out = []
    for i, x in enumerate(line):
        if x is None:
            out.append(None)
            continue
        edge = torch.full_like(x.narrow(dim, 0, depth), boundary_value)
        before = edge if i == 0 else ghost(x, i - 1, "last")
        after = edge if i == n - 1 else ghost(x, i + 1, "first")
        out.append(torch.cat([before, x, after], dim=dim))
    return out


def _pad(shards: list, depth: int, boundary_value: float, dim: int) -> list:
    if isinstance(shards, Line):
        return _pad_across(shards, depth, boundary_value, dim)
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        _check_depth(x, depth, dim)
        if i == 0:
            before = torch.full_like(x.narrow(dim, 0, depth), boundary_value)
        else:
            prev = shards[i - 1]
            before = move(prev.narrow(dim, prev.shape[dim] - depth, depth), x.device)
        if i == n - 1:
            after = torch.full_like(x.narrow(dim, 0, depth), boundary_value)
        else:
            after = move(shards[i + 1].narrow(dim, 0, depth), x.device)
        out.append(torch.cat([before, x, after], dim=dim))
    return out


def halo_pad_rows(shards: list, depth: int = 1, boundary_value: float = 0.0) -> list:
    """Each (..., H_local, W) shard padded with ``depth`` ghost rows on top
    (the last rows of the shard before it) and at the bottom (the first rows
    of the shard after it). ``depth`` > 1 serves wide stencils (the blur's
    radius); it must not exceed a shard's rows."""
    return _pad(shards, depth, boundary_value, -2)


def halo_pad_cols(shards: list, depth: int = 1, boundary_value: float = 0.0) -> list:
    """Column counterpart of :func:`halo_pad_rows` for (..., H, W_local) shards."""
    return _pad(shards, depth, boundary_value, -1)
