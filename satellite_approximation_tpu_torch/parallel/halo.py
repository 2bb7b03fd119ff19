"""Halo exchange for spatially sharded stencils
(``satellite_approximation_tpu/parallel/halo.py``).

Each function takes the shards of one mesh axis in order (a row block or a
column block each) and returns them padded with ``depth`` ghost rows or
columns from their neighbours. The shards at the ends of the axis get
``boundary_value`` there, exactly as ``ppermute`` plus ``where`` fills them
in the JAX package; zeros are the zero padding the masked operator wants at
the image boundary. The 5-point stencil needs no corner ghosts, so a 2-D
exchange is the row exchange plus an independent column exchange. Slabs
move with an asynchronous copy to the neighbour's device.
"""

from __future__ import annotations

import torch

from .collectives import move


def _pad(shards: list, depth: int, boundary_value: float, dim: int) -> list:
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        if depth > x.shape[dim]:
            raise ValueError(f"halo depth {depth} exceeds the shard's extent {x.shape[dim]}")
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
