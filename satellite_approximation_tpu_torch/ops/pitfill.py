"""Pit-fill (morphological reconstruction by erosion) as a monotone fixpoint
(``satellite_approximation_tpu/ops/pitfill.py``).

Replacement for the reference's iterative OpenCL kernel
(lib/cloud_shadow_detection/source/PitFillAlgorithm.cpp:28-91,120-154):
start from an all-ones surface, repeatedly apply

    F <- max(original, min over the 8-neighbourhood of F)

with out-of-image neighbours fixed at ``border_value``, until nothing
changes. The reference ping-pongs two device buffers with a host-read
"hasChanged" flag per sweep. Here the sweeps are queued in budgets (8, 16,
32, then 64 at a time) and the host reads one flag per budget: whether the
budget's last sweep changed anything. Sweeping on from the fixpoint changes
nothing, so the surplus sweeps cost time and never the result.

**Active tiles.** A cell can change in a sweep only if one of its 8
neighbours changed in the sweep before, so after a round of k sweeps the
cells that can change within the next k sweeps lie within k pixels of those
the round's last sweep changed. Large levels are therefore cut into tiles:
a round gathers the tiles that hold such a cell or touch one that does, each
with a halo of k pixels, sweeps that batch k times (the halo's outer ring
held still: its error travels one pixel a sweep and never reaches the tile),
and writes the tiles back; the result equals k sweeps of the whole raster.
Most of a noisy raster settles within a few rounds and only the long
drainage paths go on, so the late rounds touch a small share of the cells.

**Hierarchical acceleration.** One Jacobi sweep propagates escape
information a single pixel, so the plain fixpoint needs O(basin diameter)
full-raster sweeps. The fixpoint has a minimax-path characterization:
F(p) = max(orig(p), min over escape paths pi from p to outside of
max(orig along pi, border_value)). Max-pooling the original 2x2 preserves an
upper bound: any coarse escape path threads adjacent fine blocks, and a fine
path through those blocks has max <= the block maxima, so the coarse
fixpoint (pointwise over its block) >= every fine fixpoint value in that
block. Upsampled coarse fixpoints therefore seed each finer level's
iteration *from above* — the monotone-decreasing sweep converges to the SAME
unique from-above fixpoint, but only needs to repair block-local detail.
Each level still runs to its exact fixpoint, so the result is bit-exact with
the plain iteration, whatever the schedule.

**Directional scan cycles.** On a level of at least
``_DIRECTIONAL_MIN_SIZE`` cells the sweeps are preceded by cycles of four
ordered passes (down, up, left, right: ``_directional_cycle``), each of
which carries drainage information across the whole raster where a sweep
moves it one pixel; budgets of ``_DIRECTIONAL_BUDGET`` cycles run until one
ends on a cycle that changes nothing, then the sweeps certify the fixpoint.
They run on the card only, where a pass is kernel 9 (``ops/pitfill_kernels.py``,
``csrc/pitfill.cu``). Their plain torch version (a loop over the rows) is
slower than the sweeps on the CPU, so a CPU level runs none unless
``_DIRECTIONAL_ON_CPU`` is set, as the tests that hold it to the JAX
package do; the fixpoint is the same either way.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import pitfill_kernels

_COARSEST = 64  # stop the pyramid when min dim is at or below this
_FIRST_BUDGET = 8  # sweeps before the first look at the flag
_MAX_BUDGET = 64  # sweeps between two looks at the flag, at most
_TILED_MIN_SIZE = 1 << 20  # levels with at least this many cells sweep by active tiles
_TILE = 256  # tile side
_HALO = 32  # halo width = sweeps a round (<= _TILE)
_TILED_MAX_SHARE = 0.6  # above this share of active tiles a round sweeps the whole raster
# levels of at least this many cells on the card run directional cycles
# before the sweeps: on an H100 every level of 128^2 or more reached its
# fixpoint sooner so (3-34x), the 86^2 and 64^2 levels did not
# (chip_profile.py --detect at 4096^2 and 10980^2); JAX's 4,000,000 was set
# by a TPU's compile cost
_DIRECTIONAL_MIN_SIZE = 1 << 14
# the plain cycles on the CPU lost to the sweeps at every size tried
_DIRECTIONAL_ON_CPU = False
_DIRECTIONAL_BUDGET = 8  # cycles between two looks at the flag


def _bordered(f: torch.Tensor, border_value) -> torch.Tensor:
    """``f`` with a one-pixel frame of ``border_value`` (a number or a 0-d
    tensor; a tensor is never read on the host)."""
    h, w = f.shape
    p = torch.empty((h + 2, w + 2), dtype=f.dtype, device=f.device)
    p.fill_(border_value)
    p[1 : h + 1, 1 : w + 1] = f
    return p


def _sweep(original, p_in, p_out, tmp) -> None:
    """One sweep F <- max(original, min8(F)) from the framed ``p_in``
    (..., h + 2, w + 2) into the interior of the framed ``p_out``;
    ``original`` (..., h, w). The min over the 8 neighbours is taken as: the
    row-wise min of three over the rows above and below (``tmp``,
    (..., h + 2, w), holds the min of three for every framed row), then the
    left and right neighbours. min is exact, so the order does not matter."""
    h, w = original.shape[-2:]
    torch.minimum(p_in[..., 0:w], p_in[..., 1 : w + 1], out=tmp)
    torch.minimum(tmp, p_in[..., 2 : w + 2], out=tmp)
    inner = p_out[..., 1 : h + 1, 1 : w + 1]
    torch.minimum(tmp[..., 0:h, :], tmp[..., 2 : h + 2, :], out=inner)
    torch.minimum(inner, p_in[..., 1 : h + 1, 0:w], out=inner)
    torch.minimum(inner, p_in[..., 1 : h + 1, 2 : w + 2], out=inner)
    torch.maximum(inner, original, out=inner)


def _sweeps(original, p, count: int, rounds: list | None = None):
    """``count`` sweeps from the framed ``p``; returns the last two framed
    iterates (newest first). ``p`` is overwritten. ``rounds``, where given,
    takes one (cells swept a sweep, sweeps) entry."""
    if rounds is not None:
        rounds.append((original.numel(), count))
    a, b = p, p.clone()
    tmp = torch.empty((*p.shape[:-1], p.shape[-1] - 2), dtype=p.dtype, device=p.device)
    for _ in range(count):
        _sweep(original, a, b, tmp)
        a, b = b, a
    return a, b


def _min8(f: torch.Tensor, border_value) -> torch.Tensor:
    """Min over the 8-neighbourhood, out-of-bounds = border_value."""
    h, w = f.shape
    p = _bordered(f, border_value)
    m = p[0:h, 0:w]
    for dr, dc in ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2)):
        m = torch.minimum(m, p[dr : dr + h, dc : dc + w])
    return m


def _fixpoint_budget(original, border_value, f0, max_sweeps: int, rounds: list | None = None):
    """Exactly ``max_sweeps`` sweeps of F <- max(original, min8(F)) from
    ``f0`` (>= the fixpoint), queued without a look at the device in
    between; returns (f, changed) where ``changed`` is a Python bool: did
    the last sweep change anything."""
    h, w = original.shape
    a, b = _sweeps(original, _bordered(f0, border_value), max_sweeps, rounds)
    changed = not torch.equal(a, b)  # the frames are equal, so this compares the interiors
    return a[1 : h + 1, 1 : w + 1], changed


def _fixpoint_tiled(original, border_value, f0, rounds: list | None = None):
    """:func:`_fixpoint` by rounds of ``_HALO`` sweeps over the active tiles
    (see the module's docstring). The raster sits in a frame of
    ``border_value`` that is ``_HALO`` wide and fills it up to whole tiles.
    A frame cell keeps that value under a sweep: its ``original`` is
    ``border_value`` and so is one of its neighbours, another frame cell.
    The loop ends on a sweep of the whole raster that changes nothing, so
    whatever the schedule did, the result is the fixpoint."""
    h, w = original.shape
    dev = original.device
    t, k = _TILE, _HALO
    nty, ntx = -(-h // t), -(-w // t)
    shape = (nty * t + 2 * k, ntx * t + 2 * k)
    state = torch.empty(shape, dtype=original.dtype, device=dev)
    state.fill_(border_value)
    orig_p = state.clone()
    state[k : k + h, k : k + w] = f0
    orig_p[k : k + h, k : k + w] = original
    side = torch.arange(t + 2 * k, device=dev)

    def changed_tiles(new, old):
        """Which tiles the last sweep changed, from (..., nty*t, ntx*t) cells."""
        diff = new != old
        return diff.reshape(nty, t, ntx, t).any(dim=3).any(dim=1)

    def whole_round(count):
        nonlocal state
        a, b = _sweeps(orig_p[1:-1, 1:-1], state, count, rounds)
        state = a
        core = slice(k, -k)
        return changed_tiles(a[core, core], b[core, core])

    changed = whole_round(_FIRST_BUDGET)
    while True:
        # a change travels one pixel a sweep: within a round it reaches the
        # tiles next to a changed one and no further
        grown = torch.nn.functional.max_pool2d(
            changed[None, None].to(torch.float32), 3, stride=1, padding=1)[0, 0] > 0
        active = torch.nonzero(grown)  # the round's one look at the device
        n = active.shape[0]
        if n == 0:
            changed = whole_round(1)  # certify: one sweep of everything
            if not bool(changed.any()):
                return state[k : k + h, k : k + w].contiguous()
            continue
        if n > _TILED_MAX_SHARE * nty * ntx:
            changed = whole_round(k)
            continue
        rows = (active[:, 0, None] * t + side)[:, :, None]  # (n, t + 2k, 1), framed coordinates
        cols = (active[:, 1, None] * t + side)[:, None, :]
        a, b = _sweeps(orig_p[rows, cols][:, 1:-1, 1:-1], state[rows, cols], k, rounds)
        core = slice(k, k + t)
        state[rows[:, core], cols[:, :, core]] = a[:, core, core]
        tile_changed = (a[:, core, core] != b[:, core, core]).flatten(1).any(dim=1)
        changed = torch.zeros_like(changed)
        changed[active[:, 0], active[:, 1]] = tile_changed


def _fixpoint(original, border_value, f0, rounds: list | None = None):
    """Run F <- max(original, min8(F)) from ``f0`` (>= the fixpoint) until a
    sweep changes nothing. Always performs at least one sweep. ``rounds``,
    where given, takes a (cells swept a sweep, sweeps) entry for every batch
    of sweeps queued."""
    if original.numel() >= _TILED_MIN_SIZE:
        return _fixpoint_tiled(original, border_value, f0, rounds)
    f, budget = f0, _FIRST_BUDGET
    while True:
        f, changed = _fixpoint_budget(original, border_value, f, budget, rounds)
        if not changed:
            return f.contiguous()
        budget = min(2 * budget, _MAX_BUDGET)


def _shift_row(v: torch.Tensor, d: int, fill: torch.Tensor) -> torch.Tensor:
    """``v`` (1-D) shifted by ``d``, the vacated cells ``fill`` (a 0-d
    tensor)."""
    pad = fill.to(v.dtype).reshape(1).expand(abs(d))
    if d > 0:
        return torch.cat([pad, v[:-d]])
    return torch.cat([v[-d:], pad])


def _pass_down(orig, bv, f):
    """One top-to-bottom propagation: each row absorbs the min of its three
    upper 8-neighbours from the already-updated row above (the row before
    the first, and neighbours outside the image, are ``bv``, a 0-d tensor);
    information crosses the whole raster in one pass, where a sweep moves it
    one pixel. A loop over the rows: the plain version of kernel 9."""
    prev = bv.to(f.dtype).expand(f.shape[1])
    rows = []
    for o_r, f_r in zip(orig, f):
        vert = torch.minimum(prev, torch.minimum(_shift_row(prev, 1, bv), _shift_row(prev, -1, bv)))
        prev = torch.maximum(o_r, torch.minimum(f_r, vert))
        rows.append(prev)
    return torch.stack(rows)


def _pass(orig, bv, f, direction: str):
    """One pass in ``direction`` (a key of ``pitfill_kernels.DIRECTIONS``):
    ``_pass_down`` on the transposes and/or flipped rows."""
    cols, rev = pitfill_kernels.DIRECTIONS[direction]
    o, x = (orig.T, f.T) if cols else (orig, f)
    if rev:
        o, x = o.flip(0), x.flip(0)
    out = _pass_down(o, bv, x)
    if rev:
        out = out.flip(0)
    return out.T if cols else out


def _directional_cycle(orig, bv, f):
    """Down, up, left and right passes (Vincent-style ordered
    reconstruction, split by direction so every step is a whole row or
    column). Monotone from above: each update is max(orig, min over the cell
    and a subset of its 8 neighbours), >= the sweep's, so from f >= the
    fixpoint it stays >= the fixpoint."""
    for direction in pitfill_kernels.DIRECTIONS:
        f = _pass(orig, bv, f, direction)
    return f.contiguous()


def _directional_budget(orig, border_value, f0, max_cycles: int, cycles: list | None = None):
    """Up to ``max_cycles`` cycles, stopping after the first that changes
    nothing: (f, changed), ``changed`` a Python bool, whether the last cycle
    changed anything. ``cycles``, where given, takes the number run. Plain
    torch ops; ``pitfill_kernels.directional_budget`` is the same on the
    card through kernel 9."""
    bv = torch.as_tensor(border_value, dtype=torch.float32, device=orig.device)
    f, changed, run = f0, True, 0
    while changed and run < max_cycles:
        nf = _directional_cycle(orig, bv, f)
        changed = bool((nf != f).any())
        f, run = nf, run + 1
    if cycles is not None:
        cycles.append(run)
    return f, changed


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool via strided slices, the ragged last row/column pooled
    with -inf."""
    h, w = x.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    xp = torch.full((ph, pw), -torch.inf, dtype=x.dtype, device=x.device)
    xp[:h, :w] = x
    return torch.maximum(
        torch.maximum(xp[0::2, 0::2], xp[0::2, 1::2]),
        torch.maximum(xp[1::2, 0::2], xp[1::2, 1::2]),
    )


def _level_counts(orig_l: torch.Tensor, rounds: list, cycles: list, launches: int) -> dict:
    """What one pyramid level did: its cells, the directional cycles it ran
    and kernel 9's launches for them (a budget queues all its cycles, so a
    budget that ends early launches more passes than it runs), its sweeps
    and the cells they swept."""
    return {
        "cells": orig_l.numel(),
        "cycles": sum(cycles),
        "launches": launches,
        "sweeps": sum(n for _, n in rounds),
        "cells_swept": sum(cells * n for cells, n in rounds),
    }


def pit_fill(original: torch.Tensor, border_value, on_level=None) -> torch.Tensor:
    """Fill every pit of ``original`` relative to ``border_value`` (a number
    or a 0-d tensor on the same device). The counterpart of both ``pit_fill``
    and ``pit_fill_host`` of the JAX package: it keeps two because one
    compiles to a single program and the other is driven from the host; here
    there is one host-driven schedule, ``pit_fill_host``'s: on a level of at
    least ``_DIRECTIONAL_MIN_SIZE`` cells on the card, budgets of
    directional cycles until one ends unchanged (kernel 9), then the sweeps.
    A smaller level, or one on the CPU, runs no cycles, as ``pit_fill`` runs
    none; the fixpoint is the same either way.

    Matches PitFillAlgorithm::PitFillAlgorithmFilter
    (PitFillAlgorithm.cpp:120-154) exactly at the fixpoint (the reference's
    update schedule differs per-pixel but the from-above fixpoint is unique;
    like the reference, inputs are assumed <= 1 so the all-ones start
    dominates the answer).

    ``on_level``: an optional ``on_level(level, shape, rounds, cycles)``
    called as each pyramid level reaches its fixpoint, coarsest first, with
    the level's (cells swept a sweep, sweeps) entries and the number of
    directional cycles it ran: what a profile reads. It changes nothing of
    the schedule. Each level is a span ``pitfill.level`` whose counts are
    the same numbers and kernel 9's launches (``_level_counts``)."""
    original = original.to(torch.float32).contiguous()
    border_value = torch.as_tensor(border_value, dtype=torch.float32, device=original.device)

    pyramid = [original]
    while min(pyramid[-1].shape) > _COARSEST:
        pyramid.append(_maxpool2(pyramid[-1]))

    f = torch.ones_like(pyramid[-1])  # reference's all-1s start, coarsest level
    run_cycles = original.is_cuda or _DIRECTIONAL_ON_CPU
    for lvl in range(len(pyramid) - 1, -1, -1):
        orig_l = pyramid[lvl]
        # from any f >= fixpoint the monotone operator is sandwiched
        # F* <= J^k(f) <= J^k(1s) -> F*, and the no-change exit lands exactly
        # on F*
        rounds, cycles = [], []
        with profiling.span("pitfill.level", level=lvl):
            launched = pitfill_kernels.launches()
            f = torch.maximum(orig_l, f)
            if run_cycles and orig_l.numel() >= _DIRECTIONAL_MIN_SIZE:
                changed = True
                while changed:  # one look at the device a budget
                    f, changed = pitfill_kernels.directional_budget(
                        orig_l, border_value, f, _DIRECTIONAL_BUDGET, cycles)
            f = _fixpoint(orig_l, border_value, f, rounds)
            done = _level_counts(orig_l, rounds, cycles, pitfill_kernels.launches() - launched)
            for name, n in done.items():
                profiling.count(name, n)
        if on_level is not None:
            on_level(lvl, tuple(orig_l.shape), rounds, done["cycles"])
        if lvl:
            fh, fw = pyramid[lvl - 1].shape
            f = f.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:fh, :fw]
    return f
