# Frozen copy of satellite_approximation_tpu_torch/ops/pitfill.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
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

The program runs directional scan cycles (kernel 9) before the sweeps on
the card; this reference runs the sweeps alone, to the same fixpoint.
"""

from __future__ import annotations

import torch

_COARSEST = 64  # stop the pyramid when min dim is at or below this
_FIRST_BUDGET = 8  # sweeps before the first look at the flag
_MAX_BUDGET = 64  # sweeps between two looks at the flag, at most
_TILED_MIN_SIZE = 1 << 20  # levels with at least this many cells sweep by active tiles
_TILE = 256  # tile side
_HALO = 32  # halo width = sweeps a round (<= _TILE)
_TILED_MAX_SHARE = 0.6  # above this share of active tiles a round sweeps the whole raster


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


def pit_fill(original: torch.Tensor, border_value) -> torch.Tensor:
    """Fill every pit of ``original`` relative to ``border_value`` (a number
    or a 0-d tensor on the same device): the pyramid's levels, coarsest
    first, each swept to its fixpoint from the level above.

    Matches PitFillAlgorithm::PitFillAlgorithmFilter
    (PitFillAlgorithm.cpp:120-154) exactly at the fixpoint (the reference's
    update schedule differs per-pixel but the from-above fixpoint is unique;
    like the reference, inputs are assumed <= 1 so the all-ones start
    dominates the answer)."""
    original = original.to(torch.float32).contiguous()
    border_value = torch.as_tensor(border_value, dtype=torch.float32, device=original.device)

    pyramid = [original]
    while min(pyramid[-1].shape) > _COARSEST:
        pyramid.append(_maxpool2(pyramid[-1]))

    f = torch.ones_like(pyramid[-1])  # reference's all-1s start, coarsest level
    for lvl in range(len(pyramid) - 1, -1, -1):
        orig_l = pyramid[lvl]
        # from any f >= fixpoint the monotone operator is sandwiched
        # F* <= J^k(f) <= J^k(1s) -> F*, and the no-change exit lands exactly
        # on F*
        f = _fixpoint(orig_l, border_value, torch.maximum(orig_l, f))
        if lvl:
            fh, fw = pyramid[lvl - 1].shape
            f = f.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[:fh, :fw]
    return f
