"""Kernel 9: the pit fill's directional pass (``csrc/pitfill.cu``), with its
plain PyTorch version beside it.

The directional scan cycles of ``ops/pitfill.py`` (the counterparts of
``_pass_down``, ``_directional_cycle`` and ``_directional_budget`` of
``satellite_approximation_tpu/ops/pitfill.py``, a ``lax.scan`` that XLA
compiles: no TPU kernel) are a chain of dependent row steps. As plain torch
ops a row is ~6 launches; here one launch is one pass over the raster, or
one batch of 64 rows of it where the raster is wider than the strips the
card holds at once (16,896 columns on an H100).

A cycle is four passes (:data:`DIRECTIONS`): ``down`` scans rows top to
bottom, ``up`` bottom to top, ``left`` scans columns from the left edge,
``right`` from the right edge. The kernel scans rows; the two column passes
run it on the transposes (a budget transposes ``orig`` once and ``f`` twice
a cycle: layout, not arithmetic).

As for kernels 1-8 (``ops/stencil_kernels.py``, whose build and library
this module uses): operands on the CPU go through the plain version, on a
CUDA device through the kernel or the wrapper raises; each launch adds one
to ``stencil_kernels.launch_counts["directional_pass"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import pitfill as P
from . import stencil_kernels as K

# the passes of a cycle in order: (scans the transposes, scans from the far end)
DIRECTIONS = {"down": (False, False), "up": (False, True),
              "left": (True, False), "right": (True, True)}
NAME = "directional_pass"


def launches() -> int:
    """Kernel 9's launches in this process so far."""
    return K.launch_counts[NAME]


def _border(border, like: torch.Tensor) -> torch.Tensor:
    """``border`` as a 0-d f32 tensor on ``like``'s device (a tensor is never
    read on the host)."""
    return torch.as_tensor(border, dtype=torch.float32, device=like.device)


def _check_pair(orig, f) -> None:
    K._check(NAME, orig, (torch.float32,), (None, None))
    K._check(NAME, f, (torch.float32,), tuple(orig.shape))


def directional_pass_plain(orig, f, border, direction: str):
    """One pass in ``direction`` (:data:`DIRECTIONS`) as plain torch ops:
    ``(out, changed)``, ``changed`` a 0-d int32 tensor, 1 where a cell of
    ``out`` differs from ``f``."""
    out = P._pass(orig, _border(border, orig), f, direction).contiguous()
    return out, (out != f).any().to(torch.int32)


@functools.cache
def _geometry(device: int) -> tuple[int, int, int]:
    """(columns a strip, rows a batch, strips the card holds at once) of
    kernel 9 on CUDA device ``device``."""
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        rc = K._library().sat_directional_geometry(*map(ctypes.byref, vals))
    K._check_rc(rc, NAME)
    return tuple(v.value for v in vals)


def _strips(w: int, device: torch.device) -> int:
    cols, _, _ = _geometry(device.index)
    return -(-w // cols)


def _launch(orig, f, out, bv, changed, skip, progress, reverse: bool) -> None:
    """Kernel 9 on CUDA operands: ``out`` <- one pass of rows of ``f``
    (``reverse``: bottom to top); ``changed``, ``skip`` int32 device scalars
    (views into a flag tensor; ``skip`` may be None), ``progress`` zeroed
    int32 with at least one counter a strip. One launch when every strip
    fits on the card at once, else one launch a batch of rows (no
    ``progress``)."""
    h, w = orig.shape
    _, rows, resident = _geometry(orig.device.index)
    if _strips(w, orig.device) <= resident:
        spans = [(0, h, progress)]
    else:
        spans = [(r, min(h, r + rows), None) for r in range(0, h, rows)]
    lib, stream = K._library(), K._stream()
    for r_first, r_last, prog in spans:
        rc = lib.sat_directional_pass(
            K._ptr(orig), K._ptr(f), K._ptr(out), K._ptr(bv), K._ptr(changed), K._ptr(skip),
            K._ptr(prog), h, w, int(reverse), r_first, r_last, stream,
        )
        K._check_rc(rc, NAME)
        K.launch_counts[NAME] += 1


def directional_pass(orig: torch.Tensor, f: torch.Tensor, border, direction: str):
    """One directional pass of ``f`` (H, W) f32 over ``orig`` (H, W) f32,
    neighbours outside the image at ``border`` (a number or a 0-d tensor):
    ``(out, changed)`` as :func:`directional_pass_plain`."""
    if direction not in DIRECTIONS:
        raise ValueError(f"{NAME}: direction {direction!r} not in {tuple(DIRECTIONS)}")
    _check_pair(orig, f)
    bv = _border(border, orig)
    if not K._on_cuda(NAME, (orig, f, bv)):
        return directional_pass_plain(orig, f, bv, direction)
    cols, reverse = DIRECTIONS[direction]
    o, x = (orig.t().contiguous(), f.t().contiguous()) if cols else (orig, f)
    out = torch.empty_like(x)
    changed = torch.zeros(1, dtype=torch.int32, device=f.device)
    progress = torch.zeros(_strips(o.shape[1], o.device), dtype=torch.int32, device=f.device)
    _launch(o, x, out, bv, changed, None, progress, reverse)
    return (out.t().contiguous() if cols else out), changed[0]


def directional_budget(orig: torch.Tensor, border, f0: torch.Tensor, max_cycles: int,
                       cycles: list | None = None):
    """Up to ``max_cycles`` directional cycles from ``f0``, ending early on a
    cycle that changes nothing: ``(f, changed)``, ``changed`` a Python bool,
    whether the last cycle run changed anything; ``cycles``, where given,
    takes the number of cycles run. ``f0`` is not written.

    On the card all ``max_cycles`` cycles are queued without a look at the
    device: a cycle whose predecessor changed nothing copies (each of its
    passes reads that cycle's flag on the device), which gives the surface
    and flag of the early exit. The host reads the flags once, at the end."""
    if max_cycles < 1:
        raise ValueError(f"{NAME}: max_cycles {max_cycles} < 1")
    _check_pair(orig, f0)
    bv = _border(border, orig)
    if not K._on_cuda(NAME, (orig, f0, bv)):
        return P._directional_budget(orig, bv, f0, max_cycles, cycles)
    h, w = orig.shape
    dev = orig.device
    # each layout's operand and its two ping-pong buffers: rows, transposed
    layouts = {False: (orig, torch.empty_like(f0), torch.empty_like(f0)),
               True: (orig.t().contiguous(), f0.new_empty((w, h)), f0.new_empty((w, h)))}
    flags = torch.zeros(max_cycles, dtype=torch.int32, device=dev)
    progress = torch.zeros((max_cycles, len(DIRECTIONS), max(_strips(w, dev), _strips(h, dev))),
                           dtype=torch.int32, device=dev)
    src, now = f0, False  # the surface, and whether it is held transposed
    for k in range(max_cycles):
        flag, skip = flags[k], flags[k - 1] if k else None
        for d, (cols, reverse) in enumerate(DIRECTIONS.values()):
            o, a, b = layouts[cols]
            if cols != now:
                a.copy_(src.t())
                src, now = a, cols
            dst = b if src is a else a
            _launch(o, src, dst, bv, flag, skip, progress[k, d], reverse)
            src = dst
    if now:
        src = src.t().contiguous()
    seen = flags.tolist()  # the budget's one look at the device
    run = seen.index(0) + 1 if 0 in seen else max_cycles
    if cycles is not None:
        cycles.append(run)
    return src, bool(seen[-1])
