"""Roofline telemetry: byte models of the port's solver and achieved-bandwidth
rows (``satellite_approximation_tpu/utils/roofline.py``).

The solver's hot loops (the Jacobi smoother, the V-cycle, the PCG
iteration) are memory-bound, far under one flop a byte, so the number that
says how close a call comes to the card's limit is the bytes it moves over
the card's memory rate, not its flop rate. This module holds:

* effective-traffic models of the port's data flow, each array read or
  written once a pass unless the code reads it again: the CUDA smoothers
  (``csrc/jacobi.cu``: a 64x64 window around each 48x48 tile, tiles without
  an unknown cell only streaming their outputs) and the plain torch passes
  around them;
* the kernels' bounds (:func:`kernel_work`): the bytes each of the eight
  kernels must move on a given mask and the flops it computes, the counts
  behind every bound share that ``chip_smoke.py`` reports;
* :func:`measure` and :class:`RooflineRow`, the schema of a measured row:
  its achieved GB/s and its share of the card's peak
  (:func:`hbm_peak_gbps`, from the card's name).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published HBM rates of NVIDIA cards, GB/s, by a piece of the name
# torch.cuda.get_device_name() gives; the first match wins.
_PEAK_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 NVL", 3900.0),
    ("H100", 3350.0),  # SXM, HBM3: "NVIDIA H100 80GB HBM3"
    ("H200", 4800.0),
    ("A100-SXM4-80GB", 2039.0),
    ("A100 80GB PCIe", 1935.0),
    ("A100", 1555.0),
)
_DEFAULT_PEAK = 3350.0  # the port's target, the H100 SXM

# the H100 SXM's published peaks at its 700 W limit: HBM3 bytes/s, f32
# flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# csrc/jacobi.cu's geometry: a WINDOW-square window of cells around each
# TILE-square interior, a ring of RING cells (csrc/stencil.cuh); up to
# BANDS_PER_BLOCK bands share one read of invm
WINDOW, TILE, RING = 64, 48, 8
BANDS_PER_BLOCK = 4


def hbm_peak_gbps(kind: str | None = None) -> float:
    """Peak HBM bandwidth, GB/s, of the card named ``kind`` (default: CUDA
    device 0's name); the H100 SXM's for an unknown name or without a card."""
    if kind is None:
        if not torch.cuda.is_available():
            return _DEFAULT_PEAK
        kind = torch.cuda.get_device_name(0)
    for key, val in _PEAK_GBPS:
        if key.lower() in kind.lower():
            return val
    return _DEFAULT_PEAK


@dataclasses.dataclass
class RooflineRow:
    """One measured kernel with its bandwidth utilization."""

    name: str
    seconds: float
    bytes_moved: int
    achieved_gbps: float
    pct_of_roofline: float
    note: str = ""

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "seconds": round(self.seconds, 6),
            "bytes_moved": int(self.bytes_moved),
            "achieved_gbps": round(self.achieved_gbps, 1),
            "pct_of_roofline": round(self.pct_of_roofline, 1),
            "note": self.note,
        }


def measure(fn, n: int = 5, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` over ``n`` runs after ``warmup``
    runs; the card is synchronised after each call."""

    def call():
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def row(name: str, seconds: float, bytes_moved: int, note: str = "") -> RooflineRow:
    gbps = bytes_moved / seconds / 1e9
    return RooflineRow(name, seconds, bytes_moved, gbps, 100.0 * gbps / hbm_peak_gbps(), note)


def bound_ms(nbytes, flops) -> tuple[float, str]:
    """(the least ms the card could take, what bounds it: "bytes" or
    "operations") at the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# The CUDA smoothers' tiles
# ---------------------------------------------------------------------------


def window_amplification() -> float:
    """Read amplification of a swept tile: its window over its interior
    (64^2 / 48^2 = 1.78)."""
    return WINDOW * WINDOW / (TILE * TILE)


def padded_pixels(h: int, w: int) -> int:
    """Interior cells of the tile grid that covers (h, w)."""
    return -(-h // TILE) * TILE * (-(-w // TILE) * TILE)


def known_windows(um: torch.Tensor, tile: int = TILE, ring: int = RING) -> float:
    """Share of the ``tile``-square tiles whose ``ring``-wide surround holds
    no unknown cell of the (H, W) mask ``um``. With the default ring these
    are kernel 7's windows that stream (jacobi_v2.cu); ``ring=0`` gives
    :func:`streaming_share`."""
    h, w = um.shape
    ty, tx = -(-h // tile), -(-w // tile)
    pad = (ring, tx * tile + ring - w, ring, ty * tile + ring - h)
    m = F.pad(um.float()[None, None], pad)
    win = F.max_pool2d(m, kernel_size=tile + 2 * ring, stride=tile)
    return float((win == 0).float().mean())


def streaming_share(um: torch.Tensor) -> float:
    """Share of jacobi.cu's tiles whose interior holds no unknown cell of
    ``um``: they do no sweeps and only stream their outputs (the tile skip;
    0.85 on bench.py's mask)."""
    return known_windows(um, TILE, 0)


def smoother_bytes(h: int, w: int, channels: int = 1, dtype_bytes: int = 4,
                   start: str = "zero", emit_residual: bool = False, half: bool = False,
                   streaming: float = 0.0) -> int:
    """Traffic of one jacobi.cu call (any sweep count: the sweeps stay on
    the chip). Every tile reads its window of invm once a group of up to
    four bands. A swept tile also reads, per band, the window of b, of u
    when it starts from u ("u", "corr"), and a quarter window of e_c
    ("corr"); a streaming tile (share ``streaming`` of the tiles) reads
    only u's interior, which it copies ("u", "corr"). Each tile writes u's
    interior, and the residual's with ``emit_residual`` (half of it with
    ``half``)."""
    px = padded_pixels(h, w)
    win = px * window_amplification()
    groups = -(-channels // BANDS_PER_BLOCK)
    swept = 1.0 - streaming
    per_band = win * swept
    if start in ("u", "corr"):
        per_band += win * swept + px * streaming
    if start == "corr":
        per_band += win / 4 * swept
    reads = groups * win + channels * per_band
    writes = channels * px
    if emit_residual:
        writes += channels * (px // 2 if half else px)
    return int((reads + writes) * dtype_bytes)


# ---------------------------------------------------------------------------
# The plain torch passes (effective traffic, as the JAX package models XLA)
# ---------------------------------------------------------------------------


def plain_smoother_bytes(h: int, w: int, channels: int, dtype_bytes: int, sweeps: int) -> int:
    """The per-sweep Jacobi of the sharded solve's distributed levels:
    each sweep reads u and b per band, the mask and 1/deg once, and writes
    u (the JAX package's ``xla_smoother_bytes``)."""
    px = h * w
    per_sweep = (2 * channels + 2) * px * dtype_bytes + channels * px * dtype_bytes
    return int(sweeps * per_sweep)


def restrict_bytes(h: int, w: int, channels: int, dtype_bytes: int) -> int:
    """2x2 block restriction: read the fine residual, write the coarse."""
    return int(channels * (h * w + (h * w) // 4) * dtype_bytes)


def prolong_correct_bytes(h: int, w: int, channels: int, dtype_bytes: int) -> int:
    """Prolong + add + mask: read the coarse e_c, the fine u and the mask,
    write the fine u."""
    px = h * w
    return int(channels * (px // 4 + 2 * px) * dtype_bytes + px * dtype_bytes)


def laplacian_bytes(h: int, w: int, channels: int, dtype_bytes: int) -> int:
    """The masked 5-point operator: read u per band, the mask and deg;
    write A u."""
    px = h * w
    return int((2 * channels + 2) * px * dtype_bytes)


def coarse_solve_bytes(h: int, w: int, channels: int, dtype_bytes: int, coarse_iters: int = 64,
                       dense_max: int = 4096) -> int:
    """The coarsest level: one mat-vec with the dense f32 inverse where the
    grid has at most ``dense_max`` cells (read r and the inverse, write e),
    else ``coarse_iters`` CG iterations (an A-apply and six vector passes
    each)."""
    px = h * w
    if px <= dense_max:
        return int(2 * channels * px * dtype_bytes + px * px * 4)
    per_iter = laplacian_bytes(h, w, channels, dtype_bytes) + 6 * channels * px * dtype_bytes
    return int(coarse_iters * per_iter)


def vcycle_bytes(level_shapes: list[tuple[int, int]], channels: int = 1, dtype_bytes: int = 4,
                 pre_sweeps: int = 7, post_sweeps: int = 7, coarse_iters: int = 64,
                 plain_levels: int = 0, streaming=0.0) -> int:
    """Traffic of one V-cycle from u = 0 over the hierarchy.

    The first ``plain_levels`` levels run plain torch sweeps (the sharded
    solve's distributed levels: sweeps, residual, restrict, prolong);
    every other level above the coarsest runs kernel 1 with its residual,
    the restrict, and kernel 2 with the correction fused in. ``streaming``:
    the share of tiles that only stream, one for all levels or one a level."""
    total = 0
    n = len(level_shapes)
    for i, (h, w) in enumerate(level_shapes):
        px = h * w
        if i == n - 1:
            total += coarse_solve_bytes(h, w, channels, dtype_bytes, coarse_iters)
        elif i < plain_levels:
            total += plain_smoother_bytes(h, w, channels, dtype_bytes, pre_sweeps)
            total += laplacian_bytes(h, w, channels, dtype_bytes)
            total += 2 * channels * px * dtype_bytes  # r = (b - Au) * m
            total += restrict_bytes(h, w, channels, dtype_bytes)
            total += prolong_correct_bytes(h, w, channels, dtype_bytes)
            total += plain_smoother_bytes(h, w, channels, dtype_bytes, post_sweeps)
        else:
            share = streaming if np.isscalar(streaming) else streaming[i]
            total += smoother_bytes(h, w, channels, dtype_bytes, "zero", True, streaming=share)
            total += restrict_bytes(h, w, channels, dtype_bytes)
            total += smoother_bytes(h, w, channels, dtype_bytes, "corr", i == 0, streaming=share)
    return int(total)


def pcg_iteration_bytes(level_shapes: list[tuple[int, int]], channels: int = 1,
                        fine_dtype_bytes: int = 4, precond_dtype_bytes: int = 4,
                        az_from_vcycle: bool = True, **vcycle_kwargs) -> int:
    """Marginal traffic of one MG-PCG iteration (``multigrid._pcg_core``):
    the V-cycle, the x / r / p updates (~7 arrays), and a fine A-apply
    unless the V-cycle's top post-smooth hands A z back (``az_from_vcycle``,
    the f32 preconditioner), which costs one more update of A p."""
    h, w = level_shapes[0]
    px = h * w
    total = vcycle_bytes(level_shapes, channels, precond_dtype_bytes, **vcycle_kwargs)
    total += 7 * channels * px * fine_dtype_bytes
    if az_from_vcycle:
        total += 3 * channels * px * fine_dtype_bytes  # A p = A z + beta A p
    else:
        total += laplacian_bytes(h, w, channels, fine_dtype_bytes)
    return int(total)


def hierarchy_shapes(h: int, w: int, min_size: int = 24) -> list[tuple[int, int]]:
    """Level shapes of ``models/multigrid.build_hierarchy`` (while the
    coarse mask is not saturated)."""
    shapes = [(h, w)]
    while min(h, w) > min_size:
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


# ---------------------------------------------------------------------------
# The kernels' bounds: what each of the eight must move on a given mask
# ---------------------------------------------------------------------------


def _sectors(need: torch.Tensor, elt: int = 4) -> int:
    """32-byte sectors of a row-major raster of ``elt``-byte cells that hold
    a True cell of the (H, W) ``need``."""
    per = 32 // elt
    flat = need.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per).any(dim=1).sum())


def _dilate4(m: torch.Tensor) -> torch.Tensor:
    """m or any of its 4-neighbours."""
    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    h, w = m.shape
    return m | p[:h, 1:-1] | p[2:, 1:-1] | p[1:-1, :w] | p[1:-1, 2:]


def v2_work(c: int, h: int, w: int, sweeps: int, emit: bool, deg_bytes: int = 4):
    """(dense bytes, bytes any mask needs, flops) of kernel 7 at (c, h, w)
    f32, at the bytes its caller hands it: u and b, the bool mask (one byte
    a cell) and deg (``deg_bytes`` a cell) once, u and, with ``emit``, r."""
    ras = c * h * w * 4
    nbytes = 2 * ras + h * w * (1 + deg_bytes) + (2 if emit else 1) * ras
    return nbytes, nbytes, c * h * w * (10 * sweeps + (8 if emit else 0))


def stride2_bytes(mode: str, shape) -> int:
    """Bytes kernel 8 must move on an f32 x of ``shape`` (..., rows, cols):
    the rows it reads (the even ones for "rows" and "both", whose every
    32-byte sector holds an even column; the first half of each row for
    "interleave") and its output."""
    *lead, r, c = shape
    n = math.prod(lead)
    rh, ch = (r + 1) // 2, (c + 1) // 2
    read = {"rows": rh * c, "cols": r * c, "both": rh * c, "interleave": r * (c // 2)}[mode]
    write = {"rows": rh * c, "cols": r * ch, "both": rh * ch, "interleave": r * c}[mode]
    return 4 * n * (read + write)


def directional_pass_work(h: int, w: int) -> tuple[int, int]:
    """Kernel 9's work in one directional pass over an (h, w) f32 raster:
    (bytes, operations). orig and f read once and the output written once,
    12 B a cell; three mins, a min and a max, and the comparison for the
    flag, 6 operations a cell. Its rows depend on one another, so the
    chain of h row steps, not this count, is what a pass waits on."""
    return 12 * h * w, 6 * h * w


def components_work(h: int, w: int) -> tuple[int, int]:
    """Kernel 10's work in labelling an (h, w) bool mask: (bytes,
    operations). The mask read once (1 B a pixel), a label written (4 B),
    reread and rewritten by the compression (8 B): 13 B a pixel; the tests
    of up to four earlier neighbours and a compare or two more, about 8
    operations a pixel."""
    return 13 * h * w, 8 * h * w


def sweep_work(cells: int) -> tuple[int, int]:
    """Kernel 11's work in sweeping ``cells`` true-box cells of (height,
    cloud) pairs: (bytes, operations). A cell reads the cloud mask (1 B),
    the potential shadow (1 B) and the id map at its cast position (4 B):
    6 B; the cast's two products and two sums a coordinate, two
    truncations, four bounds tests and the id compare, about 12 operations."""
    return 6 * cells, 12 * cells


def kernel_work(um: torch.Tensor, c: int, sweeps: int, stride2_mode: str = "both") -> dict:
    """Per kernel at (c, H, W) f32 on the mask ``um``: (dense bytes, bytes
    this mask needs, flops). Dense: every operand read once, every output
    written once. For this mask: invm everywhere; b and x_hi only in the
    32-byte sectors that hold an unknown cell; the residual kernels' image
    and x_lo in those that hold an unknown cell or a 4-neighbour of one;
    e_c in those that hold the coarse parent of an unknown cell; u in full
    where known cells are copied; every output in full. Kernel 7 masks by
    multiplies, so the sign of each output zero depends on every b and u:
    its two counts agree (:func:`v2_work`), as kernel 8's (mode
    ``stride2_mode``), which reads no mask. The flops count ~10 a sweep and
    ~8 for the residual on each cell that computes, ~40 for a residual
    cascade."""
    h, w = um.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    plane = h * w * 4
    ras = c * plane
    ec = c * hc * wc * 4
    half = c * hc * w * 4
    unk = c * 32 * _sectors(um)
    nbr = c * 32 * _sectors(_dilate4(um))
    coarse = F.pad(um.to(torch.uint8), (0, 2 * wc - w, 0, 2 * hc - h)).view(hc, 2, wc, 2)
    ec_unk = c * 32 * _sectors(coarse.amax(dim=(1, 3)).bool())
    n_unk = c * int(um.sum())
    jac = n_unk * (10 * sweeps + 8)
    res = n_unk * 40
    both = stride2_bytes(stride2_mode, (c, h, w))
    return {
        "jacobi_zero": (ras + plane + 2 * ras, unk + plane + 2 * ras, jac),
        "jacobi_corr": (2 * ras + plane + ec + 2 * ras, ras + unk + plane + ec_unk + 2 * ras, jac),
        "jacobi": (2 * ras + plane + 2 * ras, ras + unk + plane + 2 * ras, jac),
        "residual_entry": (ras + plane + 2 * ras, nbr + plane + 2 * ras, res),
        "residual_pair": (3 * ras + plane + ras, 2 * nbr + unk + plane + ras, res),
        "jacobi_zero_half": (ras + plane + ras + half, unk + plane + ras + half, jac),
        "jacobi_v2": v2_work(c, h, w, sweeps, True),
        "stride2": (both, both, 0),
    }
