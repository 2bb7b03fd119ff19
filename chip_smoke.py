#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``satellite_approximation_tpu_torch``)
on one NVIDIA GPU: builds the hand-written kernels from ``csrc/`` with nvcc,
holds each against its plain PyTorch version, drives the masked fill through
its public entry points at the size users run, and certifies the results.

    python3 chip_smoke.py                   # the smoke run
    python3 chip_smoke.py --against DIR     # kernels of the tree in DIR against these
    python3 chip_smoke.py --tile-detect     # detection alone, once at a full 10980^2 tile
    python3 chip_smoke.py --tile-entry      # the entry points alone, once at a full tile

Phases (each raises on failure, so the run exits non-zero):

1. device: the card's name and power limit, TF32 off for matmuls and cuDNN;
2. build: nvcc builds ``csrc/*.cu`` into ``csrc/build/``, one compiler
   process per source, all started together (seconds printed, and the
   compiler's register and spill report);
3. kernels: each of the eight kernels against its plain version on the
   card, at the main path's level-0 shape (13x2048x2048 f32) on the bench
   mask and on a 60 % random mask, and at 2x1373x1374 in f32 and bf16
   storage (the stride-2 kernel at the probe's 128x512 and at 13x2048x2048
   f32, in all four modes beside torch's own call, and at widths 1, 3, 7, 9,
   33 and on an x whose address is 4 mod 16 bytes; the residual kernels also
   with 1 and 5 bands at widths 2048 and 1373, and with each operand at an
   address 4 mod 16 bytes; the separate-operand smoother also with 1, 5 and
   13 bands at widths 2048 and 1373, deg in f32 and bf16, each operand at 4
   mod 16 bytes, and on windows one condition short of static) — bit-equal
   required;
   median times of both; each kernel's bound at the main shape, for the
   dense count and for what the bench mask needs, and torch's time to
   write the residual kernels' outputs alone (zero_()); the general smoother
   from u = 0 against the zero-start one, the separate-operand smoother
   against the general one with omega repeated, the half residual against
   the row pass of the full one;
4. main path: ``filling_missing_portions_smooth_boundaries`` and
   ``blend_images_poisson`` on bench.py's 13-band 2048^2 system, then
   ``multigrid.solve`` on it to 1e-6 (median of 5 after a warm-up); every
   result's relative residual is re-evaluated in f64 and must meet the
   tolerance, a small fill must match a direct sparse solve, and every
   kernel's launch count must have moved;
5. full tile: one band of a 10980^2 Sentinel-2 tile through ``laplace_fill``
   to 1e-6, with its time and peak device memory;
6. general iterate: 10 stationary cycles u <- V(b, u) from x0 = img * m on
   phase 4's system and on phase 5's band, the f64 residual and its
   contraction after each; from u = 0 the general route must be bit-equal
   to the zero-start one; one V-cycle at 13x2048^2 timed in two forms, the
   current route and one where the half-residual kernel feeds the
   restrict's column pass (bit-equal to it);
7. benchmark paths: ``benchmarks/x_kernel_v2.py``'s comparison of the
   separate-operand smoother with the general one (4096^2, 6 sweeps; the
   former beside its bound), and ``benchmarks/x_stride_probe.py``'s five
   idioms with its own checks;
8. detection: ``detect`` from pre-decoded rasters of a synthetic scene to the
   four mask files and a ``Status``, no hand-written kernel on its path.
   8a at 1024^2 in both routes (host: native scan and numpy refinement;
   all-device: torch sweep and refinement): cloud and potential-shadow masks
   equal, object and final masks at IoU >= 0.995, the scene not trivial; the
   normalization on the card bit-equal to numpy's f32 division for every
   u8 and u16 value, the pit fill on the card bit-equal to the native
   priority flood and the device LS reduction within 1e-6 of the host one. 8b at 4096^2 (>= 16
   Mpix, so backend "auto" takes the device stages), cold and warm, with the
   stage table, each stage's route and the peak device memory.
   ``--tile-detect`` runs phases 1 and 8 alone with 8b at 10980^2.
9. entry points, in process, on the card by default, each with its wall
   time split into reading, solving or detecting, and writing, and its peak
   device memory: 9a ``sat-torch-laplace`` on a 2048^2 RGB PNG and a marker
   PNG of bench.py's mask (the PNG equal to the fill in memory, its f64
   residual); 9b ``sat-torch-poisson`` on a 6-page 2048^2 f32 TIFF (one
   5-band output, the closed mask on the card bit-equal to the CPU's, each
   band's f64 residual <= 1e-6); 9c ``fill_missing_data_folder`` over three
   date folders of 13 bands at 2048^2 (one over the skip threshold, one
   without its shadow_mask.tif): files, DB rows, a residual per band, known
   pixels unchanged, then a second run that solves nothing, ``compute_index``
   and ``find_good_close_image``; 9d ``sat-torch-cloud-detection`` on
   ``synthesize(4096)``'s GeoTIFFs (masks equal to ``detect``'s in memory,
   ``cached`` on a second run). Kernels 1, 2, 4 and 5 must launch in 9a and
   9c, 1 and 2 in 9b. ``--tile-entry`` runs phases 1, 2 and 9 alone with 9b
   at 10980^2 and 9c on one date folder of the four 10 m bands at 10980^2.

Each path that a kernel's launch count is read from (phases 4, 6, 7 and
9a-9c) runs with every count set to 0 just before it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script prints no result and exits non-zero.

``--against DIR`` compares the compiled kernels of another checkout (DIR,
e.g. the parent commit unpacked with ``git archive``) with this one's on
one card, in turns parent, change, change, parent: phases 1 and 2, then
kernels 1-7 at 13x2048x2048 f32 on the bench mask and the 60 % mask (each
beside the bound that mask needs), kernel 8 in its four modes beside
torch's call, kernel 7 on a mask without an unknown cell and at phase 7's
4096^2 system with and without the residual, ``multigrid.solve`` on the
bench system, kernels 4 and 5 at the 10980^2 band's shape and one warm
10980^2 band. The two libraries share this tree's Python and C interface,
but for kernel 7, which each tree's own wrapper calls; the kernels of both
must be bit-equal to their plain versions. It ends with one
``{"against": ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
H = W = 2048
BANDS = 13
TILE = 10980
TOL = 1e-6
PALLAS = "satellite_approximation_tpu/ops/pallas_kernels.py"
CSRC = "satellite_approximation_tpu_torch/csrc"
KERNELS = {
    # wrapper name (launch-count key) -> (CUDA source, TPU kernel it replaces)
    "jacobi_zero": (f"{CSRC}/jacobi.cu", f"{PALLAS}:743"),
    "jacobi_corr": (f"{CSRC}/jacobi.cu", f"{PALLAS}:582"),
    "jacobi": (f"{CSRC}/jacobi.cu", f"{PALLAS}:377"),
    "residual_entry": (f"{CSRC}/residual.cu", f"{PALLAS}:1013"),
    "residual_pair": (f"{CSRC}/residual.cu", f"{PALLAS}:1023"),
    "jacobi_zero_half": (f"{CSRC}/jacobi.cu", f"{PALLAS}:649"),
    "jacobi_v2": (f"{CSRC}/jacobi_v2.cu", "benchmarks/x_kernel_v2.py:187"),
    "stride2": (f"{CSRC}/stride.cu", "benchmarks/x_stride_probe.py:29"),
}
STRIDE2_TIMED = "both"  # the mode whose times stand in the kernels line
# the kernels --against times, each on the bench mask and the 60 % mask
AGAINST = ("jacobi_zero", "jacobi_corr", "jacobi", "residual_entry", "residual_pair",
           "jacobi_zero_half", "jacobi_v2")
# published peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s, f32 flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# a stationary cycle may raise the residual only within this factor of the
# f32 floor (the residual of the f32-rounded solution)
FLOOR_FACTOR = 4.0

def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ inputs


def make_mask(h, w, seed=3):
    """bench.py's synthetic cloud field: union of 40 ellipses."""
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), dtype=bool)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(40):
        cy, cx = r.integers(40, h - 40), r.integers(40, w - 40)
        ry, rx = r.integers(8, h // 24), r.integers(8, w // 24)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    return m


def small_mask(h, w, seed=4):
    """A few ellipses on a small grid, border known."""
    r = np.random.default_rng(seed)
    yy, xx = np.ogrid[:h, :w]
    m = np.zeros((h, w), dtype=bool)
    for _ in range(6):
        cy, cx, ry, rx = r.integers(5, h - 5), r.integers(5, w - 5), *r.integers(3, 15, 2)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    return m


def smooth(h, w, seed):
    """bench.py's smooth random field."""
    r = np.random.default_rng(seed)
    x = r.random((h, w), dtype=np.float32)
    for _ in range(4):
        x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1) + np.roll(x, -1, 1))
    return x


def tile_mask(torch, n, device, seed=5):
    """A full-tile cloud field built on the device: bench.py's ellipse
    statistics at the density of its 2048^2 field (40 per 2048^2)."""
    r = np.random.default_rng(seed)
    m = torch.zeros((n, n), dtype=torch.bool, device=device)
    count = int(40 * (n / 2048) ** 2)
    for _ in range(count):
        cy, cx = int(r.integers(40, n - 40)), int(r.integers(40, n - 40))
        ry, rx = int(r.integers(8, 2048 // 24)), int(r.integers(8, 2048 // 24))
        y0, y1 = max(cy - ry, 0), min(cy + ry + 1, n)
        x0, x1 = max(cx - rx, 0), min(cx + rx + 1, n)
        yy = torch.arange(y0, y1, device=device, dtype=torch.float64)[:, None]
        xx = torch.arange(x0, x1, device=device, dtype=torch.float64)[None, :]
        m[y0:y1, x0:x1] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    return m


def tile_image(torch, n, device, seed=6):
    """A smooth u16-range reflectance band (integers, exact in f32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, n), generator=g, device=device)
    for _ in range(4):
        x = 0.25 * (x.roll(1, 0) + x.roll(-1, 0) + x.roll(1, 1) + x.roll(-1, 1))
    return torch.round(x * 10000.0)[None]


# ------------------------------------------------------------- certificates


def s4(v):
    """Sum of the four in-image neighbours (zero outside)."""
    import torch.nn.functional as F

    p = F.pad(v, (1, 1, 1, 1))
    h, w = v.shape[-2:]
    return p[..., :h, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :w] + p[..., 1:-1, 2:]


def rel_residual(torch, out, umask, known_src, guidance=None):
    """max over bands of ||b - A x|| / ||b|| in f64 on the device, for the
    system the fill solved: x = ``out`` on ``umask``, known values
    ``known_src`` elsewhere, b = Dirichlet sums (+ the guidance divergence)."""
    dev = umask.device
    x = torch.as_tensor(out, device=dev, dtype=torch.float64)
    src = torch.as_tensor(known_src, device=dev, dtype=torch.float64)
    um = umask.to(torch.float64)
    deg = s4(torch.ones_like(um))  # in-image neighbour count

    known = src * (1.0 - um)
    b = s4(known)
    if guidance is not None:
        g = torch.as_tensor(guidance, device=dev, dtype=torch.float64)
        b = b + deg * g - s4(g)
    xu = x * um
    r = (b - (deg * xu - s4(xu))) * um
    b = b * um
    rel = torch.linalg.vector_norm(r, dim=(-2, -1)) / torch.linalg.vector_norm(b, dim=(-2, -1))
    return float(rel.max())


def direct_reference(img, umask):
    """f64 sparse direct solve of the Laplace system, per band (scipy)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    h, w = umask.shape
    idx = -np.ones((h, w), dtype=np.int64)
    ys, xs = np.nonzero(umask)
    n = len(ys)
    idx[ys, xs] = np.arange(n)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.full(n, 4.0)]
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        y2, x2 = ys + dy, xs + dx
        unk = umask[y2, x2]
        rows.append(idx[ys[unk], xs[unk]])
        cols.append(idx[y2[unk], x2[unk]])
        vals.append(np.full(int(unk.sum()), -1.0))
    a = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), (n, n))
    out = img.astype(np.float64).copy()
    for c in range(img.shape[0]):
        known = img[c].astype(np.float64) * (~umask)
        p = np.pad(known, 1)
        b = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])[ys, xs]
        out[c, ys, xs] = spla.spsolve(a.tocsc(), b)
    return out


# ------------------------------------------------------------------ phases


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {smi}")
    log(
        f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"kind={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def phase_build(K):
    t0 = time.perf_counter()
    lib = K.build()
    K._library()
    dt = time.perf_counter() - t0
    log(f"[2 build] {lib.relative_to(REPO)} in {dt:.3f} s")
    report = lib.with_name(lib.name.replace("libsatstencil_", "nvcc_").replace(".so", ".log"))
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build]   {line.strip()}")


def _median_ms(torch, fn, runs=7, min_ms=2.0):
    """Median over ``runs`` samples of one call's device time. Each sample
    times back-to-back calls between two CUDA events, as many as fill
    ``min_ms``: one wrapper call costs the host ~50 us, which a single timed
    call would count whenever the kernel is shorter."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    reps = max(1, math.ceil(min_ms / max(a.elapsed_time(b), 1e-3)))
    times = []
    for _ in range(runs):
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _bitwise(torch, got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        err = max(err, float((g.float() - w.float()).abs().max()))
        if g.dtype != w.dtype or not torch.equal(g.view(view), w.view(view)):
            raise AssertionError(f"kernel output differs from its plain version (max |d| {err})")
    return err


def _value_diff(torch, got, want):
    """(max |d|, cells whose bits differ although the values are equal —
    zeros of opposite sign) over a pair of outputs or pairs of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, signs = 0.0, 0
    for g, w in zip(got, want):
        view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        err = max(err, float((g.float() - w.float()).abs().max()))
        signs += int(((g == w) & (g.view(view) != w.view(view))).sum())
    return err, signs


def _sectors(torch, need, elt=4):
    """32-byte sectors of a row-major raster of ``elt``-byte cells that hold
    a True cell of the (H, W) ``need``."""
    per = 32 // elt
    flat = need.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per).any(dim=1).sum())


def _dilate4(torch, m):
    """m or any of its 4-neighbours."""
    import torch.nn.functional as F

    p = F.pad(m.to(torch.uint8), (1, 1, 1, 1)).bool()
    h, w = m.shape
    return m | p[:h, 1:-1] | p[2:, 1:-1] | p[1:-1, :w] | p[1:-1, 2:]


def kernel_work(torch, um, c, sweeps):
    """Per kernel at (c, H, W) f32 on the mask ``um``: (dense bytes, bytes
    this mask needs, flops). Dense: every operand read once, every output
    written once. For this mask: invm everywhere; b and x_hi only in the
    32-byte sectors that hold an unknown cell; the residual kernels' image
    and x_lo in those that hold an unknown cell or a 4-neighbour of one;
    e_c in those that hold the coarse parent of an unknown cell; u in full
    where known cells are copied; every output in full. Kernel 7 masks by
    multiplies, so the sign of each output zero depends on every b and u:
    its two counts agree (``v2_work``), as kernel 8's, which reads no mask.
    The flops count ~10 a sweep and ~8 for the residual on each cell that
    computes, ~40 for a residual cascade."""
    import torch.nn.functional as F

    h, w = um.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    plane = h * w * 4
    ras = c * plane
    ec = c * hc * wc * 4
    half = c * hc * w * 4
    unk = c * 32 * _sectors(torch, um)
    nbr = c * 32 * _sectors(torch, _dilate4(torch, um))
    coarse = F.pad(um.to(torch.uint8), (0, 2 * wc - w, 0, 2 * hc - h)).view(hc, 2, wc, 2)
    ec_unk = c * 32 * _sectors(torch, coarse.amax(dim=(1, 3)).bool())
    n_unk = c * int(um.sum())
    jac = n_unk * (10 * sweeps + 8)
    res = n_unk * 40
    v2 = v2_work(c, h, w, sweeps, True)
    both = stride2_bytes(STRIDE2_TIMED, (c, h, w))
    return {
        "jacobi_zero": (ras + plane + 2 * ras, unk + plane + 2 * ras, jac),
        "jacobi_corr": (2 * ras + plane + ec + 2 * ras, ras + unk + plane + ec_unk + 2 * ras, jac),
        "jacobi": (2 * ras + plane + 2 * ras, ras + unk + plane + 2 * ras, jac),
        "residual_entry": (ras + plane + 2 * ras, nbr + plane + 2 * ras, res),
        "residual_pair": (3 * ras + plane + ras, 2 * nbr + unk + plane + ras, res),
        "jacobi_zero_half": (ras + plane + ras + half, unk + plane + ras + half, jac),
        "jacobi_v2": v2,
        "stride2": (both, both, 0),
    }


def v2_work(c, h, w, sweeps, emit, deg_bytes=4):
    """(dense bytes, bytes any mask needs, flops) of kernel 7 at (c, h, w)
    f32, at the bytes its caller hands it: u and b, the bool mask (one byte
    a cell) and deg (``deg_bytes`` a cell) once, u and, with ``emit``, r."""
    ras = c * h * w * 4
    nbytes = 2 * ras + h * w * (1 + deg_bytes) + (2 if emit else 1) * ras
    return nbytes, nbytes, c * h * w * (10 * sweeps + (8 if emit else 0))


def known_windows(torch, um, tile=48, ring=8):
    """Share of kernel 7's windows (each ``tile``-square tile with its
    ``ring``) that hold no unknown cell of the (H, W) mask ``um``: those
    stream in jacobi_v2.cu."""
    import torch.nn.functional as F

    h, w = um.shape
    ty, tx = -(-h // tile), -(-w // tile)
    pad = (ring, tx * tile + ring - w, ring, ty * tile + ring - h)
    m = F.pad(um.float()[None, None], pad)
    win = F.max_pool2d(m, kernel_size=tile + 2 * ring, stride=tile)
    return float((win == 0).float().mean())


def stride2_bytes(mode, shape):
    """Bytes kernel 8 must move on an f32 x of ``shape`` (..., rows, cols):
    the rows it reads (the even ones for "rows" and "both", whose every
    32-byte sector holds an even column; the first half of each row for
    "interleave") and its output."""
    *lead, r, c = shape
    n = int(np.prod(lead, dtype=np.int64))
    rh, ch = (r + 1) // 2, (c + 1) // 2
    read = {"rows": rh * c, "cols": r * c, "both": rh * c, "interleave": r * (c // 2)}[mode]
    write = {"rows": rh * c, "cols": r * ch, "both": rh * ch, "interleave": r * c}[mode]
    return 4 * n * (read + write)


def bound_ms(nbytes, flops):
    """(the least ms the card could take, what bounds it) at its published
    peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_stride2_edges(torch, K, dev):
    """Kernel 8 bit-equal at ragged widths, odd row counts, one row, and on
    an x whose address is 4 mod 16 bytes (its scalar path)."""
    gen = np.random.default_rng(1)
    xs = []
    for width in (1, 3, 7, 8, 9, 33, 64):
        for shape in ((2, 5, width), (3, 1, width), (2, 2, 6, width)):
            xs.append(torch.from_numpy(gen.random(shape, np.float32)).to(dev))
    xs.append(_shifted(torch.from_numpy(gen.random((3, 7, 64), np.float32)).to(dev)))
    for x in xs:
        for mode in K.STRIDE2_MODES:
            if mode != "interleave" or x.shape[-1] % 2 == 0:
                _bitwise(torch, K.stride2(x, mode), K.stride2_plain(x, mode))
    log("[3 kernels] stride2 bit-equal at widths 1, 3, 7, 8, 9, 33, 64 (5, 1 and 2x6 rows) "
        "and on an x at 4 mod 16 bytes")


def _shifted(t):
    """A contiguous copy of ``t`` 4 bytes past an aligned allocation (so at
    an address 4 mod 16 bytes)."""
    k = 4 // t.element_size()
    flat = t.new_empty(t.numel() + k)
    out = flat[k:].view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 != 4:
        raise AssertionError(f"expected an address 4 mod 16, got {out.data_ptr() % 16}")
    return out


def residual_inputs(torch, K, um, c, dtype, gen):
    """(img, x_hi, x_lo, invm) of the residual kernels on the mask ``um`` with
    ``c`` bands: an integer image, x_hi and x_lo zero on known cells."""
    from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor

    h, w = um.shape
    dev = um.device
    invm = K.invm_for_kernel(um, neighbor_degree_tensor(h, w, dev)).to(dtype)
    img = torch.round(torch.rand((c, h, w), generator=gen, device=dev) * 10000)
    x_hi = torch.rand((c, h, w), generator=gen, device=dev) * 9000 * um
    x_lo = torch.randn((c, h, w), generator=gen, device=dev) * 1e-4 * um
    return img, x_hi, x_lo, invm


def check_residual_edges(torch, K, dev):
    """Kernels 4 and 5 bit-equal with 1 and 5 bands (band groups of every
    size), at width 2048 (16-byte strips) and 1373 (per-cell path), with f32
    and bf16 invm, and with img, x_hi, x_lo or invm at an address 4 mod 16
    bytes (per-cell path)."""
    gen = torch.Generator(device=dev).manual_seed(7)

    def both(img, x_hi, x_lo, invm):
        _bitwise(torch, K.residual_entry(img, invm), K.residual_entry_plain(img, invm))
        _bitwise(torch, K.residual_pair(img, x_hi, x_lo, invm),
                 K.residual_pair_plain(img, x_hi, x_lo, invm))

    for c in (1, 5):
        for w in (2048, 1373):
            um = torch.rand((517, w), generator=gen, device=dev) > 0.4
            for dtype in (torch.float32, torch.bfloat16):
                both(*residual_inputs(torch, K, um, c, dtype, gen))
    um = torch.from_numpy(make_mask(517, 2048)).to(dev)
    ops = residual_inputs(torch, K, um, 5, torch.float32, gen)
    for k in range(len(ops)):
        both(*(_shifted(t) if n == k else t for n, t in enumerate(ops)))
    log("[3 kernels] residual_entry and residual_pair bit-equal with 1 and 5 bands at widths "
        "2048 and 1373 (f32 and bf16 invm), and with img, x_hi, x_lo or invm at 4 mod 16 bytes")


def v2_edge_inputs(torch, c, w, dev, gen, kind="static"):
    """(u, b, umask, deg) of kernel 7 at (c, 241, w) f32: bench.py's mask
    statistics (most 48x48 tiles' windows entirely known), cleared around
    the window of tile (1, 1) (image rows and columns 40 .. 103), and there
    ``kind``: ``static`` nothing more, else one condition short of a static
    window on a known cell of band 0 (``neg0``, ``inf``, ``nan``, ``bmax``,
    ``umax``), or an unknown cell at one corner of the window's outer ring
    or the ring inside it (``ring0-<corner>``, ``ring1-<corner>``)."""
    from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor

    h = 241
    um = torch.from_numpy(make_mask(h, w)).to(dev)
    um[30:114, 30:114] = False
    u = torch.rand((c, h, w), generator=gen, device=dev) * 2 - 1
    b = torch.rand((c, h, w), generator=gen, device=dev) * 2 - 1
    special = {"neg0": ("u", -0.0), "inf": ("u", math.inf), "nan": ("u", math.nan),
               "bmax": ("b", -3.4e38), "umax": ("u", 3.4e38)}
    if kind in special:
        name, value = special[kind]
        (u if name == "u" else b)[0, 70, 70] = value
        if kind == "bmax":
            u[0, 70, 70] = 1e38  # b - A u overflows
    elif kind.startswith("ring"):
        ring, corner = int(kind[4]), kind.split("-")[1]
        lo, hi = 40 + ring, 103 - ring
        um[lo if corner[0] == "t" else hi, lo if corner[1] == "l" else hi] = True
    elif kind != "static":
        raise ValueError(kind)
    return u, b, um, neighbor_degree_tensor(h, w, dev)


V2_EDGE_KINDS = ("neg0", "inf", "nan", "bmax", "umax",
                 *(f"ring{r}-{c}" for r in (0, 1) for c in ("tl", "tr", "bl", "br")))


def check_v2_edges(torch, K, dev):
    """Kernel 7 bit-equal with 1, 5 and 13 bands (band groups of every
    size), at widths 2048 and 1373, in f32 and bf16 with deg in f32 and in
    the storage dtype, with each operand at an address 4 mod 16 bytes, and
    on windows one condition short of static (``v2_edge_inputs``)."""
    gen = torch.Generator(device=dev).manual_seed(8)

    def both(u, b, um, deg, dtype, deg_dtype):
        u, b, deg = u.to(dtype), b.to(dtype), deg.to(deg_dtype)
        for sweeps, emit in ((8, False), (7, True)):
            _bitwise(torch, K.jacobi_v2(u, b, um, deg, sweeps, 0.8, emit),
                     K.jacobi_v2_plain(u, b, um, deg, sweeps, 0.8, emit))

    dtypes = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))
    for c in (1, 5, 13):
        for w in (2048, 1373):
            ops = v2_edge_inputs(torch, c, w, dev, gen)
            for dtype, deg_dtype in dtypes:
                both(*ops, dtype, deg_dtype)
    ops = v2_edge_inputs(torch, 5, 2048, dev, gen)
    for k in range(len(ops)):
        both(*(_shifted(t) if n == k else t for n, t in enumerate(ops)), *dtypes[0])
    for kind in V2_EDGE_KINDS:
        for w in (2048, 1373):  # the 16-byte streaming path and the per-cell one
            for dtype, deg_dtype in dtypes[:2]:
                both(*v2_edge_inputs(torch, 2, w, dev, gen, kind), dtype, deg_dtype)
    log("[3 kernels] jacobi_v2 bit-equal with 1, 5 and 13 bands at widths 2048 and 1373 (f32, "
        "bf16; deg f32 and bf16), with u, b, mask or deg at 4 mod 16 bytes, and on windows one "
        f"condition short of static ({', '.join(V2_EDGE_KINDS)})")


def kernel_inputs(torch, K, mg, tag, shape, dtype, dev):
    """The kernels' inputs at ``shape`` on the bench mask (``tag`` "main") or
    on a 60 % random mask, drawn from a generator seeded by the shape, and
    each kernel's call beside its plain version on them: ``calls`` with the
    residual emitted, ``bare`` the three smoothers without it (as every level
    below the top calls them)."""
    from types import SimpleNamespace

    from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor

    c, h, w = shape
    pre = mg._smoother_omegas(mg._PRE_SMOOTH)
    post = tuple(reversed(mg._smoother_omegas(mg._POST_SMOOTH)))
    v2 = (0.8,) * mg._PRE_SMOOTH
    g = torch.Generator(device=dev).manual_seed(h + c)
    if tag == "main":
        um = torch.from_numpy(make_mask(h, w)).to(dev)
    else:
        um = torch.rand((h, w), generator=g, device=dev) > 0.4
    deg = neighbor_degree_tensor(h, w, dev)
    invm = K.invm_for_kernel(um, deg).to(dtype)
    b = torch.rand(shape, generator=g, device=dev).to(dtype)
    u = torch.rand(shape, generator=g, device=dev).to(dtype)
    e_c = torch.randn((c, (h + 1) // 2, (w + 1) // 2), generator=g, device=dev).to(dtype)
    img, x_hi, x_lo, _ = residual_inputs(torch, K, um, c, dtype, g)

    def pair(name, *args):
        # the wrapper is looked up at each call, so kernels_from can swap it
        plain = getattr(K, f"{name}_plain")
        return (lambda: getattr(K, name)(*args)), (lambda: plain(*args))

    calls = {
        "jacobi_zero": pair("jacobi_zero", b, invm, pre, True),
        "jacobi_corr": pair("jacobi_corr", u, b, invm, e_c, post, True),
        "jacobi": pair("jacobi", u, b, invm, pre, True),
        "residual_entry": pair("residual_entry", img, invm),
        "residual_pair": pair("residual_pair", img, x_hi, x_lo, invm),
        "jacobi_zero_half": pair("jacobi_zero", b, invm, pre, "half"),
        "jacobi_v2": pair("jacobi_v2", u, b, um, deg, len(v2), v2[0], True),
    }
    bare = {
        "jacobi_zero": pair("jacobi_zero", b, invm, pre, False),
        "jacobi_corr": pair("jacobi_corr", u, b, invm, e_c, post, False),
        "jacobi": pair("jacobi", u, b, invm, pre, False),
    }
    return SimpleNamespace(um=um, deg=deg, invm=invm, b=b, u=u, pre=pre, v2=v2,
                           calls=calls, bare=bare)


def phase_kernels(torch, K, mg, dev):
    """Every kernel bit-equal to its plain version; times and bounds at the
    main shape on the bench mask and on a 60 % mask."""
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    bounds = {}

    def record(name, tag, shape, dtype, kern, plain, label=None):
        err = _bitwise(torch, kern(), plain())
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms, plain_ms = _median_ms(torch, kern), _median_ms(torch, plain)
        line = (f"[3 kernels] {tag:5s} {label or name:16s} {'x'.join(map(str, shape))} "
                f"{str(dtype)[6:]:8s} bit-equal max|d|={err:.1e} kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms")
        if name in bounds:
            dense_bytes, need_bytes, flops = bounds[name]
            if name == "stride2":
                dense_bytes = need_bytes = stride2_bytes(label, shape)
            dense, need, by = bound_ms(dense_bytes, flops)[0], *bound_ms(need_bytes, flops)
            line += (f"; bound dense {dense:.4f} ms ({dense / ms:.0%}), this mask {need:.4f} ms "
                     f"({need / ms:.0%}, {by})")
            if tag == "main" and label in (None, STRIDE2_TIMED):
                res.update(ms=ms, plain_ms=plain_ms, bound_ms=need, bound_by=by,
                           # kernel 8's plain version is torch's own call, a
                           # strided slice and .contiguous()
                           library_ms=plain_ms if name == "stride2" else None)
        log(line)

    cases = [((BANDS, H, W), torch.float32, "main"), ((BANDS, H, W), torch.float32, "dense"),
             ((2, 1373, 1374), torch.float32, "odd"), ((2, 1373, 1374), torch.bfloat16, "odd")]
    for shape, dtype, tag in cases:
        x = kernel_inputs(torch, K, mg, tag, shape, dtype, dev)
        b, u, invm, um, deg, pre, v2 = x.b, x.u, x.invm, x.um, x.deg, x.pre, x.v2
        bounds = kernel_work(torch, um, shape[0], len(pre)) if tag in ("main", "dense") else {}
        if bounds:
            need = ", ".join(f"{k} {v[1] / 1e9:.3f}" for k, v in bounds.items())
            log(f"[3 kernels] {tag}: {float(um.float().mean()) * 100:.2f}% unknown, "
                f"{known_windows(torch, um):.1%} of kernel 7's windows without an unknown cell; "
                f"GB this mask needs: {need}")
        for name, (kern, plain) in x.bare.items():
            err = _bitwise(torch, kern(), plain())
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        for name, (kern, plain) in x.calls.items():
            record(name, tag, shape, dtype, kern, plain)

        # kernel 3 from u = 0 is kernel 1, up to the sign of zero
        err, signs = _value_diff(torch, K.jacobi(torch.zeros_like(b), b, invm, pre, True),
                                 K.jacobi_zero(b, invm, pre, True))
        if err != 0.0:
            raise AssertionError(f"jacobi from u = 0 differs from jacobi_zero: max |d| {err}")
        log(f"[3 kernels] jacobi(u=0) vs jacobi_zero: max|d|={err:.1e}, {signs} zeros of "
            "opposite sign")
        # kernel 6's half residual is the row pass of kernel 1's full residual
        _bitwise(torch, K.jacobi_zero(b, invm, pre, "half")[1],
                 K.restrict_rows(K.jacobi_zero(b, invm, pre, True)[1]))
        log("[3 kernels] jacobi_zero_half vs row pass of jacobi_zero's residual: bit-equal")
        # kernel 7 against kernel 3 with omega repeated (benchmarks/x_kernel_v2.py:265-275);
        # in bf16 kernel 3 reads 1/deg rounded to bf16, kernel 7 computes it in f32
        err, signs = _value_diff(torch, K.jacobi_v2(u, b, um, deg, len(v2), v2[0], True),
                                 K.jacobi(u, b, invm, v2, True))
        log(f"[3 kernels] jacobi_v2 vs jacobi, omega {v2[0]} x{len(v2)}, "
            f"{str(dtype)[6:]}: max|d|={err:.3e}, {signs} zeros of opposite sign")
        if dtype == torch.float32 and err != 0.0:
            raise AssertionError(f"jacobi_v2 differs from jacobi in f32: max |d| {err}")
        if tag == "main":
            for mode in K.STRIDE2_MODES:
                record("stride2", tag, shape, dtype, lambda mode=mode: K.stride2(b, mode),
                       lambda mode=mode: K.stride2_plain(b, mode), label=mode)
            # the residual kernels' output stream alone, as torch writes it
            outs = (torch.empty_like(b), torch.empty_like(b))
            for n, name in ((2, "residual_entry"), (1, "residual_pair")):
                ms = _median_ms(torch, lambda n=n: [o.zero_() for o in outs[:n]])
                log(f"[3 kernels] {tag:5s} {name} outputs alone (torch zero_() of {n} raster(s)): "
                    f"{ms:.4f} ms, {n * b.numel() * 4 / ms / 1e9:.3f} TB/s")
            del outs
        del x, b, u, invm, um, deg
        torch.cuda.empty_cache()
    bounds = {}
    x = torch.from_numpy(np.random.default_rng(0).random((128, 512), np.float32)).to(dev)
    for mode in K.STRIDE2_MODES:
        record("stride2", "probe", (128, 512), torch.float32,
               lambda mode=mode: K.stride2(x, mode), lambda mode=mode: K.stride2_plain(x, mode),
               label=mode)
    check_stride2_edges(torch, K, dev)
    check_residual_edges(torch, K, dev)
    check_v2_edges(torch, K, dev)
    return results


def bench_images():
    """bench.py's 13-band 2048^2 system: (its mask, its f64 images)."""
    umask = make_mask(H, W)
    return umask, np.stack([smooth(H, W, s) for s in range(BANDS)]).astype(np.float64)


def bench_rhs(umask, imgs):
    """bench.py's rhs system on ``imgs``: the in-image degree and
    b = the sum of the known neighbours, on unknowns."""
    h, w = umask.shape
    deg = np.full((h, w), 4.0, dtype=np.float32)
    deg[0, :] -= 1
    deg[-1, :] -= 1
    deg[:, 0] -= 1
    deg[:, -1] -= 1
    known = imgs * (~umask)
    p = np.pad(known, ((0, 0), (1, 1), (1, 1)))
    b = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]) * umask
    return deg, b


def timed_solves(torch, K, multigrid, b_t, umask, deg, x0_t, runs=5):
    """``multigrid.solve`` to TOL once to warm up and ``runs`` times timed:
    (the last result, the wall times, the kernel launches of the last)."""

    def solve_once():
        res = multigrid.solve(b_t, umask, deg=deg, x0=x0_t, tolerance=TOL,
                              refinement_steps=4, device_output=True)
        torch.cuda.synchronize()
        return res

    solve_once()  # warm-up
    times = []
    for _ in range(runs):
        before = dict(K.launch_counts)
        t0 = time.perf_counter()
        res = solve_once()
        times.append(time.perf_counter() - t0)
    per_solve = {k: v - before[k] for k, v in K.launch_counts.items()}
    return res, times, per_solve


def phase_main_path(torch, K, dev, card):
    import satellite_approximation_tpu_torch as port
    from satellite_approximation_tpu_torch.config import SolverConfig
    from satellite_approximation_tpu_torch.models import fill, multigrid

    # a small fill against a direct f64 sparse solve
    sm = small_mask(130, 97)
    simg = np.stack([smooth(130, 97, s) for s in range(2)])
    small = fill.laplace_fill(simg, sm, tolerance=1e-9, refinement_steps=4,
                              device_output=False, device=dev)
    ref = direct_reference(simg, sm)
    small_err = float(np.abs(small.x - ref).max())
    if not (small_err <= 1e-5 and small.error <= 1e-9):
        raise AssertionError(f"small fill vs direct solve: {small_err}, residual {small.error}")
    log(f"[4 main] small fill 2x130x97 vs scipy spsolve: max|d|={small_err:.2e} "
        f"residual {small.error:.2e}")

    umask, imgs = bench_images()
    repl = np.stack([smooth(H, W, 100 + s) for s in range(BANDS)]).astype(np.float64)
    um_t = torch.from_numpy(umask).to(dev)
    n_masked = int(umask.sum()) * BANDS
    log(f"[4 main] bench system {BANDS}x{H}x{W}, {umask.mean() * 100:.2f}% masked")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    filled = port.filling_missing_portions_smooth_boundaries(imgs, umask)
    t_fill = time.perf_counter() - t0
    if filled.shape != imgs.shape or not np.isfinite(filled).all():
        raise AssertionError("fill output has the wrong shape or non-finite values")
    if not np.array_equal(filled[:, ~umask], imgs[:, ~umask]):
        raise AssertionError("fill changed known pixels")
    # laplace.solve_matrix solves to 1e-9 with multigrid, 1e-7 with plain CG
    fill_tol = 1e-9 if umask.sum() >= SolverConfig().mg_threshold_pixels else 1e-7
    rel_fill = rel_residual(torch, filled, um_t, imgs)
    if not rel_fill <= fill_tol:
        raise AssertionError(f"fill residual {rel_fill} > {fill_tol}")
    log(f"[4 main] filling_missing_portions_smooth_boundaries: {t_fill:.4f} s (first call), "
        f"f64 residual {rel_fill:.3e} <= {fill_tol}")

    t0 = time.perf_counter()
    blended = port.blend_images_poisson(imgs, repl, umask, tolerance=TOL)
    t_blend = time.perf_counter() - t0
    rel_blend = rel_residual(torch, blended, um_t, imgs, guidance=repl)
    if not (np.isfinite(blended).all() and rel_blend <= TOL):
        raise AssertionError(f"blend residual {rel_blend} > {TOL}")
    log(f"[4 main] blend_images_poisson: {t_blend:.4f} s, f64 residual {rel_blend:.3e} <= {TOL}")

    deg, b = bench_rhs(umask, imgs)
    b_t = torch.from_numpy(b).to(dev)
    x0_t = torch.from_numpy(imgs * umask).to(dev)
    res, times, per_solve = timed_solves(torch, K, multigrid, b_t, umask, deg, x0_t)
    counts = dict(K.launch_counts)
    med = statistics.median(times)
    # rhs mode: b is given, so re-evaluate b - A x directly
    ax = res.x * um_t
    r = (b_t - (torch.from_numpy(deg).to(dev).double() * ax - s4(ax))) * um_t
    rel_solve = float((torch.linalg.vector_norm(r, dim=(-2, -1))
                       / torch.linalg.vector_norm(b_t, dim=(-2, -1))).max())
    if not (res.error <= TOL and rel_solve <= TOL):
        raise AssertionError(f"solve residual {res.error} / f64 {rel_solve} > {TOL}")
    log(f"[4 main] multigrid.solve {BANDS}x{H}x{W} to {TOL}: {res.iterations} iterations, "
        f"median {med:.6f} s of {[round(t, 6) for t in times]}, "
        f"{n_masked / med / 1e6:.3f} masked Mpix/s, certified {res.error:.3e}, "
        f"f64 residual {rel_solve:.3e} [{card}]")
    counts = {k: counts[k] for k in ("jacobi_zero", "jacobi_corr", "residual_entry",
                                     "residual_pair")}
    missing = [k for k, v in counts.items() if v == 0]
    log(f"[4 main] kernel launches on the main path: {counts}; in one multigrid.solve: "
        f"{ {k: v for k, v in per_solve.items() if v} }")
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # phase 6 reuses the system; kept on the host, so phase 5's peak memory
    # counts only the tile
    return counts, (umask, deg, b, imgs * umask)


def band_fill(torch, m, img, dev):
    """One ``laplace_fill`` of the band ``img`` on the mask ``m`` to TOL,
    checked: (seconds, iterations, certified residual, peak GiB)."""
    from satellite_approximation_tpu_torch.models import fill

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fill.laplace_fill(img, m, tolerance=TOL, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = res.x
    if out.shape != m.shape and out.shape != (1, *m.shape):
        raise AssertionError(f"tile output shape {tuple(out.shape)}")
    if not (bool(torch.isfinite(out).all()) and res.error <= TOL):
        raise AssertionError(f"tile fill: residual {res.error} or non-finite output")
    if not torch.equal(out[..., ~m], img[..., ~m]):
        raise AssertionError("tile fill changed known pixels")
    return dt, res.iterations, res.error, torch.cuda.max_memory_allocated() / 2**30


def phase_full_tile(torch, dev, card):
    m = tile_mask(torch, TILE, dev)
    img = tile_image(torch, TILE, dev)
    torch.cuda.synchronize()
    log(f"[5 tile] 1x{TILE}x{TILE}, {float(m.float().mean()) * 100:.2f}% masked")
    for run in ("cold", "warm"):
        dt, iters, err, peak = band_fill(torch, m, img, dev)
        log(f"[5 tile] laplace_fill ({run} hierarchy): {dt:.4f} s, {iters} iterations, "
            f"certified {err:.3e}, peak {peak:.3f} GiB [{card}]")
    return m, img


def rhs_residual(torch, u, b, umask, deg):
    """max over bands of ||(b - A u) * m|| / ||b|| in f64, A the masked
    5-point operator with the in-image degree ``deg``."""
    um = umask.to(torch.float64)
    x = u.to(torch.float64) * um
    b64 = b.to(torch.float64)
    r = (b64 - (deg.to(torch.float64) * x - s4(x))) * um
    rel = torch.linalg.vector_norm(r, dim=(-2, -1)) / torch.linalg.vector_norm(b64, dim=(-2, -1))
    return float(rel.max())


def stationary_cycles(torch, K, mg, pb, b, x0, umask, deg, label, card, cycles=10):
    """``cycles`` stationary V-cycles u <- V(b, u) from ``x0`` (kernel 3 for
    the pre-smooth at the top): the f64 residual and its contraction after
    each. The residual must fall in every cycle until it reaches the f32
    floor, the residual of the f32-rounded solution of the same system
    (double-float ``multigrid.solve`` to 1e-10); there it may jitter within
    FLOOR_FACTOR times the floor, and the last cycle must end there.
    Returns the launch counts of the cycles."""
    sol = mg.solve(b.double(), umask, deg=deg, tolerance=1e-10, refinement_steps=4,
                   device_output=True)
    floor = rhs_residual(torch, sol.x.float(), b, umask, deg)
    log(f"[6 general] {label}: f32 floor {floor:.3e} (f64 solution to {sol.error:.2e}, "
        f"its own residual {rhs_residual(torch, sol.x, b, umask, deg):.3e})")
    del sol
    u = x0
    prev = rhs_residual(torch, u, b, umask, deg)
    log(f"[6 general] {label}: cycle 0 (x0 = img * m) residual {prev:.6e}")
    K.reset_launch_counts()
    for k in range(1, cycles + 1):
        t0 = time.perf_counter()
        u = mg._v_cycle(pb, b, u)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cur = rhs_residual(torch, u, b, umask, deg)
        log(f"[6 general] {label}: cycle {k} residual {cur:.6e} contraction {cur / prev:.6f} "
            f"({cur / floor:.3f}x floor) {dt * 1e3:.3f} ms [{card}]")
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{label}: cycle {k} left non-finite values")
        if cur > prev and cur > FLOOR_FACTOR * floor:
            raise AssertionError(f"{label}: cycle {k} raised the residual {prev:.3e} -> {cur:.3e}")
        prev = cur
    counts = dict(K.launch_counts)
    if prev > FLOOR_FACTOR * floor:
        raise AssertionError(f"{label}: {cycles} cycles end at {prev:.3e}, above "
                             f"{FLOOR_FACTOR} x the f32 floor {floor:.3e}")
    return counts


def v_cycle_half_restrict(K, mg, pb, b, lvl=0, emit_top_residual=False):
    """``mg._v_cycle(pb, b)`` with kernel 6 in place of kernel 1: the
    pre-smooth emits its residual with the row pairs summed, and only the
    restrict's column pass remains. Bit-equal to the current route."""
    um, deg = pb.levels[lvl]
    if lvl == len(pb.levels) - 1:
        return mg._coarse_solve(b, um, deg, pb.coarse_inv)
    pre = mg._smoother_omegas(mg._PRE_SMOOTH)
    post = tuple(reversed(mg._smoother_omegas(mg._POST_SMOOTH)))
    invm = pb.invms[lvl]
    u, rows = K.jacobi_zero(b, invm, pre, emit_residual="half")
    r_c = mg._restrict_cols(rows) * pb.levels[lvl + 1][0].to(rows.dtype)
    e_c = v_cycle_half_restrict(K, mg, pb, r_c, lvl + 1)
    return K.jacobi_corr(u, b, invm, e_c, post, emit_residual=emit_top_residual)


def phase_general_iterate(torch, K, dev, card, system, tile):
    from satellite_approximation_tpu_torch.models import multigrid as mg
    from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor

    umask_np, deg_np, b64, x064 = system
    umask = torch.from_numpy(umask_np).to(dev)
    deg = torch.from_numpy(deg_np).to(dev)
    # phase 4's hierarchy, from the cache
    pb = mg.prebuild(mg._device_hierarchy(umask_np, deg, dev), torch.float32)
    b, x0 = (torch.from_numpy(a).to(dev).float() for a in (b64, x064))
    counts = stationary_cycles(torch, K, mg, pb, b, x0, umask, deg, f"{BANDS}x{H}x{W}", card)

    for emit in (False, True):
        _bitwise(torch, mg._v_cycle(pb, b, torch.zeros_like(b), emit_top_residual=emit),
                 mg._v_cycle(pb, b, emit_top_residual=emit))
    log("[6 general] _v_cycle(pb, b, u=0) bit-equal to _v_cycle(pb, b), with and without "
        "the top residual")

    # A/B: the current route against the half-residual route, as PCG calls
    # the V-cycle (top residual emitted); turns A B B A, CUDA events
    def current():
        return mg._v_cycle(pb, b, emit_top_residual=True)

    def half():
        return v_cycle_half_restrict(K, mg, pb, b, emit_top_residual=True)

    _bitwise(torch, half(), current())
    K.reset_launch_counts()
    times = {"current": [], "half": []}
    for turn in range(10):
        order = ("current", "half") if turn % 2 == 0 else ("half", "current")
        for name in order:
            times[name].append(_median_ms(torch, current if name == "current" else half, runs=1))
    counts["jacobi_zero_half"] = K.launch_counts["jacobi_zero_half"]
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[6 general] one V-cycle {BANDS}x{H}x{W} f32 (top residual emitted), 10 pairs: "
        f"current route median {med['current']:.4f} ms {[round(t, 4) for t in times['current']]}, "
        f"half-restrict route median {med['half']:.4f} ms {[round(t, 4) for t in times['half']]}, "
        f"bit-equal [{card}]")

    m, img = tile
    n = m.shape[-1]
    tdeg = neighbor_degree_tensor(n, n, dev)
    tb = s4(torch.where(m, 0.0, img)) * m
    tx0 = img * m
    tpb = mg.prebuild(mg._device_hierarchy(m, tdeg, dev), torch.float32)
    tile_counts = stationary_cycles(torch, K, mg, tpb, tb, tx0, m, tdeg, f"1x{n}x{n}", card)
    counts["jacobi"] += tile_counts["jacobi"]
    log(f"[6 general] kernel launches of the stationary cycles and the A/B: "
        f"jacobi {counts['jacobi']}, jacobi_zero_half {counts['jacobi_zero_half']}")
    return {k: counts[k] for k in ("jacobi", "jacobi_zero_half")}


V2_PROBE_SWEEPS = 6


def v2_probe_inputs(torch, dev, n=4096):
    """``benchmarks/x_kernel_v2.py``'s system: (u, b, umask, deg) at 1 x n x
    n, f32 from seed 0, 70 % of the mask unknown, deg 4."""
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.random((1, n, n), dtype=np.float32)).to(dev)
    b = torch.from_numpy(rng.random((1, n, n), dtype=np.float32)).to(dev)
    m = torch.from_numpy(rng.random((n, n)) > 0.3).to(dev)
    return u, b, m, torch.full((n, n), 4.0, device=dev)


def phase_benchmark_paths(torch, K, dev, card):
    """The two benchmark scripts whose Pallas kernels the port carries."""
    from satellite_approximation_tpu_torch import ops

    # benchmarks/x_kernel_v2.py main(): v1 (kernel 3) against v2 (kernel 7)
    u, b, m, deg = v2_probe_inputs(torch, dev)
    n = m.shape[-1]
    K.reset_launch_counts()
    for emit in (False, True):
        def v1(emit=emit):
            return ops.fused_jacobi(u, b, m, deg, sweeps=V2_PROBE_SWEEPS, emit_residual=emit)

        def v2(emit=emit):
            return K.jacobi_v2(u, b, m, deg, sweeps=V2_PROBE_SWEEPS, emit_residual=emit)

        diff, signs = _value_diff(torch, v2(), v1())
        log(f"[7 bench] x_kernel_v2 1x{n}x{n} sweeps={V2_PROBE_SWEEPS} emit_residual={emit}: "
            f"max |v1 - v2| = {diff}, {signs} zeros of opposite sign")
        if diff != 0.0:
            raise AssertionError("v2 mismatch")
        ms = _median_ms(torch, v2)
        bound, by = bound_ms(*v2_work(1, n, n, V2_PROBE_SWEEPS, emit)[1:])
        log(f"[7 bench]   v1 {_median_ms(torch, v1):.4f} ms  v2 {ms:.4f} ms; v2's bound "
            f"{bound:.4f} ms ({bound / ms:.0%}, {by}) [{card}]")
    counts = {"jacobi_v2": K.launch_counts["jacobi_v2"]}
    del u, b, m, deg

    # benchmarks/x_stride_probe.py main(): the five idioms and their checks
    x = np.random.default_rng(0).random((128, 512), np.float32)
    xt = torch.from_numpy(x).to(dev)
    probes = [
        ("A sublane x[0::2, :]", "rows", lambda y: np.array_equal(y, x[0::2, :])),
        ("B lane x[:, 0::2]", "cols", lambda y: np.array_equal(y, x[:, 0::2])),
        ("C reshape-pair lanes", "cols",
         lambda y: np.array_equal(y, x.reshape(128, 256, 2)[:, :, 0])),
        ("D both x[0::2, 0::2]", "both", lambda y: np.array_equal(y, x[0::2, 0::2])),
        ("E stack-interleave lanes", "interleave",
         lambda y: np.array_equal(y[:, 0::2], x[:, :256])
         and np.array_equal(y[:, 1::2], x[:, :256] + 1.0)),
    ]
    K.reset_launch_counts()
    for label, mode, check in probes:
        ok = check(K.stride2(xt, mode).cpu().numpy())
        log(f"[7 bench] x_stride_probe {label}: launched, correct={ok}")
        if not ok:
            raise AssertionError(f"stride probe {label} is wrong")
    counts["stride2"] = K.launch_counts["stride2"]
    log(f"[7 bench] kernel launches of the benchmark paths: {counts}")
    return counts


# ------------------------------------------------------------------ phase 8: detection


def synthesize(n: int, seed: int = 7):
    """The synthetic Sentinel-2-style scene of
    ``benchmarks/bench_detect_fulltile.py``: a blobby cloud field (CLP, CLD
    and SCL consistent), NIR with dark shadow copies of the clouds displaced
    along the sun azimuth (so the height sweep finds real matches) and
    constant-gradient angle rasters, as the raw rasters ``detect`` decodes."""
    from satellite_approximation_tpu_torch.ops.blur import gaussian_blur_host

    rng = np.random.default_rng(seed)
    # blobby cloud probability: max of local Gaussian bumps, each computed
    # only inside its ~4-sigma window
    base = np.zeros((n, n), np.float32)
    n_blobs = max(60, n // 40)
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, n, 2)
        ry = int(rng.integers(n // 400 + 4, n // 40 + 8))
        rx = int(rng.integers(n // 400 + 4, n // 40 + 8))
        y0, y1 = max(cy - 4 * ry, 0), min(cy + 4 * ry + 1, n)
        x0, x1 = max(cx - 4 * rx, 0), min(cx + 4 * rx + 1, n)
        yy = np.arange(y0, y1)[:, None]
        xx = np.arange(x0, x1)[None, :]
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        np.maximum(
            base[y0:y1, x0:x1],
            np.exp(-0.5 * d2.astype(np.float32)),
            out=base[y0:y1, x0:x1],
        )
    clp = np.clip(base * 255 * 1.2, 0, 255).astype(np.uint8)
    cld = np.clip(base * 100 * 1.1, 0, 100).astype(np.uint8)
    cloud = base > 0.55

    scl = np.full((n, n), 4, np.uint8)  # vegetation
    scl[base > 0.75] = 9  # cloud high probability
    scl[(base > 0.65) & (base <= 0.75)] = 8  # cloud medium

    # shadows: clouds displaced north-west (sun from the south-east),
    # darkening the NIR
    dy, dx = -(n // 180), -(n // 240)
    shadow = np.zeros_like(cloud)
    src = cloud[max(-dy, 0) : n - max(dy, 0), max(-dx, 0) : n - max(dx, 0)]
    shadow[max(dy, 0) : n - max(-dy, 0), max(dx, 0) : n - max(-dx, 0)] = src
    # spatially correlated NIR like real 10 m imagery (white noise makes
    # every pixel a pit — adversarial and unrepresentative for pit fill)
    g = gaussian_blur_host(rng.standard_normal((n, n)).astype(np.float32), 3.0)
    g = g / max(float(g.std()), 1e-6)
    nir = (6000 + 1500 * g).clip(500, 10000)
    nir[shadow] *= 0.35
    nir = nir.astype(np.uint16)

    gy, gx = np.ogrid[:n, :n]
    grad = (gy / n + gx / n).astype(np.float32)
    return {
        "CLP": clp,
        "CLD": cld,
        "SCL": scl,
        "B08": nir,
        "sunZenithAngles": 35.0 + 0.5 * grad,
        "sunAzimuthAngles": 145.0 + 0.5 * grad,
        "viewZenithMean": 5.0 + 0.2 * grad,
        "viewAzimuthMean": 100.0 + 0.3 * grad,
    }


MASK_FILES = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")


def run_detect(torch, dev, scene, n, backends, label, card):
    """One ``detect`` of ``scene`` on the card, from pre-decoded rasters to
    the four mask files in a temporary directory: (status, masks read back
    from the files, StageTimer, seconds, peak GiB). The peak is the most the
    call held above what was allocated before it (earlier phases leave their
    cached hierarchies on the card). ``backends``: (refinement, matching)
    backend values."""
    import dataclasses
    import tempfile

    from satellite_approximation_tpu_torch.config import DEFAULT_DETECTION
    from satellite_approximation_tpu_torch.models.detection.pipeline import (
        CloudParams, detect, get_diagonal_distance,
    )
    from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff
    from satellite_approximation_tpu_torch.utils.profiling import StageTimer

    config = dataclasses.replace(
        DEFAULT_DETECTION,
        refinement=dataclasses.replace(DEFAULT_DETECTION.refinement, backend=backends[0]),
        matching=dataclasses.replace(DEFAULT_DETECTION.matching, backend=backends[1]),
    )
    diag = get_diagonal_distance(-114.0, 50.5, -112.5, 51.5) * (n / TILE)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # only B08 needs to exist on disk (mask writes copy its GeoTIFF tags)
        write_geotiff(scene["B08"], work / "B08.tif")
        params = CloudParams.from_root(work)
        timer = StageTimer(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        status = detect(params, diag, use_cache=False, config=config, timer=timer,
                        inputs=dict(scene), device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        masks = {name: GeoTIFF.open(work / f"{name}.tif").read().astype(bool)
                 for name in MASK_FILES}
    for name, m in masks.items():
        if m.shape != (n, n):
            raise AssertionError(f"{label}: {name} has shape {m.shape}")
    matched = sum(1 for k, t in timer.stages if k.startswith("matching/"))
    for v in (status.percent_clouds, status.percent_shadows, status.percent_invalid):
        if v is None or not math.isfinite(v):
            raise AssertionError(f"{label}: status {status}")
    if not (masks["cloud_mask"].any() and masks["object_based_shadows"].any()
            and status.percent_shadows > 0 and matched):
        raise AssertionError(f"{label}: trivial scene (status {status})")
    log(f"[8 detect] {label}: {n}x{n} in {dt:.3f} s, peak {peak:.3f} GiB, clouds "
        f"{status.percent_clouds:.6f} shadows {status.percent_shadows:.6f} invalid "
        f"{status.percent_invalid:.6f}, object-shadow pixels "
        f"{int(masks['object_based_shadows'].sum())} [{card}]")
    for stage, route in timer.routes.items():
        log(f"[8 detect]   route of {stage}: {route}")
    return status, masks, timer, dt, peak


def log_stages(timer, label):
    """The StageTimer table, the per-bucket matching stages summed."""
    rows: dict[str, float] = {}
    for name, t in timer.stages:
        key = name.split(" ")[0] + " (all buckets)" if name.startswith(
            ("matching/sweep", "matching/detail")) else name
        rows[key] = rows.get(key, 0.0) + t
    log(f"[8 detect]   stages of {label}: " + "; ".join(f"{k} {v:.3f}" for k, v in rows.items()))


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else float(np.logical_and(a, b).sum() / union)


def phase_detect(torch, dev, card, big=4096):
    """Phase 8: ``detect`` through its entry point on the card. 8a at 1024^2
    in both routes, held against each other, with the pit fill against the
    native priority flood and the device LS reduction against the host one;
    8b at ``big``^2 (>= 16 Mpix: the device stages under backend "auto"),
    cold and warm."""
    from satellite_approximation_tpu_torch import native
    from satellite_approximation_tpu_torch.config import BIG_SCENE_PIXELS
    from satellite_approximation_tpu_torch.ops import geometry
    from satellite_approximation_tpu_torch.ops.pitfill import pit_fill

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library did not build (g++ on PATH?): the host route "
                             "cannot run, see csrc/build/gxx_satnative.log")
    log(f"[8 detect] native library {native.build().relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.3f} s")

    # ---- 8a: both routes at 1024^2
    n = 1024
    scene = synthesize(n)
    host = run_detect(torch, dev, scene, n, ("host", "native"), "8a host route", card)
    device = run_detect(torch, dev, scene, n, ("torch", "torch"), "8a all-device route", card)
    for name in MASK_FILES:
        a, b = host[1][name], device[1][name]
        differ = int((a != b).sum())
        log(f"[8 detect] 8a {name}: {int(a.sum())} set, {differ} pixels differ between the "
            f"routes, IoU {_iou(a, b):.6f}")
        # the cloud and potential-shadow stages are the same device code on
        # both routes; matching and refinement run as C++/numpy on one and as
        # torch on the other, and may flip pixels at a threshold
        exact = name in ("cloud_mask", "potential_shadows")
        if (exact and differ) or _iou(a, b) < 0.995:
            raise AssertionError(f"8a: {name} differs between the routes ({differ} pixels)")
    hs, ds = host[0], device[0]
    if hs.percent_clouds != ds.percent_clouds or abs(hs.percent_shadows - ds.percent_shadows) > 1e-3:
        raise AssertionError(f"8a: statuses differ: {hs} against {ds}")

    from satellite_approximation_tpu_torch.models.detection.pipeline import _read_normalized_u8

    for dtype, max_value in ((np.uint8, 255), (np.uint8, 100), (np.uint16, 65535)):
        raw = np.arange(np.iinfo(dtype).max + 1).astype(dtype).reshape(-1, 16)
        got = _read_normalized_u8(Path("X.tif"), max_value, {"X": raw}, dev).cpu().numpy()
        if not np.array_equal(got, raw.astype(np.float32) / np.float32(max_value)):
            raise AssertionError(f"8a: {dtype.__name__} over {max_value} on the card differs from "
                                 "numpy's f32 division")
    log("[8 detect] 8a normalization on the card: every u8 value over 255 and 100 and every u16 "
        "value over 65535 bit-equal to numpy's f32 division")
    nir = scene["B08"].astype(np.float32) / np.float32(65535)
    border = float(np.partition(nir.ravel(), nir.size // 2)[nir.size // 2])
    t0 = time.perf_counter()
    filled = pit_fill(torch.as_tensor(nir, device=dev), border).cpu().numpy()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    flood = native.pit_fill_flood(nir, border)
    t_host = time.perf_counter() - t0
    if not np.array_equal(filled, flood):
        raise AssertionError("8a: pit_fill on the card differs from native.pit_fill_flood")
    log(f"[8 detect] 8a pit_fill {n}x{n} bit-equal to the native priority flood "
        f"({t_dev:.3f} s on the card, {t_host:.3f} s on the host)")
    shape = (n, n)
    for zen, azi, z in (("sunZenithAngles", "sunAzimuthAngles", 1.5e9),
                        ("viewZenithMean", "viewAzimuthMean", 785.0)):
        p_dev = geometry.ls_point_equal_to_device(scene[zen], scene[azi], shape, 20.0, z, device=dev)
        p_host = geometry.ls_point_equal_to_chunked(scene[zen], scene[azi], shape, 20.0, z)
        rel = float(np.abs(p_dev - p_host).max() / np.abs(p_host).max())
        log(f"[8 detect] 8a LS point from {zen}: device against host, relative {rel:.3e}")
        if not rel <= 1e-6:
            raise AssertionError(f"8a: LS point differs by {rel}")

    # ---- 8b: full width, the device stages under backend "auto"
    if big * big < BIG_SCENE_PIXELS:
        raise AssertionError(f"8b needs >= {BIG_SCENE_PIXELS} pixels, got {big}^2")
    scene = synthesize(big)
    out = {}
    for label in ("cold", "warm"):
        status, masks, timer, dt, peak = run_detect(
            torch, dev, scene, big, ("auto", "auto"), f"8b {label}", card)
        log_stages(timer, f"8b {label}")
        on_host = [stage for stage, route in timer.routes.items()
                   if not route.startswith("device") or "host" in route]
        on_host += [name for name, _ in timer.stages if name.startswith("matching/native scan")]
        # only the hole fill of the probability surface is host work on this route
        if on_host:
            raise AssertionError(f"8b: stages left the card: {on_host} ({timer.routes})")
        out[label] = (status, masks, dt, peak)
    for name in MASK_FILES:
        if not np.array_equal(out["cold"][1][name], out["warm"][1][name]):
            raise AssertionError(f"8b: {name} differs between two runs on the same scene")
    log(f"[8 detect] 8b detect {big}x{big}: cold {out['cold'][2]:.3f} s, warm "
        f"{out['warm'][2]:.3f} s, peak {out['warm'][3]:.3f} GiB [{card}]")


# ------------------------------------------------------------------ phase 9: entry points

# the 13 bands of a Sentinel-2 L2A date folder, and the four 10 m bands
S2_BANDS = ("B01", "B02", "B03", "B04", "B05", "B06", "B07", "B08", "B8A", "B09", "B10", "B11",
            "B12")
S2_10M_BANDS = ("B02", "B03", "B04", "B08")
FILL_KERNELS = ("jacobi_zero", "jacobi_corr", "residual_entry", "residual_pair")
BLEND_KERNELS = ("jacobi_zero", "jacobi_corr")  # poisson mode: no laplace residual
SKIP_THRESHOLD = 0.5
DETECT_N = 4096  # 9d: >= 16 Mpix, so backend "auto" runs the device stages


@contextlib.contextmanager
def spans(torch, targets):
    """Inside the block, each call of a function named in ``targets``
    ({label: [(module, attribute), ...]}) adds its wall time, the device
    synchronised at its end, to ``took[label]``, and ``seen[attribute]``
    lists each call's (args, result). The entry points look their callees
    up at call time, so wrapping the attribute splits their wall time
    without an option in the program."""
    took = dict.fromkeys(targets, 0.0)
    seen: dict[str, list] = {}
    saved = []
    for label, funcs in targets.items():
        for mod, name in funcs:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def timed(*args, _fn=fn, _label=label, _name=name, **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                took[_label] += time.perf_counter() - t0
                seen.setdefault(_name, []).append((args, out))
                return out

            setattr(mod, name, timed)
    try:
        yield took, seen
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def entry_run(torch, K):
    """One run of an entry point, every kernel count set to 0 just before
    it. On exit ``run`` holds its wall seconds, the peak device memory above
    what was allocated at its start (GiB) and the kernel launches it made."""
    run = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    yield run
    torch.cuda.synchronize()
    run["wall"] = time.perf_counter() - t0
    run["peak"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    run["launches"] = dict(K.launch_counts)


def log_entry(part, run, splits, card, need=()):
    """One part's line: wall, its split, peak memory, launches; raises when
    a kernel of ``need`` did not launch."""
    split = ", ".join(f"{k} {v:.3f} s" for k, v in splits.items())
    launched = {k: v for k, v in run["launches"].items() if v}
    log(f"[9 entry] {part}: wall {run['wall']:.3f} s ({split}), peak {run['peak']:.3f} GiB, "
        f"kernel launches {launched} [{card}]")
    missing = [k for k in need if not run["launches"][k]]
    if missing:
        raise AssertionError(f"{part}: kernels never launched: {missing}")


def smooth_fields(torch, n, count, seed, dev):
    """``count`` smooth f32 fields in [0, 1] at n x n (tile_image's, made
    on the card)."""
    return np.stack([(tile_image(torch, n, dev, seed + k)[0] / 10000.0).cpu().numpy()
                     for k in range(count)])


def cloud_field(torch, n, dev, seed):
    """bench.py's cloud field at 2048^2, tile_mask's on the card otherwise."""
    return make_mask(n, n, seed) if n == H else tile_mask(torch, n, dev, seed).cpu().numpy()


def entry_laplace(torch, K, dev, card, work):
    """9a: ``sat-torch-laplace`` in process on a 2048^2 RGB PNG (bench.py's
    ``smooth`` scaled to u8) and a marker PNG whose red/green pixels are
    ``make_mask(2048, 2048)``."""
    from PIL import Image

    from satellite_approximation_tpu_torch.cli import laplace_main
    from satellite_approximation_tpu_torch.config import SolverConfig
    from satellite_approximation_tpu_torch.models import laplace

    base = np.stack([smooth(H, W, 10 + c) for c in range(3)], axis=-1)
    base = np.clip(np.round(base * 255), 0, 255).astype(np.uint8)
    invalid = make_mask(H, W)
    marker = np.zeros((H, W, 3), np.uint8)
    marker[invalid] = (255, 0, 0)
    Image.fromarray(base).save(work / "base.png")
    Image.fromarray(marker).save(work / "marker.png")
    argv = [str(work / name) for name in ("base.png", "marker.png", "filled.png")]
    targets = {"read": [(laplace_main, "read_image_raw")], "solve": [(laplace_main, "apply_laplace")]}
    with spans(torch, targets) as (took, _), entry_run(torch, K) as run:
        code = laplace_main.main(argv)
    log_entry(f"9a sat-torch-laplace 3x{H}x{W} PNG", run,
              {**took, "write": run["wall"] - sum(took.values())}, card, FILL_KERNELS)
    if code != 0:
        raise AssertionError(f"9a: exit code {code}")

    written = np.asarray(Image.open(work / "filled.png"))
    value = laplace.apply_laplace(base.astype(np.float64), marker, device=dev)
    want = np.clip(value, 0, 255).astype(np.uint8)
    if not np.array_equal(written, want):
        raise AssertionError(f"9a: the PNG differs from the fill in memory in "
                             f"{int((written != want).sum())} values")
    if not np.array_equal(written[~invalid], base[~invalid]):
        raise AssertionError("9a: known pixels changed")
    umask = laplace._laplace_unknowns(invalid)
    tol = 1e-9 if umask.sum() >= SolverConfig().mg_threshold_pixels else 1e-7
    rel = rel_residual(torch, np.ascontiguousarray(np.moveaxis(value, -1, 0)),
                       torch.from_numpy(umask).to(dev),
                       np.ascontiguousarray(np.moveaxis(base, -1, 0)).astype(np.float64))
    if not rel <= tol:
        raise AssertionError(f"9a: f64 residual {rel} > {tol}")
    log(f"[9 entry] 9a PNG equal to the fill in memory, {umask.mean() * 100:.2f}% filled, f64 "
        f"residual {rel:.3e} <= {tol}")
    return run


def entry_poisson(torch, K, dev, card, work, n):
    """9b: ``sat-torch-poisson`` on a 6-page n x n f32 TIFF (5 bands, band 6
    the cloud field) and a second seeded 5-band TIFF."""
    from satellite_approximation_tpu_torch.cli import poisson_main
    from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff

    invalid = cloud_field(torch, n, dev, seed=3 if n == H else 5)
    bands = smooth_fields(torch, n, 5, 20, dev)
    repl = smooth_fields(torch, n, 5, 40, dev)
    write_geotiff(np.concatenate([bands, invalid[None].astype(np.float32)]), work / "scene.tif",
                  compression=None)
    write_geotiff(repl, work / "replacement.tif", compression=None)
    targets = {"solve": [(poisson_main, "preprocess_cloud_band"),
                         (poisson_main, "blend_images_poisson")],
               "write": [(poisson_main, "write_geotiff")]}
    with spans(torch, targets) as (took, seen), entry_run(torch, K) as run:
        code = poisson_main.main([str(work / "scene.tif"), str(work / "replacement.tif")])
    log_entry(f"9b sat-torch-poisson 5x{n}x{n} TIFF", run,
              {"read": run["wall"] - sum(took.values()), **took}, card, BLEND_KERNELS)
    if code != 0:
        raise AssertionError(f"9b: exit code {code}")

    outs = sorted((work / "poisson_simple_replace").glob("*.tif"))
    if [p.name for p in outs] != ["scene.tif"]:
        raise AssertionError(f"9b: outputs {outs}")
    out = GeoTIFF.open(outs[0])
    written = out.read_all()
    result = seen["blend_images_poisson"][0][1]
    if out.num_bands != 5 or not np.array_equal(written, result.astype(np.float32)):
        raise AssertionError(f"9b: the output ({out.num_bands} bands) is not the blend's result")
    mask = seen["preprocess_cloud_band"][0][1]
    t0 = time.perf_counter()
    mask_cpu = poisson_main.preprocess_cloud_band(invalid.astype(np.float32), device="cpu")
    t_cpu = time.perf_counter() - t0
    if not np.array_equal(mask, mask_cpu):
        raise AssertionError(f"9b: the closed mask on the card differs from the CPU's in "
                             f"{int((mask != mask_cpu).sum())} pixels")
    if not np.array_equal(written[:, ~mask], bands[:, ~mask]):
        raise AssertionError("9b: known pixels changed")
    um = torch.from_numpy(mask).to(dev)
    rels = [rel_residual(torch, result[k : k + 1], um, bands[k : k + 1].astype(np.float64),
                         guidance=repl[k : k + 1].astype(np.float64)) for k in range(5)]
    if not max(rels) <= TOL:
        raise AssertionError(f"9b: f64 residuals {rels} > {TOL}")
    log(f"[9 entry] 9b one 5-band output equal to the blend's result; closed mask "
        f"({mask.mean() * 100:.2f}%) bit-equal to the CPU's ({t_cpu:.3f} s there); f64 "
        f"residuals {', '.join(f'{r:.3e}' for r in rels)} <= {TOL}")
    return run


def entry_folder(torch, K, dev, card, work, n, band_names, dates):
    """9c: ``fill_missing_data_folder`` over a base folder of date folders
    ({date: kind}, kind "fill", "over threshold" or "no shadow file") at
    n x n, then again (nothing to solve), then ``compute_index`` and
    ``find_good_close_image``."""
    import satellite_approximation_tpu_torch as port
    from satellite_approximation_tpu_torch.config import SolverConfig
    from satellite_approximation_tpu_torch.models import laplace
    from satellite_approximation_tpu_torch.models.detection.pipeline import Status
    from satellite_approximation_tpu_torch.utils.dates import Date
    from satellite_approximation_tpu_torch.utils.db import ApproxMethod, DataBase
    from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff

    base = work / "dates"
    base.mkdir()
    values = {}
    with DataBase(base) as db:
        for k, (date, kind) in enumerate(dates.items()):
            folder = base / date
            folder.mkdir()
            clouds = cloud_field(torch, n, dev, seed=(3 if n == H else 5) + k)
            shadows = np.roll(clouds, (n // 180, n // 240), axis=(0, 1)) & ~clouds
            shadows[[0, -1], :] = shadows[:, [0, -1]] = False
            write_geotiff(clouds.astype(np.uint8), folder / "cloud_mask.tif", compression=None)
            if kind != "no shadow file":
                write_geotiff(shadows.astype(np.uint8), folder / "shadow_mask.tif",
                              compression=None)
            for j, band in enumerate(band_names):
                v = (tile_image(torch, n, dev, 100 * k + j)[0]).to(torch.int32).cpu().numpy()
                values[date, band] = v.astype(np.uint16)
                write_geotiff(values[date, band], folder / f"{band}.tif", compression=None)
            invalid = 0.9 if kind == "over threshold" else float((clouds | shadows).mean())
            db.write_detection_result(Date.from_string(date), Status(
                percent_invalid=invalid, clouds_computed=True, shadows_computed=True))
    solved = [d for d, kind in dates.items() if kind != "over threshold"]

    targets = {"solve": [(laplace, "solve_matrix")], "write": [(laplace, "write_geotiff")]}
    with spans(torch, targets) as (took, seen), entry_run(torch, K) as run:
        port.fill_missing_data_folder(base, list(band_names), skip_threshold=SKIP_THRESHOLD)
    part = f"9c fill_missing_data_folder {len(dates)} dates x {len(band_names)}x{n}x{n}"
    log_entry(part, run, {"read": run["wall"] - sum(took.values()), **took}, card, FILL_KERNELS)

    with DataBase(base) as db:
        rows = {d: db.get_approx_status(d, ApproxMethod.Laplace) for d in dates}
    for date in dates:
        files = sorted(p.name for p in (base / date / "approximated_data").glob("*.tif"))
        want = sorted(f"{b}_{i}.tif" for b, i in rows[date].items())
        expect = set(band_names) if date in solved else set()
        if set(rows[date]) != expect or files != want:
            raise AssertionError(f"9c: {date}: DB rows {rows[date]}, files {files}")
    calls = seen.get("solve_matrix", [])
    if len(calls) != len(solved):
        raise AssertionError(f"9c: {len(calls)} solves for the {len(solved)} dates to fill")
    rels = []
    for date, (args, (filled, _)) in zip(solved, calls):
        umask = laplace._laplace_unknowns(args[1])
        tol = 1e-9 if umask.sum() >= SolverConfig().mg_threshold_pixels else 1e-7
        um = torch.from_numpy(umask).to(dev)
        for j, band in enumerate(band_names):
            src = values[date, band]
            rel = rel_residual(torch, filled[j : j + 1], um, src[None].astype(np.float64))
            rels.append(rel)
            out = GeoTIFF.open(base / date / "approximated_data" / f"{band}_{rows[date][band]}.tif")
            got = out.read()
            if not rel <= tol:
                raise AssertionError(f"9c: {date}/{band}: f64 residual {rel} > {tol}")
            if not np.array_equal(got, filled[j].astype(np.float32)):
                raise AssertionError(f"9c: {date}/{band}: the file is not the solve's result")
            if not np.array_equal(got[~umask], src[~umask].astype(np.float32)):
                raise AssertionError(f"9c: {date}/{band}: known pixels changed")
    log(f"[9 entry] 9c {sum(len(r) for r in rows.values())} bands written with their DB rows, "
        f"dates skipped: {len(dates) - len(solved)}; f64 residuals {min(rels):.3e} .. "
        f"{max(rels):.3e}; known pixels unchanged")

    with spans(torch, targets) as (took, seen), entry_run(torch, K) as again:
        port.fill_missing_data_folder(base, list(band_names), skip_threshold=SKIP_THRESHOLD)
    log_entry(f"{part}, again", again, {"read": again["wall"] - sum(took.values()), **took}, card)
    with DataBase(base) as db:
        rows_again = {d: db.get_approx_status(d, ApproxMethod.Laplace) for d in dates}
    if seen or any(again["launches"].values()) or rows_again != rows:
        raise AssertionError(f"9c: the second run solved {len(seen.get('solve_matrix', []))} "
                             f"folders, launched {again['launches']}")

    folder = base / solved[0]
    present = [p.stem for p in folder.glob("*.tif")]
    for index in (port.Indices.NDVI, port.Indices.SWI):
        if port.missing_files(present, index):
            log(f"[9 entry] 9c {index.value}: needs {port.required_files(index)}, not all here")
            continue
        times = []
        for _ in range(2):  # computed, then read from its cache
            t0 = time.perf_counter()
            got = port.compute_index(folder, folder / "B08.tif", index)
            times.append(time.perf_counter() - t0)
        if got.shape != (n, n) or not np.isfinite(got).all() or np.abs(got).max() > 1.0:
            raise AssertionError(f"9c: {index.value} out of range")
        log(f"[9 entry] 9c compute_index {index.value} {n}x{n}: {times[0]:.3f} s, from its cache "
            f"{times[1]:.3f} s")

    with DataBase(base) as db:
        day = list(dates)[len(dates) // 2]
        t0 = time.perf_counter()
        best = port.find_good_close_image(day, 0.3, db)
        dt = time.perf_counter() - t0
        info = {str(d.date): d.distance(Date.from_string(day), 0.3)
                for d in db.select_close_images(day)}
        current = db.select_info_about_date(day).percent_invalid
        pick = min(info, key=info.get) if info else ""
        pick_inv = db.select_info_about_date(pick).percent_invalid if pick else None
    want = "" if not info else (day if current < pick_inv else pick)
    if best != want:
        raise AssertionError(f"9c: find_good_close_image({day}) = {best!r}, expected {want!r}")
    log(f"[9 entry] 9c find_good_close_image({day}, 0.3) = {best!r} in {dt * 1e3:.3f} ms")
    return run


def entry_detect(torch, K, dev, card, work, n):
    """9d: ``sat-torch-cloud-detection`` on ``synthesize(n)``'s rasters
    written as GeoTIFFs (georeferenced: the CLI derives the diagonal from
    B08's geotransform) into a date folder, against ``detect`` called in
    memory on the same folder; then once more, from its cache."""
    import io
    from unittest import mock

    from satellite_approximation_tpu_torch.cli import cloud_detection_main as cli
    from satellite_approximation_tpu_torch.models.detection.pipeline import (
        CloudParams, detect, get_diagonal_distance,
    )
    from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff
    from satellite_approximation_tpu_torch.utils.profiling import StageTimer
    from satellite_approximation_tpu_torch.utils.tiffmb import write_multiband_tiff

    scene = synthesize(n)
    folder = work / "2019-05-22"
    folder.mkdir()
    template = work / "template.tif"
    # the tile's degrees a pixel, so the diagonal scales with n as in phase 8
    write_multiband_tiff(np.zeros((1, 4, 4), np.uint8), template, extra_tags=[
        (33550, 12, (1.5 / TILE, 1.0 / TILE, 0.0)),
        (33922, 12, (0.0, 0.0, 0.0, -114.0, 51.5, 0.0)),
        (34735, 3, (1, 1, 0, 2, 1024, 0, 1, 2, 2048, 0, 1, 4326))])  # WGS84 geographic
    for name, raster in scene.items():
        write_geotiff(raster, folder / f"{name}.tif", template_path=template, compression=None)

    def run_cli(timer):
        out = io.StringIO()
        real = cli.detect
        with mock.patch.object(cli, "detect", lambda *a, **k: real(*a, timer=timer, **k)), \
                contextlib.redirect_stdout(out):
            code = cli.main([str(folder)])
        if code != 0:
            raise AssertionError(f"9d: exit code {code}")
        return out.getvalue()

    timer = StageTimer(dev)
    with entry_run(torch, K) as run:
        printed = run_cli(timer)
    read = sum(t for name, t in timer.stages if name.startswith("read"))
    wait = sum(t for name, t in timer.stages if "write" in name and "(wait)" in name)
    workers = sum(t for name, t in timer.stages if "write" in name and "(wait)" not in name)
    log_entry(f"9d sat-torch-cloud-detection {n}x{n}", run,
              {"read": read, "detect": run["wall"] - read - wait, "write (wait)": wait}, card)
    log(f"[9 entry] 9d mask writes on workers {workers:.3f} s; printed {printed.strip()!r}")
    masks = {name: GeoTIFF.open(folder / f"{name}.tif").read() for name in MASK_FILES}

    b08 = GeoTIFF.open(folder / "B08.tif")
    diag = get_diagonal_distance(b08.west(), b08.south(), b08.east(), b08.north())
    status = detect(CloudParams.from_root(folder), diag, use_cache=False, device=dev)
    line = (f"clouds: {status.percent_clouds:.4f}, shadows: {status.percent_shadows:.4f}, "
            f"invalid: {status.percent_invalid:.4f}\n")
    for name in MASK_FILES:
        again = GeoTIFF.open(folder / f"{name}.tif").read()
        if not np.array_equal(masks[name], again):
            raise AssertionError(f"9d: {name} differs from detect's in memory")
    if printed != line or not masks["cloud_mask"].any():
        raise AssertionError(f"9d: printed {printed!r}, detect in memory gives {line!r}")
    t0 = time.perf_counter()
    cached = run_cli(StageTimer(dev))
    if cached != "cached: outputs already exist\n":
        raise AssertionError(f"9d: the second run printed {cached!r}")
    log(f"[9 entry] 9d four masks equal to detect's in memory (diagonal {diag:.3f} km); second "
        f"run {time.perf_counter() - t0:.3f} s: {cached.strip()!r}")
    return run


def phase_entry_points(torch, K, dev, card, tile=False):
    """Phase 9: the entry points a user calls, each run in process through
    its public function, on the card by default: 9a ``sat-torch-laplace``,
    9b ``sat-torch-poisson``, 9c ``fill_missing_data_folder`` with
    ``compute_index`` and ``find_good_close_image``, 9d
    ``sat-torch-cloud-detection``. ``tile``: 9b and 9c alone at 10980^2
    (9c on one date folder of the four 10 m bands). Returns the kernel
    launches of 9a-9c, each read just after its run."""
    import tempfile

    counts = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name in ("9a", "9b", "9c", "9d"):
            (work / name).mkdir()
        runs = []
        if tile:
            runs.append(entry_poisson(torch, K, dev, card, work / "9b", TILE))
            runs.append(entry_folder(torch, K, dev, card, work / "9c", TILE, S2_10M_BANDS,
                                     {"2019-05-10": "fill"}))
        else:
            runs.append(entry_laplace(torch, K, dev, card, work / "9a"))
            runs.append(entry_poisson(torch, K, dev, card, work / "9b", H))
            runs.append(entry_folder(torch, K, dev, card, work / "9c", H, S2_BANDS, {
                "2019-05-10": "fill", "2019-05-12": "over threshold",
                "2019-05-14": "no shadow file"}))
            entry_detect(torch, K, dev, card, work / "9d", DETECT_N)
    for run in runs:
        for name, n in run["launches"].items():
            counts[name] += n
    log(f"[9 entry] kernel launches on the entry points: { {k: v for k, v in counts.items() if v} }")
    return counts


def load_kernels_of(tree: Path):
    """``ops/stencil_kernels.py`` of the checkout at ``tree``, under a name of
    its own: it builds that checkout's ``csrc/`` into that checkout's
    ``csrc/build/``."""
    path = tree / "satellite_approximation_tpu_torch" / "ops" / "stencil_kernels.py"
    spec = importlib.util.spec_from_file_location("against_stencil_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def kernels_from(K, mod):
    """Inside the block, K's wrappers launch the kernels of the checkout
    whose ``stencil_kernels`` module is ``mod``: every wrapper through that
    checkout's library, and ``jacobi_v2`` through that checkout's own wrapper
    (kernel 7's C interface follows the operands its wrapper hands it)."""
    own = K._library, K.jacobi_v2
    K._library, K.jacobi_v2 = mod._library, mod.jacobi_v2
    try:
        yield
    finally:
        K._library, K.jacobi_v2 = own


def phase_against(torch, K, mg, dev, card, tree: Path):
    """The compiled kernels of the checkout at ``tree`` ("parent") against
    this one's ("change"), under this tree's Python (but kernel 7's wrapper,
    see ``kernels_from``): each measurement runs with one library, then the
    other, in turns parent, change, change, parent (kernel 8 also torch's own
    call in turns between them)."""
    t0 = time.perf_counter()
    libs = {"parent": load_kernels_of(tree), "change": K}
    for mod in libs.values():
        mod._library()  # builds that checkout's csrc/
    log(f"[ab] kernels of {tree} built in {time.perf_counter() - t0:.3f} s")
    order = ("parent", "change", "change", "parent")
    out = {"card": card, "order": order, "kernels": {}, "stride2": {}}

    def in_turns(fns, names, measure=lambda fn: _median_ms(torch, fn)):
        """{name: [measure(fns[name]) in each of its turns]}; a name that is
        a library runs its function with that library's kernels."""
        got = {n: [] for n in names}
        for n in names:
            with kernels_from(K, libs[n]) if n in libs else contextlib.nullcontext():
                got[n].append(measure(fns[n]))
        return got

    def both_bit_equal(kern, want):
        for lib in libs.values():
            with kernels_from(K, lib):
                _bitwise(torch, kern(), want)

    def time_calls(calls, names, tag, shape, need):
        """Each kernel of ``names`` in turns, beside the bound that ``need``
        (kernel_work's counts) gives it."""
        for name in names:
            kern, plain = calls[name]
            both_bit_equal(kern, plain())
            t = in_turns(dict.fromkeys(libs, kern), order)
            bound = bound_ms(need[name][1], need[name][2])[0]
            out["kernels"][f"{name}/{tag}"] = {**t, "bound_ms": bound}
            share = {n: [f"{bound / ms:.0%}" for ms in v] for n, v in t.items()}
            log(f"[ab] {name:16s} {tag:5s} {'x'.join(map(str, shape))} f32, both bit-equal: parent "
                f"{t['parent']} ms, change {t['change']} ms; this mask's bound {bound:.4f} ms, "
                f"share parent {share['parent']} change {share['change']} [{card}]")

    def time_kernels(tag):
        shape = (BANDS, H, W)
        x = kernel_inputs(torch, K, mg, tag, shape, torch.float32, dev)
        need = kernel_work(torch, x.um, BANDS, len(x.pre))
        time_calls(x.calls, AGAINST, tag, shape, need)
        if tag == "main":
            for mode in K.STRIDE2_MODES:
                kern = lambda mode=mode: K.stride2(x.b, mode)  # noqa: E731
                torch_call = lambda mode=mode: K.stride2_plain(x.b, mode)  # noqa: E731
                both_bit_equal(kern, torch_call())
                t = in_turns({**dict.fromkeys(libs, kern), "torch": torch_call},
                             ("parent", "change", "torch", "torch", "change", "parent"))
                out["stride2"][mode] = t
                log(f"[ab] stride2 {mode:10s} {BANDS}x{H}x{W} f32, both bit-equal: parent "
                    f"{t['parent']} ms, change {t['change']} ms, torch {t['torch']} ms [{card}]")

    for tag in ("main", "dense"):
        time_kernels(tag)
        torch.cuda.empty_cache()

    # kernel 7 where every window streams (no unknown cell), and at the
    # phase-7 probe, without and with the residual
    x = kernel_inputs(torch, K, mg, "main", (BANDS, H, W), torch.float32, dev)
    args = (x.u, x.b, torch.zeros_like(x.um), x.deg, len(x.v2), x.v2[0], True)
    calls = {"jacobi_v2": (lambda: K.jacobi_v2(*args), lambda: K.jacobi_v2_plain(*args))}
    time_calls(calls, tuple(calls), "known", (BANDS, H, W),
               {"jacobi_v2": v2_work(BANDS, H, W, len(x.v2), True)})
    del x, args, calls
    u, b, m, deg = v2_probe_inputs(torch, dev)
    n = m.shape[-1]
    for emit in (False, True):
        args = (u, b, m, deg, V2_PROBE_SWEEPS, 0.8, emit)
        calls = {"jacobi_v2": (lambda args=args: K.jacobi_v2(*args),  # looked up at each call
                               lambda args=args: K.jacobi_v2_plain(*args))}
        time_calls(calls, tuple(calls), "probe+r" if emit else "probe", (1, n, n),
                   {"jacobi_v2": v2_work(1, n, n, V2_PROBE_SWEEPS, emit)})
    del u, b, m, deg, calls
    torch.cuda.empty_cache()

    umask, imgs = bench_images()
    sdeg, sb = bench_rhs(umask, imgs)
    b_t = torch.from_numpy(sb).to(dev)
    x0_t = torch.from_numpy(imgs * umask).to(dev)

    def solves(_):
        res, times, _counts = timed_solves(torch, K, mg, b_t, umask, sdeg, x0_t)
        if res.error > TOL:
            raise AssertionError(f"solve residual {res.error} > {TOL}")
        return {"median_s": statistics.median(times), "times_s": times,
                "iterations": res.iterations, "certified": res.error}

    out["solve"] = in_turns(dict.fromkeys(libs), order, solves)
    for name in libs:
        log(f"[ab] multigrid.solve {BANDS}x{H}x{W} to {TOL} with the {name} kernels: "
            + "; ".join(f"{r['iterations']} iterations, median {r['median_s']:.6f} s, certified "
                        f"{r['certified']:.3e}" for r in out["solve"][name]) + f" [{card}]")
    del b_t, x0_t
    torch.cuda.empty_cache()

    m = tile_mask(torch, TILE, dev)
    img = tile_image(torch, TILE, dev)
    # kernels 4 and 5 at the band's shape (C = 1, so one band a group)
    _, x_hi, x_lo, invm = residual_inputs(torch, K, m, 1, torch.float32,
                                          torch.Generator(device=dev).manual_seed(TILE))
    calls = {"residual_entry": (lambda: K.residual_entry(img, invm),
                                lambda: K.residual_entry_plain(img, invm)),
             "residual_pair": (lambda: K.residual_pair(img, x_hi, x_lo, invm),
                               lambda: K.residual_pair_plain(img, x_hi, x_lo, invm))}
    time_calls(calls, tuple(calls), "tile", (1, TILE, TILE), kernel_work(torch, m, 1, 0))
    del x_hi, x_lo, invm, calls
    torch.cuda.empty_cache()

    def band(_):
        dt, iters, _err, peak = band_fill(torch, m, img, dev)
        return {"warm_s": dt, "iterations": iters, "peak_gib": peak}

    in_turns(dict.fromkeys(libs), tuple(libs), band)  # the first fill builds the hierarchy
    out["tile"] = in_turns(dict.fromkeys(libs), order, band)
    for name in libs:
        log(f"[ab] laplace_fill 1x{TILE}x{TILE} warm with the {name} kernels: "
            + "; ".join(f"{r['warm_s']:.4f} s, {r['iterations']} iterations, peak "
                        f"{r['peak_gib']:.3f} GiB" for r in out["tile"][name]) + f" [{card}]")
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout whose compiled kernels to time against this one's")
    parser.add_argument("--tile-detect", action="store_true",
                        help="phases 1 and 8 alone, 8b at the full 10980^2 tile")
    parser.add_argument("--tile-entry", action="store_true",
                        help="phases 1, 2 and 9 alone, 9b and 9c at the full 10980^2 tile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (REPO / "satellite_approximation_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the satellite_approximation_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from satellite_approximation_tpu_torch.models import multigrid as mg
    from satellite_approximation_tpu_torch.ops import stencil_kernels as K

    dev = torch.device("cuda")
    card = phase_device(torch)
    if args.tile_detect:
        phase_detect(torch, dev, card, big=TILE)
        return 0
    phase_build(K)
    if args.tile_entry:
        phase_entry_points(torch, K, dev, card, tile=True)
        return 0
    if args.against is not None:
        print(json.dumps({"against": phase_against(torch, K, mg, dev, card,
                                                   args.against.resolve())}))
        return 0
    results = phase_kernels(torch, K, mg, dev)
    counts, system = phase_main_path(torch, K, dev, card)
    tile = phase_full_tile(torch, dev, card)
    counts.update(phase_general_iterate(torch, K, dev, card, system, tile))
    del tile
    counts.update(phase_benchmark_paths(torch, K, dev, card))
    phase_detect(torch, dev, card)
    for name, n in phase_entry_points(torch, K, dev, card).items():
        counts[name] = counts.get(name, 0) + n
    missing = [name for name in KERNELS if counts.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    if any(m.startswith("jax") for m in sys.modules):
        raise AssertionError("jax was imported")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **{k: results[name][k] for k in keys}}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
