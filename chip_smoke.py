#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``satellite_approximation_tpu_torch``)
on one NVIDIA GPU: builds the hand-written kernels from ``csrc/`` with nvcc,
holds each against its plain PyTorch version, drives the masked fill through
its public entry points at the size users run, and certifies the results.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. device: the card's name and power limit, TF32 off for matmuls and cuDNN;
2. build: nvcc builds ``csrc/*.cu`` into ``csrc/build/`` (seconds printed);
3. kernels: each of the four kernels against its plain version on the card,
   at the main path's level-0 shape (13x2048x2048 f32) and at 2x1373x1374 in
   f32 and bf16 storage — bit-equal required; median times of both;
4. main path: ``filling_missing_portions_smooth_boundaries`` and
   ``blend_images_poisson`` on bench.py's 13-band 2048^2 system, then
   ``multigrid.solve`` on it to 1e-6 (median of 5 after a warm-up); every
   result's relative residual is re-evaluated in f64 and must meet the
   tolerance, a small fill must match a direct sparse solve, and every
   kernel's launch count must have moved;
5. full tile: one band of a 10980^2 Sentinel-2 tile through ``laplace_fill``
   to 1e-6, with its time and peak device memory.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script prints no result and exits non-zero.
"""

from __future__ import annotations

import json
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
KERNELS = {
    # wrapper name -> (CUDA source, TPU kernel it replaces)
    "jacobi_zero": ("satellite_approximation_tpu_torch/csrc/jacobi.cu", f"{PALLAS}:743"),
    "jacobi_corr": ("satellite_approximation_tpu_torch/csrc/jacobi.cu", f"{PALLAS}:582"),
    "residual_entry": ("satellite_approximation_tpu_torch/csrc/residual.cu", f"{PALLAS}:1013"),
    "residual_pair": ("satellite_approximation_tpu_torch/csrc/residual.cu", f"{PALLAS}:1023"),
}


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


def _median_ms(torch, fn, runs=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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


def phase_kernels(torch, K, mg, dev):
    """Every kernel bit-equal to its plain version; times at the main shape."""
    from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor

    pre = mg._smoother_omegas(mg._PRE_SMOOTH)
    post = tuple(reversed(mg._smoother_omegas(mg._POST_SMOOTH)))
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    cases = [((BANDS, H, W), torch.float32, "main"), ((2, 1373, 1374), torch.float32, "odd"),
             ((2, 1373, 1374), torch.bfloat16, "odd")]
    for (c, h, w), dtype, tag in cases:
        g = torch.Generator(device=dev).manual_seed(h + c)
        if tag == "main":
            um = torch.from_numpy(make_mask(h, w)).to(dev)
        else:
            um = torch.rand((h, w), generator=g, device=dev) > 0.4
        invm = K.invm_for_kernel(um, neighbor_degree_tensor(h, w, dev)).to(dtype)
        b = torch.rand((c, h, w), generator=g, device=dev).to(dtype)
        u = torch.rand((c, h, w), generator=g, device=dev).to(dtype)
        e_c = torch.randn((c, (h + 1) // 2, (w + 1) // 2), generator=g, device=dev).to(dtype)
        img = torch.round(torch.rand((c, h, w), generator=g, device=dev) * 10000)
        x_hi = torch.rand((c, h, w), generator=g, device=dev) * 9000 * um
        x_lo = torch.randn((c, h, w), generator=g, device=dev) * 1e-4 * um
        calls = {
            "jacobi_zero": (lambda: K.jacobi_zero(b, invm, pre, True),
                            lambda: K.jacobi_zero_plain(b, invm, pre, True)),
            "jacobi_corr": (lambda: K.jacobi_corr(u, b, invm, e_c, post, True),
                            lambda: K.jacobi_corr_plain(u, b, invm, e_c, post, True)),
            "residual_entry": (lambda: K.residual_entry(img, invm),
                               lambda: K.residual_entry_plain(img, invm)),
            "residual_pair": (lambda: K.residual_pair(img, x_hi, x_lo, invm),
                              lambda: K.residual_pair_plain(img, x_hi, x_lo, invm)),
        }
        # the post-smooth without its residual runs on every level below the top
        err = _bitwise(torch, K.jacobi_corr(u, b, invm, e_c, post, False),
                       K.jacobi_corr_plain(u, b, invm, e_c, post, False))
        results["jacobi_corr"]["max_abs_err"] = max(results["jacobi_corr"]["max_abs_err"], err)
        for name, (kern, plain) in calls.items():
            err = _bitwise(torch, kern(), plain())
            res = results[name]
            res["max_abs_err"] = max(res["max_abs_err"], err)
            ms, plain_ms = _median_ms(torch, kern), _median_ms(torch, plain)
            if tag == "main":
                res["ms"], res["plain_ms"] = ms, plain_ms
            log(f"[3 kernels] {name:15s} {c}x{h}x{w} {str(dtype)[6:]:8s} bit-equal "
                f"max|d|={err:.1e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        del b, u, e_c, img, x_hi, x_lo, invm, calls
        torch.cuda.empty_cache()
    return results


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

    umask = make_mask(H, W)
    imgs = np.stack([smooth(H, W, s) for s in range(BANDS)]).astype(np.float64)
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

    deg = np.full((H, W), 4.0, dtype=np.float32)
    deg[0, :] -= 1
    deg[-1, :] -= 1
    deg[:, 0] -= 1
    deg[:, -1] -= 1
    known = imgs * (~umask)
    p = np.pad(known, ((0, 0), (1, 1), (1, 1)))
    b = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]) * umask
    b_t = torch.from_numpy(b).to(dev)
    x0_t = torch.from_numpy(imgs * umask).to(dev)

    def solve_once():
        res = multigrid.solve(b_t, umask, deg=deg, x0=x0_t, tolerance=TOL,
                              refinement_steps=4, device_output=True)
        torch.cuda.synchronize()
        return res

    solve_once()  # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = solve_once()
        times.append(time.perf_counter() - t0)
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
    missing = [k for k, v in counts.items() if v == 0]
    log(f"[4 main] kernel launches on the main path: {counts}")
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def phase_full_tile(torch, dev, card):
    from satellite_approximation_tpu_torch.models import fill

    m = tile_mask(torch, TILE, dev)
    img = tile_image(torch, TILE, dev)
    torch.cuda.synchronize()
    log(f"[5 tile] 1x{TILE}x{TILE}, {float(m.float().mean()) * 100:.2f}% masked")
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fill.laplace_fill(img, m, tolerance=TOL, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = res.x
        if out.shape != (TILE, TILE) and out.shape != (1, TILE, TILE):
            raise AssertionError(f"tile output shape {tuple(out.shape)}")
        if not (bool(torch.isfinite(out).all()) and res.error <= TOL):
            raise AssertionError(f"tile fill: residual {res.error} or non-finite output")
        if not torch.equal(out[..., ~m], img[..., ~m]):
            raise AssertionError("tile fill changed known pixels")
        log(f"[5 tile] laplace_fill ({run} hierarchy): {dt:.4f} s, {res.iterations} iterations, "
            f"certified {res.error:.3e}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"[{card}]")
        del res, out


def main() -> int:
    import torch

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
    phase_build(K)
    results = phase_kernels(torch, K, mg, dev)
    counts = phase_main_path(torch, K, dev, card)
    phase_full_tile(torch, dev, card)
    if any(m.startswith("jax") for m in sys.modules):
        raise AssertionError("jax was imported")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
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
