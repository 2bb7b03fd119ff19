"""Native (C++) runtime helpers, loaded via ctypes with pure-Python fallback.

Counterpart of ``satellite_approximation_tpu/native/__init__.py``, with the
same ten wrappers. The C++ source is the JAX package's
``native/src/satnative.cpp``, read where it lies and never written; the
library is built on first use with the same flags into the port's own build
directory (``csrc/build/``, not tracked by git) under a name that hashes the
source and the flags. It is written to a temporary name and renamed, so a
process that finds the file finds a whole library, however many processes
build at once. Without a toolchain (or without the source) every entry point
returns ``None`` and its caller takes the Python route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "satellite_approximation_tpu" / "native" / "src" / "satnative.cpp"
BUILD_DIR = _PKG / "csrc" / "build"
# -ffp-contract=off: cloud_sweep's f32 affine must round exactly like the
# torch/numpy (no-FMA) path so pixel truncation matches
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")


def build() -> Path | None:
    """Compile ``SOURCE`` into ``csrc/build/libsatnative_<hash>.so`` unless
    that file exists; returns its path, or None without ``g++`` or the
    source, or when the compiler fails."""
    gxx = shutil.which("g++")
    if gxx is None or not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"libsatnative_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / lib.name
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            capture_output=True, text=True, check=False, timeout=300,
        )
        if proc.returncode != 0:
            (BUILD_DIR / "gxx_satnative.log").write_text(proc.stdout + proc.stderr)
            return None
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


@functools.cache
def get_lib():
    """The loaded native library, building it on demand; None if unavailable."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.hole_fill.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
    ]
    lib.flood_partition.restype = ctypes.c_int32
    lib.flood_partition.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.border_mask.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _i32p = ctypes.POINTER(ctypes.c_int32)
    _f32p = ctypes.POINTER(ctypes.c_float)
    lib.cloud_sweep.argtypes = [
        _u8p, _u8p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        _i32p, _i32p, _i32p, _i32p,
        _f32p, _f32p,
        ctypes.c_int32, _f32p,
    ]
    lib.cloud_detail.argtypes = [
        _u8p, _u8p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, _u8p, _i32p, _i32p,
    ]
    lib.pit_fill_flood.argtypes = [
        _f32p, _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
    ]
    lib.prob_histograms.argtypes = [
        _f32p, _f32p, _u8p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
    ]
    lib.final_mask_sample.argtypes = [
        _f32p, _f32p, _f32p, ctypes.c_int32, _u8p, _u8p,
        ctypes.c_float, ctypes.c_int64, _u8p,
    ]
    return lib


def available() -> bool:
    return get_lib() is not None


def hole_fill(grid: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Sequential inverse-distance hole fill (reference-exact update order).
    grid: (D, D) f32 indexed [j, i]; valid: (D, D) bool. Returns updated
    copies, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    d = grid.shape[0]
    g = np.ascontiguousarray(grid, dtype=np.float32).copy()
    v = np.ascontiguousarray(valid, dtype=np.uint8).copy()
    lib.hole_fill(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(d),
    )
    return g, v.astype(bool)


def flood_partition(mask: np.ndarray, min_area: int) -> tuple[np.ndarray, int] | None:
    """BFS flood partition in reference scan order. mask: (H, W) bool.
    Returns (labels int32 with -1 background, n_regions), or None."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = m.shape
    labels = np.empty((h, w), dtype=np.int32)
    n = lib.flood_partition(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(h),
        ctypes.c_int32(w),
        ctypes.c_int32(min_area),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return labels, int(n)


def border_mask(mask: np.ndarray) -> np.ndarray | None:
    """Region-border extraction (Functions::border semantics)."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = m.shape
    out = np.empty((h, w), dtype=np.uint8)
    lib.border_mask(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(h),
        ctypes.c_int32(w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def cloud_sweep(
    cmask: np.ndarray,
    psm: np.ndarray,
    cmap: np.ndarray,
    width: int,
    height: int,
    cid: int,
    mnx: np.ndarray,
    mny: np.ndarray,
    mxx: np.ndarray,
    mxy: np.ndarray,
    a2: np.ndarray,
    delta: np.ndarray,
    min_support: int,
) -> np.ndarray | None:
    """Ray-cast similarity of one cloud over all heights
    (CloudShadowMatching.cpp:70-152 scan, host path). cmask/psm bool and
    cmap int32 are the padded flipped rasters; per-height bbox arrays int,
    a2 (nh, 2, 2) f32, delta (nh, 2) f32. Returns (nh,) f32 sims or None."""
    lib = get_lib()
    if lib is None:
        return None
    cm = np.ascontiguousarray(cmask, np.uint8)
    ps = np.ascontiguousarray(psm, np.uint8)
    cp = np.ascontiguousarray(cmap, np.int32)
    nh = len(mnx)
    sims = np.empty(nh, np.float32)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    mnx, mny, mxx, mxy = i32(mnx), i32(mny), i32(mxx), i32(mxy)
    a2c = np.ascontiguousarray(a2.reshape(nh, 4), np.float32)
    dc = np.ascontiguousarray(delta.reshape(nh, 2), np.float32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    lib.cloud_sweep(
        cm.ctypes.data_as(p_u8), ps.ctypes.data_as(p_u8), cp.ctypes.data_as(p_i32),
        ctypes.c_int32(cm.shape[1]), ctypes.c_int32(width), ctypes.c_int32(height),
        ctypes.c_int32(cid), ctypes.c_int32(nh),
        mnx.ctypes.data_as(p_i32), mny.ctypes.data_as(p_i32),
        mxx.ctypes.data_as(p_i32), mxy.ctypes.data_as(p_i32),
        a2c.ctypes.data_as(p_f32), dc.ctypes.data_as(p_f32),
        ctypes.c_int32(min_support), sims.ctypes.data_as(p_f32),
    )
    return sims


def cloud_detail(
    cmask: np.ndarray,
    psm: np.ndarray,
    cmap: np.ndarray,
    width: int,
    height: int,
    cid: int,
    bbox: tuple[int, int, int, int],
    a2: np.ndarray,
    delta: np.ndarray,
    hb: int,
    wb: int,
):
    """Hit window + counts + hit bounds at one height (the _bucket_detail
    contract). Returns (t, c, hit_win bool (hb, wb), x0, y0, x1, y1)."""
    lib = get_lib()
    if lib is None:
        return None
    cm = np.ascontiguousarray(cmask, np.uint8)
    ps = np.ascontiguousarray(psm, np.uint8)
    cp = np.ascontiguousarray(cmap, np.int32)
    hit = np.zeros((hb, wb), np.uint8)
    counts = np.zeros(2, np.int32)
    bounds = np.zeros(4, np.int32)
    a2f = np.asarray(a2, np.float32).reshape(4)
    df = np.asarray(delta, np.float32).reshape(2)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.cloud_detail(
        cm.ctypes.data_as(p_u8), ps.ctypes.data_as(p_u8), cp.ctypes.data_as(p_i32),
        ctypes.c_int32(cm.shape[1]), ctypes.c_int32(width), ctypes.c_int32(height),
        ctypes.c_int32(cid),
        ctypes.c_int32(bbox[0]), ctypes.c_int32(bbox[1]),
        ctypes.c_int32(bbox[2]), ctypes.c_int32(bbox[3]),
        ctypes.c_float(a2f[0]), ctypes.c_float(a2f[1]),
        ctypes.c_float(a2f[2]), ctypes.c_float(a2f[3]),
        ctypes.c_float(df[0]), ctypes.c_float(df[1]),
        ctypes.c_int32(hb), ctypes.c_int32(wb),
        hit.ctypes.data_as(p_u8),
        counts.ctypes.data_as(p_i32), bounds.ctypes.data_as(p_i32),
    )
    return (
        int(counts[0]), int(counts[1]), hit.astype(bool),
        int(bounds[0]), int(bounds[1]), int(bounds[2]), int(bounds[3]),
    )


def pit_fill_flood(original: np.ndarray, border_value: float) -> np.ndarray | None:
    """Priority-flood pit fill (exact reconstruction-by-erosion fixpoint,
    O(n log n) host-side). original: (H, W) f32. Returns the filled surface,
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    o = np.ascontiguousarray(original, dtype=np.float32)
    h, w = o.shape
    if h * w >= 2**32:  # the C kernel indexes cells as uint32
        return None
    out = np.empty_like(o)
    lib.pit_fill_flood(
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(h),
        ctypes.c_int32(w),
        ctypes.c_float(border_value),
    )
    return out


def prob_histograms(
    alpha: np.ndarray, beta: np.ndarray, shadow: np.ndarray, divisions
) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """All probability-surface histogram resolutions in one native pass.
    Returns [(counts (d,d) i64, sums (d,d) f64), ...] per division, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(alpha, dtype=np.float32).ravel()
    b = np.ascontiguousarray(beta, dtype=np.float32).ravel()
    s = np.ascontiguousarray(shadow, dtype=np.uint8).ravel()
    divs = np.asarray(divisions, dtype=np.int32)
    total = int((divs.astype(np.int64) ** 2).sum())
    counts = np.zeros(total, dtype=np.int64)
    sums = np.zeros(total, dtype=np.float64)
    lib.prob_histograms(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(a.size),
        divs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(divs)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    out = []
    off = 0
    for d in divs:
        d = int(d)
        out.append(
            (counts[off : off + d * d].reshape(d, d), sums[off : off + d * d].reshape(d, d))
        )
        off += d * d
    return out


def final_mask_sample(
    alpha: np.ndarray,
    beta: np.ndarray,
    ext: np.ndarray,
    object_mask: np.ndarray,
    cloud_mask: np.ndarray,
    threshold: float,
) -> np.ndarray | None:
    """Final-mask surface sampling (bit-identical to the numpy path),
    OpenMP-parallel. Returns the bool mask or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(alpha, np.float32)
    b = np.ascontiguousarray(beta, np.float32)
    e = np.ascontiguousarray(ext, np.float32)
    o = np.ascontiguousarray(object_mask, np.uint8)
    c = np.ascontiguousarray(cloud_mask, np.uint8)
    out = np.empty(a.shape, np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.final_mask_sample(
        a.ctypes.data_as(f32p), b.ctypes.data_as(f32p),
        e.ctypes.data_as(f32p), ctypes.c_int32(e.shape[0]),
        o.ctypes.data_as(u8p), c.ctypes.data_as(u8p),
        ctypes.c_float(threshold), ctypes.c_int64(a.size),
        out.ctypes.data_as(u8p),
    )
    return out.astype(bool)
