"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same numpy inputs, made from a seed, go through the JAX package (on the
CPU, where its Pallas kernels are replaced by their XLA routes) and through
the port (on the CPU, where each CUDA kernel is replaced by its plain PyTorch
version). Kernel tests that need the card use the ``cuda_device`` fixture
and the ``gpu`` marker: they run only with ``SAT_GPU_TESTS=1`` on a CUDA
host.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

# the suite runs with several workers; keep each worker's intra-op pool small
torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the kernels run only on the card."""
    if os.environ.get("SAT_GPU_TESTS") != "1":
        pytest.skip("CUDA kernel test: set SAT_GPU_TESTS=1 on a host with an H100")
    if not torch.cuda.is_available():
        pytest.skip("SAT_GPU_TESTS=1 but no CUDA device is available")
    return torch.device("cuda")


def make_mask(h, w, seed=3, n=40, margin=40, div=24):
    """Synthetic cloud field, a union of ellipses — bench.py's ``make_mask``
    with its margin and radius divisor as parameters, so that small grids
    can take it (bench.py's defaults give ~8-12% coverage at 2048^2)."""
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), dtype=bool)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(n):
        cy, cx = r.integers(margin, h - margin), r.integers(margin, w - margin)
        ry, rx = r.integers(2, max(h // div, 3)), r.integers(2, max(w // div, 3))
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    return m


def small_mask(h, w, seed=3):
    return make_mask(h, w, seed=seed, n=10, margin=4, div=6)


# kernel 10's shapes and masks (tests/test_torch_components.py, the card tests)
COMPONENT_SHAPES = [(1, 1), (1, 300), (300, 1), (37, 53), (257, 131)]
COMPONENT_KINDS = ["all-true", "all-false", "checkerboard", "spiral", "random-0.4", "random-0.6"]


def spiral(h, w):
    """A one-pixel spiral from the top left corner inwards, its turns one
    pixel apart: one 8-connected component whose diameter is its length."""
    m = np.zeros((h, w), bool)
    r = c = 0
    dr, dc = 0, 1
    m[0, 0] = True
    turns = 0
    while turns < 2:
        nr, nc, ar, ac = r + dr, c + dc, r + 2 * dr, c + 2 * dc
        inside = 0 <= nr < h and 0 <= nc < w
        touches = 0 <= ar < h and 0 <= ac < w and m[ar, ac]
        if inside and not m[nr, nc] and not touches:
            r, c, turns = nr, nc, 0
            m[r, c] = True
        else:
            dr, dc, turns = dc, -dr, turns + 1
    return m


def component_mask(h, w, kind, seed=91):
    """One of :data:`COMPONENT_KINDS`: the diagonal checkerboard is one
    component under 8-connectivity and single pixels under 4."""
    if kind == "all-true":
        return np.ones((h, w), bool)
    if kind == "all-false":
        return np.zeros((h, w), bool)
    if kind == "checkerboard":
        return np.add.outer(np.arange(h), np.arange(w)) % 2 == 0
    if kind == "spiral":
        return spiral(h, w)
    return np.random.default_rng(seed).random((h, w)) < float(kind.split("-")[1])


def smooth(h, w, seed):
    """bench.py's ``smooth``: a random field under four 4-neighbour means."""
    r = np.random.default_rng(seed)
    x = r.random((h, w), dtype=np.float32)
    for _ in range(4):
        x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1) + np.roll(x, -1, 1))
    return x


def bench_system(h, w, bands, seed=3):
    """bench.py's system at (bands, h, w): (imgs, umask, deg, b, x0)."""
    umask = small_mask(h, w, seed)
    deg = np.full((h, w), 4.0, dtype=np.float32)
    deg[0, :] -= 1
    deg[-1, :] -= 1
    deg[:, 0] -= 1
    deg[:, -1] -= 1
    imgs = np.stack([smooth(h, w, s) for s in range(bands)])
    known = imgs * (~umask)
    p = np.pad(known, ((0, 0), (1, 1), (1, 1)))
    b = (
        p[:, 0:h, 1 : w + 1] + p[:, 2 : h + 2, 1 : w + 1]
        + p[:, 1 : h + 1, 0:w] + p[:, 1 : h + 1, 2 : w + 2]
    ) * umask
    return imgs, umask, deg, b, imgs * umask


def random_mask(h, w, seed, p=0.4):
    """A mask with many degree-1/2/3 boundary cells."""
    return np.random.default_rng(seed).random((h, w)) > p


def edge_mask(h, w, kind, seed=0):
    """Masks at the edges of jacobi.cu's tile skip (48x48 tiles, 8-cell
    ring): ``none`` (no unknown cell), ``corner`` (one unknown cell in a
    corner of a few tiles, every other tile entirely known), ``ring48`` and
    ``ring112`` (unknown cells only just outside a 48^2 or 112^2 interior,
    inside its ring), ``dense`` (60 % unknown)."""
    m = np.zeros((h, w), dtype=bool)
    if kind == "corner":
        for i, j in ((48, 48), (95, 143), (47, 96), (96, 191)):
            if 0 < i < h - 1 and 0 < j < w - 1:
                m[i, j] = True
    elif kind in ("ring48", "ring112"):
        t = 48 if kind == "ring48" else 112
        # around the interior [t, 2t) x [t, 2t): the 8 rows above and below
        # it, the 8 columns left and right of it
        for i, j in ((t - 1, t + 5), (t - 8, t + 9), (2 * t, t + 3), (2 * t + 7, 2 * t - 1),
                     (t + 4, t - 1), (t + 11, t - 8), (t + 2, 2 * t), (2 * t - 1, 2 * t + 7)):
            if 0 < i < h - 1 and 0 < j < w - 1:
                m[i, j] = True
    elif kind == "dense":
        m = random_mask(h, w, seed, p=0.4)
    elif kind != "none":
        raise ValueError(kind)
    return m


# kernel 7's windows one condition short of static (v2_window_case)
V2_EDGE_KINDS = ("neg0", "inf", "nan", "bmax", "umax") + tuple(
    f"ring{r}-{c}" for r in (0, 1) for c in ("tl", "tr", "bl", "br")
)


def v2_window_case(c, w, kind="static", seed=0, h=241):
    """Kernel 7's inputs (u, b, umask, deg) at (c, h, w) f32: a cloud mask
    (``make_mask``) cleared around the window of jacobi_v2.cu's tile (1, 1)
    (image rows and columns 40 .. 103, 48x48 tiles with an 8-cell ring), and
    there ``kind``: ``static`` nothing more, else one condition short of a
    static window on a known cell of band 0 (``neg0`` u = -0, ``inf``,
    ``nan``, ``bmax`` b - A u overflowing, ``umax`` u near the f32 maximum),
    or one unknown cell at a corner of the window's outer ring or of the ring
    inside it (``ring0-tl`` .. ``ring1-br``)."""
    from satellite_approximation_tpu_torch.models.cg import neighbor_degree

    rng = np.random.default_rng(seed)
    um = make_mask(h, w, seed=seed)
    um[30:114, 30:114] = False
    u = (rng.random((c, h, w)) * 2 - 1).astype(np.float32)
    b = (rng.random((c, h, w)) * 2 - 1).astype(np.float32)
    special = {"neg0": ("u", -0.0), "inf": ("u", np.inf), "nan": ("u", np.nan),
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
    return u, b, um, neighbor_degree((h, w))


def shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` 4 bytes past an aligned allocation (so at
    an address 4 mod 16 bytes)."""
    k = 4 // t.element_size()
    flat = t.new_empty(t.numel() + k)
    out = flat[k:].view(t.shape)
    out.copy_(t)
    return out


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def assert_within_ulps(got, want, ulps: int = 2, scale: float | None = None) -> None:
    """max |got - want| <= ``ulps`` f32 ulps of ``scale``; by default
    max |want| (the scale of a cascade residual's rounding). Probability
    rasters pass their range, 1.0."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    bound = ulps * np.spacing(np.float32(np.max(np.abs(want)) if scale is None else scale))
    diff = float(np.max(np.abs(got - want)))
    assert diff <= bound, f"max diff {diff} > {ulps} ulp of max|want| ({bound})"


def assert_bitwise(got, want) -> None:
    """Equal bit for bit, the sign of zero included."""
    g, w = got.detach().cpu(), want.detach().cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(g.contiguous().view(view), w.contiguous().view(view)), (
        f"max |diff| {float((g.float() - w.float()).abs().max())}"
    )


# ---------------------------------------------------------------- detection


def match_scene(h=96, w=128, diag=10.0, n_clouds=3, seed=5, shift=(0, 14), border=False):
    """Synthetic matching scene (the ``make_scene`` of tests/test_detection.py
    as plain arrays): a few rectangular clouds and a potential-shadow field
    displaced by ``shift`` = (rows, cols) pixels, with speckle. Returns
    (cloud mask, potential shadows, sun position, view position, diagonal);
    each package partitions the mask itself. ``border``: one more cloud that
    touches the image's left and bottom border."""
    r = np.random.default_rng(seed)
    mask = np.zeros((h, w), dtype=bool)
    for _ in range(n_clouds):
        cy, cx = int(r.integers(18, h - 26)), int(r.integers(30, w - 30))
        hh, ww = int(r.integers(4, 9)), int(r.integers(4, 10))
        mask[cy : cy + hh, cx : cx + ww] = True
    if border:
        mask[h - 7 :, :9] = True
    sun_pos = np.array([2.0e8, 1.0e8, 1.5e9])
    view_pos = np.array([0.05, 0.1, 785.0])
    dy, dx = shift
    psm = np.roll(mask, (-dy, -dx), axis=(0, 1))
    psm |= r.random((h, w)) > 0.96
    psm &= ~mask
    return mask, psm, sun_pos, view_pos, diag


def bucket_scene(scale: int = 1, seed: int = 3, shift=(-3, -5)):
    """A matching scene whose clouds fall into six window buckets: six
    rectangles of 3x5 to 40x60 pixels (rows x columns), sizes and places
    times ``scale``, at 0.0625 km a pixel, with a potential-shadow field
    displaced by ``shift`` pixels and speckle. Returns what
    :func:`match_scene` returns."""
    sizes = [(3, 5), (6, 12), (12, 5), (20, 28), (36, 14), (40, 60)]
    places = [(20, 20), (20, 50), (20, 90), (20, 130), (80, 20), (80, 60)]
    h, w = 160 * scale, 224 * scale
    mask = np.zeros((h, w), dtype=bool)
    for (rows, cols), (r0, c0) in zip(sizes, places):
        mask[r0 * scale : (r0 + rows) * scale, c0 * scale : (c0 + cols) * scale] = True
    r = np.random.default_rng(seed)
    psm = np.roll(mask, (-shift[0], -shift[1]), axis=(0, 1))
    psm |= r.random((h, w)) > 0.96
    psm &= ~mask
    sun_pos = np.array([2.0e8, 1.0e8, 1.5e9])
    view_pos = np.array([0.05, 0.1, 785.0])
    return mask, psm, sun_pos, view_pos, 0.0625 * float(np.hypot(h, w))


def strip_scene(length: int):
    """A 40 x 4400 matching scene at 10 m a pixel with one cloud, a row of
    ``length`` pixels, and its shadow: the strip moved 3 rows down and 6
    columns left (where it falls from about 0.45 km under the sun of
    :func:`match_scene`), with speckle. A strip of more than 4096 px casts
    windows wider than the largest of ``matching._BUCKETS``. Returns what
    :func:`match_scene` returns."""
    h, w = 40, 4400
    mask = np.zeros((h, w), dtype=bool)
    mask[12, 100 : 100 + length] = True
    psm = np.roll(mask, (3, -6), axis=(0, 1))
    psm |= np.random.default_rng(3).random((h, w)) > 0.97
    psm &= ~mask
    sun_pos = np.array([2.0e8, 1.0e8, 1.5e9])
    view_pos = np.array([0.05, 0.1, 785.0])
    return mask, psm, sun_pos, view_pos, 0.010 * float(np.hypot(h, w))

# kernel 11's cases: the (wb, hb) buckets (the card tests take all, the CPU
# tests the first three; 8192 is past the largest of matching._BUCKETS) and
# the kinds of pairs (see sweep_case)
SWEEP_BUCKETS = [(8, 8), (16, 8), (64, 32), (256, 128), (1024, 512), (4096, 2048), (8192, 64)]
SWEEP_KINDS = ["separable", "sheared", "edges", "leaving", "sparse", "absent", "oversized"]


def sweep_case(wb: int, hb: int, kind: str, seed: int = 0, nh: int = 3, nc: int = 4):
    """The operands of one bucket's similarity sweep (``matching._bucket_sweep``),
    as numpy: (rasters, ids, per-pair operands, static arguments).

    Random rasters of about 1.5 buckets a side (at least 24), padded as
    ``match_clouds_shadows`` pads them; the id map in 8x8 blocks of the
    clouds' ids and -1. Pairs of ``nh`` heights and ``nc`` clouds, boxes of
    half a bucket to a bucket, casts A x + d with A about the identity.
    ``kind``: "separable" (A a multiple of the identity), "sheared" (the
    cross terms 0.005-0.05), "edges" (boxes clipped at the left, right,
    bottom and top edge of the raster), "leaving" (shifts of 0.6 rasters:
    casts leave the raster, some by less than one pixel), "sparse" (99.5 %
    cloud: most pairs under the minimum support), "absent" (a cloud whose id
    is not in the id map), "oversized" (boxes up to 1.5 buckets, which the
    bucket clips)."""
    rng = np.random.default_rng(seed)
    h, w = max(hb + hb // 2, 24), max(wb + wb // 2, 24)
    ids = (3 * np.arange(1, nc + 1)).astype(np.int32)
    coarse = rng.choice(np.r_[-1, ids], size=((h + 7) // 8, (w + 7) // 8))
    id_map = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w].astype(np.int32)
    cloud = rng.random((h, w)) < (0.995 if kind == "sparse" else 0.3)
    shadow = rng.random((h, w)) < 0.5
    if kind == "absent":
        ids[-1] = 10**6
    top = 3 if kind == "oversized" else 2
    ext_x = rng.integers(wb // 2 + 1, top * wb // 2 + 1, (nh, nc))
    ext_y = rng.integers(hb // 2 + 1, top * hb // 2 + 1, (nh, nc))
    min_x, min_y = rng.integers(0, w, (nh, nc)), rng.integers(0, h, (nh, nc))
    if kind == "edges":
        min_x[:, 0::4] = 0
        min_x[:, 1::4] = w - ext_x[:, 1::4] // 2
        min_y[:, 2::4] = 0
        min_y[:, 3::4] = h - ext_y[:, 3::4] // 2
    max_x = np.minimum(min_x + ext_x - 1, w - 1)
    max_y = np.minimum(min_y + ext_y - 1, h - 1)
    scale = rng.uniform(0.97, 1.03, (nh, nc))
    a2 = np.zeros((nh, nc, 2, 2))
    a2[..., 0, 0] = a2[..., 1, 1] = scale
    if kind == "sheared":
        a2[..., 0, 1] = rng.choice([-1, 1], (nh, nc)) * rng.uniform(0.005, 0.05, (nh, nc))
        a2[..., 1, 0] = rng.choice([-1, 1], (nh, nc)) * rng.uniform(0.005, 0.05, (nh, nc))
    delta = rng.uniform(-12.0, 12.0, (nh, nc, 2))
    if kind == "leaving":
        delta[..., 0] -= 0.6 * w * (np.arange(nc) % 2 == 0)
        delta[..., 1] += 0.6 * h * (np.arange(nc) % 2 == 1)
    pf = max(wb, hb)
    pad = ((pf, hb), (pf, wb))
    rasters = (np.pad(cloud, pad), np.pad(shadow, pad),
               np.pad(id_map, pad, constant_values=-2))
    pairs = dict(min_x=min_x.astype(np.int32), min_y=min_y.astype(np.int32),
                 max_x=max_x.astype(np.int32), max_y=max_y.astype(np.int32),
                 a2=a2.astype(np.float32), delta=delta.astype(np.float32))
    return rasters, ids, pairs, dict(wb=wb, hb=hb, width=w, height=h, pf=pf)


def true_box_counts(rasters, ids, pairs, wb, hb, width, height, pf):
    """(t, c), int32 (Nh, Nc): kernel 11's algorithm in numpy, pair by pair
    over its box clipped to the bucket, the cast position rounded op by op
    in f32 and truncated toward zero."""
    cloud, shadow, id_map = rasters
    nh, nc = pairs["min_x"].shape
    t = np.zeros((nh, nc), np.int32)
    c = np.zeros((nh, nc), np.int32)
    for i in range(nh):
        for j in range(nc):
            x0, y0 = int(pairs["min_x"][i, j]), int(pairs["min_y"][i, j])
            x1 = min(int(pairs["max_x"][i, j]), x0 + wb - 1)
            y1 = min(int(pairs["max_y"][i, j]), y0 + hb - 1)
            fx = np.arange(x0, x1 + 1, dtype=np.float32)[None, :]
            fy = np.arange(y0, y1 + 1, dtype=np.float32)[:, None]
            (a00, a01), (a10, a11) = pairs["a2"][i, j]
            d0, d1 = pairs["delta"][i, j]
            qi = ((a00 * fx + a01 * fy) + d0).astype(np.int32)
            qj = ((a10 * fx + a11 * fy) + d1).astype(np.int32)
            valid = (qi >= 0) & (qi < width) & (qj >= 0) & (qj < height)
            win = (slice(y0 + pf, y1 + 1 + pf), slice(x0 + pf, x1 + 1 + pf))
            src = id_map[np.clip(qj, 0, height - 1) + pf, np.clip(qi, 0, width - 1) + pf]
            cand = ~cloud[win] & valid & (src == ids[j])
            t[i, j] = cand.sum()
            c[i, j] = (cand & shadow[win]).sum()
    return t, c


def mini_scene(n: int, seed: int = 7):
    """Tiny synthetic Sentinel-2-style scene (clouds, displaced NIR shadows,
    smooth angle rasters) — the ``_mini_scene`` of the JAX package's
    ``parallel/detect.py`` rebuilt from a numpy seed, as the RAW rasters
    ``detect`` decodes, keyed by file stem (CLP and CLD u8, B08 u16)."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n, n), np.float32)
    yy, xx = np.ogrid[:n, :n]
    for _ in range(10):
        cy, cx = rng.integers(n // 8, 7 * n // 8, 2)
        ry = int(rng.integers(n // 32 + 2, n // 12 + 4))
        rx = int(rng.integers(n // 32 + 2, n // 12 + 4))
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        np.maximum(base, np.exp(-0.5 * d2.astype(np.float32)), out=base)
    clp = np.clip(base * 255 * 1.2, 0, 255).astype(np.uint8)
    cld = np.clip(base * 100 * 1.1, 0, 100).astype(np.uint8)
    cloud = base > 0.55

    scl = np.full((n, n), 4, np.uint8)
    scl[base > 0.75] = 9
    scl[(base > 0.65) & (base <= 0.75)] = 8

    dy, dx = -max(n // 24, 2), -max(n // 32, 2)
    shadow = np.zeros_like(cloud)
    src = cloud[max(-dy, 0) : n - max(dy, 0), max(-dx, 0) : n - max(dx, 0)]
    shadow[max(dy, 0) : n - max(-dy, 0), max(dx, 0) : n - max(-dx, 0)] = src
    g = rng.standard_normal((n, n)).astype(np.float32)
    for _ in range(6):
        g = 0.25 * (
            np.roll(g, 1, 0) + np.roll(g, -1, 0) + np.roll(g, 1, 1) + np.roll(g, -1, 1)
        )
    g = g / max(float(g.std()), 1e-6)
    nir = (6000 + 1500 * g).clip(500, 10000)
    nir[shadow] *= 0.35

    grad = (yy / n + xx / n).astype(np.float32)
    return {
        "CLP": clp,
        "CLD": cld,
        "SCL": scl,
        "B08": nir.astype(np.uint16),
        "sunZenithAngles": 35.0 + 0.5 * grad,
        "sunAzimuthAngles": 145.0 + 0.5 * grad,
        "viewZenithMean": 5.0 + 0.2 * grad,
        "viewAzimuthMean": 100.0 + 0.3 * grad,
    }


def mini_diagonal(n: int) -> float:
    """A tile's ~219 km diagonal scaled to an n x n scene, km."""
    return 100.0 * (n / 10980.0) * 219.0 / 100.0


def normalized(scene: dict) -> dict:
    """The f32 rasters the stages take, from a raw scene (host numpy f32
    division, which the device normalization equals bit for bit)."""
    return {
        "clp": scene["CLP"].astype(np.float32) / np.float32(255),
        "cld": scene["CLD"].astype(np.float32) / np.float32(100),
        "nir": scene["B08"].astype(np.float32) / np.float32(65535),
        "scl": scene["SCL"],
    }


def detection_config(mod, refinement: str, matching: str):
    """``mod.DEFAULT_DETECTION`` (either package's config module) with the
    two backends set."""
    import dataclasses

    c = mod.DEFAULT_DETECTION
    return dataclasses.replace(
        c,
        refinement=dataclasses.replace(c.refinement, backend=refinement),
        matching=dataclasses.replace(c.matching, backend=matching),
    )


NATIVE_ROUTES = ["native", "python"]


@contextlib.contextmanager
def jax_package_without_native():
    """Run the JAX package's Python routes: whether its C++ library exists
    depends on a build that concurrent test workers race for, and its two
    hole fills differ in the last digits (f32 against f64 accumulation), so
    a reference taken with "whatever is there" would not be one reference."""
    from satellite_approximation_tpu import native as jax_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "get_lib", lambda: None)
        yield


@pytest.fixture
def native_route(request, monkeypatch):
    """Both routes of a function that has a C++ twin, as two cases of one
    parametrised test (``@pytest.mark.parametrize("native_route",
    NATIVE_ROUTES, indirect=True)``): "native" requires the port's library
    wherever a compiler is on PATH, so that the case cannot quietly run the
    Python route; "python" takes the library away."""
    import shutil

    from satellite_approximation_tpu_torch import native

    if request.param == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif shutil.which("g++") is not None:
        assert native.available(), "g++ is on PATH but the native library did not build"
    return request.param

