"""Device (torch) backend for the probability-refinement stages
(``satellite_approximation_tpu/models/detection/refinement_jax.py``; the
functions keep that module's names without the ``_jax`` suffix).

The host backend in :mod:`refinement` replicates the reference's numerics
(ProbabilityRefinement.cpp) with numpy/scipy; this module provides the same
stages as torch ops on the rasters' device — equality-tested against the
host backend:

* :func:`alpha_map` — the logistic remap, elementwise;
* :func:`beta_map` — the per-shadow radial falloff, bucketed into
  statically-shaped influence windows (the same bucket strategy as
  matching) and evaluated a batch of shadows at a time: an exact integer
  Euclidean distance transform (column scan + row min-plus reduction,
  BANDED to the bucket's influence radius — no data-dependent control
  flow), the quadratic radial falloff, the f64 inverse-cast back-projection
  of the blurred CLP, and a max-composite window by window;
* :func:`probability_map` — the raster-sized histogram accumulation
  (ProbabilityRefinement.cpp:137-151) as integer ``index_add_``; the TINY
  (d<=128 squared) sequential hole-fill and surface composite stay on the
  host, where the reference's in-round update order is natural — only
  d*d-cell grids come to the host, not rasters;
* :func:`improved_shadow_mask` — the per-pixel surface sampling + final
  mask logic (:226-241, :264-283) as gathers over the precomputed extended
  surface table.

Exactness notes (why host and device agree):
* the EDT is computed in integer arithmetic (squared distances are exact
  in i32 for any bucket size used here), then rooted in f64 — the same
  correctly-rounded value scipy's EDT produces;
* the back-projection runs in f64 with the host's operation order
  (pixel_to_world -> M^-1 -> world_to_index floor semantics);
* the falloff factor is f32 like Functions.cpp:151-162, one torch op per
  numpy op in the same order;
* the histograms count in int32, so the order in which a CUDA device adds
  is immaterial.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import RefinementConfig
from ...device import as_tensor, divide, resolve_device
from ...ops import geometry
from ...ops.masks import fetch_mask, push_mask
from .matching import OptimalSolution, ShadowObject, _bucket_size
from .refinement import _border_mask

_NO_SEED = 1 << 15  # farther than any window diagonal; square fits i32
_BETA_BATCH_CELLS = 1 << 22  # window cells per batch of shadows (f64 intermediates)


def _device_of(x, device) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else resolve_device(device)


def alpha_map(nir_difference, alpha_a: float = 17.0, alpha_b: float = 0.007, device=None):
    """Device alpha map: F(x) = f(x-.5) - f(-.5), f(x)=1/(1+b e^{-ax}), f32
    (ProbabilityRefinement.cpp:13-27). Returns a tensor."""
    dev = _device_of(nir_difference, device)
    a = np.float32(alpha_a).item()
    b = np.float32(alpha_b).item()
    x = as_tensor(nir_difference, dev, torch.float32)

    def f(v):
        return 1.0 / (1.0 + b * torch.exp(-a * v))

    return f(x - 0.5) - f(torch.full((), -0.5, dtype=torch.float32, device=dev))


def _edt_sq(seeds, extent_h, extent_w, band: int | None = None):
    """Squared Euclidean distance to the nearest seed, i32 — exact up to
    ``band`` (exact everywhere when band is None). ``seeds`` (..., hb, wb)
    bool; ``extent_h`` / ``extent_w`` ints or tensors that broadcast against
    it (shape (..., 1, 1)): seeds beyond the extent are ignored.

    Two-phase separable EDT without data-dependent control flow:
    phase 1 scans each column for the nearest seed row (cummax of seed row
    indices, both directions); phase 2 is a min-plus reduction over column
    OFFSETS, banded to |offset| <= band. Any pixel whose true distance
    exceeds ``band`` gets SOME value > band^2 (the banded min is over a
    candidate subset, so it only over-estimates); callers that threshold at
    a distance <= band (beta's influence radius is clipped to
    beta_max_distance) therefore see exact results. Cost drops from
    O(hb * wb^2) to O(hb * wb * band)."""
    hb, wb = seeds.shape[-2:]
    dev = seeds.device
    rows = torch.arange(hb, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(wb, dtype=torch.int32, device=dev)[None, :]
    seeds = seeds & (rows < extent_h) & (cols < extent_w)

    neg_big, pos_big = -(1 << 20), 1 << 20
    above = rows - torch.cummax(torch.where(seeds, rows, neg_big), dim=-2).values
    below = torch.cummin(torch.where(seeds, rows, pos_big).flip(-2), dim=-2).values.flip(-2) - rows
    g = torch.minimum(above, below).clamp_max(_NO_SEED)
    g2 = g * g

    big = 2**30
    b_eff = wb - 1 if band is None else min(int(band), wb - 1)
    # padded candidates carry `big` (no overflow: big + band^2 < 2^31)
    g2p = torch.nn.functional.pad(g2, (b_eff, b_eff), value=big)
    acc = torch.full_like(g2, big)
    for i in range(2 * b_eff + 1):  # offsets -b_eff..+b_eff
        d = i - b_eff
        torch.minimum(acc, g2p[..., i : i + wb] + d * d, out=acc)
    return acc


def _beta_bucket(
    clp_f,  # (H, W) f32, flipped rows (bottom-origin), shared
    ret_f,  # (H + hb, W + wb) f32, flipped + padded; updated in place
    in_shadow,  # (Ns, hb, wb) bool
    border,  # (Ns, hb, wb) bool
    anchor,  # Ns host pairs (ib_x0, ib_y0)
    extent,  # (Ns, 2) i32: (ih, iw) true influence size
    inf_f,  # (Ns,) f32
    lo,  # (Ns,) f32 — inf * beta_min_factor
    mid: float,  # beta_mid_percentile
    minv,  # (Ns, 4, 4) f64
    sx: float,
    sy: float,
    hb: int,
    wb: int,
    height: int,
    width: int,
    band: int | None = None,  # EDT exactness horizon >= max influence radius
):
    """Max-composite the radial-falloff contributions of one bucket of
    shadows into ``ret_f`` (ProbabilityRefinement.cpp:29-106): the windows
    of a batch of shadows are evaluated together, then merged one by one
    (max is order-independent)."""
    dev = clp_f.device
    ns = in_shadow.shape[0]
    u = torch.arange(wb, dtype=torch.int32, device=dev)
    v = torch.arange(hb, dtype=torch.int32, device=dev)
    anc = torch.tensor(anchor, dtype=torch.int32, device=dev).reshape(ns, 2)
    mid = np.float32(mid).item()
    step = max(1, _BETA_BATCH_CELLS // (hb * wb))
    for s0 in range(0, ns, step):
        s = slice(s0, s0 + step)
        ih = extent[s, 0, None, None]
        iw = extent[s, 1, None, None]
        d2 = _edt_sq(border[s], ih, iw, band=band)
        dist = torch.sqrt(d2.to(torch.float64)).to(torch.float32)
        dist = torch.where(in_shadow[s], torch.zeros_like(dist), dist)
        hi = inf_f[s, None, None]
        lo_s = lo[s, None, None]
        within = dist <= hi

        # quadratic radial basis, f32 (Functions.cpp:151-162)
        a = mid * hi + (1 - mid) * lo_s
        span2 = (hi - lo_s) * (hi - lo_s)
        falling = 1 - (dist - lo_s) * (dist - lo_s) / (span2 * mid)
        rising = (dist - hi) * (dist - hi) / (span2 * (1 - mid))
        factor = torch.where(
            dist <= lo_s,
            torch.ones_like(dist),
            torch.where(dist <= a, falling, torch.where(dist <= hi, rising, torch.zeros_like(dist))),
        )

        # f64 back-projection with the host's op order: pixel centre ->
        # world -> M^-1 -> floor index (ImageOperations.h pos/index)
        gx = (anc[s, 0, None] + u).to(torch.float64)  # (n, wb)
        gy = (anc[s, 1, None] + v).to(torch.float64)  # (n, hb)
        px = divide(sx * (gx + 0.5), width)[:, None, :]
        py = divide(sy * (gy + 0.5), height)[:, :, None]
        m = minv[s]
        back0 = m[:, 0, 0, None, None] * px + m[:, 0, 1, None, None] * py + m[:, 0, 3, None, None]
        back1 = m[:, 1, 0, None, None] * px + m[:, 1, 1, None, None] * py + m[:, 1, 3, None, None]
        ci = torch.floor(divide(width * back0, sx)).to(torch.int32)
        cj = torch.floor(divide(height * back1, sy)).to(torch.int32)
        valid = (ci >= 0) & (ci < width) & (cj >= 0) & (cj < height)
        flat = cj.clamp(0, height - 1) * width + ci.clamp(0, width - 1)
        clp_v = clp_f.reshape(-1).index_select(0, flat.reshape(-1)).reshape(flat.shape)

        in_ext = (v[:, None] < ih) & (u[None, :] < iw)
        contrib = torch.where(within & valid & in_ext, clp_v * factor, torch.zeros_like(dist))
        for n, (ix0, iy0) in enumerate(anchor[s]):
            region = ret_f[iy0 : iy0 + hb, ix0 : ix0 + wb]
            torch.maximum(region, contrib[n], out=region)
    return ret_f


def _beta_prep(
    shadows: dict[int, ShadowObject],
    solutions: dict[int, OptimalSolution],
    h: int,
    w: int,
    config: RefinementConfig,
):
    """Host prep of the beta map: per accepted shadow, the influence window geometry and the (tiny)
    bbox-border stencil — pure indexing, no floating-point compute.
    Returns (items, buckets, max_b)."""
    items = []
    for sid, shadow in shadows.items():
        if shadow.window is None or shadow.area == 0 or shadow.bounds is None:
            continue
        sol = solutions[sid]
        m_inv = np.linalg.inv(sol.M)
        inf_f = float(
            np.clip(
                np.float32(config.beta_area_correction) * np.sqrt(np.float32(shadow.area)),
                config.beta_min_distance,
                config.beta_max_distance,
            )
        )
        inf_i = int(np.floor(inf_f))
        bx0, by0, bx1, by1 = shadow.bounds
        ib_x0 = int(np.clip(bx0 - inf_i, 0, w - 1))
        ib_y0 = int(np.clip(by0 - inf_i, 0, h - 1))
        ib_x1 = int(np.clip(bx1 + inf_i, 0, w - 1))
        ib_y1 = int(np.clip(by1 + inf_i, 0, h - 1))
        iw_t, ih_t = ib_x1 - ib_x0 + 1, ib_y1 - ib_y0 + 1

        ax, ay = shadow.anchor
        win = shadow.window
        bbox = np.zeros((by1 - by0 + 1, bx1 - bx0 + 1), dtype=bool)
        bbox[:, :] = win[by0 - ay : by1 - ay + 1, bx0 - ax : bx1 - ax + 1]
        border = _border_mask(bbox)

        in_shadow = np.zeros((ih_t, iw_t), bool)
        bord_g = np.zeros((ih_t, iw_t), bool)
        oy0, ox0 = by0 - ib_y0, bx0 - ib_x0
        in_shadow[oy0 : oy0 + bbox.shape[0], ox0 : ox0 + bbox.shape[1]] = bbox
        bord_g[oy0 : oy0 + bbox.shape[0], ox0 : ox0 + bbox.shape[1]] = border
        items.append(
            dict(
                anchor=(ib_x0, ib_y0), extent=(ih_t, iw_t), inf=inf_f,
                lo=inf_f * config.beta_min_factor, minv=m_inv,
                in_shadow=in_shadow, border=bord_g,
            )
        )

    # a shadow's influence window (its box grown by the influence radius on
    # each side) can pass the largest of _BUCKETS, as on a 10 m tile
    max_b = _bucket_size(max((max(it["extent"]) for it in items), default=8))
    buckets: dict[tuple[int, int], list[dict]] = {}
    for it in items:
        key = (_bucket_size(it["extent"][0]), _bucket_size(it["extent"][1]))
        buckets.setdefault(key, []).append(it)
    return items, buckets, max_b


def _bucket_band(members: list[dict]) -> int:
    """EDT band for one bucket: the largest influence radius in the bucket,
    rounded up to a power of two. Distances beyond the radius contribute factor 0, so banding is exact
    (see _edt_sq) — with the default config this is 128 vs bucket widths up
    to 4096."""
    need = int(np.ceil(max(it["inf"] for it in members))) + 1
    return _bucket_size(need)  # never under-band (exactness)


def _bucket_operands(members: list[dict], hb: int, wb: int, device):
    """Stacked per-shadow operands for one bucket, on ``device`` (the
    anchors stay host pairs: the composite slices with them)."""
    pad = lambda a: np.pad(a, ((0, hb - a.shape[0]), (0, wb - a.shape[1])))
    put = lambda a, dt: as_tensor(np.asarray(a), device, dt)
    return dict(
        in_shadow=put(np.stack([pad(it["in_shadow"]) for it in members]), torch.bool),
        border=put(np.stack([pad(it["border"]) for it in members]), torch.bool),
        anchor=[it["anchor"] for it in members],
        extent=put([it["extent"] for it in members], torch.int32),
        inf_f=put(np.asarray([it["inf"] for it in members], np.float32), torch.float32),
        lo=put(np.asarray([it["lo"] for it in members], np.float32), torch.float32),
        minv=put(np.stack([it["minv"] for it in members]), torch.float64),
    )


def beta_map(
    shadows: dict[int, ShadowObject],
    solutions: dict[int, OptimalSolution],
    clp_blended,
    diagonal: float,
    config: RefinementConfig = RefinementConfig(),
    device_output: bool = False,
    device=None,
):
    """Device beta map: same contract as :func:`refinement.beta_map`,
    evaluated bucket by bucket on the device where ``clp_blended`` lies
    (a host array goes to ``device``; ``None``: the CUDA device).

    ``device_output=True`` returns the tensor (its only consumers — the
    histograms and the final-mask sampling — run there too)."""
    dev = _device_of(clp_blended, device)
    h, w = clp_blended.shape
    sx, sy = geometry.sides((h, w), diagonal)
    clp_t = torch.flipud(as_tensor(clp_blended, dev, torch.float32)).contiguous()

    items, buckets, max_b = _beta_prep(shadows, solutions, h, w, config)
    ret = torch.zeros((h + max_b, w + max_b), dtype=torch.float32, device=dev)

    for (hb, wb), members in buckets.items():
        ops = _bucket_operands(members, hb, wb, dev)
        _beta_bucket(
            clp_t, ret, ops["in_shadow"], ops["border"], ops["anchor"], ops["extent"],
            ops["inf_f"], ops["lo"], config.beta_mid_percentile, ops["minv"],
            float(sx), float(sy),
            hb=hb, wb=wb, height=h, width=w, band=_bucket_band(members),
        )
    out = torch.flipud(ret[:h, :w]).contiguous()
    return out if device_output else out.cpu().numpy()


def _histograms(alpha, beta, shadow, divisions: tuple[int, ...], valid=None):
    """Per-resolution (counts, sums) histograms of the shadow indicator over
    (alpha, beta) cells (ProbabilityRefinement.cpp:137-151) as ``index_add_``
    into int32 cells, for tensors on one device. Both counts AND indicator
    sums accumulate as int32, so they are exact for any cell population up
    to 2^31 and the same in whatever order the device adds;
    element_from_histogram converts to f32 only at the final division,
    matching the host's f64-bincount-then-f32 path bit-for-bit.

    ``valid`` (optional bool, broadcastable to alpha's shape): pixels whose
    count/sum contribution is masked out entirely — the hook for a
    row-padded sharded route. None = every pixel counts."""
    a = alpha.to(torch.float32).reshape(-1)
    b = beta.to(torch.float32).reshape(-1)
    s = shadow.reshape(-1).to(torch.int32)
    if valid is not None:
        v = valid.to(torch.bool).expand(alpha.shape).reshape(-1).to(torch.int32)
        s = s * v
    else:
        v = torch.ones_like(s)

    def agg(h, k):  # exact (d*k, d*k) -> (d, d) block sum, stays i32
        d = h.shape[0] // k
        return h.reshape(d, k, d, k).sum(dim=(1, 3), dtype=torch.int32)

    # The raster-scale adds are the expensive op here; the default divisions
    # are nested, and clip(floor(a*dk), 0, dk-1) // k == clip(floor(a*d), 0, d-1)
    # for any integer k >= 1 (floor-division identity; clipping maps the
    # a >= 1 and a < 0 tails consistently at every level) — so each division
    # whose value divides an already-computed finer one is derived by an
    # exact tiny block-sum instead of another pass over the raster.
    computed: dict[int, tuple] = {}
    for d in sorted(set(divisions), reverse=True):
        src = next((p for p in computed if p % d == 0), None)
        if src is not None:
            k = src // d
            computed[d] = tuple(agg(h, k) for h in computed[src])
        else:
            i = torch.floor(a * d).to(torch.int32).clamp(0, d - 1)
            j = torch.floor(b * d).to(torch.int32).clamp(0, d - 1)
            cell = i + d * j
            counts = torch.zeros(d * d, dtype=torch.int32, device=a.device).index_add_(0, cell, v)
            sums = torch.zeros(d * d, dtype=torch.int32, device=a.device).index_add_(0, cell, s)
            computed[d] = (counts.reshape(d, d), sums.reshape(d, d))
    return tuple(computed[d] for d in divisions)


def probability_map(
    shadow_mask,
    alpha,
    beta,
    config: RefinementConfig = RefinementConfig(),
    device=None,
):
    """Device-histogram variant of :func:`refinement.probability_map`.

    The raster-sized accumulation runs where ``alpha`` lies (a host array
    goes to ``device``); the d*d hole-fill (whose reference-exact sequential
    in-round update order is inherently serial,
    ProbabilityRefinement.cpp:162-183) and the 256x256 composite run on the
    host via the shared helpers — tiny grids, negligible transfer."""
    from . import refinement

    dev = _device_of(alpha, device)
    hists = _histograms(
        as_tensor(alpha, dev, torch.float32),
        as_tensor(beta, dev, torch.float32),
        push_mask(shadow_mask, dev),
        tuple(config.histogram_divisions),
    )
    elements = [
        refinement.element_from_histogram(c.cpu().numpy(), s.cpu().numpy())
        for (c, s) in hists
    ]
    return refinement.composite_surface(elements, config)


def _sample_final(ext, alpha, beta, object_mask, cloud_mask, threshold: float):
    """final = (bilinear-sample(P; alpha, beta) >= threshold OR object)
    AND NOT cloud, gathering from the extended surface table
    (ProbabilityRefinement.cpp:226-241 with operator() :264-283).

    ``ext`` is the (n+2, n+2) table of surface.at(i, j) for i, j in
    [-1, n] — every cell the sampler can touch for inputs in [0, 1], which
    alpha/beta satisfy by construction (both are probabilities)."""
    hgt = ext.shape[0] - 2
    wdt = ext.shape[1] - 2
    cellx = alpha.to(torch.float32) * float(wdt)
    celly = beta.to(torch.float32) * float(hgt)

    def roundf(x):  # half away from zero, like C roundf (:269-272)
        return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(torch.int32)

    x_max = roundf(cellx)
    y_max = roundf(celly)
    x_min = x_max - 1
    y_min = y_max - 1
    table = ext.reshape(-1)
    stride = ext.shape[1]

    def at(y, x):
        flat = (y + 1) * stride + (x + 1)
        return table.index_select(0, flat.reshape(-1)).reshape(flat.shape)

    p0 = at(y_min, x_min)
    p1 = at(y_min, x_max)
    p2 = at(y_max, x_min)
    p3 = at(y_max, x_max)
    u = cellx - (x_min.to(torch.float32) + 0.5)
    v = celly - (y_min.to(torch.float32) + 0.5)
    bottom = (1 - u) * p0 + u * p1
    top = (1 - u) * p2 + u * p3
    prob = (1 - v) * bottom + v * top
    ret = prob >= np.float32(threshold).item()
    return (ret | object_mask) & ~cloud_mask


def improved_shadow_mask(
    object_shadow_mask,
    cloud_mask,
    alpha,
    beta,
    surface,
    threshold: float,
    device_output: bool = False,
    device=None,
):
    """Device variant of :func:`refinement.improved_shadow_mask`: the
    raster-sized sampling + mask logic runs where ``alpha`` lies (a host
    array goes to ``device``), over the host-precomputed extended surface
    table. ``device_output`` returns the bool tensor — the pipeline's
    consumers (the percent reductions, the OR with the cloud mask) take it
    there."""
    dev = _device_of(alpha, device)
    out = _sample_final(
        as_tensor(surface._extended(), dev, torch.float32),
        as_tensor(alpha, dev, torch.float32),
        as_tensor(beta, dev, torch.float32),
        push_mask(object_shadow_mask, dev),
        push_mask(cloud_mask, dev),
        threshold,
    )
    return out if device_output else fetch_mask(out)
