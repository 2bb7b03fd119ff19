"""Cloud-shadow matching by ray casting — the pipeline's hot loop
(``satellite_approximation_tpu/models/detection/matching.py``).

Rebuild of lib/cloud_shadow_detection/source/CloudShadowMatching.cpp. The
reference triple-nests: per cloud, per hypothesis height (0.2..12 km in
0.025 steps → 473 candidates, CloudShadowMatching.cpp:139), per pixel of the
projected bbox — all single-threaded CPU. Here:

* the projective geometry (two perspectives + affine quad fit + inverse) is
  batched over (cloud × height) in one f64 einsum on the host — thousands of
  4x4 ops, microseconds;
* clouds are bucketed by window size; the per-pixel similarity scan of a
  bucket runs on the device, out of rasters padded so that no window leaves
  them. On a CUDA device it is kernel 11 (``csrc/sweep.cu``): one launch a
  bucket, every (height, cloud) pair's two counts in registers over its
  true box. Elsewhere it is a batch of window gathers (the torch form, the
  plain version of the kernel): every pair of a pass reads a statically
  sized window anchored at its projected bbox, masked to its true extent,
  and a bucket is cut into cloud groups and a group's heights into passes,
  so that a pass holds a bounded number of window cells whatever the scene.

Semantics match the reference pixel-for-pixel: candidate pixels are
non-cloud pixels inside the projected-quad bbox whose inverse-mapped
position (trunc-toward-zero, like glm's float→ivec2) lands on the cloud's
own id; similarity = |candidates ∩ potential-shadow| / |candidates|, with
<5-pixel support rejected (CloudShadowMatching.cpp:70-95) and a 0.3
similarity floor (CloudShadowMatching.cpp:154). The f32 affine that maps a
pixel to its cast position is separate multiplies and adds, rounded one by
one as the native scan (built without FMA contraction) rounds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ... import native
from ...config import MatchingConfig
from ...device import as_tensor, resolve_device
from ...ops import geometry, sweep_kernels
from ...ops import stencil_kernels as K
from ...ops.masks import fetch_mask, push_mask
from ...ops.stats import trimmed_average
from . import placement
from .cloud_mask import CloudObject

# bucket sides; a window wider than the last takes the next power of two
_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# window cells per cloud group of one bucket, and per batched pass of the
# torch form over a group's (height, cloud) pairs: they bound the live
# window-sized intermediates (about 20 bytes per cell) of the torch form's
# sweep and of the detail pass
_SWEEP_GROUP_CELLS = 1 << 24
_SWEEP_PASS_CELLS = 1 << 26


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def height_sweep(config: MatchingConfig) -> np.ndarray:
    """The f32-accumulated height ladder, replicating the reference's
    ``for (z = .2f; z <= 12.f; z += .025f)`` float loop exactly
    (CloudShadowMatching.cpp:139)."""
    out = []
    z = np.float32(config.height_min_km)
    step = np.float32(config.height_step_km)
    while z <= np.float32(config.height_max_km):
        out.append(float(z))
        z = np.float32(z + step)
    return np.asarray(out, dtype=np.float64)


@dataclasses.dataclass
class OptimalSolution:
    """Best match per cloud (CloudShadowMatching.h OptimalSolution)."""

    height: float
    similarity: float
    M: np.ndarray  # 4x4 world→world shadow-cast transform
    id: int


@dataclasses.dataclass
class ShadowObject:
    """Matched shadow pixels of one cloud, stored as a window + anchor
    instead of the reference's pixel list (types.h Pixels)."""

    id: int
    # bbox of hit pixels in (x, y-from-bottom) coordinates; None if no match
    bounds: tuple[int, int, int, int] | None
    area: int
    # bool window; window[v, u] covers pixel (anchor_x + u, anchor_y + v)
    window: np.ndarray | None
    anchor: tuple[int, int] | None


@dataclasses.dataclass
class MatchCloudsShadowsResults:
    solutions: dict[int, OptimalSolution]
    shadows: dict[int, ShadowObject]
    trimmed_mean_height: float
    shadow_mask: np.ndarray  # (H, W) bool, top-left convention


def _cast_transforms(
    clouds: list[CloudObject],
    heights: np.ndarray,
    shape_hw: tuple[int, int],
    diagonal: float,
    sun_pos: np.ndarray,
    view_pos: np.ndarray,
):
    """Batched geometry for all (cloud, height) pairs.

    Returns A2 (Nc,Nh,2,2), delta (Nc,Nh,2), window bounds (Nc,Nh,4) and the
    full M (Nc,Nh,4,4) — the vectorization of __MatchCloudShadow__'s
    per-height perspective/affineTransform block (CloudShadowMatching.cpp:139-143).
    """
    h, w = shape_hw
    corners = np.stack([c.quad.corners() for c in clouds])  # (Nc,4,3)
    c = corners[:, None, :, :]  # (Nc,1,4,3)
    z = heights[None, :, None]  # (1,Nh,1)

    # perspective through the height plane toward the satellite
    d1 = view_pos[None, None, None, :] - c
    t1 = (z[..., None] * np.ones_like(c[..., :1]) - c[..., 2:3]) / d1[..., 2:3]
    p1 = c + d1 * t1
    # then through the ground plane toward the sun
    d2 = sun_pos[None, None, None, :] - p1
    t2 = -p1[..., 2:3] / d2[..., 2:3]
    p2 = p1 + d2 * t2  # (Nc,Nh,4,3)

    ones = np.ones((*p2.shape[:-1], 1))
    x2 = np.concatenate([p2, ones], axis=-1)  # rows are corners
    x2 = np.swapaxes(x2, -1, -2)  # corners as columns (4,4)
    x1 = np.concatenate([corners, np.ones((corners.shape[0], 4, 1))], axis=-1)
    x1 = np.swapaxes(x1, -1, -2)
    # The quad corners all lie in z=0, so x1 is rank-3 singular. The
    # reference feeds it to Eigen's FullPivHouseholderQr inverse anyway
    # (Functions.cpp:84) — an ill-defined operation on a singular matrix.
    # The well-defined equivalent is the minimum-norm least-squares affine
    # fit M = x2 @ pinv(x1); for the near-affine sun/view projections the
    # fit residual is negligible.
    x1inv = np.linalg.pinv(x1)  # (Nc,4,4)
    m = np.einsum("cnij,cjk->cnik", x2, x1inv)
    m[..., 2, 2] = 1.0  # make invertible (CloudShadowMatching.cpp:144)
    minv = np.linalg.inv(m)

    ratio_r = np.sqrt(float(w) * w + float(h) * h) / diagonal
    a2 = minv[..., :2, :2]
    delta = np.einsum(
        "cnij,j->cni", minv, np.array([0.5, 0.5, 0.0, ratio_r])
    )[..., :2]

    # projected-quad window bounds (CloudShadowMatching.cpp:33-55)
    hom = np.concatenate([corners, np.ones((corners.shape[0], 4, 1))], axis=-1)
    cast = np.einsum("cnij,ckj->cnki", m, hom)[..., :3]  # (Nc,Nh,4,3)
    idx = geometry.world_to_index(shape_hw, diagonal, cast)  # (Nc,Nh,4,2)
    min_x = np.clip(idx[..., 0].min(axis=-1), 0, w - 1)
    max_x = np.clip(idx[..., 0].max(axis=-1), 0, w - 1)
    min_y = np.clip(idx[..., 1].min(axis=-1), 0, h - 1)
    max_y = np.clip(idx[..., 1].max(axis=-1), 0, h - 1)
    return a2, delta, (min_x, max_x, min_y, max_y), m


def _window_index(raster, min_x, min_y, wb: int, hb: int, pf: int):
    """Flat indices (B, hb, wb) into ``raster`` of the windows anchored at
    logical (min_y, min_x); int32 while the raster allows it."""
    dt = torch.int32 if raster.numel() < 2**31 else torch.int64
    stride = raster.shape[1]
    u = torch.arange(wb, dtype=dt, device=raster.device)
    v = torch.arange(hb, dtype=dt, device=raster.device)
    rows = (min_y.to(dt)[:, None] + (v + pf)) * stride  # (B, hb)
    cols = min_x.to(dt)[:, None] + (u + pf)  # (B, wb)
    return rows[:, :, None] + cols[:, None, :]


def _gather(raster, index):
    return raster.reshape(-1).index_select(0, index.reshape(-1)).reshape(index.shape)


def _pair_counts(
    cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
    wb: int, hb: int, width: int, height: int, pf: int, separable: bool,
):
    """(candidates, hit) bool windows (B, hb, wb) of B (height, cloud) pairs:
    every operand has B leading entries. ``separable`` computes the cast
    position from the column alone and the row alone (cross terms pinned at
    the window corner), which `_sep_metadata` must have vouched for."""
    dev = cmap_f.device
    u = torch.arange(wb, dtype=torch.int32, device=dev)
    v = torch.arange(hb, dtype=torch.int32, device=dev)
    px = min_x[:, None] + u  # (B, wb)
    py = min_y[:, None] + v  # (B, hb)
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    a00, a01 = a2[:, 0, 0, None], a2[:, 0, 1, None]
    a10, a11 = a2[:, 1, 0, None], a2[:, 1, 1, None]
    d0, d1 = delta[:, 0, None], delta[:, 1, None]
    dt = torch.int32 if cmap_f.numel() < 2**31 else torch.int64
    stride = cmap_f.shape[1]
    if separable:
        # same op order as the per-pixel form with the cross term pinned at
        # the window corner (any row/column gives the identical f32 value
        # per the host pinch check)
        qx = (a00 * fx + a01 * min_y[:, None].to(torch.float32)) + d0  # (B, wb)
        qy = (a10 * min_x[:, None].to(torch.float32) + a11 * fy) + d1  # (B, hb)
        qi = qx.to(torch.int32)  # trunc toward zero, like glm ivec2
        qj = qy.to(torch.int32)
        validq = ((qj >= 0) & (qj < height))[:, :, None] & ((qi >= 0) & (qi < width))[:, None, :]
        src = ((qj.clamp(0, height - 1).to(dt) + pf) * stride)[:, :, None] + (
            qi.clamp(0, width - 1).to(dt) + pf
        )[:, None, :]
    else:
        qx = a00[:, :, None] * fx[:, None, :] + a01[:, :, None] * fy[:, :, None] + d0[:, :, None]
        qy = a10[:, :, None] * fx[:, None, :] + a11[:, :, None] * fy[:, :, None] + d1[:, :, None]
        qi = qx.to(torch.int32)
        qj = qy.to(torch.int32)
        validq = (qi >= 0) & (qi < width) & (qj >= 0) & (qj < height)
        src = (qj.clamp(0, height - 1).to(dt) + pf) * stride + (qi.clamp(0, width - 1).to(dt) + pf)
    at_cloud = _gather(cmap_f, src) == ids[:, None, None]
    win = _window_index(cmap_f, min_x, min_y, wb, hb, pf)
    in_win = (py <= max_y[:, None])[:, :, None] & (px <= max_x[:, None])[:, None, :]
    cand = in_win & ~_gather(cmask_f, win) & validq & at_cloud
    hit = cand & _gather(psm_f, win)
    return cand, hit


def _similarity(t, c, min_support: int):
    """Similarity of each pair from its candidate and hit counts (int32):
    c / t, or -1.1 under ``min_support`` candidates."""
    return torch.where(
        t >= min_support,
        c.to(torch.float32) / t.to(torch.float32),
        torch.full((), -1.1, dtype=torch.float32, device=t.device),
    )


def _sweep(
    cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
    wb, hb, width, height, pf, min_support, separable,
):
    nh, nc = min_x.shape
    rep = lambda a: a.reshape(nh * nc, *a.shape[2:])
    cand, hit = _pair_counts(
        cmask_f, psm_f, cmap_f, ids.repeat(nh), rep(min_x), rep(min_y), rep(max_x), rep(max_y),
        rep(a2), rep(delta), wb, hb, width, height, pf, separable,
    )
    t = cand.sum(dim=(1, 2), dtype=torch.int32)
    c = hit.sum(dim=(1, 2), dtype=torch.int32)
    return _similarity(t, c, min_support).reshape(nh, nc)


def _bucket_sweep(
    cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
    wb: int, hb: int, width: int, height: int, pf: int = 0,
    min_support: int = 5,
):
    """Similarity of every (height, cloud) pair of one pass, (Nh, Nc) f32.

    ``cmask_f`` / ``psm_f`` bool and ``cmap_f`` int32: the flipped
    (bottom-origin-row) rasters, padded by ``pf`` in front (logical index 0
    sits at padded index pf) and by at least the bucket size behind;
    ``ids`` (Nc,) int32; the bounds (Nh, Nc) int32, ``a2`` (Nh, Nc, 2, 2)
    and ``delta`` (Nh, Nc, 2) f32, height-major.

    The one dispatch point of the sweep: on CUDA operands kernel 11
    (``ops/sweep_kernels.py``), which keeps each pair's two counts in
    registers and walks its true box, with no bound on Nh * Nc; elsewhere
    the torch form, one batched window pass whose intermediates the caller
    bounds by Nh * Nc * hb * wb. Both give the same bits.
    """
    operands = (cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta)
    if K._on_cuda(sweep_kernels.NAME, operands):
        t, c = sweep_kernels.pair_counts(*operands, wb, hb, width, height, pf)
        return _similarity(t, c, min_support)
    return _sweep(*operands, wb, hb, width, height, pf, min_support, separable=False)


def _bucket_sweep_sep(
    cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
    wb: int, hb: int, width: int, height: int, pf: int = 0,
    min_support: int = 5,
):
    """`_bucket_sweep` for separable (pure-homothety) casts, bit-equal to it
    whenever `_sep_metadata` vouches for the pass: the cast position is
    computed per column and per row (two vectors a pair instead of two
    windows), and the gather ``cmap[qj, qi]`` takes its index as the outer
    sum of the two. (The JAX package's kernel of this name goes further and
    replaces the gather by shift-and-select passes, because a gather is slow
    on its device; a CUDA device gathers well, so the port keeps the gather
    and drops the shift spans.)"""
    return _sweep(cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
                  wb, hb, width, height, pf, min_support, separable=True)


def _bucket_detail(
    cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
    wb: int, hb: int, width: int, height: int, pf: int = 0,
):
    """Hit windows + hit-pixel bounds at each cloud's best height: every
    operand has Nc leading entries. Returns (t, c, hit (Nc, hb, wb) bool,
    bx0, by0, bx1, by1)."""
    cand, hit = _pair_counts(
        cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
        wb, hb, width, height, pf, separable=False,
    )
    big = 2**30
    u = torch.arange(wb, dtype=torch.int32, device=hit.device)
    v = torch.arange(hb, dtype=torch.int32, device=hit.device)
    px = min_x[:, None] + u
    py = min_y[:, None] + v
    any_col = hit.any(dim=1)  # (Nc, wb)
    any_row = hit.any(dim=2)  # (Nc, hb)
    bx0 = torch.where(any_col, px, big).amin(dim=1)
    bx1 = torch.where(any_col, px, -big).amax(dim=1)
    by0 = torch.where(any_row, py, big).amin(dim=1)
    by1 = torch.where(any_row, py, -big).amax(dim=1)
    t = cand.sum(dim=(1, 2), dtype=torch.int32)
    c = hit.sum(dim=(1, 2), dtype=torch.int32)
    return t, c, hit, bx0, by0, bx1, by1


def _sep_metadata(a2, delta, min_x, min_y, wb: int, hb: int):
    """Separability verdicts for the (height, cloud) pairs of one pass: a
    bool tensor, one entry per pair, computed where the operands lie.

    The matching affine is the composition of two point-projections between
    parallel planes — a homothety, so its linear part is (scale)*I and the
    off-diagonal terms are pure least-squares-fit noise (~1e-14; see
    benchmarks/x_affine_probe.py). In the f32 arithmetic of the sweep the
    cross terms are then absorbed below the ULP of the diagonal terms,
    making qi a function of the column alone and qj of the row alone. This
    PROVES that bit-wise per pair, with a monotone pinch check: f32 ops are
    monotone, so if the window's two extreme rows yield bit-identical qx
    for every column, every row in between does too (same op order as
    `_pair_counts`' qx/qy: separate multiplies and adds, each rounded once).

    (The JAX package's function of this name runs in numpy on the host and
    also returns source anchors and shift spans for its shift-and-select
    kernel. The port's sweep gathers and reads the verdicts only, and takes
    them on the device: on the host the check cost more than the vector
    form saves.)
    """
    a00, a01 = a2[..., 0, 0, None], a2[..., 0, 1, None]
    a10, a11 = a2[..., 1, 0, None], a2[..., 1, 1, None]
    d0, d1 = delta[..., 0, None], delta[..., 1, None]
    u = torch.arange(wb, dtype=torch.int32, device=a2.device)
    v = torch.arange(hb, dtype=torch.int32, device=a2.device)
    x_col = a00 * (min_x[..., None] + u).to(torch.float32)  # (..., wb)
    v_row = a11 * (min_y[..., None] + v).to(torch.float32)  # (..., hb)
    y_lo = a01 * min_y[..., None].to(torch.float32)
    y_hi = a01 * (min_y[..., None] + (hb - 1)).to(torch.float32)
    u_lo = a10 * min_x[..., None].to(torch.float32)
    u_hi = a10 * (min_x[..., None] + (wb - 1)).to(torch.float32)
    ok_x = (((x_col + y_lo) + d0) == ((x_col + y_hi) + d0)).all(dim=-1)
    ok_y = (((u_lo + v_row) + d1) == ((u_hi + v_row) + d1)).all(dim=-1)
    return ok_x & ok_y


def _bucket_size(n: int) -> int:
    """The side of the bucket that holds a window side of ``n``: the
    smallest of ``_BUCKETS`` that does, past the largest the next power of
    two. (The JAX package stops at the largest and scans wider windows on
    its native backend; every sweep here holds any window: ``in_win``
    masks the torch form to the true box, kernel 11 walks only that.)"""
    for b in _BUCKETS:
        if n <= b:
            return b
    return 1 << (int(n) - 1).bit_length()


def _whole_bucket(dev: torch.device) -> bool:
    """Whether a bucket is swept in one pass over all its clouds and heights
    on ``dev``: where `_bucket_sweep` runs kernel 11, which holds no
    window-sized intermediates."""
    return dev.type == "cuda"


def _match_native(
    clouds, cloud_map, cloud_mask, potential_shadow, config,
    a2, delta, mnx, mxx, mny, mxy, m_all,
    heights, solutions, shadows, shadow_mask_flipped,
):
    """Per-cloud 473-height scan on the native backend (exact per-height
    bounding boxes — no bucket padding)."""
    hgt, wdt = cloud_mask.shape
    cmask_f = np.ascontiguousarray(np.flipud(fetch_mask(cloud_mask)))
    psm_f = np.ascontiguousarray(np.flipud(fetch_mask(potential_shadow)))
    cmap_f = np.ascontiguousarray(np.flipud(_host(cloud_map).astype(np.int32, copy=False)))

    for k, cloud in enumerate(clouds):
        cid = cloud.id
        sims = native.cloud_sweep(
            cmask_f, psm_f, cmap_f, wdt, hgt, cid,
            mnx[k], mny[k], mxx[k], mxy[k], a2[k], delta[k],
            config.min_support_pixels,
        )
        hsel = int(np.argmax(sims))  # first max, like `>` keeps first
        best = float(sims[hsel])
        if best < config.min_similarity:
            solutions[cid] = OptimalSolution(
                height=0.0, similarity=-1.0, M=np.eye(4), id=cid
            )
            shadows[cid] = ShadowObject(
                id=cid, bounds=None, area=0, window=None, anchor=None
            )
            continue
        x0, y0 = int(mnx[k, hsel]), int(mny[k, hsel])
        wb = int(mxx[k, hsel]) - x0 + 1
        hb = int(mxy[k, hsel]) - y0 + 1
        t, c, win, bx0, by0, bx1, by1 = native.cloud_detail(
            cmask_f, psm_f, cmap_f, wdt, hgt, cid,
            (x0, y0, int(mxx[k, hsel]), int(mxy[k, hsel])),
            a2[k, hsel], delta[k, hsel], hb, wb,
        )
        solutions[cid] = OptimalSolution(
            height=float(heights[hsel]), similarity=best, M=m_all[k, hsel], id=cid
        )
        shadows[cid] = ShadowObject(
            id=cid, bounds=(bx0, by0, bx1, by1), area=c, window=win,
            anchor=(x0, y0),
        )
        h_keep = min(hb, hgt - y0)
        w_keep = min(wb, wdt - x0)
        shadow_mask_flipped[y0 : y0 + h_keep, x0 : x0 + w_keep] |= win[
            :h_keep, :w_keep
        ]


def match_clouds_shadows(
    clouds: list[CloudObject],
    cloud_map,
    cloud_mask,
    potential_shadow,
    diagonal: float,
    sun_pos: np.ndarray,
    view_pos: np.ndarray,
    config: MatchingConfig = MatchingConfig(),
    timer=None,
    use_native: bool | None = None,
    sweep_fn=None,
    device=None,
) -> MatchCloudsShadowsResults:
    """Match every cloud to its shadow (CloudShadowMatching.cpp:168-197).

    Two equivalent backends (equality-tested): the bucketed sweep on
    ``device`` (``None``: where the masks lie if they are tensors, else the
    CUDA device; kernel 11, one pass a bucket, on a CUDA device), and the
    native C++ scan. ``use_native=None`` takes the backend
    ``placement.native_matching`` picks for ``config.backend``;
    ``use_native=False`` forces the device path.

    ``sweep_fn``: optional replacement for the similarity-sweep kernel
    (same call contract as :func:`_bucket_sweep`) — the hook for a sweep
    sharded over several devices that shares ALL of this function's
    orchestration (bucketing, passes, detail extraction, mask compositing).
    Forces the device route and the torch form's passes; its ``shards``
    attribute, where it has one, goes into the route.

    Each bucket's sweep is a stage ``matching/sweep`` with the counts
    ``pairs`` ((height, cloud) pairs swept), ``cells`` (the cells of their
    true boxes), ``kernel`` (1 where kernel 11 swept them, on a CUDA
    device, 0 for the torch form) and ``oversized`` (the clouds whose
    window passes ``_BUCKETS[-1]``, which the JAX package scans on its
    native backend instead).
    """
    if timer is None:
        from ...utils.profiling import StageTimer

        timer = StageTimer()

    def sweep_device() -> torch.device:
        if device is not None:
            return torch.device(device)
        if isinstance(cloud_mask, torch.Tensor):
            return cloud_mask.device
        return resolve_device(None)

    if sweep_fn is not None:
        use_native = False
    if use_native is None:
        use_native = placement.native_matching(
            int(np.prod(cloud_mask.shape)), sweep_device(), config.backend)
    timer.routes["matching"] = placement.matching_route(
        use_native, sweep_device(), getattr(sweep_fn, "shards", None))
    hgt, wdt = cloud_mask.shape
    heights = height_sweep(config)

    shadow_mask_flipped = np.zeros((hgt, wdt), dtype=bool)
    solutions: dict[int, OptimalSolution] = {}
    shadows: dict[int, ShadowObject] = {}

    if clouds:
        with timer.stage("matching/cast transforms"):
            a2, delta, (mnx, mxx, mny, mxy), m_all = _cast_transforms(
                clouds, heights, (hgt, wdt), diagonal, sun_pos, view_pos
            )
    if clouds and use_native:
        with timer.stage("matching/native scan"):
            _match_native(
                clouds, cloud_map, cloud_mask, potential_shadow, config,
                a2, delta, mnx, mxx, mny, mxy, m_all,
                heights, solutions, shadows, shadow_mask_flipped,
            )
    if clouds and not use_native:
        dev = sweep_device()
        # flipped (bottom-origin-row) rasters, padded so that no window
        # leaves them — flip and pad on the device: host inputs upload their
        # raw bytes once, tensors already there never leave
        wb_k = np.array([_bucket_size(int(n)) for n in (mxx - mnx + 1).max(axis=1)])
        hb_k = np.array([_bucket_size(int(n)) for n in (mxy - mny + 1).max(axis=1)])
        buckets: dict[tuple[int, int], list[int]] = {}
        for k, key in enumerate(zip(wb_k.tolist(), hb_k.tolist())):
            buckets.setdefault(key, []).append(k)

        # anchors lie inside the raster (see _cast_transforms), so nothing
        # is read in front of it; behind it, the torch form and the detail
        # pass read each window whole: pad by the furthest reach of any
        # window past the raster, not by a whole bucket
        back_w = max(0, int((mnx.max(axis=1) + wb_k).max()) - wdt)
        back_h = max(0, int((mny.max(axis=1) + hb_k).max()) - hgt)

        def padded(t, value):
            return F.pad(torch.flipud(t), (0, back_w, 0, back_h), value=value).contiguous()

        cmask_t = padded(push_mask(cloud_mask, dev), False)
        psm_t = padded(push_mask(potential_shadow, dev), False)
        cmap_t = padded(as_tensor(cloud_map, dev, torch.int32), -2)

        nh = len(heights)
        # where kernel 11 sweeps (CUDA, no sweep_fn) a bucket goes in one
        # pass over all its clouds and heights; the torch form's passes and
        # groups bound its window-sized intermediates
        whole_bucket = sweep_fn is None and _whole_bucket(dev)
        sweep = sweep_fn or _bucket_sweep
        raster_kw = dict(width=wdt, height=hgt, pf=0)

        def ids_of(sel):
            return torch.tensor([clouds[k].id for k in sel], dtype=torch.int32, device=dev)

        def operands(sel, idx):
            """Operands of the (height, cloud) pairs ``idx`` picks out of the
            height-major (Nh, len(sel), ...) arrays of the clouds ``sel``."""
            i32 = lambda a: as_tensor(np.ascontiguousarray(a.T[idx], np.int32), dev)
            f32 = lambda a: as_tensor(
                np.ascontiguousarray(np.swapaxes(a, 0, 1)[idx], np.float32), dev)
            return dict(
                min_x=i32(mnx[sel]), min_y=i32(mny[sel]),
                max_x=i32(mxx[sel]), max_y=i32(mxy[sel]),
                a2=f32(a2[sel]), delta=f32(delta[sel]),
            )

        def sweep_sims(sel, wb, hb, ch):
            """(Nh, len(sel)) similarities of the clouds ``sel``, in passes of
            ``ch`` heights."""
            ids = ids_of(sel)

            def one_pass(g0):
                ops = operands(sel, slice(g0, g0 + ch))
                fn = sweep
                if not whole_bucket and sweep_fn is None:
                    # the vector form of the affine wherever the pinch
                    # check vouches for every pair of the pass
                    ok = _sep_metadata(ops["a2"], ops["delta"], ops["min_x"], ops["min_y"],
                                       wb, hb)
                    fn = _bucket_sweep_sep if bool(ok.all()) else _bucket_sweep
                return fn(cmask_t, psm_t, cmap_t, ids, **ops, wb=wb, hb=hb, **raster_kw,
                          min_support=config.min_support_pixels)

            box_w = np.minimum(mxx[sel], mnx[sel] + wb - 1) - mnx[sel] + 1
            box_h = np.minimum(mxy[sel], mny[sel] + hb - 1) - mny[sel] + 1
            with timer.stage(f"matching/sweep {wb}x{hb} n={len(sel)}", "matching/sweep",
                             wb=wb, hb=hb, n=len(sel), pairs=nh * len(sel),
                             cells=int((box_w * box_h).sum()), kernel=int(dev.type == "cuda"),
                             oversized=len(sel) if max(wb, hb) > _BUCKETS[-1] else 0):
                parts = [one_pass(g0) for g0 in range(0, nh, ch)]
                return torch.cat(parts, dim=0).cpu().numpy()

        def finish(sel, sims, wb, hb):
            """Each cloud of ``sel`` at its best height: the detail pass, the
            solutions and shadows, the composite mask."""
            best_idx = np.argmax(sims, axis=0)  # first max, like `>` keeps first
            best_sim = sims[best_idx, np.arange(len(sel))]

            with timer.stage(f"matching/detail {wb}x{hb} n={len(sel)}", "matching/detail",
                             wb=wb, hb=hb, n=len(sel)):
                at_best = (best_idx, np.arange(len(sel)))
                detail = _bucket_detail(
                    cmask_t, psm_t, cmap_t, ids_of(sel), **operands(sel, at_best),
                    wb=wb, hb=hb, **raster_kw,
                )
                _, c_arr, hits, bx0, by0, bx1, by1 = (d.cpu().numpy() for d in detail)

            for n, k in enumerate(sel):
                cid = clouds[k].id
                if best_sim[n] < config.min_similarity:
                    solutions[cid] = OptimalSolution(
                        height=0.0, similarity=-1.0, M=np.eye(4), id=cid
                    )
                    shadows[cid] = ShadowObject(
                        id=cid, bounds=None, area=0, window=None, anchor=None
                    )
                    continue
                hsel = int(best_idx[n])
                solutions[cid] = OptimalSolution(
                    height=float(heights[hsel]),
                    similarity=float(best_sim[n]),
                    M=m_all[k, hsel],
                    id=cid,
                )
                anchor = (int(mnx[k, hsel]), int(mny[k, hsel]))
                win = hits[n]
                shadows[cid] = ShadowObject(
                    id=cid,
                    bounds=(int(bx0[n]), int(by0[n]), int(bx1[n]), int(by1[n])),
                    area=int(c_arr[n]),
                    window=win,
                    anchor=anchor,
                )
                # composite into the object-based shadow mask
                ax, ay = anchor
                h_keep = min(hb, hgt - ay)
                w_keep = min(wb, wdt - ax)
                shadow_mask_flipped[ay : ay + h_keep, ax : ax + w_keep] |= win[
                    :h_keep, :w_keep
                ]

        for (wb, hb), members in buckets.items():
            # cloud groups bound the detail pass's live memory (and the torch
            # form's sweep)
            grp = max(1, int(_SWEEP_GROUP_CELLS // (wb * hb)))
            groups = [np.asarray(members[m0 : m0 + grp]) for m0 in range(0, len(members), grp)]
            if whole_bucket:
                sims = sweep_sims(np.asarray(members), wb, hb, nh)
                for g0, sel in zip(range(0, len(members), grp), groups):
                    finish(sel, sims[:, g0 : g0 + len(sel)], wb, hb)
                continue
            for sel in groups:
                # the heights go in passes of bounded window cells
                cells = max(len(sel) * wb * hb, 1)
                ch = max(1, min(int(config.height_chunk), int(_SWEEP_PASS_CELLS // cells)))
                finish(sel, sweep_sims(sel, wb, hb, ch), wb, hb)

    accepted_heights = [
        s.height for s in solutions.values() if s.height >= config.height_min_km
    ]
    trimmed = trimmed_average(np.asarray(accepted_heights), config.trim_lo, config.trim_hi)

    return MatchCloudsShadowsResults(
        solutions=solutions,
        shadows=shadows,
        trimmed_mean_height=trimmed,
        shadow_mask=np.flipud(shadow_mask_flipped).copy(),
    )
