# The plain reference of the benchmark's detect cells: the data types and
# the cast geometry are a frozen copy of
# satellite_approximation_tpu_torch/models/detection/matching.py; the scan
# is the benchmark's own.
"""Cloud-shadow matching by ray casting (CloudShadowMatching.cpp:70-197).

The reference triple-nests: per cloud, per hypothesis height (0.2..12 km in
0.025 steps: 473 candidates, CloudShadowMatching.cpp:139), per pixel of the
projected bbox. The cast geometry (``_cast_transforms``, a frozen copy of
the port's host numpy) is batched over (cloud, height). The scan is the
benchmark's own, written from those semantics and not from the program's
sweep: one cloud at a time, every height's exact window, the heights in
chunks of a bounded number of cells, plain torch ops where the rasters lie.

A candidate is a non-cloud pixel of the height's window whose f32
back-projection q = A2 p + delta (separate multiplies and adds, each
rounded once; truncated toward zero like glm's float->ivec2) lands inside
the image on the cloud's own id; similarity = hits on the potential-shadow
mask / candidates, -1.1 below 5 candidates (CloudShadowMatching.cpp:70-95),
and a best similarity under 0.3 matches nothing (:154).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import MatchingConfig
from .device import as_tensor
from . import geometry
from .stats import trimmed_average
from .cloud_mask import CloudObject

# window cells of the heights scanned together (about 40 bytes a cell live)
_CHUNK_CELLS = 1 << 25


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


def _windows(cmask, psm, cmap, cid: int, mnx, mny, mxx, mxy, a2, delta):
    """(candidates, hits) bool (n, hb, wb) of one cloud at n heights: window
    k covers x in [mnx[k], mxx[k]], y in [mny[k], mxy[k]] of the flipped
    (bottom-origin-row) rasters ``cmask``, ``psm`` (bool) and ``cmap``
    (int32), anchored at (mnx[k], mny[k]); cells past a window's own extent
    are no candidates. The bounds are int64 tensors (n,), ``a2`` (n, 2, 2)
    and ``delta`` (n, 2) f32 tensors, all on the rasters' device."""
    height, width = cmask.shape
    dev = cmask.device
    wb = int((mxx - mnx).max()) + 1
    hb = int((mxy - mny).max()) + 1
    px = mnx[:, None] + torch.arange(wb, device=dev)  # (n, wb)
    py = mny[:, None] + torch.arange(hb, device=dev)  # (n, hb)
    inside = (py <= mxy[:, None])[:, :, None] & (px <= mxx[:, None])[:, None, :]
    at = py.clamp(max=height - 1)[:, :, None] * width + px.clamp(max=width - 1)[:, None, :]
    fx = px.to(torch.float32)[:, None, :]
    fy = py.to(torch.float32)[:, :, None]
    a00, a01 = a2[:, 0, 0, None, None], a2[:, 0, 1, None, None]
    a10, a11 = a2[:, 1, 0, None, None], a2[:, 1, 1, None, None]
    qx = (a00 * fx + a01 * fy) + delta[:, 0, None, None]
    qy = (a10 * fx + a11 * fy) + delta[:, 1, None, None]
    qi = qx.to(torch.int32).to(torch.int64)  # toward zero
    qj = qy.to(torch.int32).to(torch.int64)
    lands = (qi >= 0) & (qi < width) & (qj >= 0) & (qj < height)
    source = qj.clamp(0, height - 1) * width + qi.clamp(0, width - 1)
    on_cloud = cmap.reshape(-1)[source] == cid
    cand = inside & ~cmask.reshape(-1)[at] & lands & on_cloud
    return cand, cand & psm.reshape(-1)[at]


def _scan_cloud(cmask, psm, cmap, cid: int, bounds, a2, delta, min_support: int) -> np.ndarray:
    """Similarity of one cloud at every height, (nh,) f32: hits over
    candidates, -1.1 under ``min_support`` candidates. ``bounds``: the
    (nh,) int arrays min_x, max_x, min_y, max_y; ``a2`` (nh, 2, 2) and
    ``delta`` (nh, 2) f64 host arrays, rounded to f32 here."""
    dev = cmask.device
    mnx, mxx, mny, mxy = (torch.as_tensor(np.asarray(b, np.int64), device=dev) for b in bounds)
    a2_t = torch.as_tensor(np.asarray(a2, np.float32), device=dev)
    delta_t = torch.as_tensor(np.asarray(delta, np.float32), device=dev)
    cells = int(((bounds[1] - bounds[0] + 1) * (bounds[3] - bounds[2] + 1)).max())
    step = max(1, _CHUNK_CELLS // max(cells, 1))
    sims = []
    for h0 in range(0, len(bounds[0]), step):
        part = slice(h0, h0 + step)
        cand, hit = _windows(cmask, psm, cmap, cid, mnx[part], mny[part], mxx[part], mxy[part],
                             a2_t[part], delta_t[part])
        t = cand.sum(dim=(1, 2))
        c = hit.sum(dim=(1, 2))
        ratio = c.to(torch.float32) / t.to(torch.float32)
        sims.append(torch.where(t >= min_support, ratio, torch.full_like(ratio, -1.1)))
    return torch.cat(sims).cpu().numpy()


def _detail(cmask, psm, cmap, cid: int, bounds, a2, delta):
    """(hits, hit window (hb, wb) bool, (x0, y0, x1, y1) of the hits) of one
    cloud at one height; ``bounds`` (min_x, max_x, min_y, max_y) of that
    height."""
    dev = cmask.device
    mnx, mxx, mny, mxy = (torch.tensor([int(b)], device=dev) for b in bounds)
    _, hit = _windows(cmask, psm, cmap, cid, mnx, mny, mxx, mxy,
                         torch.as_tensor(np.asarray(a2, np.float32)[None], device=dev),
                         torch.as_tensor(np.asarray(delta, np.float32)[None], device=dev))
    win = hit[0].cpu().numpy()
    rows = np.flatnonzero(win.any(axis=1))
    cols = np.flatnonzero(win.any(axis=0))
    x0, y0 = int(bounds[0]), int(bounds[2])
    box = (x0 + int(cols[0]), y0 + int(rows[0]), x0 + int(cols[-1]), y0 + int(rows[-1]))
    return int(win.sum()), win, box


def match_clouds_shadows(
    clouds: list[CloudObject],
    cloud_map: np.ndarray,
    cloud_mask: np.ndarray,
    potential_shadow: np.ndarray,
    diagonal: float,
    sun_pos: np.ndarray,
    view_pos: np.ndarray,
    config: MatchingConfig = MatchingConfig(),
    device="cpu",
) -> MatchCloudsShadowsResults:
    """Match every cloud to its shadow (CloudShadowMatching.cpp:168-197):
    for each cloud the first height of the best similarity, its hit pixels
    composited into the object-based shadow mask. The host masks and the
    cloud map scan on ``device``."""
    hgt, wdt = cloud_mask.shape
    heights = height_sweep(config)
    shadow_mask_flipped = np.zeros((hgt, wdt), dtype=bool)
    solutions: dict[int, OptimalSolution] = {}
    shadows: dict[int, ShadowObject] = {}

    if clouds:
        a2, delta, (mnx, mxx, mny, mxy), m_all = _cast_transforms(
            clouds, heights, (hgt, wdt), diagonal, sun_pos, view_pos
        )
        dev = torch.device(device)
        flip = lambda a, dtype: as_tensor(np.ascontiguousarray(np.flipud(a), dtype), dev)
        cmask = flip(cloud_mask, bool)
        psm = flip(potential_shadow, bool)
        cmap = flip(cloud_map, np.int32)
    for k, cloud in enumerate(clouds):
        cid = cloud.id
        bounds = (mnx[k], mxx[k], mny[k], mxy[k])
        sims = _scan_cloud(cmask, psm, cmap, cid, bounds, a2[k], delta[k],
                           config.min_support_pixels)
        best = int(np.argmax(sims))  # the first of the best, as `>` keeps it
        if sims[best] < config.min_similarity:
            solutions[cid] = OptimalSolution(height=0.0, similarity=-1.0, M=np.eye(4), id=cid)
            shadows[cid] = ShadowObject(id=cid, bounds=None, area=0, window=None, anchor=None)
            continue
        at = tuple(b[best] for b in bounds)
        hits, win, box = _detail(cmask, psm, cmap, cid, at, a2[k, best], delta[k, best])
        solutions[cid] = OptimalSolution(
            height=float(heights[best]), similarity=float(sims[best]), M=m_all[k, best], id=cid)
        anchor = (int(at[0]), int(at[2]))
        shadows[cid] = ShadowObject(id=cid, bounds=box, area=hits, window=win, anchor=anchor)
        ax, ay = anchor
        shadow_mask_flipped[ay : ay + win.shape[0], ax : ax + win.shape[1]] |= win

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
