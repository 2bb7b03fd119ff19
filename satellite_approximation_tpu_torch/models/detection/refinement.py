"""Probability-analysis refinement of the object-based shadow mask.

Rebuild of lib/cloud_shadow_detection/source/ProbabilityRefinement.cpp:

* AlphaMap — logistic remap of the pit-fill NIR difference (:13-27);
* BetaMap — per shadow object, a quadratic radial falloff of the cloud's
  blurred CLP probability pulled through the inverse cast transform (:29-106);
* ProbabilityMap — P(shadow | alpha, beta) estimated as a multiresolution
  2-D histogram (D in {8,16,32,64,128}, weights 16..1/31), hole-filled by
  inverse-distance diffusion, composited onto a 256x256 surface (:137-224);
* ImprovedShadowMask — final = (P(a,b) >= 0.15 OR object-shadow) AND
  NOT cloud (:226-241).

Histograms accumulate 0/1 counts (exact in any precision); the hole-filling
replicates the reference's *sequential in-round* update order exactly, so
surfaces match bit-for-bit where the reference is well-defined.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ...config import RefinementConfig
from ...ops import geometry
from .matching import OptimalSolution, ShadowObject
from .placement import big_scene


def alpha_map(nir_difference: np.ndarray, config: RefinementConfig = RefinementConfig()) -> np.ndarray:
    """F(x) = f(x-.5) - f(-.5) with f(x)=1/(1+b e^{-ax}), a=17, b=.007,
    in f32 (ProbabilityRefinement.cpp:13-27)."""
    a = np.float32(config.alpha_a)
    b = np.float32(config.alpha_b)
    x = np.asarray(nir_difference, dtype=np.float32)

    def f(v):
        return np.float32(1.0) / (np.float32(1.0) + b * np.exp(-a * v, dtype=np.float32))

    sub = f(np.float32(-0.5))
    return (f(x - np.float32(0.5)) - sub).astype(np.float32)


def _border_mask(m: np.ndarray) -> np.ndarray:
    """Border pixels of a region mask over its own bbox: a set pixel whose
    4-neighbour (clamped inside the bbox) is unset, or which lies on the
    bbox edge (Functions::border, Functions.cpp:126-149)."""
    p = np.pad(m, 1, mode="edge")
    h, w = m.shape
    interior = (
        p[0:h, 1 : w + 1] & p[2 : h + 2, 1 : w + 1] & p[1 : h + 1, 0:w] & p[1 : h + 1, 2 : w + 2]
    )
    border = m & ~interior
    border[0, :] |= m[0, :]
    border[-1, :] |= m[-1, :]
    border[:, 0] |= m[:, 0]
    border[:, -1] |= m[:, -1]
    return border


def beta_map(
    shadows: dict[int, ShadowObject],
    solutions: dict[int, OptimalSolution],
    clp_blended: np.ndarray,
    diagonal: float,
    config: RefinementConfig = RefinementConfig(),
) -> np.ndarray:
    """Max-composited radial-falloff probability per shadow object
    (ProbabilityRefinement.cpp:29-106). The reference iterates every shadow
    including rejected ones whose bounds are NaN-cast garbage (undefined
    behaviour); here rejected shadows (no matched pixels) are skipped.

    Returned in top-left row-major convention like every other raster.
    """
    h, w = clp_blended.shape
    ret_f = np.zeros((h, w), dtype=np.float32)  # flipped (bottom-origin rows)
    clp_f = np.flipud(np.asarray(clp_blended, np.float32))

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

        # shadow mask over its own bbox (flipped space: row==y-from-bottom)
        ax, ay = shadow.anchor
        win = shadow.window
        bbox = np.zeros((by1 - by0 + 1, bx1 - bx0 + 1), dtype=bool)
        wy0, wy1 = by0 - ay, by1 - ay
        wx0, wx1 = bx0 - ax, bx1 - ax
        bbox[:, :] = win[wy0 : wy1 + 1, wx0 : wx1 + 1]
        border = _border_mask(bbox)
        brows, bcols = np.nonzero(border)
        border_x = (bcols + bx0).astype(np.int64)
        border_y = (brows + by0).astype(np.int64)

        # influence window pixel grid (x, y-from-bottom)
        xs = np.arange(ib_x0, ib_x1 + 1)
        ys = np.arange(ib_y0, ib_y1 + 1)
        gx, gy = np.meshgrid(xs, ys)

        in_shadow = np.zeros(gx.shape, dtype=bool)
        ox0 = max(bx0 - ib_x0, 0)
        oy0 = max(by0 - ib_y0, 0)
        sx0 = max(ib_x0 - bx0, 0)
        sy0 = max(ib_y0 - by0, 0)
        cw = min(bx1, ib_x1) - max(bx0, ib_x0) + 1
        ch = min(by1, ib_y1) - max(by0, ib_y0) + 1
        if cw > 0 and ch > 0:
            in_shadow[oy0 : oy0 + ch, ox0 : ox0 + cw] = bbox[sy0 : sy0 + ch, sx0 : sx0 + cw]

        # distance to the nearest border pixel: exact Euclidean distance
        # transform over the influence window (equivalent to the reference's
        # O(area x border) nearest-border scan, ProbabilityRefinement.cpp:75-82,
        # but linear time). Shadow pixels are defined as distance 0.
        border_grid = np.ones(gx.shape, dtype=bool)
        bx_in = border_x - ib_x0
        by_in = border_y - ib_y0
        keep = (
            (bx_in >= 0) & (bx_in < gx.shape[1]) & (by_in >= 0) & (by_in < gx.shape[0])
        )
        border_grid[by_in[keep], bx_in[keep]] = False
        dist = ndimage.distance_transform_edt(border_grid).astype(np.float32)
        dist = np.where(in_shadow, np.float32(0.0), dist)

        within = dist <= inf_f
        factor = geometry.quadratic_radial_basis(
            dist, inf_f * config.beta_min_factor, inf_f, config.beta_mid_percentile
        )

        # pull the cloud's CLP through the inverse cast transform
        pos = geometry.pixel_to_world((h, w), diagonal, gx, gy)  # (..., 3)
        hom = np.concatenate([pos, np.ones((*pos.shape[:-1], 1))], axis=-1)
        back = np.einsum("ij,...j->...i", m_inv, hom)[..., :3]
        idx = geometry.world_to_index((h, w), diagonal, back)
        ci = idx[..., 0]
        cj = idx[..., 1]
        valid = (ci >= 0) & (ci < w) & (cj >= 0) & (cj < h)
        clp_v = np.where(
            valid, clp_f[np.clip(cj, 0, h - 1), np.clip(ci, 0, w - 1)], np.float32(0.0)
        )

        contrib = np.where(within & valid, clp_v * factor, np.float32(0.0))
        region = ret_f[ib_y0 : ib_y1 + 1, ib_x0 : ib_x1 + 1]
        np.maximum(region, contrib, out=region)

    return np.flipud(ret_f).copy()


class UniformProbabilitySurface:
    """Bilinear-sampled probability surface with clamped-boundary
    extrapolation (ProbabilityRefinement.cpp:243-379). Stored as S[j, i]."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.float32)
        self.alpha_min = None
        self.alpha_max = None
        self.beta_min = None
        self.beta_max = None

    @property
    def data(self) -> np.ndarray:
        return self._data

    @data.setter
    def data(self, value: np.ndarray) -> None:
        self._data = np.asarray(value, dtype=np.float32)
        self._ext = None  # invalidate the fast-sampling table

    # --- vectorized .at(i, j) with boundary interpolation ---

    def at(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        # the branch cascade evaluates every branch on every element;
        # irrelevant branches may divide by zero before being discarded
        with np.errstate(divide="ignore", invalid="ignore"):
            return self._at(i, j)

    def _at(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        s = self.data
        hgt, wdt = s.shape
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        left = i < 0
        right = i >= wdt
        down = j < 0
        up = j >= hgt
        mid_x = ~(left | right)
        mid_y = ~(up | down)
        ic = np.clip(i, 0, wdt - 1)
        jc = np.clip(j, 0, hgt - 1)

        def lin(lo, hi, u):
            return (1.0 - u) * lo + u * hi

        out = s[jc, ic].astype(np.float32)

        # single-axis extrapolation (:300-330)
        if self.alpha_min is not None:
            left_val = lin(np.float32(self.alpha_min), s[jc, 0], (2 * i + 1).astype(np.float32))
        else:
            left_val = lin(s[jc, 0], s[jc, 1], i.astype(np.float32))
        if self.alpha_max is not None:
            right_val = lin(s[jc, wdt - 1], np.float32(self.alpha_max), (2 * (i + 1 - wdt)).astype(np.float32))
        else:
            right_val = lin(s[jc, wdt - 2], s[jc, wdt - 1], (i + 2 - wdt).astype(np.float32))
        if self.beta_min is not None:
            down_val = lin(np.float32(self.beta_min), s[0, ic], (2 * j + 1).astype(np.float32))
        else:
            down_val = lin(s[0, ic], s[1, ic], j.astype(np.float32))
        if self.beta_max is not None:
            up_val = lin(s[hgt - 1, ic], np.float32(self.beta_max), (2 * (j + 1 - hgt)).astype(np.float32))
        else:
            up_val = lin(s[hgt - 2, ic], s[hgt - 1, ic], (j + 2 - hgt).astype(np.float32))

        out = np.where(left & mid_y, left_val, out)
        out = np.where(right & mid_y, right_val, out)
        out = np.where(mid_x & down, down_val, out)
        out = np.where(mid_x & up, up_val, out)

        # corner double interpolation (:332-360): blend the two single-axis
        # extrapolations by distance to each axis.
        def corner(val_x_axis, val_y_axis, d_to_x, d_to_y):
            t = d_to_x / (d_to_x + d_to_y)
            return lin(val_x_axis, val_y_axis, t)

        # at(i, 0) / at(i, H-1) resolve through the x-axis branches with jc pinned
        def at_row(row):
            jr = np.full_like(j, row)
            v = s[jr, ic].astype(np.float32)
            if self.alpha_min is not None:
                lv = lin(np.float32(self.alpha_min), s[jr, 0], (2 * i + 1).astype(np.float32))
            else:
                lv = lin(s[jr, 0], s[jr, 1], i.astype(np.float32))
            if self.alpha_max is not None:
                rv = lin(s[jr, wdt - 1], np.float32(self.alpha_max), (2 * (i + 1 - wdt)).astype(np.float32))
            else:
                rv = lin(s[jr, wdt - 2], s[jr, wdt - 1], (i + 2 - wdt).astype(np.float32))
            return np.where(left, lv, np.where(right, rv, v))

        def at_col(col):
            ir = np.full_like(i, col)
            v = s[jc, ir].astype(np.float32)
            if self.beta_min is not None:
                dv = lin(np.float32(self.beta_min), s[0, ir], (2 * j + 1).astype(np.float32))
            else:
                dv = lin(s[0, ir], s[1, ir], j.astype(np.float32))
            if self.beta_max is not None:
                uv = lin(s[hgt - 1, ir], np.float32(self.beta_max), (2 * (j + 1 - hgt)).astype(np.float32))
            else:
                uv = lin(s[hgt - 2, ir], s[hgt - 1, ir], (j + 2 - hgt).astype(np.float32))
            return np.where(down, dv, np.where(up, uv, v))

        ld = corner(at_row(0), at_col(0), (-j).astype(np.float32), (-i).astype(np.float32))
        rd = corner(at_row(0), at_col(wdt - 1), (-j).astype(np.float32), (i + 1 - wdt).astype(np.float32))
        lu = corner(at_row(hgt - 1), at_col(0), (j + 1 - hgt).astype(np.float32), (-i).astype(np.float32))
        ru = corner(at_row(hgt - 1), at_col(wdt - 1), (j + 1 - hgt).astype(np.float32), (i + 1 - wdt).astype(np.float32))

        out = np.where(left & down, ld, out)
        out = np.where(right & down, rd, out)
        out = np.where(left & up, lu, out)
        out = np.where(right & up, ru, out)
        return out

    def _extended(self) -> np.ndarray:
        """at(i, j) tabulated for i, j in [-1, wdt] x [-1, hgt]: every cell
        :meth:`sample` can touch for inputs in [0, 1]. Replaces the ~30-pass
        per-pixel branch cascade with 4 gathers — values are identical
        because the same ``at`` computes the table."""
        hgt, wdt = self.data.shape
        ii, jj = np.meshgrid(np.arange(-1, wdt + 1), np.arange(-1, hgt + 1))
        return self.at(ii, jj).astype(np.float32)

    def sample(self, alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
        """operator()(alpha, beta): bilinear over the four cells around the
        sample point, roundf (half away from zero) cell snapping (:264-283)."""
        s = self.data
        hgt, wdt = s.shape
        cellx = np.asarray(alpha, np.float32) * np.float32(wdt)
        celly = np.asarray(beta, np.float32) * np.float32(hgt)

        def roundf(x):
            return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)

        x_max = roundf(cellx)
        y_max = roundf(celly)
        x_min = x_max - 1
        y_min = y_max - 1
        in_table = (
            (x_min >= -1) & (x_max <= wdt) & (y_min >= -1) & (y_max <= hgt)
        )
        if np.all(in_table):
            if self._ext is None:
                self._ext = self._extended()
            e = self._ext
            p0 = e[y_min + 1, x_min + 1]
            p1 = e[y_min + 1, x_max + 1]
            p2 = e[y_max + 1, x_min + 1]
            p3 = e[y_max + 1, x_max + 1]
        else:
            p0 = self.at(x_min, y_min)
            p1 = self.at(x_max, y_min)
            p2 = self.at(x_min, y_max)
            p3 = self.at(x_max, y_max)
        u = cellx - (x_min.astype(np.float32) + np.float32(0.5))
        v = celly - (y_min.astype(np.float32) + np.float32(0.5))
        bottom = (1 - u) * p0 + u * p1
        top = (1 - u) * p2 + u * p3
        return ((1 - v) * bottom + v * top).astype(np.float32)


def _probability_map_element(
    alpha: np.ndarray, beta: np.ndarray, shadow: np.ndarray, d: int
) -> UniformProbabilitySurface:
    """One histogram resolution: mean shadow indicator per (alpha, beta)
    cell, then sequential inverse-distance hole filling — replicating the
    reference's in-round update order (ProbabilityRefinement.cpp:137-186)."""
    i = np.clip(np.floor(alpha.ravel() * d).astype(np.int64), 0, d - 1)
    j = np.clip(np.floor(beta.ravel() * d).astype(np.int64), 0, d - 1)
    cell = i + d * j
    counts = np.bincount(cell, minlength=d * d).astype(np.int64)
    sums = np.bincount(cell, weights=shadow.ravel().astype(np.float64), minlength=d * d)
    return element_from_histogram(counts.reshape(d, d), sums.reshape(d, d))


def element_from_histogram(
    counts2: np.ndarray, sums2: np.ndarray
) -> UniformProbabilitySurface:
    """Histogram (counts, sums of the shadow indicator) -> hole-filled
    surface element. Shared tail of :func:`_probability_map_element`; also
    fed by the device histogram path (refinement_torch), whose int32
    index_add_ sums are exact integers and therefore identical to the host
    bincounts after the shared f32 conversion below."""
    d = counts2.shape[0]
    grid = np.zeros((d, d), dtype=np.float32)  # grid[j, i]; cell = i + d*j
    valid = counts2 > 0
    grid[valid] = (
        sums2[valid].astype(np.float32) / counts2[valid].astype(np.float32)
    )

    # sequential hole fill: list built scanning i (x) outer, j inner (:152-158)
    from ...native import hole_fill as native_hole_fill

    filled = native_hole_fill(grid, valid)
    if filled is not None:
        return UniformProbabilitySurface(filled[0])

    empty = [(ii, jj) for ii in range(d) for jj in range(d) if not valid[jj, ii]]
    val = valid.copy()
    while empty:
        progressed = False
        remaining = []
        for (ii, jj) in empty:
            accum = 0.0
            weight = 0.0
            found = False
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ni, nj = ii + di, jj + dj
                    if di == 0 and dj == 0:
                        continue
                    if 0 <= ni < d and 0 <= nj < d and val[nj, ni]:
                        found = True
                        wgt = 1.0 / float(di * di + dj * dj)
                        accum += float(grid[nj, ni]) * wgt
                        weight += wgt
            if found:
                val[jj, ii] = True  # visible to later cells in this round
                grid[jj, ii] = np.float32(accum / weight)
                progressed = True
            else:
                remaining.append((ii, jj))
        if not progressed:
            break  # fully empty grid (no samples at all)
        empty = remaining

    return UniformProbabilitySurface(grid)


def probability_map(
    shadow_mask: np.ndarray,
    alpha: np.ndarray,
    beta: np.ndarray,
    config: RefinementConfig = RefinementConfig(),
) -> UniformProbabilitySurface:
    """Composite multiresolution surface (ProbabilityRefinement.cpp:188-224).

    Full-tile-class rasters accumulate ALL resolutions in one native C++
    pass (5 numpy digitize+bincount rounds over 120 Mpix allocate ~5 GB of
    temporaries and took ~60 s; the fused pass is ~2 s and bit-identical —
    verified in tests/test_native.py)."""
    alpha = np.asarray(alpha)
    if big_scene(alpha.size):
        from ...native import prob_histograms as native_hists

        hists = native_hists(
            alpha, beta, np.asarray(shadow_mask, bool), config.histogram_divisions
        )
        if hists is not None:
            elements = [element_from_histogram(c, s) for c, s in hists]
            return composite_surface(elements, config)
    elements = [
        _probability_map_element(alpha, beta, shadow_mask.astype(np.float32), d)
        for d in config.histogram_divisions
    ]
    return composite_surface(elements, config)


def composite_surface(
    elements: list[UniformProbabilitySurface],
    config: RefinementConfig = RefinementConfig(),
) -> UniformProbabilitySurface:
    """Weight-blend the per-resolution elements onto the final n x n surface
    (ProbabilityRefinement.cpp:188-224, composite loop)."""
    n = config.surface_resolution
    out = UniformProbabilitySurface(np.zeros((n, n), dtype=np.float32))
    out.alpha_min = 0.0
    out.beta_min = 0.0

    ii, jj = np.meshgrid(np.arange(n), np.arange(n))  # ii: alpha index
    a = (ii.astype(np.float32) + 0.5) / np.float32(n)
    b = (jj.astype(np.float32) + 0.5) / np.float32(n)
    v = np.zeros((n, n), dtype=np.float32)
    for wgt, el in zip(config.histogram_weights, elements):
        v += np.float32(wgt) * el.sample(a, b)
    v = np.clip(v, 0.0, 1.0)
    v[:, 0] = 0.0  # i == 0 column forced to zero (:211-212)
    out.data = v.astype(np.float32)
    return out


def improved_shadow_mask(
    object_shadow_mask: np.ndarray,
    cloud_mask: np.ndarray,
    alpha: np.ndarray,
    beta: np.ndarray,
    surface: UniformProbabilitySurface,
    threshold: float,
) -> np.ndarray:
    """final = (P(alpha,beta) >= threshold OR object-shadow) AND NOT cloud
    (ProbabilityRefinement.cpp:226-241). Full-tile-class rasters sample via
    the native OpenMP pass (bit-identical to the numpy gather — compiled
    -ffp-contract=off, same op order; tests/test_native.py)."""
    alpha = np.asarray(alpha)
    if big_scene(alpha.size):
        from ...native import final_mask_sample

        out = final_mask_sample(
            alpha, beta, surface._extended(), object_shadow_mask, cloud_mask,
            float(threshold),
        )
        if out is not None:
            return out
    prob = surface.sample(alpha, beta)
    ret = prob >= np.float32(threshold)
    return (ret | object_shadow_mask) & ~cloud_mask
