# Frozen copy of satellite_approximation_tpu_torch/ops/geometry.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""World-frame geometry for the detection pipeline
(``satellite_approximation_tpu/ops/geometry.py``).

Rebuild of lib/cloud_shadow_detection/source/Functions.cpp and the
pixel<->world mapping of ImageOperations.h:47-117. The world frame matches
the reference: x east in km, y north-from-bottom in km, z altitude in km;
an image of (H, W) pixels spans ``sides = D * normalize((W, H))`` where D is
the geodetic diagonal length. Pixel coordinates in this module are the
reference's (i, j) = (col, row-from-bottom); conversion to array rows is
``row = H - 1 - j`` and happens only at array access boundaries.
"""

from __future__ import annotations

import dataclasses

import numpy as np

def sides(shape_hw: tuple[int, int], diagonal: float) -> tuple[float, float]:
    """(side_x, side_y) in km (ImageOperations.h sides)."""
    h, w = shape_hw
    n = np.sqrt(float(w) * w + float(h) * h)
    return (diagonal * w / n, diagonal * h / n)


def pixel_to_world(
    shape_hw: tuple[int, int],
    diagonal: float,
    i,
    j,
    alpha: float = 0.5,
    beta: float = 0.5,
) -> np.ndarray:
    """World (x, y, 0) of pixel (i, j-from-bottom) with sub-pixel offsets
    (ImageOperations.h pos)."""
    h, w = shape_hw
    sx, sy = sides(shape_hw, diagonal)
    i = np.asarray(i, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    return np.stack(
        [sx * (i + alpha) / w, sy * (j + beta) / h, np.zeros_like(i)], axis=-1
    )


def world_to_index(shape_hw: tuple[int, int], diagonal: float, pos) -> np.ndarray:
    """Pixel (i, j-from-bottom) containing a world point, floor semantics
    (ImageOperations.h index)."""
    h, w = shape_hw
    sx, sy = sides(shape_hw, diagonal)
    pos = np.asarray(pos, dtype=np.float64)
    return np.stack(
        [np.floor(w * pos[..., 0] / sx), np.floor(h * pos[..., 1] / sy)], axis=-1
    ).astype(np.int64)


@dataclasses.dataclass
class Quad:
    """Four 3-D corners (types.h Quad): p00, p01, p10, p11."""

    p00: np.ndarray
    p01: np.ndarray
    p10: np.ndarray
    p11: np.ndarray

    def corners(self) -> np.ndarray:
        return np.stack([self.p00, self.p01, self.p10, self.p11])

    @classmethod
    def from_corners(cls, c: np.ndarray) -> "Quad":
        return cls(c[0], c[1], c[2], c[3])

    def transform(self, m: np.ndarray) -> "Quad":
        """Apply a 4x4 homogeneous transform (types.cpp Quad operator*)."""
        c = self.corners()
        hom = np.concatenate([c, np.ones((4, 1))], axis=1)
        out = (m @ hom.T).T
        return Quad.from_corners(out[:, :3])


def plane_line_intersection(
    plane_p0: np.ndarray, plane_n: np.ndarray, line_p0: np.ndarray, line_d: np.ndarray
) -> np.ndarray:
    """Plane ∩ line (types.cpp operator&): l(t) with
    t = n.(p0_plane - p0_line) / n.d."""
    t = np.dot(plane_n, plane_p0 - line_p0) / np.dot(plane_n, line_d)
    return line_p0 + line_d * t


def perspective(quad: Quad, eye: np.ndarray, plane_p0: np.ndarray, plane_n: np.ndarray) -> Quad:
    """Project each corner toward ``eye`` onto a plane (Functions.cpp:58-65)."""
    out = []
    for p in quad.corners():
        out.append(plane_line_intersection(plane_p0, plane_n, p, eye - p))
    return Quad.from_corners(np.stack(out))


def quadratic_radial_basis(d, lo: float, hi: float, percent: float):
    """Smooth 1→0 falloff over [lo, hi] with a quadratic knee at
    ``percent`` of the interval (Functions.cpp:151-162). Vectorized."""
    d = np.asarray(d, dtype=np.float32)
    lo, hi, percent = np.float32(lo), np.float32(hi), np.float32(percent)
    a = percent * hi + (1 - percent) * lo
    span2 = (hi - lo) * (hi - lo)
    falling = 1 - (d - lo) * (d - lo) / (span2 * percent)
    rising = (d - hi) * (d - hi) / (span2 * (1 - percent))
    out = np.where(d <= lo, np.float32(1.0), np.where(d <= a, falling, np.where(d <= hi, rising, np.float32(0.0))))
    return out


def _solve_z_constrained(m3: np.ndarray, b3: np.ndarray, z: float) -> np.ndarray:
    """Solve the z-constrained KKT system: the LS normal equations bordered
    with the altitude constraint (VectorGridOperations.cpp:90-99; the 0.5
    Lagrange scaling matches the reference's m4 assembly)."""
    m4 = np.zeros((4, 4))
    m4[:3, :3] = m3
    m4[2, 3] = 0.5
    m4[3, 2] = 1.0
    sol = np.linalg.solve(m4, np.concatenate([b3, [z]]))
    return sol[:3]


def ls_point_equal_to_chunked(
    zenith_deg, azimuth_deg, shape_hw: tuple[int, int], diagonal: float, z: float,
    rows_per_chunk: int = 1024,
) -> np.ndarray:
    """Least-squares point nearest all pixel rays, constrained to altitude z
    (VectorGridOperations.cpp:44-71, 90-99), as a chunked host reduction:
    f32 directions (the reference's own precision), f64 accumulation, row
    blocks, no (H, W, 3) materialization."""
    h, w = shape_hw
    sx, sy = sides(shape_hw, diagonal)
    m3 = np.zeros((3, 3))
    b3 = np.zeros(3)
    n = 0.0
    ax_base = sx * (np.arange(w, dtype=np.float64) + 0.5) / w
    for r0 in range(0, h, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, h)
        zen = np.radians(np.asarray(zenith_deg[r0:r1], np.float32))
        azi = np.radians(np.asarray(azimuth_deg[r0:r1], np.float32))
        sz = np.sin(zen)
        dx = sz * np.sin(azi)
        dy = -sz * np.cos(azi)
        dz = np.cos(zen)
        nrm = np.sqrt(dx * dx + dy * dy + dz * dz)
        valid = np.isfinite(nrm) & (nrm > 0)
        nrm = np.where(valid, nrm, np.float32(1.0))
        dn = [
            np.where(valid, c / nrm, np.float32(0.0)).astype(np.float64)
            for c in (dx, dy, dz)
        ]
        rows = np.arange(r0, r1, dtype=np.float64)
        ay = (sy * ((h - 1 - rows) + 0.5) / h)[:, None] * valid
        ax = ax_base[None, :] * valid
        da = dn[0] * ax + dn[1] * ay
        a = (ax, ay, 0.0)
        for i in range(3):
            ai = a[i] if i < 2 else 0.0
            b3[i] -= float((ai - dn[i] * da).sum())
            for j in range(i, 3):
                m3[i, j] += float((dn[i] * dn[j]).sum())
        n += float(valid.sum())
    m3 = m3 + np.triu(m3, 1).T  # symmetrize the accumulated upper triangle
    m3 -= n * np.eye(3)
    return _solve_z_constrained(m3, b3, z)
