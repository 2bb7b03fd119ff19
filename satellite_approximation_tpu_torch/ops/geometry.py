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

EARTH_RADIUS_KM = 6371.0


def haversine_distance(p0: tuple[float, float], p1: tuple[float, float]) -> float:
    """Great-circle distance in km between two (lng, lat) points
    (Functions.cpp:37-46, f32 like the reference)."""
    lng0, lat0 = np.radians(np.float32(p0[0])), np.radians(np.float32(p0[1]))
    lng1, lat1 = np.radians(np.float32(p1[0])), np.radians(np.float32(p1[1]))
    dlng2 = (lng1 - lng0) * np.float32(0.5)
    dlat2 = (lat1 - lat0) * np.float32(0.5)
    a = np.sin(dlat2) ** 2 + np.cos(lat0) * np.cos(lat0) * np.sin(dlng2) ** 2
    return float(
        np.float32(2.0) * np.float32(EARTH_RADIUS_KM) * np.arctan2(np.sqrt(a), np.sqrt(1 - a))
    )


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


def affine_transform(qi: Quad, qf: Quad) -> np.ndarray:
    """4x4 transform mapping quad qi onto qf: M = X2 @ X1^-1 with corner
    columns homogenized (Functions.cpp:67-88; the reference computes this in
    long double — we use f64, ample for the downstream pixel rounding)."""
    x1 = np.concatenate([qi.corners().T, np.ones((1, 4))], axis=0)
    x2 = np.concatenate([qf.corners().T, np.ones((1, 4))], axis=0)
    return x2 @ np.linalg.inv(x1)


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


def vector_grid(zenith_rad: np.ndarray, azimuth_rad: np.ndarray) -> np.ndarray:
    """Per-pixel 3-D direction (..., 3) from zenith/azimuth angle rasters —
    the y component negated to match the world frame
    (VectorGridOperations.cpp:10-25)."""
    sz = np.sin(zenith_rad)
    return np.stack(
        [sz * np.sin(azimuth_rad), -sz * np.cos(azimuth_rad), np.cos(zenith_rad)], axis=-1
    )


def ls_point_equal_to(
    grid: np.ndarray, shape_hw: tuple[int, int], diagonal: float, z: float
) -> np.ndarray:
    """Least-squares point nearest all pixel rays, constrained to altitude z
    (VectorGridOperations.cpp:44-71, 90-99). ``grid`` is (H, W, 3) with grid
    row 0 = image row 0 (top); the reference's bottom-origin pixel positions
    are reproduced via j = H-1-row. Accumulated in f64 (the reference's f32
    accumulation over millions of pixels loses ~4 digits; the extra accuracy
    moves the solution well below pixel resolution)."""
    h, w = shape_hw
    d = np.asarray(grid, dtype=np.float64)
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    dn = d / norm
    rows = np.arange(h)[:, None] * np.ones((1, w))
    cols = np.ones((h, 1)) * np.arange(w)[None, :]
    a = pixel_to_world(shape_hw, diagonal, cols, h - 1 - rows)  # (H, W, 3)

    valid = np.isfinite(dn).all(axis=-1) & np.isfinite(a).all(axis=-1)
    dn = np.where(valid[..., None], dn, 0.0)
    a = np.where(valid[..., None], a, 0.0)
    n = float(valid.sum())

    # b = -sum planeProjection(a, d) = -sum (a - d (d.a))
    da = np.sum(dn * a, axis=-1, keepdims=True)
    b3 = -(a - dn * da).sum(axis=(0, 1))
    s = np.einsum("hwi,hwj->ij", dn, dn)  # sum d d^T
    m3 = s - n * np.eye(3)
    return _solve_z_constrained(m3, b3, z)


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


def _ls_system(grid: np.ndarray, shape_hw: tuple[int, int], diagonal: float):
    """(M3, b3, positions, directions, valid) of the least-squares ray system
    (VectorGridOperations __getLSSystem__, :44-71)."""
    h, w = shape_hw
    d = np.asarray(grid, dtype=np.float64)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rows = np.arange(h)[:, None] * np.ones((1, w))
    cols = np.ones((h, 1)) * np.arange(w)[None, :]
    a = pixel_to_world(shape_hw, diagonal, cols, h - 1 - rows)
    valid = np.isfinite(dn).all(axis=-1) & np.isfinite(a).all(axis=-1)
    dn = np.where(valid[..., None], dn, 0.0)
    a = np.where(valid[..., None], a, 0.0)
    n = float(valid.sum())
    da = np.sum(dn * a, axis=-1, keepdims=True)
    b3 = -(a - dn * da).sum(axis=(0, 1))
    m3 = np.einsum("hwi,hwj->ij", dn, dn) - n * np.eye(3)
    return m3, b3, a, dn, valid


def ls_point(grid: np.ndarray, shape_hw: tuple[int, int], diagonal: float) -> np.ndarray:
    """Unconstrained least-squares point nearest all pixel rays
    (VectorGridOperations::LSPoint, :74-78)."""
    m3, b3, *_ = _ls_system(grid, shape_hw, diagonal)
    return np.linalg.solve(m3, b3)


def sum_of_square_distance(
    grid: np.ndarray, shape_hw: tuple[int, int], diagonal: float, p: np.ndarray
) -> float:
    """Sum over pixels of squared distance from ``p`` to each pixel ray
    (VectorGridOperations::SumOfSquareDistance, :26-41)."""
    _, _, a, dn, valid = _ls_system(grid, shape_hw, diagonal)
    v = p[None, None, :] - a
    proj = v - dn * np.sum(dn * v, axis=-1, keepdims=True)
    return float((np.sum(proj * proj, axis=-1) * valid).sum())


def _ls_point_bounded(grid, shape_hw, diagonal, z_bound, keep_unbounded):
    m3, b3, *_ = _ls_system(grid, shape_hw, diagonal)
    p3 = np.linalg.solve(m3, b3)
    p4 = np.concatenate([_solve_z_constrained(m3, b3, z_bound), [z_bound]])
    unbounded_ok = np.isfinite(p3).all() and keep_unbounded(p3[2])
    bounded_ok = np.isfinite(p4).all()
    if unbounded_ok and bounded_ok:
        if sum_of_square_distance(grid, shape_hw, diagonal, p3) <= sum_of_square_distance(
            grid, shape_hw, diagonal, p4[:3]
        ):
            return p3
        return p4[:3]
    return p3 if unbounded_ok else p4[:3]


def ls_point_greater_than(grid, shape_hw, diagonal, min_z) -> np.ndarray:
    """Constrained LS point with z >= min_z (VectorGridOperations::LSPointGreaterThan)."""
    return _ls_point_bounded(grid, shape_hw, diagonal, min_z, lambda z: z >= min_z)


def ls_point_less_than(grid, shape_hw, diagonal, max_z) -> np.ndarray:
    """Constrained LS point with z <= max_z (VectorGridOperations::LSPointLessThan)."""
    return _ls_point_bounded(grid, shape_hw, diagonal, max_z, lambda z: z <= max_z)


def average_dot_product(grid, shape_hw, diagonal, pos) -> float:
    """Mean alignment of pixel rays with directions toward ``pos``
    (VectorGridOperations::AverageDotProduct, :140-158)."""
    _, _, a, dn, valid = _ls_system(grid, shape_hw, diagonal)
    to_pos = pos[None, None, :] - a
    to_pos = to_pos / np.maximum(np.linalg.norm(to_pos, axis=-1, keepdims=True), 1e-300)
    dots = np.sum(dn * to_pos, axis=-1)
    return float(dots[valid].mean())


def average_direction(grid: np.ndarray) -> np.ndarray:
    """Normalized mean direction (VectorGridOperations::AverageDirection, :160)."""
    m = np.asarray(grid, dtype=np.float64).mean(axis=(0, 1))
    return m / np.linalg.norm(m)


def _ls_reduce_device(zen_deg, azi_deg, h: int, w: int, sx: float, sy: float):
    """Tensor reduction for the LS ray system: returns (m3, b3, n) as f64
    tensors without materializing the (H, W, 3) grids. Directions are
    computed in f32 (the reference's own precision, VectorGridOperations
    uses f32 Eigen) and accumulated in f64."""
    import torch

    dev = zen_deg.device
    zen = torch.deg2rad(zen_deg.to(torch.float32))
    azi = torch.deg2rad(azi_deg.to(torch.float32))
    sz = torch.sin(zen)
    dx = sz * torch.sin(azi)
    dy = -sz * torch.cos(azi)
    dz = torch.cos(zen)
    nrm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    valid = torch.isfinite(nrm) & (nrm > 0)
    nrm = torch.where(valid, nrm, torch.ones_like(nrm))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dn = [torch.where(valid, c / nrm, zero).to(torch.float64) for c in (dx, dy, dz)]
    del zen, azi, sz, dx, dy, dz, nrm

    rows = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    vf = valid.to(torch.float64)
    from ..device import divide

    ax = divide(sx * (cols + 0.5), w) * vf
    ay = divide(sy * ((h - 1 - rows) + 0.5), h) * vf

    da = dn[0] * ax + dn[1] * ay  # a_z = 0
    a = (ax, ay, torch.zeros_like(ax))
    b3 = torch.stack([-(a[i] - dn[i] * da).sum() for i in range(3)])
    m3 = torch.stack(
        [torch.stack([(dn[i] * dn[j]).sum() for j in range(3)]) for i in range(3)]
    )
    return m3, b3, vf.sum()


def _push_angles(deg, device, quantize: bool = False):
    """A degree raster as an f32 tensor on ``device`` for the LS reduction;
    tensors already there pass through.

    ``quantize``: send a finite host f32 raster as u16 with a per-raster
    affine range (65535 steps over its span, ~1e-4 deg for a field that
    spans a few degrees) and widen it on the device: half the bytes, not the
    same numbers. Off by default: the port uploads exact f32."""
    import torch

    from ..device import as_tensor

    device = torch.device(device)
    if isinstance(deg, torch.Tensor):
        return deg.to(device=device, dtype=torch.float32)
    deg = np.asarray(deg)
    if not quantize:
        return as_tensor(deg, device, torch.float32)
    lo = float(np.min(deg))
    hi = float(np.max(deg))
    if not (np.isfinite(lo) and np.isfinite(hi)) or hi - lo < 1e-12:
        return as_tensor(deg, device, torch.float32)
    scale = (hi - lo) / 65535.0
    q = np.rint((deg - np.float32(lo)) * np.float32(1.0 / scale)).astype(np.uint16)
    # torch has no arithmetic on uint16: widen on the host side of the copy
    qt = as_tensor(q.astype(np.int32), device).to(torch.float32)
    return qt * np.float32(scale).item() + np.float32(lo).item()


def upload_angles(deg, device, quantize: bool = False):
    """Public entry for pre-uploading an angle raster for
    :func:`ls_point_equal_to_device`, which passes a tensor on its device
    through unchanged, so results are bit-identical to the serial path."""
    return _push_angles(deg, device, quantize)


def ls_point_equal_to_device(
    zenith_deg, azimuth_deg, shape_hw: tuple[int, int], diagonal: float, z: float,
    quantize: bool = False, device=None,
) -> np.ndarray:
    """Device-reduction variant of :func:`ls_point_equal_to` taking DEGREE
    rasters (radians conversion happens on the device too). Only the 3x3
    system + count cross back to the host. Used by the pipeline's
    all-device route; agrees with the host path to f32-direction accuracy.
    ``device``: where host rasters go (``None``: the CUDA device); tensors
    are reduced where they lie."""
    import torch

    from ..device import resolve_device

    if isinstance(zenith_deg, torch.Tensor):
        dev = zenith_deg.device
    else:
        dev = resolve_device(device)
    h, w = shape_hw
    sx, sy = sides(shape_hw, diagonal)
    m3, b3, n = _ls_reduce_device(
        _push_angles(zenith_deg, dev, quantize),
        _push_angles(azimuth_deg, dev, quantize),
        h=h, w=w, sx=float(sx), sy=float(sy),
    )
    m3 = m3.cpu().numpy() - float(n) * np.eye(3)
    return _solve_z_constrained(m3, b3.cpu().numpy(), z)


def ls_point_equal_to_chunked(
    zenith_deg, azimuth_deg, shape_hw: tuple[int, int], diagonal: float, z: float,
    rows_per_chunk: int = 1024,
) -> np.ndarray:
    """Host chunked-reduction variant of :func:`ls_point_equal_to_device`:
    f32 directions (the reference's own precision), f64 accumulation, row
    blocks — no (H, W, 3) materialization and no device transfers."""
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
