"""Sharded geometric multigrid (``satellite_approximation_tpu/parallel/mg.py``).

Image rows shard over the mesh's 'x' axis (or rows over 'y' and columns
over 'x' on a 2-D mesh); bands over 'b'. Fine levels run *distributed*:
each Jacobi sweep and residual stencil takes one ghost row (and column)
from each neighbouring shard, as plain torch ops on every shard. The 2x2
block transfers need no halo: rows (and columns) are padded so that every
distributed level splits evenly, and every 2x2 block lives inside one
shard. Once a level's shards get too small, the coarse levels are
*replicated*: the residual is gathered, the single-device V-cycle
(``models/multigrid._v_cycle``, whose smoothers are the hand-written
kernels 1 and 2 on a CUDA device) runs once on every distinct device of
the mesh, and each shard takes its rows of the correction back.

The PCG loop reads one flag a iteration, true while any band group is above
its threshold; its dot products are summed over the spatial shards. The
f64 refinement around it re-measures the true residual in f64 and re-solves
the correction, at most three times.

On a mesh that spans processes the same code runs in every process, on
the shards it owns: halos and sums cross through the mesh's transport, the
tail's residual is all-gathered and each process runs the single-device
V-cycle once per device it owns, and the solution is assembled on process
0 only (the per-band residuals on every process).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import as_tensor
from ..models import multigrid as M
from ..models.cg import neighbor_degree
from .collectives import (
    all_gather, any_true, complete, gather, map_lines, on_device, shard, smap, unzip,
)
from .halo import halo_pad_cols, halo_pad_rows
from .mesh import ShardMesh
from .solver import _threshold, cg_direction, cg_update, dots, stencil_rows

_MIN_LOCAL_ROWS = 8  # below this, switch to replicated coarse levels
_MIN_LOCAL_COLS = 8  # correctness floor of the 2-D mesh


def build_sharded_hierarchy(umask: np.ndarray, deg: np.ndarray, xdim: int):
    """Global hierarchy split into a distributed prefix and a replicated
    tail: (padded_shape, dist_levels, repl_levels). dist_levels' row counts
    divide by ``xdim``; repl_levels continue on the full (small) grid."""
    m = np.asarray(umask, bool)
    h, w = m.shape
    depth = 0
    probe = m
    while min(probe.shape) > M._MIN_SIZE:
        ph = (probe.shape[0] + 1) // 2
        pw = (probe.shape[1] + 1) // 2
        if ph // xdim < _MIN_LOCAL_ROWS:
            break
        probe = probe[:ph, :pw]  # shape probe only
        depth += 1
    align = xdim * (1 << max(depth, 0))
    hp = -(-h // align) * align
    mp = np.zeros((hp, w), dtype=bool)
    mp[:h] = m
    dp = np.full((hp, w), 0.0, dtype=np.float32)
    dp[:h] = deg
    dp[h:] = 1.0  # padded rows: inert known cells

    dist_levels = [(mp, dp)]
    cur = mp
    for _ in range(depth):
        ch, cw = cur.shape
        pw = (cw + 1) // 2 * 2
        tmp = np.zeros((ch, pw), dtype=bool)
        tmp[:, :cw] = cur
        # 2x2 ALL-pooling, as models/multigrid.build_hierarchy
        pooled = tmp.reshape(ch // 2, 2, pw // 2, 2).all(axis=(1, 3))
        if pooled.all():
            break
        cur = pooled
        dist_levels.append((cur, neighbor_degree(cur.shape)))

    repl_levels = M.build_hierarchy(cur, neighbor_degree(cur.shape))
    return (hp, w), dist_levels, repl_levels


def build_sharded_hierarchy_2d(umask: np.ndarray, deg: np.ndarray, ydim: int, xdim: int):
    """2-D counterpart of :func:`build_sharded_hierarchy`: rows and columns
    padded so that every distributed level splits evenly over (ydim, xdim);
    padded cells are inert (known, degree 1)."""
    m = np.asarray(umask, bool)
    h, w = m.shape
    depth = 0
    ph, pw = h, w
    while min(ph, pw) > M._MIN_SIZE:
        nh, nw = (ph + 1) // 2, (pw + 1) // 2
        if nh // ydim < _MIN_LOCAL_ROWS or nw // xdim < _MIN_LOCAL_COLS:
            break
        ph, pw = nh, nw
        depth += 1
    align_y = ydim * (1 << depth)
    align_x = xdim * (1 << depth)
    hp = -(-h // align_y) * align_y
    wp = -(-w // align_x) * align_x
    mp = np.zeros((hp, wp), dtype=bool)
    mp[:h, :w] = m
    dp = np.full((hp, wp), 1.0, dtype=np.float32)
    dp[:h, :w] = deg

    dist_levels = [(mp, dp)]
    cur = mp
    for _ in range(depth):
        ch, cw = cur.shape
        pooled = cur.reshape(ch // 2, 2, cw // 2, 2).all(axis=(1, 3))
        if pooled.all():
            break
        cur = pooled
        dist_levels.append((cur, neighbor_degree(cur.shape)))

    repl_levels = M.build_hierarchy(cur, neighbor_degree(cur.shape))
    return (hp, wp), dist_levels, repl_levels


def _restrict_rows_sharded(r: torch.Tensor) -> torch.Tensor:
    """out[i] = f[2i] + f[2i+1]: every 2-row block lies in one shard."""
    return r[..., 0::2, :] + r[..., 1::2, :]


def _prolong_rows_sharded(e: torch.Tensor) -> torch.Tensor:
    """Transpose of :func:`_restrict_rows_sharded`: each coarse row to its
    two fine rows."""
    return e.repeat_interleave(2, dim=-2)


def _stencil_2d(mesh: ShardMesh, u, um, deg):
    """A(u) over (row, col) tiles: ghost rows from the 'y' neighbours and
    ghost columns from the 'x' neighbours, two independent exchanges."""
    masked = smap(torch.mul, u, um)
    rpad = map_lines(mesh, masked, "y", halo_pad_rows)
    cpad = map_lines(mesh, masked, "x", halo_pad_cols)

    def local(v, rp, cp, m, d):
        h, w = v.shape[-2:]
        s = rp[..., 0:h, :] + rp[..., 2 : h + 2, :] + cp[..., :, 0:w] + cp[..., :, 2 : w + 2]
        return (d * v - s) * m

    return smap(local, u, rpad, cpad, um, deg)


class _Layout:
    """What the 1-D and 2-D solvers differ in: the spatial mesh axes, the
    specs of a band stack and of a mask, and the stencil."""

    def __init__(self, mesh: ShardMesh, two_d: bool):
        self.mesh = mesh
        self.two_d = two_d
        self.spatial = ("y", "x") if two_d else ("x",)
        self.spec = ("b", "y", "x") if two_d else ("b", "x", None)
        self.mspec = ("y", "x") if two_d else ("x", None)

    def stencil(self, u, um, deg):
        if self.two_d:
            return _stencil_2d(self.mesh, u, um, deg)
        return stencil_rows(self.mesh, u, um, deg, "x")

    def dots(self, p, q):
        return dots(self.mesh, p, q, self.spatial)


def _levels(lay: _Layout, dist_levels):
    """Per distributed level: (um, deg, inv) f32 grids, inv = 1/deg on
    unknowns and 0 elsewhere (the smoother's weight)."""
    out = []
    for m_, d_ in dist_levels:
        um = shard(lay.mesh, m_.astype(np.float32), lay.mspec, torch.float32)
        deg = shard(lay.mesh, np.asarray(d_, np.float32), lay.mspec, torch.float32)
        inv = smap(lambda d, m: torch.where(d > 0, 1.0 / d, 0.0) * m, deg, um)
        out.append((um, deg, inv))
    return out


def _tail_hierarchies(mesh: ShardMesh, repl_levels) -> dict:
    """The replicated tail's prebuilt hierarchy on each distinct device, with
    the dense coarse inverse where the coarsest grid is small enough."""
    m_c = repl_levels[-1][0]
    out = {}
    for dev in mesh.distinct_devices():
        with on_device(dev):
            levels = tuple((as_tensor(m_, dev, torch.bool), as_tensor(np.asarray(d_, np.float32), dev))
                           for m_, d_ in repl_levels)
            cinv = M._dense_coarse_inverse(*levels[-1]) if m_c.size <= M._DENSE_COARSE_MAX else None
            out[dev] = M.prebuild(M.Hierarchy(levels, cinv), torch.float32)
    return out


def _smooth(lay: _Layout, u, b, level, omegas):
    """Weighted-Jacobi sweeps with one halo exchange each, the Chebyshev
    weights of the single-device smoother."""
    um, deg, inv = level
    for om in omegas:
        au = lay.stencil(u, um, deg)
        u = smap(lambda v, bb, a, iv: v + om * (bb - a) * iv, u, b, au, inv)
    return u


def _tail(lay: _Layout, r, tails: dict):
    """Gather the residual of every band group, run the single-device
    V-cycle on it once per distinct device (u = 0: kernels 1 and 2 on a
    card) and hand each shard its block of the correction."""
    two_d = lay.two_d
    ydim = lay.mesh.shape["y"] if two_d else lay.mesh.shape["x"]
    xdim = lay.mesh.shape["x"] if two_d else 1

    def run(shards):
        full = complete(shards)
        done = {}
        out = []
        for k, s in enumerate(shards):
            if s is None:
                out.append(None)
                continue
            hl, wl = s.shape[-2:]
            dev = s.device
            if dev not in done:
                rows = [all_gather(full[i * xdim : (i + 1) * xdim], -1, dev) for i in range(ydim)]
                with on_device(dev):
                    done[dev] = M._v_cycle(tails[dev], all_gather(rows, -2, dev))
            yi, xi = divmod(k, xdim)
            out.append(done[dev][..., yi * hl : (yi + 1) * hl, xi * wl : (xi + 1) * wl])
        return out

    return map_lines(lay.mesh, r, lay.spatial, run)


def _v_cycle_sharded(lay: _Layout, levels, tails, b, lvl: int = 0):
    """One V-cycle from u = 0 on distributed level ``lvl``."""
    level = levels[lvl]
    um = level[0]
    pre = M._smoother_omegas(M._PRE_SMOOTH)
    post = tuple(reversed(M._smoother_omegas(M._POST_SMOOTH)))
    u = _smooth(lay, smap(torch.zeros_like, b), b, level, pre)
    au = lay.stencil(u, um, level[1])
    r = smap(lambda bb, a, m: (bb - a) * m, b, au, um)
    if lvl == len(levels) - 1:
        e = _tail(lay, r, tails)
        u = smap(lambda v, ee, m: v + ee * m, u, e, um)
        return _smooth(lay, u, b, level, post)

    def restrict(rr, m_c):
        r_c = _restrict_rows_sharded(rr)
        if r_c.shape[-1] % 2:  # odd widths pad to even (rows-only meshes)
            r_c = F.pad(r_c, (0, 1))
        return (r_c[..., :, 0::2] + r_c[..., :, 1::2]) * m_c

    r_c = smap(restrict, r, levels[lvl + 1][0])
    e_c = _v_cycle_sharded(lay, levels, tails, r_c, lvl + 1)

    def correct(v, ec, m):
        e_f = _prolong_rows_sharded(ec).repeat_interleave(2, dim=-1)[..., :, : v.shape[-1]]
        return v + e_f * m

    u = smap(correct, u, e_c, um)
    return _smooth(lay, u, b, level, post)


def _pcg(lay: _Layout, levels, tails, b, x0, tol: float, max_iterations: int):
    """MG-preconditioned CG (Polak-Ribiere) over the mesh: (x, iterations,
    ||r||^2 per band)."""
    um0, deg0, _ = levels[0]

    def precond(r):
        return _v_cycle_sharded(lay, levels, tails, r)

    bb = smap(torch.mul, b, um0)
    x = smap(torch.mul, x0, um0)
    r = smap(lambda v, a, m: (v - a) * m, bb, lay.stencil(x, um0, deg0), um0)
    z = precond(r)
    p = z
    rz = lay.dots(r, z)
    threshold = _threshold(tol, lay.dots(bb, bb))

    it = 0
    while it < max_iterations and any_true(lay.mesh, smap(torch.gt, lay.dots(r, r), threshold)):
        ap = lay.stencil(p, um0, deg0)
        pap = lay.dots(p, ap)
        x, r_new = unzip(smap(cg_update, x, r, p, ap, rz, pap), 2)
        z_new = precond(r_new)
        rz_new = lay.dots(r_new, z_new)
        beta_num = smap(torch.sub, rz_new, lay.dots(r, z_new))
        p = smap(cg_direction, z_new, p, rz, beta_num)
        r, z, rz = r_new, z_new, rz_new
        it += 1
    return x, it, lay.dots(r, r)


def _solve(lay: _Layout, b, x0, hier, shape, tolerance: float, max_iterations: int):
    """Shared body of the 1-D and 2-D solves: PCG inside the f64
    refinement, on the padded grid; returns the padded f64 solution grid."""
    mesh = lay.mesh
    (hp, wp), dist_levels, repl_levels = hier
    c, h, w = shape

    def pad(a):
        return np.pad(np.asarray(a, np.float64), [(0, 0), (0, hp - h), (0, wp - w)])

    # b and x0 stay in f64 for the refinement (the JAX package rounds them to
    # f32 first, which an f32 input leaves unchanged); only the PCG's right-
    # hand sides are f32
    b64 = shard(mesh, pad(b), lay.spec, torch.float64)
    levels = _levels(lay, dist_levels)
    tails = _tail_hierarchies(mesh, repl_levels)

    um0, deg0, _ = levels[0]
    um64 = smap(lambda m: m.to(torch.float64), um0)
    deg64 = smap(lambda d: d.to(torch.float64), deg0)
    x64 = smap(torch.mul, shard(mesh, pad(x0), lay.spec, torch.float64), um64)
    zeros = smap(lambda v: torch.zeros_like(v, dtype=torch.float32), b64)

    def residual64(x_):
        # the true residual in f64, with the same halo exchange
        ax = lay.stencil(smap(torch.mul, x_, um64), um64, deg64)
        r = smap(lambda v, a, m: (v * m - a) * m, b64, ax, um64)
        return r, lay.dots(r, r)

    def band_norms(sq):
        return np.sqrt(gather(mesh, sq, ("b",)).cpu().numpy())

    bnorm = band_norms(lay.dots(smap(torch.mul, b64, um64), smap(torch.mul, b64, um64)))
    target = tolerance * np.maximum(bnorm, 1e-300)
    total = 0
    r64, rsq = residual64(x64)
    rnorm = band_norms(rsq)
    for _ in range(3):
        if np.all(rnorm <= target):
            break
        r32 = smap(lambda v: v.to(torch.float32), r64)
        d, it, _ = _pcg(lay, levels, tails, r32, zeros, tolerance, max_iterations)
        total += it
        x64 = smap(lambda v, dd, m: v + dd.to(torch.float64) * m, x64, d, um64)
        r64, rsq = residual64(x64)
        rnorm = band_norms(rsq)
    return x64, total, rnorm / np.maximum(bnorm, 1e-300)


def sharded_mg_solve(b, x0, umask, deg, mesh: ShardMesh, tolerance: float = 1e-6,
                     max_iterations: int = 100):
    """MG-preconditioned CG over a ('b', 'x') mesh.

    ``b`` / ``x0`` (C, H, W), ``umask`` (H, W); C must divide over 'b'. Rows
    are padded so that every distributed level splits evenly over 'x'. The
    refinement measures the residual against ``b`` in f64 as given (the JAX
    package rounds ``b`` to f32 first, so its certificate there is of the
    rounded system).
    Returns (x, iterations, relative residual per band): x a (C, H, W) f64
    tensor gathered on the mesh's first device (the padded rows gathered
    and cut off), the residuals a numpy array. On a mesh that spans
    processes every process passes the same inputs, and x is None but on
    process 0."""
    c, h, w = b.shape
    if deg is None:
        deg = neighbor_degree((h, w))
    lay = _Layout(mesh, two_d=False)
    hier = build_sharded_hierarchy(umask, deg, mesh.shape["x"])
    x64, total, rel = _solve(lay, b, x0, hier, (c, h, w), tolerance, max_iterations)
    x = gather(mesh, x64, lay.spec, root=0)
    return (None if x is None else x[:, :h, :]), total, rel


def sharded_mg_solve_2d(b, x0, umask, deg, mesh: ShardMesh, tolerance: float = 1e-6,
                        max_iterations: int = 100):
    """MG-preconditioned CG over a ('b', 'y', 'x') mesh, rows over 'y' and
    columns over 'x': the 2-D-tiled form of :func:`sharded_mg_solve`, with
    the same return values."""
    c, h, w = b.shape
    if deg is None:
        deg = neighbor_degree((h, w))
    lay = _Layout(mesh, two_d=True)
    hier = build_sharded_hierarchy_2d(umask, deg, mesh.shape["y"], mesh.shape["x"])
    x64, total, rel = _solve(lay, b, x0, hier, (c, h, w), tolerance, max_iterations)
    x = gather(mesh, x64, lay.spec, root=0)
    return (None if x is None else x[:, :h, :w]), total, rel


def comm_volume_report_2d(h: int, w: int, c: int, ydim: int, xdim: int,
                          umask: np.ndarray | None = None) -> dict:
    """Per-shard halo bytes of one PCG iteration on a ('b', 'y', 'x') mesh:
    each exchange moves 2 ghost rows of the local width and 2 ghost columns
    of the local height (f32)."""
    m = np.ones((h, w), bool) if umask is None else np.asarray(umask, bool)
    deg = neighbor_degree(m.shape)
    (hp, wp), dist_levels, repl_levels = build_sharded_hierarchy_2d(m, deg, ydim, xdim)

    sweeps = M._PRE_SMOOTH + M._POST_SMOOTH
    per_level = []
    total_halo_bytes = 0
    for ml, _ in dist_levels:
        hl, wl = ml.shape
        exchanges = sweeps + 1
        halo_bytes = exchanges * (2 * (wl // xdim) + 2 * (hl // ydim)) * 4 * c
        per_level.append({"level_shape": [int(hl), int(wl)],
                          "halo_exchanges": int(exchanges), "halo_bytes": int(halo_bytes)})
        total_halo_bytes += halo_bytes
    tail_h, tail_w = dist_levels[-1][0].shape
    n_spatial = ydim * xdim
    allgather_bytes = c * tail_h * tail_w * 4 * (n_spatial - 1) // max(n_spatial, 1)
    pcg_body_bytes = (2 * (w // xdim) + 2 * (h // ydim)) * 4 * c + 3 * 4 * c
    total = total_halo_bytes + allgather_bytes + pcg_body_bytes
    return {
        "grid": [int(hp), int(wp)],
        "bands": int(c),
        "ydim": int(ydim),
        "xdim": int(xdim),
        "distributed_levels": len(dist_levels),
        "replicated_levels": len(repl_levels),
        "local_tile_per_level": [[int(ml.shape[0]) // ydim, int(ml.shape[1]) // xdim]
                                 for ml, _ in dist_levels],
        "per_level": per_level,
        "tail_allgather_bytes": int(allgather_bytes),
        "bytes_per_pcg_iteration": int(total),
    }


def comm_volume_report(h: int, w: int, c: int, xdim: int, umask: np.ndarray | None = None) -> dict:
    """Communication volume of one sharded MG-PCG iteration on a row mesh:
    per V-cycle level one 2-ghost-row exchange per smoother sweep and one
    for the residual stencil (the block transfers need none), the tail's
    gather, and the PCG body's A-apply exchange and 3 scalar sums (f32)."""
    m = np.ones((h, w), bool) if umask is None else np.asarray(umask, bool)
    deg = neighbor_degree(m.shape)
    (hp, wp), dist_levels, repl_levels = build_sharded_hierarchy(m, deg, xdim)

    sweeps = M._PRE_SMOOTH + M._POST_SMOOTH
    per_level = []
    total_halo_bytes = 0
    for ml, _ in dist_levels:
        hl, wl = ml.shape
        exchanges = sweeps + 1  # smoother sweeps + residual stencil
        halo_bytes = exchanges * 2 * wl * 4 * c  # 2 ghost rows per exchange
        per_level.append({"level_shape": [int(hl), int(wl)],
                          "halo_exchanges": int(exchanges), "halo_bytes": int(halo_bytes)})
        total_halo_bytes += halo_bytes
    tail_h, tail_w = dist_levels[-1][0].shape
    allgather_bytes = c * tail_h * tail_w * 4 * (xdim - 1) // max(xdim, 1)
    pcg_body_bytes = 2 * w * 4 * c + 3 * 4 * c  # A-apply halo + 3 sums
    total = total_halo_bytes + allgather_bytes + pcg_body_bytes
    return {
        "grid": [int(hp), int(wp)],
        "bands": int(c),
        "xdim": int(xdim),
        "distributed_levels": len(dist_levels),
        "replicated_levels": len(repl_levels),
        "local_rows_per_level": [int(ml.shape[0]) // xdim for ml, _ in dist_levels],
        "per_level": per_level,
        "tail_allgather_bytes": int(allgather_bytes),
        "bytes_per_pcg_iteration": int(total),
        "compute_bytes_per_iteration_per_shard": int(
            # every level's smoother reads/writes ~5 arrays per sweep
            sum(5 * 4 * c * (ml.size // xdim) * sweeps for ml, _ in dist_levels)
        ),
    }
