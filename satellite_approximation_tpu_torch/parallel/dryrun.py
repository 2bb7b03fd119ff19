"""The multi-device dry run: every sharded path once on a mesh of shards
(the port's counterpart of ``__graft_entry__.dryrun_multichip``), at the
JAX dry run's sizes. It raises on any mismatch and never drops to the CPU
unless it is asked to run there."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.cg import neighbor_degree
from ..ops.blur import gaussian_blur
from ..ops.pitfill import pit_fill
from .detect import mini_detect_sharded
from .mesh import spatial_band_mesh, spatial_mesh_2d, spread_devices
from .mg import build_sharded_hierarchy, comm_volume_report, sharded_mg_solve, sharded_mg_solve_2d
from .solver import sharded_masked_cg, sharded_training_step
from .stencils import sharded_gaussian_blur, sharded_pit_fill


def dryrun_multichip(n_devices: int, device=None, log=print) -> dict:
    """Run, on a mesh of ``n_devices`` shards: the sharded training step, the
    sharded CG, the sharded MG-PCG (with its row padding, and a 1024x512
    fill with a deep distributed hierarchy to a verified 1e-6), the 2-D
    solve with its iteration parity against the (y, 1) partition, the
    sharded blur and pit fill bit-equal to the single-device ones, and the
    sharded mini detect. ``device``: None is the CUDA device (raises
    without one). Returns what it measured; raises on any mismatch."""
    dev = resolve_device(device)
    devices = spread_devices(n_devices, dev)
    mesh = spatial_band_mesh(n_devices, devices=devices)
    bdim, xdim = mesh.shape["b"], mesh.shape["x"]
    out: dict = {"mesh": repr(mesh)}

    c, h, w = 2 * bdim, 16 * xdim, 64
    rng = np.random.default_rng(1)
    inputs = rng.random((c, h, w)).astype(np.float32)
    repl = rng.random((c, h, w)).astype(np.float32)
    umask = np.zeros((h, w), dtype=bool)
    umask[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = True

    filled, rs = sharded_training_step(mesh)(inputs, repl, umask)
    if tuple(filled.shape) != (c, h, w) or not bool(torch.isfinite(rs).all()):
        raise AssertionError("sharded training step: wrong shape or non-finite residual")

    b_np = rng.random((c, h, w)).astype(np.float32) * umask
    _, mg_iters, rel = sharded_mg_solve(b_np, np.zeros_like(b_np), umask, None, mesh,
                                        tolerance=1e-5, max_iterations=100)
    if not np.isfinite(rel).all():
        raise AssertionError("sharded MG solve: non-finite residual")

    b = np.ones((c, h, w), np.float32) * umask
    _, cg_iters, rs2 = sharded_masked_cg(b, np.zeros_like(b), umask, neighbor_degree((h, w)), mesh,
                                         tolerance=1e-4, max_iterations=200)
    if not bool(torch.isfinite(rs2).all()):
        raise AssertionError("sharded CG: non-finite residual")
    out.update(mg_iterations=mg_iters, cg_iterations=cg_iters)

    # a 1024x512 fill with >= 3 row-sharded levels before the replicated tail
    h2, w2, c2 = 1024, 512, 2
    rng2 = np.random.default_rng(7)
    yy, xx = np.ogrid[:h2, :w2]
    umask2 = np.zeros((h2, w2), bool)
    for _ in range(12):
        cy, cx = rng2.integers(60, h2 - 60), rng2.integers(60, w2 - 60)
        ry, rx = rng2.integers(20, 90), rng2.integers(20, 70)
        umask2 |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    umask2[0, :] = umask2[-1, :] = umask2[:, 0] = umask2[:, -1] = False
    _, dist_levels, _ = build_sharded_hierarchy(umask2, neighbor_degree((h2, w2)), xdim)
    if len(dist_levels) < 3:
        raise AssertionError(f"the dry run needs a deep distributed hierarchy, got "
                             f"{len(dist_levels)} levels")
    b2 = (rng2.random((c2, h2, w2)) * umask2).astype(np.float32)
    _, iters2, rel2 = sharded_mg_solve(b2, np.zeros_like(b2), umask2, None, mesh,
                                       tolerance=1e-6, max_iterations=100)
    if not np.all(rel2 <= 1e-6):
        raise AssertionError(f"sharded MG solve: residual {rel2} missed 1e-6")
    report = comm_volume_report(h2, w2, c2, xdim, umask2)
    out.update(fill_iterations=iters2, fill_residual=float(np.max(rel2)),
               comm_bytes_per_iteration=report["bytes_per_pcg_iteration"])
    log(f"comm volume @ {h2}x{w2}x{c2}, xdim={xdim}: {report['bytes_per_pcg_iteration']} "
        f"B/PCG-iter over {report['distributed_levels']} distributed levels "
        f"(local rows {report['local_rows_per_level']})")

    # the 2-D mesh: 1e-6, and the same iterations as the (y, 1) partition
    if n_devices >= 4:
        h3 = w3 = 256
        umask3 = umask2[:h3, :w3].copy()
        umask3[0, :] = umask3[-1, :] = umask3[:, 0] = umask3[:, -1] = False
        b3 = (rng2.random((2, h3, w3)) * umask3).astype(np.float32)
        by_mesh = {}
        for yd, xd in ((2, 2), (2, 1)):
            mesh2d = spatial_mesh_2d(yd * xd, shape=(1, yd, xd), devices=devices[: yd * xd])
            _, it3, rel3 = sharded_mg_solve_2d(b3, np.zeros_like(b3), umask3, None, mesh2d,
                                               tolerance=1e-6, max_iterations=100)
            if not np.all(rel3 <= 1e-6):
                raise AssertionError(f"2-D residual {rel3}")
            by_mesh[(yd, xd)] = it3
        if by_mesh[(2, 2)] != by_mesh[(2, 1)]:
            raise AssertionError(f"2-D mesh iteration parity broken: {by_mesh}")
        out["iterations_2d"] = {f"{k[0]}x{k[1]}": v for k, v in by_mesh.items()}
        log(f"2-D mesh (2,2) vs (2,1): iterations {by_mesh}")

    # the sharded detection stencils, bit-equal
    img = rng2.random((64 * xdim, 256)).astype(np.float32)
    want = gaussian_blur(torch.from_numpy(img).to(dev), 4.0)
    if not torch.equal(sharded_gaussian_blur(img, 4.0, mesh).to(dev), want):
        raise AssertionError("sharded blur mismatch")
    pf_img = rng2.random((32 * xdim, 128)).astype(np.float32)
    want = pit_fill(torch.from_numpy(pf_img).to(dev), 0.3)
    if not torch.equal(sharded_pit_fill(pf_img, 0.3, mesh).to(dev), want):
        raise AssertionError("sharded pit fill mismatch")

    det = mini_detect_sharded(mesh, n=256)
    out["mini_detect_matched"] = det["n_matched"]
    log(f"sharded mini-detect ok: {det['n_matched']} matched clouds, masks bit-equal across "
        f"{n_devices} shards")
    return out
