"""Workers of the multi-process tests (tests/test_torch_multihost.py). Each
runs in a fresh interpreter started by ``parallel.multihost.run_processes``,
joins a mesh that spans the processes (on the CPU by default: gloo over
loopback; ``--device cuda`` on the card) and writes what its shards
computed to ``--out``, one file a process:

    python tests/multihost_workers.py solve --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id 0 --shape 1 4 --out DIR
    python tests/multihost_workers.py collectives ...

The test computes the same on a mesh of the same shape inside one process
and holds the two bit for bit. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from satellite_approximation_tpu_torch.parallel import collectives as C  # noqa: E402
from satellite_approximation_tpu_torch.parallel import halo  # noqa: E402
from satellite_approximation_tpu_torch.parallel.mesh import init_process_mesh  # noqa: E402
from satellite_approximation_tpu_torch.parallel.mg import (  # noqa: E402
    sharded_mg_solve,
    sharded_mg_solve_2d,
)
from satellite_approximation_tpu_torch.parallel.multihost import problem  # noqa: E402

AXES = {2: ("b", "x"), 3: ("b", "y", "x")}
SOLVE_SIZE, SOLVE_BANDS = 96, 3
HALO_CASES = [(depth, bv) for depth in (1, 3) for bv in (0.0, 7.0)]


def solve_inputs(mesh_shape):
    """The dry run's system at SOLVE_SIZE with SOLVE_BANDS bands, zero bands
    appended up to a multiple of the 'b' axis."""
    b, umask = problem(SOLVE_SIZE, SOLVE_BANDS)
    pad = -b.shape[0] % mesh_shape[0]
    return np.concatenate([b, np.zeros((pad, *b.shape[1:]), b.dtype)]), umask


def solve(mesh, mesh_shape) -> dict:
    """The sharded MG-PCG to 1e-6 (process 0 holds x)."""
    b, umask = solve_inputs(mesh_shape)
    fn = sharded_mg_solve_2d if len(mesh_shape) == 3 else sharded_mg_solve
    x, iters, rel = fn(b, np.zeros_like(b), umask, None, mesh, tolerance=1e-6)
    out = {"iterations": np.array(iters), "rel": np.asarray(rel)}
    if x is not None:
        out["x"] = x.cpu().numpy()
    return out


def collective_inputs():
    """A (2, 24, 20) f32 field, its shards along 'x' by rows and by columns."""
    return np.random.default_rng(11).standard_normal((2, 24, 20)).astype(np.float32)


def collectives(mesh) -> dict:
    """Halo rows and columns, psum, pmax, any_true and gather across the
    ('b', 'x') mesh; every shard's result under its flat index."""
    x = collective_inputs()
    rows = C.shard(mesh, x, ("b", "x", None))
    cols = C.shard(mesh, x, ("b", None, "x"))
    out = {}

    def keep(name, grid):
        for i, t in enumerate(grid.reshape(-1)):
            if t is not None:
                out[f"{name}/{i}"] = t.cpu().numpy()

    for depth, bv in HALO_CASES:
        keep(f"rows_{depth}_{bv:g}", C.map_lines(
            mesh, rows, "x", lambda s, d=depth, v=bv: halo.halo_pad_rows(s, d, v)))
        keep(f"cols_{depth}_{bv:g}", C.map_lines(
            mesh, cols, "x", lambda s, d=depth, v=bv: halo.halo_pad_cols(s, d, v)))
    keep("psum", C.psum(mesh, C.smap(lambda t: torch.sum(t * t, dim=(-2, -1)), rows), "x"))
    keep("pmax", C.pmax(mesh, rows, "x"))
    flags = []
    for thr in (-10.0, 10.0, 2.5):
        flags.append(C.any_true(mesh, C.smap(lambda t, v=thr: t > v, rows)))
    # True in the last shard only, which another process holds
    last = mesh.size - 1
    only = C.smap(lambda t: torch.zeros_like(t, dtype=torch.bool), rows)
    if mesh.owns(last):
        only.reshape(-1)[last] = torch.ones_like(rows.reshape(-1)[last], dtype=torch.bool)
    flags.append(C.any_true(mesh, only))
    out["any_true"] = np.array(flags)
    out["gather_all"] = C.gather(mesh, rows, ("b", "x", None)).cpu().numpy()
    g = C.gather(mesh, cols, ("b", None, "x"), root=0)
    if g is not None:
        out["gather_root"] = g.cpu().numpy()
    return out


def main(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("solve", "collectives"))
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--shape", type=int, nargs="+", required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    shape = tuple(args.shape)
    per = int(np.prod(shape)) // args.num_processes
    mesh = init_process_mesh(shape, AXES[len(shape)], args.coordinator, args.num_processes,
                             args.process_id, per, args.device, timeout_s=120.0)
    try:
        result = solve(mesh, shape) if args.case == "solve" else collectives(mesh)
        result["backend"] = np.array(mesh.transport.backend)
    finally:
        dist.destroy_process_group()
    np.savez(args.out / f"{args.case}_{args.process_id}.npz", **result)


if __name__ == "__main__":
    main(sys.argv[1:])
