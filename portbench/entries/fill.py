"""Entry ``fill``: the Laplace gap fill of a stack of bands over a cloud and
shadow mask, through ``models.laplace.solve_matrix`` with the default
``SolverConfig`` (the function behind the public
``fill_missing_portion_smooth_boundary``, which returns the solve's
``CGResult`` as well).

The bands are u16-valued rasters held as float64, as Sentinel-2 L2A bands
are once read, so the port takes its device-assembly route. The pool's
scenes share one stack of bands (one place) under the mix's masks (its
dates). The check judges sampled calls' filled stacks by the plain
reference's float64 residual of the system it works out again itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class State:
    images: np.ndarray  # (C, H, W) float64, u16-valued
    invalid: list  # one (H, W) bool array a scene of the pool
    order: list  # the scenes in the order the window calls them
    units: int  # band-pixels a call


def load(ctx) -> None:
    from satellite_approximation_tpu_torch.models import laplace  # noqa: F401


def build(ctx) -> None:
    """Load the port's CUDA kernels (built into its ``csrc/build/`` at a
    checkout's first run)."""
    if ctx.device.type == "cuda":
        from satellite_approximation_tpu_torch.ops import stencil_kernels

        stencil_kernels._library()


def prepare(ctx) -> State:
    g = ctx.generator()
    h, w = ctx.config["height"], ctx.config["width"]
    bands = len(ctx.config["fill_bands"])
    gen = g.generator(ctx.seed, ctx.device)
    stack = g.smooth_bands(bands, h, w, gen, ctx.device)
    masks = [g.fill_scene(h, w, cover, gen, ctx.device) for cover in g.pool_covers(ctx.traffic)]
    images = stack.to(torch.int16).cpu().numpy().astype(np.float64)
    invalid = [m.cpu().numpy() for m in masks]
    return State(images, invalid, g.call_order(ctx.traffic, ctx.seed), bands * h * w)


def call(ctx, state: State, i: int) -> dict:
    from satellite_approximation_tpu_torch.models import laplace
    from satellite_approximation_tpu_torch.ops import stencil_kernels

    k = state.order[i % len(state.order)]
    passes = stencil_kernels.launch_counts["residual_pair"]
    out, result = laplace.solve_matrix(state.images, state.invalid[k], device=ctx.device)
    return {
        "units": state.units,
        "scene": k,
        "iterations": int(result.iterations),
        # refinement passes (one residual kernel each; counted on the card)
        "passes": stencil_kernels.launch_counts["residual_pair"] - passes,
        "output": out,
    }


def warm(ctx, state: State) -> None:
    """One call at the cell's shapes."""
    call(ctx, state, 0)


@contextlib.contextmanager
def spans(ctx, state: State, record: dict):
    """A span around ``models.fill.laplace_fill`` (the device solve inside
    the public surface): seconds a call, in ``record["laplace_fill"]``."""
    from satellite_approximation_tpu_torch.models import fill

    inner = fill.laplace_fill
    times = record.setdefault("laplace_fill", [])

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("portbench: models.fill.laplace_fill"):
                return inner(*args, **kwargs)
        finally:
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            times.append(time.perf_counter() - t0)

    fill.laplace_fill = timed
    try:
        yield
    finally:
        fill.laplace_fill = inner


def disk_bytes(ctx, state: State) -> int:
    return 0


def check(ctx, state: State, samples) -> dict:
    """The worst residual and the count of changed known pixels over the
    sampled calls."""
    from satellite_approximation_tpu_torch.models import multigrid

    multigrid._HIERARCHY_CACHE.clear()  # the program's cached hierarchies, freed
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ctx.reference()
    worst = {"residual": 0.0, "known_changed": 0}
    for _, (rec, out) in samples:
        r = ref.judge(state.images, state.invalid[rec["scene"]], out, ctx.device)
        worst["residual"] = max(worst["residual"], r["residual"])
        worst["known_changed"] += r["known_changed"]
    return worst


def control(ctx, state: State, i: int, dtype) -> dict:
    """Call ``i`` answered by the plain reference in ``dtype``, in the
    program's place."""
    k = state.order[i % len(state.order)]
    # to the program's own target, 1e-9, within a fixed budget of iterations
    out = ctx.reference().solve(state.images, state.invalid[k], dtype=dtype, device=ctx.device,
                                tolerance=1e-9, max_iterations=20000)
    return {"units": state.units, "scene": k, "output": out}
