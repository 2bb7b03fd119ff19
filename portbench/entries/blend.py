"""Entry ``blend``: the Poisson blend of a clear date into a cloudy one over
its cloud and shadow mask, through the public mask overload
``models.poisson.blend_images_poisson(inputs, replacement,
invalid_mask=mask, device=...)`` with its public defaults: the default
``SolverConfig`` and the tolerance 1e-6 that the configuration states.

The bands are u16-valued rasters held as float64, as Sentinel-2 L2A bands
are once read, so the port takes its device-assembly route. The pool's
scenes share one stack of bands (one place) and one clear replacement date
under the mix's masks (its cloudy dates). The check judges sampled calls'
blended stacks by the plain reference's float64 residual of the system it
works out again itself.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class State:
    images: np.ndarray  # (C, H, W) float64, u16-valued: the cloudy date
    replacement: np.ndarray  # (C, H, W) float64, u16-valued: the clear date
    invalid: list  # one (H, W) bool array a scene of the pool
    order: list  # the scenes in the order the window calls them
    units: int  # band-pixels a call


def load(ctx) -> None:
    from satellite_approximation_tpu_torch.models import poisson  # noqa: F401


def _fill(ctx):
    """The entry ``fill``, whose kernel load and harness span the blend's are."""
    return ctx.bench.module("entries", "fill")


def build(ctx) -> None:
    """Load the port's CUDA kernels (built into its ``csrc/build/`` at a
    checkout's first run)."""
    _fill(ctx).build(ctx)


def prepare(ctx) -> State:
    """The stack and the masks as ``refscene.fill13``'s of the same seed,
    then the replacement: a second draw of bands from the same generator."""
    g = ctx.generator()
    h, w = ctx.config["height"], ctx.config["width"]
    bands = len(ctx.config["fill_bands"])
    gen = g.generator(ctx.seed, ctx.device)
    stack = g.smooth_bands(bands, h, w, gen, ctx.device)
    masks = [g.fill_scene(h, w, cover, gen, ctx.device) for cover in g.pool_covers(ctx.traffic)]
    repl = g.smooth_bands(bands, h, w, gen, ctx.device)
    images = stack.to(torch.int16).cpu().numpy().astype(np.float64)
    replacement = repl.to(torch.int16).cpu().numpy().astype(np.float64)
    invalid = [m.cpu().numpy() for m in masks]
    return State(images, replacement, invalid, g.call_order(ctx.traffic, ctx.seed),
                 bands * h * w)


@contextlib.contextmanager
def _watched(seen: dict):
    """Record what the blend's solve reports while it runs: the
    ``CGResult`` of ``models.fill.laplace_fill`` (looked up by the blend at
    call time) and the refinement passes, one inner solve each
    (``multigrid._pcg_core``, or ``_cg_core`` below the multigrid route)."""
    from satellite_approximation_tpu_torch.models import fill, multigrid

    inner = fill.laplace_fill, multigrid._pcg_core, fill._cg_core

    def laplace_fill(*args, **kwargs):
        seen["result"] = inner[0](*args, **kwargs)
        return seen["result"]

    def counted(solve):
        def one_pass(*args, **kwargs):
            seen["passes"] += 1
            return solve(*args, **kwargs)
        return one_pass

    fill.laplace_fill, multigrid._pcg_core, fill._cg_core = (
        laplace_fill, counted(inner[1]), counted(inner[2]))
    try:
        yield
    finally:
        fill.laplace_fill, multigrid._pcg_core, fill._cg_core = inner


def call(ctx, state: State, i: int) -> dict:
    from satellite_approximation_tpu_torch.models import poisson

    k = state.order[i % len(state.order)]
    seen = {"result": None, "passes": 0}
    with _watched(seen):
        out = poisson.blend_images_poisson(state.images, state.replacement,
                                           invalid_mask=state.invalid[k], device=ctx.device)
    if seen["result"] is None:
        raise RuntimeError("the blend did not take the device route through laplace_fill")
    return {
        "units": state.units,
        "scene": k,
        "iterations": int(seen["result"].iterations),
        "passes": seen["passes"],
        "output": out,
    }


def warm(ctx, state: State) -> None:
    """One call at the cell's shapes."""
    call(ctx, state, 0)


def spans(ctx, state: State, record: dict):
    """The entry ``fill``'s span around ``models.fill.laplace_fill`` (the
    device solve inside the public surface): seconds a call, in
    ``record["laplace_fill"]``."""
    return _fill(ctx).spans(ctx, state, record)


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
        r = ref.judge(state.images, state.replacement, state.invalid[rec["scene"]], out,
                      ctx.device)
        worst["residual"] = max(worst["residual"], r["residual"])
        worst["known_changed"] += r["known_changed"]
    return worst


def control(ctx, state: State, i: int, dtype) -> dict:
    """Call ``i`` answered by the plain reference in ``dtype``, in the
    program's place, to the call's own tolerance within a fixed budget of
    iterations."""
    k = state.order[i % len(state.order)]
    out = ctx.reference().solve(state.images, state.replacement, state.invalid[k], dtype=dtype,
                                device=ctx.device, tolerance=ctx.config["tolerance"],
                                max_iterations=20000)
    return {"units": state.units, "scene": k, "output": out}
