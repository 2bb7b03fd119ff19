"""Poisson image editing: seamless clone / gap fill with guidance gradients.

Port of ``satellite_approximation_tpu/models/poisson.py``. For every unknown
pixel p (the non-sentinel pixels of an offset replacement patch, or an
explicit invalid mask):

    |N(p)| u_p - sum_{q in N(p), q unknown} u_q
        = sum_{q in N(p)} (g_p - g_q) + sum_{q in N(p), q known} input_q

with N(p) the in-image 4-neighbourhood and g the replacement (guidance)
channel, solved matrix-free and warm-started from the replacement values.
``device=None`` solves on the CUDA device.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import numpy as np

from ..config import DEFAULT_SOLVER, SolverConfig, check_single_device
from ..device import resolve_device
from ..utils.log import create_logger
from ..utils.perf import PerfInfo
from . import multigrid
from .cg import neighbor_degree, solve_banded_chunks, solve_masked_poisson

_logger = create_logger("approx.poisson")

__all__ = ["blend_images_poisson", "highlight_area_replaced", "PerfInfo", "valid_pixel_mask"]


def valid_pixel_mask(images: np.ndarray) -> np.ndarray:
    """Non-sentinel pixels of a replacement patch: a pixel is invalid when
    the first three channels all truncate to integer 1 (the all-white
    sentinel). ``images`` is (C, H, W) with C >= 3."""
    a = np.asarray(images)
    invalid = (
        (a[0].astype(np.int64) == 1)
        & (a[1].astype(np.int64) == 1)
        & (a[2].astype(np.int64) == 1)
    )
    return ~invalid


def _poisson_rhs(
    replacement: np.ndarray, boundary_values: np.ndarray, umask: np.ndarray
) -> np.ndarray:
    """b = sum of guidance gradients + known-neighbour boundary values,
    batched over channels, f64."""
    g = np.asarray(replacement, dtype=np.float64)
    known = np.asarray(boundary_values, dtype=np.float64) * (~umask)
    deg = neighbor_degree(umask.shape).astype(np.float64)

    def s4(x):
        p = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])
        h, w = x.shape[-2], x.shape[-1]
        return (
            p[..., 0:h, 1 : w + 1]
            + p[..., 2 : h + 2, 1 : w + 1]
            + p[..., 1 : h + 1, 0:w]
            + p[..., 1 : h + 1, 2 : w + 2]
        )

    grad_sum = deg * g - s4(g)  # sum_q (g_p - g_q) over in-image neighbours
    return (grad_sum + s4(known)) * umask


def _solve(
    inputs: np.ndarray,
    replacement: np.ndarray,
    umask: np.ndarray,
    tolerance: float,
    max_iterations: int | None,
    perf_path: Path | str | None,
    config: SolverConfig,
    device,
) -> np.ndarray:
    n_unknowns = int(umask.sum())
    _logger.debug("Found %d invalid pixels", n_unknowns)
    if n_unknowns == 0:
        return np.asarray(inputs, dtype=np.float64)

    max_iters = max_iterations if max_iterations is not None else max(n_unknowns // 2, 1)
    use_mg = config.use_multigrid and n_unknowns >= config.mg_threshold_pixels
    if use_mg:
        check_single_device(config.mesh, device)

    start = time.perf_counter()
    # device path (see laplace.solve_matrix): f32 uploads, guidance RHS
    # assembled on the device, only the n solved values come back
    inp32 = np.asarray(inputs, np.float32)
    rep32 = np.asarray(replacement, np.float32)
    if config.device_assembly == "force" or (
        config.device_assembly == "auto"
        and np.array_equal(inp32.astype(np.float64), np.asarray(inputs, np.float64))
        and np.array_equal(rep32.astype(np.float64), np.asarray(replacement, np.float64))
    ):
        from .fill import laplace_fill

        result = laplace_fill(
            inp32,
            umask,
            tolerance=tolerance,
            refinement_steps=max(config.refinement_steps, 1),
            max_iterations=200 if use_mg else max_iters,
            use_multigrid=use_mg,
            masked_values_output=True,
            replacement=rep32,
            device=device,
        )
        out = np.asarray(inputs, dtype=np.float64).copy()
        ys, xs = np.nonzero(umask)
        out[..., ys, xs] = result.x  # (C, n)
    else:
        b = _poisson_rhs(replacement, inputs, umask)
        x0 = np.asarray(replacement, dtype=np.float64) * umask
        if use_mg:
            solver = functools.partial(
                multigrid.solve,
                umask=umask,
                deg=neighbor_degree(umask.shape),
                tolerance=tolerance,
                refinement_steps=config.refinement_steps,
            )
        else:
            solver = functools.partial(
                solve_masked_poisson,
                umask=umask,
                tolerance=tolerance,
                max_iterations=max_iters,
                refinement_steps=config.refinement_steps,
            )
        result = solve_banded_chunks(solver, b, device=device, x0=x0)
        out = np.asarray(inputs, dtype=np.float64).copy()
        out[..., umask] = result.x[..., umask]
    solve_ms = (time.perf_counter() - start) * 1e3
    _logger.debug(
        "Solution found after %d iterations with %.4e error", result.iterations, result.error
    )
    if perf_path is not None:
        PerfInfo(
            region_size=n_unknowns,
            tolerance=tolerance,
            max_iterations=max_iters,
            iterations=result.iterations,
            error=result.error,
            solve_time=solve_ms,
        ).write(perf_path)
    return out


def blend_images_poisson(
    input_images,
    replacement_images,
    invalid_mask: np.ndarray | None = None,
    start_row: int = 0,
    start_column: int = 0,
    tolerance: float = 1e-6,
    max_iterations: int | None = None,
    perf_path: Path | str | None = None,
    config: SolverConfig = DEFAULT_SOLVER,
    device=None,
):
    """Blend ``replacement_images`` into ``input_images`` by Poisson editing.

    * ``invalid_mask`` given: both stacks are full-size; unknowns are the
      mask's true pixels.
    * ``invalid_mask`` None: the replacement is a patch placed at
      (start_row, start_column); unknowns are its non-sentinel pixels.

    Accepts a list of (H, W) arrays or a (C, H, W) array and returns the same
    structure. ``tolerance``/``max_iterations`` default to the reference's
    1e-6 and n_unknowns/2.
    """
    dev = resolve_device(device)
    as_list = isinstance(input_images, (list, tuple))
    inputs = (
        np.stack([np.asarray(c, np.float64) for c in input_images])
        if as_list
        else np.asarray(input_images, np.float64)
    )
    repl = (
        np.stack([np.asarray(c, np.float64) for c in replacement_images])
        if isinstance(replacement_images, (list, tuple))
        else np.asarray(replacement_images, np.float64)
    )
    squeeze = inputs.ndim == 2
    if squeeze:
        inputs, repl = inputs[None], repl[None]

    if invalid_mask is not None:
        if repl.shape != inputs.shape:
            raise ValueError(
                f"Replacement image is not the same size as input image "
                f"({repl.shape} vs {inputs.shape})"
            )
        if invalid_mask.shape != inputs.shape[-2:]:
            raise ValueError(
                f"Input images and mask are different sizes "
                f"({inputs.shape[-2:]} vs {invalid_mask.shape})"
            )
        umask = np.asarray(invalid_mask, dtype=bool)
        out = _solve(inputs, repl, umask, tolerance, max_iterations, perf_path, config, dev)
    else:
        rh, rw = repl.shape[-2:]
        ih, iw = inputs.shape[-2:]
        if start_row < 0 or start_column < 0 or start_row >= ih or start_column >= iw:
            raise ValueError(f"Row/column out of bounds: {start_row}, {start_column}")
        if start_row + rh > ih or start_column + rw > iw:
            raise ValueError("Replacement image goes beyond the bounds of the input image")
        umask = valid_pixel_mask(repl)
        window = inputs[..., start_row : start_row + rh, start_column : start_column + rw]
        solved = _solve(window, repl, umask, tolerance, max_iterations, perf_path, config, dev)
        out = inputs.copy()
        out[..., start_row : start_row + rh, start_column : start_column + rw] = solved

    if squeeze:
        out = out[0]
    return [out[c] for c in range(out.shape[0])] if as_list else out


def highlight_area_replaced(
    input_images: np.ndarray,
    replacement_images: np.ndarray,
    start_row: int,
    start_column: int,
    color,
) -> np.ndarray:
    """Paint the replaced region a solid colour for visual debugging."""
    inputs = np.asarray(input_images, dtype=np.float64).copy()
    repl = np.asarray(replacement_images, dtype=np.float64)
    mask = valid_pixel_mask(repl)
    rh, rw = repl.shape[-2:]
    region = inputs[..., start_row : start_row + rh, start_column : start_column + rw]
    for c in range(min(3, inputs.shape[0])):
        region[c][mask] = color[c]
    return inputs
