"""Laplace fill: solve del^2 u = 0 over masked pixels with Dirichlet data.

Port of ``satellite_approximation_tpu/models/laplace.py``. Unknowns are the
invalid pixels off the image border (border pixels are always known, so
every unknown has four in-image neighbours); for p in U

    4 u_p - sum_{q in N4(p) ∩ U} u_q = sum_{q in N4(p) \\ U} input_q

The public functions take and return numpy arrays; ``device=None`` solves on
the CUDA device.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from ..config import DEFAULT_SOLVER, SolverConfig, check_single_device
from ..device import resolve_device
from ..utils.db import ApproxMethod, DataBase
from ..utils.filesystem import multispectral_folders
from ..utils.geotiff import GeoTIFF, write_geotiff
from ..utils.log import create_logger
from ..utils.perf import Stopwatch
from . import multigrid
from .cg import CGResult, solve_banded_chunks, solve_masked_poisson

_logger = create_logger("approx.laplace")


def _laplace_unknowns(invalid: np.ndarray) -> np.ndarray:
    u = np.asarray(invalid, dtype=bool).copy()
    u[0, :] = False
    u[-1, :] = False
    u[:, 0] = False
    u[:, -1] = False
    return u


def _laplace_rhs(images: np.ndarray, umask: np.ndarray) -> np.ndarray:
    """b = sum of known-neighbour values, batched, f64."""
    known = np.asarray(images, dtype=np.float64) * (~umask)
    p = np.pad(known, [(0, 0)] * (known.ndim - 2) + [(1, 1), (1, 1)])
    h, w = known.shape[-2], known.shape[-1]
    s = (
        p[..., 0:h, 1 : w + 1]
        + p[..., 2 : h + 2, 1 : w + 1]
        + p[..., 1 : h + 1, 0:w]
        + p[..., 1 : h + 1, 2 : w + 2]
    )
    return s * umask


def solve_matrix(
    images: np.ndarray,
    invalid_mask: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER,
    device=None,
) -> tuple[np.ndarray, CGResult]:
    """Fill invalid pixels of (H,W) or (C,H,W) ``images``; returns
    (filled_images, solve_info). The solve runs to near machine precision,
    like the reference's default-tolerance Eigen CG."""
    dev = resolve_device(device)
    images = np.asarray(images, dtype=np.float64)
    squeeze = images.ndim == 2
    if squeeze:
        images = images[None]
    invalid = np.asarray(invalid_mask, dtype=bool)
    if invalid.shape != images.shape[-2:]:
        raise ValueError(
            f"Image and mask sizes differ ({images.shape[-2:]} vs {invalid.shape})"
        )

    umask = _laplace_unknowns(invalid)
    if not umask.any():
        _logger.info("Could not perform approximation: no invalid pixels")
        out = images[0] if squeeze else images
        return out, CGResult(out, 0, 0.0)

    n = int(umask.sum())
    use_mg = config.use_multigrid and n >= config.mg_threshold_pixels
    if use_mg:
        check_single_device(config.mesh, dev)

    # device path: when the f64 input is exactly representable in f32 (every
    # u8/u16-derived raster), upload f32 and fetch back only the n solved
    # values
    img32 = images.astype(np.float32)
    if config.device_assembly == "force" or (
        config.device_assembly == "auto" and np.array_equal(img32.astype(np.float64), images)
    ):
        from .fill import laplace_fill

        result = laplace_fill(
            img32,
            umask,
            tolerance=1e-9 if use_mg else 1e-7,  # ~ Eigen's machine-eps default
            refinement_steps=max(config.refinement_steps, 4),
            max_iterations=200 if use_mg else 4 * n + 64,
            use_multigrid=use_mg,
            masked_values_output=True,
            device=dev,
        )
        filled = images.copy()
        ys, xs = np.nonzero(umask)
        filled[:, ys, xs] = result.x  # (C, n)
        out = filled[0] if squeeze else filled
        return out, result

    # exact-f64 route (inputs with more than f32 mantissa precision): host
    # assembly of the f64 right-hand side
    b = _laplace_rhs(images, umask)
    deg = np.full(invalid.shape, 4.0, dtype=np.float32)
    x0 = images * umask
    if use_mg:
        solver = functools.partial(
            multigrid.solve, umask=umask, deg=deg, tolerance=1e-9,
            refinement_steps=max(config.refinement_steps, 2),
        )
    else:
        solver = functools.partial(
            solve_masked_poisson,
            umask=umask,
            deg=deg,
            tolerance=1e-7,
            max_iterations=4 * n + 64,
            refinement_steps=max(config.refinement_steps, 2),
        )
    result = solve_banded_chunks(solver, b, device=dev, x0=x0)
    filled = np.where(umask, result.x, images)
    out = filled[0] if squeeze else filled
    return out, result


def fill_missing_portion_smooth_boundary(
    input_image: np.ndarray,
    invalid_pixels: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER,
    device=None,
) -> np.ndarray:
    """Public fill entry point (reference laplace.cpp:122-132)."""
    sw = Stopwatch()
    out, _ = solve_matrix(input_image, invalid_pixels, config, device=device)
    _logger.debug("It took %.3f seconds to solve the problem", sw.elapsed())
    return out


def filling_missing_portions_smooth_boundaries(
    input_image: np.ndarray, invalid_pixels: np.ndarray, device=None
) -> np.ndarray:
    """pybind-surface alias (reference src/main.cpp:49-54)."""
    return fill_missing_portion_smooth_boundary(input_image, invalid_pixels, device=device)


def find_connected_components(invalid: np.ndarray, min_area: int = 1, device=None):
    """Connected regions of an invalid-pixel mask.

    The reference *declares and unit-tests* this function but never
    implements it (approx/laplace.h:11-20; tests/approximation.h:55-76) —
    implemented here for real: returns (matrix, region_map) matching the
    declared ``ConnectedComponents`` struct, where ``matrix`` holds the
    compact region id per pixel (-1 background) and ``region_map`` maps
    region id -> list of (row, col) pixel indices.

    The native C++ flood labels the mask on the host where the library is
    built; otherwise the label propagation runs on ``device`` (``None``: the
    CUDA device, raises without one).
    """
    from ..ops.components import partition_regions

    id_map, regions = partition_regions(
        np.asarray(invalid, bool), min_area=min_area, device=device)
    region_map: dict[int, list[tuple[int, int]]] = {}
    for r in regions:
        rows, cols = np.nonzero(id_map == r.id)
        region_map[r.id] = list(zip(rows.tolist(), cols.tolist()))
    return id_map, region_map


def fill_missing_data_folder(
    base_folder,
    band_names: list[str],
    use_cache: bool = True,
    skip_threshold: float = 1.0,
    config: SolverConfig = DEFAULT_SOLVER,
    device=None,
) -> None:
    """Laplace-fill every band of every multispectral date folder.

    Implements the reference's commented-out batch loop for real
    (laplace.cpp:170-244): per date folder, load cloud/shadow masks, skip
    dates whose invalid fraction exceeds ``skip_threshold``, fill each band
    not already recorded in the DB, write results to
    ``<date>/approximated_data/<band>_<id>.tif``, and record completion in
    the ``approximated_data`` table. All requested bands solve in one
    batched call (the same mask shares one system) on ``device`` (``None``:
    the CUDA device, raises without one).
    """
    dev = resolve_device(device)
    base_folder = Path(base_folder)
    if not base_folder.is_dir():
        _logger.warning("Could not process: base folder is not a directory (%s)", base_folder)
        return

    with DataBase(base_folder) as db:
        for folder in multispectral_folders(base_folder):
            _logger.debug("Starting folder: %s", folder)
            out_dir = folder / "approximated_data"
            out_dir.mkdir(exist_ok=True)

            status = db.get_status(folder.name)
            if not (status.clouds_exist and status.shadows_exist):
                _logger.warning(
                    "Both clouds and shadows don't exist for folder %s. Skipping", folder
                )
                continue
            if status.percent_invalid > skip_threshold:
                _logger.info(
                    "Skipping %s because there is too little valid data (%.1f%% invalid)",
                    folder,
                    status.percent_invalid * 100.0,
                )
                continue

            clouds = GeoTIFF.open(folder / "cloud_mask.tif").read().astype(bool)
            shadow_path = folder / "shadow_mask.tif"
            if shadow_path.exists():
                shadows = GeoTIFF.open(shadow_path).read().astype(bool)
            else:
                shadows = np.zeros_like(clouds)
            mask = clouds | shadows

            existing = db.get_approx_status(folder.name, ApproxMethod.Laplace)
            todo = [b for b in band_names if not (use_cache and b in existing)]
            if not todo:
                continue

            values = np.stack(
                [GeoTIFF.open(folder / f"{band}.tif").read().astype(np.float64) for band in todo]
            )
            filled, _ = solve_matrix(values, mask, config, device=dev)
            for k, band in enumerate(todo):
                rid = db.write_approx_results(folder.name, band, ApproxMethod.Laplace)
                write_geotiff(
                    filled[k].astype(np.float32),
                    out_dir / f"{band}_{rid}.tif",
                    template_path=folder / f"{band}.tif",
                )
            _logger.info("Finished folder: %s", folder)


def apply_laplace(
    image: np.ndarray, invalid_image: np.ndarray, red_threshold: float = 220.0, device=None
) -> np.ndarray:
    """Derive the mask from a marker image and fill every channel.

    Mask = (red >= red_threshold) AND (green <= 150) on the marker image's
    red/green channels; ``image`` and ``invalid_image`` are (H, W, C)
    RGB-ordered arrays. All channels solve in one batched call.
    """
    invalid_image = np.asarray(invalid_image)
    red = invalid_image[..., 0].astype(np.float64)
    green = invalid_image[..., 1].astype(np.float64)
    invalid = (red >= red_threshold) & (green <= 150)
    _logger.debug("Laplace: found %d pixels to replace", int(invalid.sum()))
    channels = np.moveaxis(np.asarray(image, dtype=np.float64), -1, 0)
    filled, _ = solve_matrix(channels, invalid, device=device)
    return np.moveaxis(filled, 0, -1)
