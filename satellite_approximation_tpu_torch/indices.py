"""Spectral indices (NDVI / NDMI / mNDWI / SWI).

Rebuild of lib/utils/{indices.h,indices.cpp} — including ``compute_index``,
which exists in the reference only as a fully commented-out block
(indices.cpp:37-88); here it is implemented for real: normalized-difference
raster math with 0/0 -> 0, cached to ``<folder>/<INDEX>.tif`` with geo
metadata copied from a template file.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from .utils.geotiff import GeoTIFF, write_geotiff


class Indices(enum.Enum):
    NDVI = "NDVI"
    NDMI = "NDMI"
    mNDWI = "mNDWI"
    SWI = "SWI"


def from_str(s: str) -> Indices | None:
    try:
        return Indices[s]
    except KeyError:
        return None


def required_files(index: Indices) -> list[str]:
    """Bands needed per index (indices.cpp:12-27)."""
    return {
        Indices.NDVI: ["B08", "B04"],
        Indices.NDMI: ["B08", "B11"],
        Indices.mNDWI: ["B03", "B11"],
        Indices.SWI: ["B03", "B08", "B11"],
    }[index]


def missing_files(files: list[str], index: Indices) -> bool:
    """True when any required band is absent (indices.cpp:29-36)."""
    return any(band not in files for band in required_files(index))


def _finite_or_zero(a: np.ndarray) -> np.ndarray:
    return np.where(np.isfinite(a), a, 0.0)


def _normalized_difference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return _finite_or_zero((a - b) / (a + b))


def compute_index(
    folder: Path | str,
    template_path: Path | str,
    index: Indices,
    use_cache: bool = True,
) -> np.ndarray:
    """Compute (and cache) an index raster for a date folder
    (implements the commented-out indices.cpp:37-88)."""
    folder = Path(folder)
    out_path = folder / f"{index.value}.tif"
    if use_cache and out_path.exists():
        return GeoTIFF.open(out_path).read().astype(np.float64)

    def band(name: str) -> np.ndarray:
        return GeoTIFF.open(folder / f"{name}.tif").read().astype(np.float64)

    if index == Indices.NDVI:
        values = _normalized_difference(band("B08"), band("B04"))
    elif index == Indices.NDMI:
        values = _normalized_difference(band("B08"), band("B11"))
    elif index == Indices.mNDWI:
        values = _normalized_difference(band("B03"), band("B11"))
    elif index == Indices.SWI:
        green, nir, swir = band("B03"), band("B08"), band("B11")
        with np.errstate(divide="ignore", invalid="ignore"):
            values = _finite_or_zero(
                green * (nir - swir) / ((green + nir) * (nir + swir))
            )
    else:
        raise ValueError(f"Unhandled index: {index}")

    write_geotiff(values.astype(np.float32), out_path, template_path=template_path)
    return values
