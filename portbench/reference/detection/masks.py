# Frozen copy of satellite_approximation_tpu_torch/ops/masks.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Mask & classification primitives (``satellite_approximation_tpu/ops/masks.py``).

Replaces the reference's elementwise CPU loops:
* Sentinel-2 Scene Classification Layer masks
  (lib/cloud_shadow_detection/source/SceneClassificationLayer.cpp:56-99),
* Threshold / NOT / AND / OR / normalize / CoverPercentage
  (lib/cloud_shadow_detection/source/ImageOperations.cpp:6-50,176-192).

The raster functions take torch tensors and run where the tensor lies.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .device import divide


class SCL(enum.IntEnum):
    """Sentinel-2 SCL class values (reference SceneClassificationLayer.h:5-17)."""

    NO_DATA = 0
    SATURATED_DEFECTIVE = 1
    DARK_AREA_PIXELS = 2
    CLOUD_SHADOWS = 3
    VEGETATION = 4
    BARE_SOIL = 5
    WATER = 6
    CLOUD_LOW = 7
    CLOUD_MEDIUM = 8
    CLOUD_HIGH = 9
    CLOUD_CIRRUS = 10
    SNOW_ICE = 11


# RGBA colours per class (reference SceneClassificationLayer.h:31-43), as
# 0xAABBGGRR words matching the reference's packing.
def scl_mask(scl: torch.Tensor, classes: tuple[SCL, ...] | frozenset[SCL]) -> torch.Tensor:
    """Boolean mask of pixels whose SCL class is in ``classes``.

    Vectorized form of SceneClassificationLayer::GenerateMask
    (SceneClassificationLayer.cpp:56-99).
    """
    values = sorted(int(c) for c in classes)
    out = torch.zeros(scl.shape, dtype=torch.bool, device=scl.device)
    for v in values:
        out = out | (scl == v)
    return out


def normalize(image: torch.Tensor, max_value: float) -> torch.Tensor:
    """Cast to f32 and divide by ``max_value`` (ImageOperations.h normalize).
    A correctly rounded f32 division, on the CPU and on a CUDA device."""
    return divide(image.to(torch.float32), max_value)


def threshold(image: torch.Tensor, value) -> torch.Tensor:
    """``image >= value`` (ImageOperations.cpp:6-27)."""
    return image >= value


def cover_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of true pixels (ImageOperations.cpp:176), an exact integer."""
    return torch.count_nonzero(mask)


def cover_percentage(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of true pixels, f32 (ImageOperations.cpp:178-186). The count
    is an integer, so it is exact past 2^24 pixels too, where a sum of f32
    ones is not; below 2^24 the two are equal."""
    return divide(cover_count(mask).to(torch.float32), mask.numel())


def fetch_mask(mask) -> np.ndarray:
    """A bool mask as a host ``np.bool_`` array: tensors are copied to the
    host as plain bytes, host arrays pass through untouched."""
    if isinstance(mask, np.ndarray):
        return mask.astype(bool, copy=False)
    return mask.to(torch.bool).cpu().numpy()
