"""Misc image operations completing ImageOperations.h parity
(``satellite_approximation_tpu/ops/image.py``).

The heavily used primitives live in ops/masks.py and ops/geometry.py; this
module carries the remaining surface: obscure, partitioning, angle
conversion, sub-window cover counting, bottom-left accessors for callers
porting reference code verbatim.
"""

from __future__ import annotations

import numpy as np
import torch


def obscure(image: torch.Tensor, mask: torch.Tensor, replace) -> torch.Tensor:
    """Replace masked pixels with a constant (ImageOperations.h obscure)."""
    return torch.where(mask, torch.as_tensor(replace, dtype=image.dtype, device=image.device), image)


def partition_unobscured_obscured(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Values of ``image`` where ``mask`` is true — yes, where TRUE: the
    reference's selector reads inverted but this is its actual behaviour
    (ImageOperations.h partitionUnobscuredObscured, used at
    PotentialShadowMask.cpp:29-31)."""
    return np.asarray(image)[np.asarray(mask, bool)]


def to_degrees(a: torch.Tensor) -> torch.Tensor:
    """Radians -> degrees (ImageOperations.cpp:128-134)."""
    return torch.rad2deg(a)


def to_radians(a: torch.Tensor) -> torch.Tensor:
    """Degrees -> radians (ImageOperations.cpp:136-142)."""
    return torch.deg2rad(a)


def sub_cover_count(mask: np.ndarray, bounds: tuple[int, int, int, int]) -> int:
    """Count of set pixels inside half-open bottom-origin (x0,y0,x1,y1)
    bounds, matching the reference's loop limits
    (ImageOperations.cpp:188-201)."""
    x0, y0, x1, y1 = bounds
    h, w = mask.shape
    flipped = np.flipud(np.asarray(mask, bool))
    xs0, xs1 = max(0, x0), min(w - 1, x1)
    ys0, ys1 = max(0, y0), min(h - 1, y1)
    if xs1 <= xs0 or ys1 <= ys0:
        return 0
    return int(flipped[ys0:ys1, xs0:xs1].sum())


def at(a: np.ndarray, i: int, j: int):
    """Bottom-left accessor for verbatim ports of reference code:
    at(A, i, j) == A[rows-1-j, i] (ImageOperations.h:24-45)."""
    return a[a.shape[0] - 1 - j, i]


def set_at(a: np.ndarray, i: int, j: int, v) -> None:
    a[a.shape[0] - 1 - j, i] = v
