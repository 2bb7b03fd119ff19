"""Dtype aliases and small array statistics helpers
(``satellite_approximation_tpu/utils/types.py``).

Replaces the reference's lib/utils/include/utils/types.h (u8..f64 aliases)
and lib/utils/include/utils/eigen.h (percent_non_zero / count_non_zero /
printable_stats). Rasters are numpy arrays or torch tensors in **top-left
row-major** (row, col) convention; geometry helpers embed the flip to the
reference's bottom-left convention where world coordinates are needed (see
ops/geometry.py).
"""

from __future__ import annotations

import numpy as np
import torch

# dtype aliases (reference utils/types.h:10-22)
u8 = np.uint8
u16 = np.uint16
u32 = np.uint32
i32 = np.int32
i64 = np.int64
f32 = np.float32
f64 = np.float64


def count_non_zero(a) -> int:
    """Number of non-zero (true) entries. Reference utils/eigen.h:14-18.
    A tensor is counted where it lies; only the count comes to the host."""
    if isinstance(a, torch.Tensor):
        return int(torch.count_nonzero(a))
    return int(np.asarray(a).astype(bool).sum())


def percent_non_zero(a) -> float:
    """Fraction of non-zero entries in [0,1]. Reference utils/eigen.h:8-12.
    The count is an exact integer at any raster size."""
    size = a.numel() if isinstance(a, torch.Tensor) else np.asarray(a).size
    if size == 0:
        return 0.0
    return float(count_non_zero(a) / size)


def printable_stats(a) -> str:
    """Min/max/mean summary string. Reference utils/eigen.h:20-24."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, dtype=np.float64)
    return f"min: {a.min():.6g}, max: {a.max():.6g}, mean: {a.mean():.6g}"
