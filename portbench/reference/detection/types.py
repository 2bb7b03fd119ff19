# Frozen copy of satellite_approximation_tpu_torch/utils/types.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Small array statistics helpers
(``satellite_approximation_tpu/utils/types.py``).

Replaces the reference's lib/utils/include/utils/eigen.h (percent_non_zero,
count_non_zero). Rasters are numpy arrays or torch tensors in **top-left
row-major** (row, col) convention; geometry helpers embed the flip to the
reference's bottom-left convention where world coordinates are needed (see
ops/geometry.py).
"""

from __future__ import annotations

import numpy as np
import torch


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
