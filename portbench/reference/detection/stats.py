# Frozen copy of satellite_approximation_tpu_torch/ops/stats.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Scalar statistics matching the reference's Functions.cpp semantics
(``satellite_approximation_tpu/ops/stats.py``)."""

from __future__ import annotations

import numpy as np
import torch


def percentile(values: np.ndarray, percent: float) -> float:
    """The reference's idiosyncratic percentile (Functions.cpp:29-35):
    sort, take element ``int(percent*n) - 1``; returns 0.0 when the index
    underflows and 1.0 when it overflows."""
    values = np.sort(np.asarray(values).ravel())
    n = values.size
    x = int(np.float32(percent) * np.float32(n))
    if x < 1:
        return 0.0
    if x > n:
        return 1.0
    return float(values[x - 1])


def masked_percentile(values: torch.Tensor, mask: torch.Tensor, percent: float) -> torch.Tensor:
    """:func:`percentile` over ``values[mask]`` at a static shape, on the
    tensors' device; returns a 0-d f32 tensor.

    Sorts the full array with masked-out entries pushed to +inf, then indexes
    element ``int(percent * count) - 1`` — identical semantics to the
    reference's partitionUnobscuredObscured + percentile pipeline
    (ImageOperations.h partitionUnobscuredObscured; Functions.cpp:29-35).
    """
    flat = values.reshape(-1).to(torch.float32)
    flat = torch.where(mask.reshape(-1), flat, torch.full_like(flat, torch.inf))
    ordered = torch.sort(flat).values
    count = torch.count_nonzero(mask)
    x = (count.to(torch.float32) * np.float32(percent).item()).to(torch.int64)
    value = ordered[torch.clamp(x - 1, 0, flat.numel() - 1)]
    value = torch.where(x < 1, torch.zeros_like(value), value)
    return torch.where(x > count, torch.ones_like(value), value)


def trimmed_average(values: np.ndarray, lo: float, hi: float) -> float:
    """Mean of the sorted slice [floor(lo*n), ceil(hi*n)] inclusive
    (Functions.cpp:212-230). NaN on empty input or inverted indices."""
    values = np.asarray(values, dtype=np.float32).ravel()
    n = values.size
    if n == 0:
        return float("nan")
    min_index = max(int(np.floor(lo * float(n))), 0)
    max_index = min(int(np.ceil(hi * float(n))), n - 1)
    if min_index > max_index:
        return float("nan")
    ordered = np.sort(values)
    return float(np.float32(ordered[min_index : max_index + 1].sum(dtype=np.float32)) / np.float32(max_index - min_index + 1))
