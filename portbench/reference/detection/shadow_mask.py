# Frozen copy of satellite_approximation_tpu_torch/models/detection/shadow_mask.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Potential (candidate) shadow mask from pit-filled NIR darkness
(``satellite_approximation_tpu/models/detection/shadow_mask.py``).

Rebuild of lib/cloud_shadow_detection/source/PotentialShadowMask.cpp:21-51:
pick a clear-sky NIR reference level (percentile chosen by cloud cover via a
linear ramp), flood every NIR pit up to that level, and flag pixels whose
fill depth exceeds 0.02 — OR'd with SCL shadow/dark classes, blurred, and
cut away from clouds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import ShadowMaskConfig
from .device import as_tensor, divide, resolve_device
from .blur import gaussian_blur
from .masks import SCL, cover_percentage, fetch_mask, scl_mask
from .pitfill import pit_fill


@dataclasses.dataclass
class PotentialShadowMaskResult:
    mask: np.ndarray
    difference_of_pitfill_nir: np.ndarray


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the Python float a tensor op takes."""
    return np.float32(x).item()


def _psm_pre(nir, cloud_mask, scl, config: ShadowMaskConfig):
    """(outside_value, scl_shadow_dark) — everything before the pit fill."""
    scl_shadow_dark = scl_mask(scl, (SCL.CLOUD_SHADOWS, SCL.DARK_AREA_PIXELS))
    scl_shadow_dark_water = scl_mask(
        scl, (SCL.CLOUD_SHADOWS, SCL.DARK_AREA_PIXELS, SCL.WATER)
    )

    # The reference's partitionUnobscuredObscured collects NIR values where
    # the combined mask is TRUE (ImageOperations.h; PotentialShadowMask.cpp:29-31)
    # — faithfully reproduced, surprising as the selector reads.
    selector = cloud_mask | scl_shadow_dark_water
    cloud_cover = cover_percentage(cloud_mask)
    percent = torch.clamp(
        _f32(config.percentile_lo)
        + divide(
            (cloud_cover - _f32(config.cloud_cover_lo))
            * _f32(config.percentile_hi - config.percentile_lo),
            config.cloud_cover_hi - config.cloud_cover_lo,
        ),
        _f32(config.percentile_lo),
        _f32(config.percentile_hi),
    )  # linearStep((.07,.4)->(.2,.7)) (PotentialShadowMask.cpp:32-34)
    outside_value = _dynamic_percentile(nir, selector, percent)
    return outside_value, scl_shadow_dark


def _psm_post(nir, pitfilled, scl_shadow_dark, cloud_mask, config: ShadowMaskConfig):
    """(mask, difference) — everything after the pit fill."""
    difference = pitfilled - nir
    prelim = difference >= config.nir_difference_threshold
    blurred = gaussian_blur((prelim | scl_shadow_dark).to(torch.float32), config.blur_sigma)
    mask = (blurred >= config.blur_threshold) & (~cloud_mask)
    return mask, difference


def _potential_shadow_kernel(nir, cloud_mask, scl, config: ShadowMaskConfig):
    outside_value, scl_shadow_dark = _psm_pre(nir, cloud_mask, scl, config)
    pitfilled = pit_fill(nir, outside_value)
    mask, difference = _psm_post(nir, pitfilled, scl_shadow_dark, cloud_mask, config)
    return mask, difference, pitfilled


def _dynamic_percentile(values, mask, percent):
    """masked_percentile with ``percent`` a 0-d f32 tensor (same semantics as
    Functions.cpp:29-35); returns a 0-d f32 tensor and reads nothing on the
    host.

    The k-th order statistic is selected by BISECTION OVER THE f32 BIT
    SPACE instead of a sort: for non-negative floats the IEEE bit pattern
    is order-isomorphic to the value, so 32 masked count-reductions find
    the smallest attained value v with count(values <= v) >= k — exactly
    the sorted selection, for any f32 data, in O(1) memory where a sort of
    a full-tile raster (120M elements) is O(n log n) work."""
    # The bit-space bisection below is order-isomorphic only for
    # NON-NEGATIVE finite floats (negative IEEE bit patterns sort above
    # positives as int32, and lo starts at +0.0). Clamp so a future caller
    # with signed data degrades to "percentile of max(x, 0)" instead of a
    # silently wrong selection; NIR/probability inputs are >= 0 already.
    flat = torch.clamp_min(values.reshape(-1).to(torch.float32), 0.0)
    valid = mask.reshape(-1)
    count = torch.count_nonzero(valid)
    x = (percent.to(torch.float32) * count.to(torch.float32)).to(torch.int64)
    k = torch.clamp_min(x, 1)

    bits = flat.view(torch.int32)
    # masked-out entries sit above every candidate, so each pass is one compare
    bits = torch.where(valid, bits, torch.full_like(bits, 0x7FFFFFFF))
    lo = torch.zeros((), dtype=torch.int32, device=flat.device)
    hi = torch.full((), 0x7F800000, dtype=torch.int32, device=flat.device)
    for _ in range(32):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        take_left = torch.count_nonzero(bits <= mid) >= k
        lo, hi = torch.where(take_left, lo, mid + 1), torch.where(take_left, mid, hi)
    value = lo.view(torch.float32)
    value = torch.where(x < 1, torch.zeros_like(value), value)
    return torch.where(x > count, torch.ones_like(value), value)


def generate_potential_shadow_mask(
    nir,
    cloud_mask,
    scl,
    config: ShadowMaskConfig = ShadowMaskConfig(),
    device=None,
) -> PotentialShadowMaskResult:
    """Full candidate-shadow stage (PotentialShadowMask.cpp:21-51), on the
    device of ``nir`` (a host ``nir`` on ``device``; ``None``: the CUDA
    device); the mask and the difference come back as host arrays."""
    dev = nir.device if isinstance(nir, torch.Tensor) else resolve_device(device)
    nir_t = as_tensor(nir, dev, torch.float32)
    cloud_t = as_tensor(cloud_mask, dev, torch.bool)
    scl_t = as_tensor(scl, dev)
    mask, diff, _ = _potential_shadow_kernel(nir_t, cloud_t, scl_t, config)
    return PotentialShadowMaskResult(mask=fetch_mask(mask), difference_of_pitfill_nir=diff.cpu().numpy())
