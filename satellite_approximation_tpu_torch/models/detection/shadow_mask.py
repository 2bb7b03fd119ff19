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

from ...config import ShadowMaskConfig
from ...device import as_tensor, divide, resolve_device
from ...ops.blur import gaussian_blur
from ...ops.masks import SCL, cover_percentage, fetch_mask, scl_mask
from ...ops.pitfill import pit_fill
from .placement import big_scene


@dataclasses.dataclass
class PotentialShadowMaskResult:
    mask: np.ndarray | torch.Tensor
    difference_of_pitfill_nir: np.ndarray | torch.Tensor
    pitfill_result: np.ndarray | torch.Tensor


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


def _scl_in_host(scl: np.ndarray, values) -> np.ndarray:
    out = np.zeros(scl.shape, bool)
    for v in values:
        out |= scl == int(v)
    return out


def _generate_host_native(nir, cloud_mask, scl, config) -> "PotentialShadowMaskResult | None":
    """Pure-host variant of the stage, pit fill via the native
    priority-flood (exact O(n log n)); None when the native lib is absent.
    Same formulas/summation order as the tensor kernel, and the same integer
    cover count."""
    from ...native import pit_fill_flood
    from ...ops.blur import gaussian_blur_host

    nir = np.asarray(nir, np.float32)
    cloud_mask = np.asarray(cloud_mask, bool)
    scl = np.asarray(scl)
    scl_shadow_dark = _scl_in_host(scl, (SCL.CLOUD_SHADOWS, SCL.DARK_AREA_PIXELS))
    selector = cloud_mask | _scl_in_host(
        scl, (SCL.CLOUD_SHADOWS, SCL.DARK_AREA_PIXELS, SCL.WATER)
    )
    cloud_cover = np.float32(cloud_mask.sum()) / np.float32(cloud_mask.size)
    percent = float(
        np.clip(
            np.float32(config.percentile_lo)
            + (cloud_cover - np.float32(config.cloud_cover_lo))
            * np.float32(config.percentile_hi - config.percentile_lo)
            / np.float32(config.cloud_cover_hi - config.cloud_cover_lo),
            np.float32(config.percentile_lo),
            np.float32(config.percentile_hi),
        )
    )
    count = int(selector.sum())
    x = int(np.float32(percent) * np.float32(count))
    if x < 1:
        outside = np.float32(0.0)
    elif x > count:
        outside = np.float32(1.0)
    else:
        vals = nir[selector]
        outside = np.partition(vals, x - 1)[x - 1]  # exact k-th smallest

    pitfilled = pit_fill_flood(nir, float(outside))
    if pitfilled is None:
        return None
    difference = pitfilled - nir
    prelim = difference >= np.float32(config.nir_difference_threshold)
    blurred = gaussian_blur_host((prelim | scl_shadow_dark).astype(np.float32), config.blur_sigma)
    mask = (blurred >= np.float32(config.blur_threshold)) & (~cloud_mask)
    return PotentialShadowMaskResult(
        mask=mask, difference_of_pitfill_nir=difference, pitfill_result=pitfilled
    )


def generate_potential_shadow_mask(
    nir,
    cloud_mask,
    scl,
    config: ShadowMaskConfig = ShadowMaskConfig(),
    device_output: bool = False,
    device=None,
) -> PotentialShadowMaskResult:
    """Full candidate-shadow stage (PotentialShadowMask.cpp:21-51).

    Three routes with identical semantics. Full-tile-class rasters: when
    ``nir`` is a HOST array and the native library is available, the whole
    stage runs on the host (priority-flood pit fill); otherwise on the
    device, where only the mask comes back to the host and the f32 rasters
    stay tensors for the device refinement. Small scenes run on the device
    and come back whole. Host rasters go to ``device`` (``None``: the CUDA
    device); tensors are processed where ``nir`` lies. ``device_output``
    keeps the mask there too."""
    big = big_scene(int(np.prod(nir.shape)))
    if isinstance(nir, np.ndarray) and big:
        host = _generate_host_native(nir, fetch_mask(cloud_mask), scl, config)
        if host is not None:
            return host

    dev = nir.device if isinstance(nir, torch.Tensor) else resolve_device(device)
    nir_t = as_tensor(nir, dev, torch.float32)
    cloud_t = as_tensor(cloud_mask, dev, torch.bool)
    scl_t = as_tensor(scl, dev)
    mask, diff, pitfilled = _potential_shadow_kernel(nir_t, cloud_t, scl_t, config)
    if big or device_output:
        return PotentialShadowMaskResult(
            mask=mask if device_output else fetch_mask(mask),
            difference_of_pitfill_nir=diff,
            pitfill_result=pitfilled,
        )
    return PotentialShadowMaskResult(
        mask=fetch_mask(mask),
        difference_of_pitfill_nir=diff.cpu().numpy(),
        pitfill_result=pitfilled.cpu().numpy(),
    )
