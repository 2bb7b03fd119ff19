"""Shadow-mask accuracy scoring against a baseline mask.

Rebuild of lib/cloud_shadow_detection/source/ShadowMaskEvaluation.cpp:
confusion-matrix error rates (total & relative), producer's/user's accuracy,
a per-pixel class image, and the casted-image evaluation bounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...ops import geometry

# class values (ShadowMaskEvaluation.h Results)
UNKNOWN_CLASS = 0
TRUE_NEGATIVE_CLASS = 1
TRUE_POSITIVE_CLASS = 2
FALSE_NEGATIVE_CLASS = 3
FALSE_POSITIVE_CLASS = 4
CLOUDS_CLASS = 5

CLASS_COLOURS = {
    UNKNOWN_CLASS: 0xFF000000,
    TRUE_NEGATIVE_CLASS: 0xFF00FF00,
    TRUE_POSITIVE_CLASS: 0xFFFF0000,
    FALSE_NEGATIVE_CLASS: 0xFF0000FF,
    FALSE_POSITIVE_CLASS: 0xFFFF00FF,
    CLOUDS_CLASS: 0xFFFFFFFF,
}


@dataclasses.dataclass
class EvaluationResults:
    pixel_classes: np.ndarray
    positive_error_total: float = 0.0
    negative_error_total: float = 0.0
    error_total: float = 0.0
    positive_error_relative: float = 0.0
    negative_error_relative: float = 0.0
    error_relative: float = 0.0
    producers_accuracy: float = 0.0
    users_accuracy: float = 0.0


def _sub_cover_count(mask: np.ndarray, bounds: tuple[int, int, int, int]) -> int:
    """Count inside half-open (x, y-from-bottom) bounds, matching the
    reference's SubCoverCount loop limits (ImageOperations.cpp:188-201)."""
    x0, y0, x1, y1 = bounds
    h, w = mask.shape
    flipped = np.flipud(mask)
    xs0, xs1 = max(0, x0), min(w - 1, x1)
    ys0, ys1 = max(0, y0), min(h - 1, y1)
    if xs1 <= xs0 or ys1 <= ys0:
        return 0
    return int(flipped[ys0:ys1, xs0:xs1].sum())


def evaluate(
    shadow_mask: np.ndarray,
    cloud_mask: np.ndarray,
    shadow_baseline: np.ndarray,
    evaluation_bounds: tuple[int, int, int, int],
) -> EvaluationResults:
    """Confusion-matrix scoring (ShadowMaskEvaluation.cpp:9-69).
    ``evaluation_bounds`` is (x0, y0, x1, y1) in bottom-origin coordinates."""
    not_cloud = ~cloud_mask
    valid_shadow = shadow_mask & not_cloud
    valid_base = shadow_baseline & not_cloud
    valid_not_shadow = ~shadow_mask & not_cloud
    valid_not_base = ~shadow_baseline & not_cloud

    tp = valid_shadow & valid_base
    tn = valid_not_shadow & valid_not_base
    fp = valid_shadow & valid_not_base
    fn = valid_not_shadow & valid_base
    any_shadow = valid_shadow | valid_base

    x0, y0, x1, y1 = evaluation_bounds
    n_total = float((x1 - x0 + 1) * (y1 - y0 + 1))
    n_rel = float(_sub_cover_count(any_shadow, evaluation_bounds))
    n_fp = float(_sub_cover_count(fp, evaluation_bounds))
    n_fn = float(_sub_cover_count(fn, evaluation_bounds))
    n_false = n_fp + n_fn

    res = EvaluationResults(pixel_classes=np.zeros(shadow_mask.shape, dtype=np.uint32))
    res.positive_error_total = n_fp / n_total
    res.negative_error_total = n_fn / n_total
    res.error_total = n_false / n_total
    res.positive_error_relative = n_fp / n_rel if n_rel else 0.0
    res.negative_error_relative = n_fn / n_rel if n_rel else 0.0
    res.error_relative = n_false / n_rel if n_rel else 0.0
    res.producers_accuracy = (
        (1.0 - res.error_relative) / (1.0 - res.positive_error_relative)
        if res.positive_error_relative != 1.0
        else 0.0
    )
    res.users_accuracy = (
        (1.0 - res.error_relative) / (1.0 - res.negative_error_relative)
        if res.negative_error_relative != 1.0
        else 0.0
    )

    classes = res.pixel_classes
    classes[tn] += TRUE_NEGATIVE_CLASS
    classes[tp] += TRUE_POSITIVE_CLASS
    classes[fn] += FALSE_NEGATIVE_CLASS
    classes[fp] += FALSE_POSITIVE_CLASS
    classes[cloud_mask] += CLOUDS_CLASS
    return res


def generate_rgba(classes: np.ndarray) -> np.ndarray:
    """Class image → packed RGBA (ShadowMaskEvaluation.cpp:72-96)."""
    out = np.full(classes.shape, CLASS_COLOURS[UNKNOWN_CLASS], dtype=np.uint32)
    for cls, colour in CLASS_COLOURS.items():
        out[classes == cls] = colour
    return out


def casted_image_bounds(
    shape_hw: tuple[int, int],
    diagonal: float,
    sun_pos: np.ndarray,
    view_pos: np.ndarray,
    height: float,
) -> tuple[int, int, int, int]:
    """Project the whole image quad through sun/view to bound the evaluable
    region (ShadowMaskEvaluation.cpp:98-134). Returns clamped
    (x0, y0, x1, y1) in bottom-origin coordinates."""
    h, w = shape_hw
    quad = geometry.Quad(
        p00=geometry.pixel_to_world(shape_hw, diagonal, 0, 0, 0.1, 0.1),
        p01=geometry.pixel_to_world(shape_hw, diagonal, w - 1, 0, 0.9, 0.1),
        p10=geometry.pixel_to_world(shape_hw, diagonal, w - 1, h - 1, 0.9, 0.9),
        p11=geometry.pixel_to_world(shape_hw, diagonal, 0, h - 1, 0.1, 0.9),
    )
    quad = geometry.perspective(
        quad, view_pos, np.array([0.0, 0.0, height]), np.array([0.0, 0.0, 1.0])
    )
    quad = geometry.perspective(
        quad, sun_pos, np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])
    )
    idx = geometry.world_to_index(shape_hw, diagonal, quad.corners())
    x0 = int(np.clip(idx[:, 0].min(), 0, w - 1))
    y0 = int(np.clip(idx[:, 1].min(), 0, h - 1))
    x1 = int(np.clip(idx[:, 0].max(), 0, w - 1))
    y1 = int(np.clip(idx[:, 1].max(), 0, h - 1))
    return (x0, y0, x1, y1)
