"""The plain reference of ``detect``: the stages of the port's
``models/detection/pipeline.py::detect`` (at the time the benchmark was
defined), each on its plain host route, without files, worker threads or a
mesh, whatever the size of the scene.

No stage runs the code of the route the program times on a tile-sized
scene (the device geometry, the bucketed device sweep, the torch beta map
and refinement), nor that of its native C++ library on a small one. The
cloud and potential-shadow masks are torch ops where the rasters lie (the
pit fill sweeps to its fixpoint without kernel 9's directional cycles);
the cloud partition labels by propagation; the sun and view points are the
chunked numpy reduction; the matching is this package's own scan
(``matching.py``); alpha, beta, the probability surface and the final mask
are numpy and scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cloud_mask as cm
from . import geometry, matching, refinement
from . import shadow_mask as sm
from .config import DEFAULT_DETECTION
from .device import as_tensor, divide
from .types import percent_non_zero

MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")


def _normalized(raw: np.ndarray, max_value: float, dev) -> torch.Tensor:
    """An integer raster over ``max_value`` in f32 on ``dev`` (one correctly
    rounded division a value)."""
    if raw.dtype == np.uint8:
        values = as_tensor(raw, dev)
    else:
        values = as_tensor(raw.view(np.int16), dev).to(torch.int32) & 0xFFFF
    return divide(values.to(torch.float32), max_value)


def detect_masks(inputs: dict, diagonal: float, device, lower=None,
                 config=DEFAULT_DETECTION) -> dict:
    """The four masks (host bool arrays, keyed as the program's files) and
    the Status numbers of one scene. ``lower``: a dtype that the normalized
    rasters are rounded through (the control)."""
    dev = torch.device(device)
    clp = _normalized(inputs["CLP"], 255, dev)
    cld = _normalized(inputs["CLD"], 100, dev)
    nir = _normalized(inputs["B08"], np.iinfo(np.uint16).max, dev)
    if lower is not None:
        clp, cld, nir = (x.to(lower).to(torch.float32) for x in (clp, cld, nir))
    scl = as_tensor(inputs["SCL"], dev)
    shape = tuple(clp.shape)

    generated = cm.generate_cloud_mask_ignore_low_probability(clp, cld, scl, config.cloud_mask)
    percent_clouds = percent_non_zero(generated.cloud_mask)
    cloud_map, clouds = cm.partition_cloud_mask(
        generated.cloud_mask_no_processing, diagonal, config.min_cloud_size_for_ray_casting,
        device=dev)
    psm = sm.generate_potential_shadow_mask(
        nir, generated.cloud_mask_no_processing, scl, config.shadow_mask)
    del clp, cld, nir, scl

    angles = {k: np.asarray(inputs[k], np.float32) for k in (
        "sunZenithAngles", "sunAzimuthAngles", "viewZenithMean", "viewAzimuthMean")}
    sun_pos = geometry.ls_point_equal_to_chunked(
        angles["sunZenithAngles"], angles["sunAzimuthAngles"], shape, diagonal,
        config.distance_to_sun_km)
    view_pos = geometry.ls_point_equal_to_chunked(
        angles["viewZenithMean"], angles["viewAzimuthMean"], shape, diagonal,
        config.distance_to_view_km)

    match = matching.match_clouds_shadows(
        clouds, cloud_map, generated.cloud_mask_no_processing, psm.mask, diagonal,
        sun_pos, view_pos, config.matching, device=dev)

    rc = config.refinement
    alpha = refinement.alpha_map(psm.difference_of_pitfill_nir, rc)
    beta = refinement.beta_map(
        match.shadows, match.solutions, generated.blended_cloud_probability, diagonal, rc)
    surface = refinement.probability_map(match.shadow_mask, alpha, beta, rc)
    final = refinement.improved_shadow_mask(
        match.shadow_mask, generated.cloud_mask, alpha, beta, surface,
        config.probability_threshold)

    masks = dict(zip(MASKS, (generated.cloud_mask, psm.mask, match.shadow_mask, final)))
    return {
        "masks": masks,
        "percent_clouds": percent_clouds,
        "percent_shadows": percent_non_zero(final),
        "percent_invalid": percent_non_zero(masks["cloud_mask"] | masks["shadow_mask"]),
    }
