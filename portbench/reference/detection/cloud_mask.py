# Frozen copy of satellite_approximation_tpu_torch/models/detection/cloud_mask.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Cloud mask generation + partitioning into cloud objects
(``satellite_approximation_tpu/models/detection/cloud_mask.py``).

Rebuild of lib/cloud_shadow_detection/source/CloudMask.cpp. The OpenCL blur,
OpenCV morphology (ellipse dilate r=15, close r=5, 11x11 Gaussian) and CPU
flood fill become torch ops on the rasters' device and the log-depth
connected components pass of ``components.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import CloudMaskConfig
from .device import as_tensor, resolve_device
from . import geometry
from .blur import gaussian_blur
from .components import Region, partition_regions
from .masks import SCL, fetch_mask, scl_mask
from .morphology import close, cv_gaussian_blur, dilate


@dataclasses.dataclass
class GeneratedCloudMask:
    """Outputs of cloud-mask generation (CloudMask.h GeneratedCloudMask),
    host arrays."""

    cloud_mask: np.ndarray  # processed (dilated/closed/blurred) mask
    cloud_mask_no_processing: np.ndarray  # raw threshold mask
    blended_cloud_probability: np.ndarray  # sigma=4 blurred CLP


def _cloud_mask_kernel(clp, cld, scl, config: CloudMaskConfig):
    blended = gaussian_blur(clp, config.clp_blur_sigma)
    mask = (blended >= config.clp_threshold) & (cld >= config.cld_threshold)
    mask = mask | scl_mask(scl, (SCL.CLOUD_MEDIUM, SCL.CLOUD_HIGH))
    # image-processing cleanup (CloudMask.cpp:42-58): dilate to catch
    # boundary clouds the SCL misses, close to fill holes, blur the edges.
    processed = dilate(mask, config.dilation_radius)
    processed = close(processed, config.close_radius)
    blurred = cv_gaussian_blur(processed.to(torch.float32), config.cleanup_blur_ksize)
    # OpenCV blurs the u8 0/1 image and rounds back to u8 (round-half-even);
    # any nonzero rounded value is true.
    processed = torch.round(blurred) > 0
    return mask, processed, blended


def _inputs(clp, cld, scl, device):
    dev = clp.device if isinstance(clp, torch.Tensor) else resolve_device(device)
    return (as_tensor(clp, dev, torch.float32), as_tensor(cld, dev, torch.float32),
            as_tensor(scl, dev))


def generate_cloud_mask_ignore_low_probability(
    clp, cld, scl,
    config: CloudMaskConfig = CloudMaskConfig(),
    device=None,
) -> GeneratedCloudMask:
    """The variant ``detect`` uses (CloudMask.cpp:30-61): threshold blurred
    CLP & CLD, OR with SCL medium/high cloud classes, then morphological
    cleanup. Returns both the processed and the raw mask, on the host.

    Host rasters go to ``device`` (``None``: the CUDA device); tensors are
    processed where ``clp`` lies."""
    mask, processed, blended = _cloud_mask_kernel(*_inputs(clp, cld, scl, device), config)
    return GeneratedCloudMask(
        cloud_mask=fetch_mask(processed),
        cloud_mask_no_processing=fetch_mask(mask),
        blended_cloud_probability=blended.cpu().numpy(),
    )


@dataclasses.dataclass
class CloudObject:
    """One cloud: compact id, pixel bbox, area, world-space quad
    (CloudMask.cpp:78-103; quad corner offsets .1/.9)."""

    id: int
    region: Region
    quad: geometry.Quad
    # bbox in the reference's (x, y-from-bottom) coordinates
    min_x: int
    max_x: int
    min_y: int
    max_y: int


def partition_cloud_mask(
    cloud_mask, diagonal_length: float, min_cloud_area: int, device=None
) -> tuple[np.ndarray, list[CloudObject]]:
    """Partition the mask into cloud objects with world-space quads
    (CloudMask.cpp:63-108). Returns (id_map, clouds); id_map holds the
    compact cloud id per pixel (-1 elsewhere), ids in the reference's
    bottom-left column-major discovery order.

    The label propagation of ``components.py`` runs on ``device`` (``None``:
    where a tensor mask lies, the CUDA device for a host mask)."""
    if device is None and isinstance(cloud_mask, torch.Tensor):
        device = cloud_mask.device
    mask = fetch_mask(cloud_mask)
    h, w = mask.shape
    id_map, regions = partition_regions(
        mask, min_area=min_cloud_area, connectivity=8, device=device)

    clouds = []
    for r in regions:
        min_x, max_x = r.col_min, r.col_max
        min_y, max_y = h - 1 - r.row_max, h - 1 - r.row_min
        quad = geometry.Quad(
            p00=geometry.pixel_to_world((h, w), diagonal_length, min_x, min_y, 0.1, 0.1),
            p01=geometry.pixel_to_world((h, w), diagonal_length, max_x, min_y, 0.9, 0.1),
            p10=geometry.pixel_to_world((h, w), diagonal_length, max_x, max_y, 0.9, 0.9),
            p11=geometry.pixel_to_world((h, w), diagonal_length, min_x, max_y, 0.1, 0.9),
        )
        clouds.append(
            CloudObject(
                id=r.id, region=r, quad=quad,
                min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
            )
        )
    return id_map, clouds
