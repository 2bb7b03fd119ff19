"""Cloud mask generation + partitioning into cloud objects
(``satellite_approximation_tpu/models/detection/cloud_mask.py``).

Rebuild of lib/cloud_shadow_detection/source/CloudMask.cpp. The OpenCL blur,
OpenCV morphology (ellipse dilate r=15, close r=5, 11x11 Gaussian) and CPU
flood fill become torch ops on the rasters' device + the host flood, or the
labelling of ops/components.py where the mask lies on a CUDA device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import CloudMaskConfig
from ...device import as_tensor, resolve_device
from ...ops import geometry
from ...ops.blur import gaussian_blur
from ...ops.components import Region, label_components, partition_labels, partition_regions
from ...ops.masks import SCL, fetch_mask, scl_mask
from ...ops.morphology import close, cv_gaussian_blur, dilate
from ...utils import profiling


@dataclasses.dataclass
class GeneratedCloudMask:
    """Outputs of cloud-mask generation (CloudMask.h GeneratedCloudMask);
    host arrays, or tensors with ``device_output``."""

    cloud_mask: np.ndarray | torch.Tensor  # processed (dilated/closed/blurred) mask
    cloud_mask_no_processing: np.ndarray | torch.Tensor  # raw threshold mask
    blended_cloud_probability: np.ndarray | torch.Tensor  # sigma=4 blurred CLP


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
    device_output: bool = False,
    device=None,
) -> GeneratedCloudMask:
    """The variant ``detect`` uses (CloudMask.cpp:30-61): threshold blurred
    CLP & CLD, OR with SCL medium/high cloud classes, then morphological
    cleanup. Returns both the processed and the raw mask.

    Host rasters go to ``device`` (``None``: the CUDA device); tensors are
    processed where ``clp`` lies. ``device_output`` keeps all three rasters
    there (the all-device pipeline route: downstream stages consume them in
    place); otherwise they come back as host arrays."""
    mask, processed, blended = _cloud_mask_kernel(*_inputs(clp, cld, scl, device), config)
    if device_output:
        return GeneratedCloudMask(
            cloud_mask=processed,
            cloud_mask_no_processing=mask,
            blended_cloud_probability=blended,
        )
    return GeneratedCloudMask(
        cloud_mask=fetch_mask(processed),
        cloud_mask_no_processing=fetch_mask(mask),
        blended_cloud_probability=blended.cpu().numpy(),
    )


def _cloud_mask_simple_kernel(clp, cld, scl, config: CloudMaskConfig):
    blended = gaussian_blur(clp, config.clp_blur_sigma)
    mask = (blended >= config.clp_threshold) & (cld >= config.cld_threshold)
    mask = mask | scl_mask(scl, (SCL.CLOUD_LOW, SCL.CLOUD_MEDIUM, SCL.CLOUD_HIGH))
    mask = gaussian_blur(mask.to(torch.float32), config.post_blur_sigma) >= config.post_blur_threshold
    return mask, blended


def generate_cloud_mask(
    clp, cld, scl,
    config: CloudMaskConfig = CloudMaskConfig(),
    device=None,
) -> GeneratedCloudMask:
    """The low-probability-inclusive variant (CloudMask.cpp:17-28)."""
    mask, blended = _cloud_mask_simple_kernel(*_inputs(clp, cld, scl, device), config)
    mask = fetch_mask(mask)
    return GeneratedCloudMask(
        cloud_mask=mask,
        cloud_mask_no_processing=mask.copy(),
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
) -> tuple[np.ndarray | torch.Tensor, list[CloudObject]]:
    """Partition the mask into cloud objects with world-space quads
    (CloudMask.cpp:63-108). Returns (id_map, clouds); id_map holds the
    compact cloud id per pixel (-1 elsewhere), ids in the reference's
    bottom-left column-major discovery order, and lies where the mask lies.

    A tensor mask is partitioned where it lies (``ops.components``:
    kernel 10 on a CUDA device, the plain label propagation on the CPU),
    its id map an int32 tensor there. A host mask takes the native flood;
    without the native library the label propagation runs on ``device``
    (``None``: the CUDA device) and the id map comes to the host.

    Under an open span it counts ``regions`` (the clouds kept) and
    ``on_device`` (1 where kernel 10 labelled the mask)."""
    h, w = cloud_mask.shape
    if isinstance(cloud_mask, torch.Tensor):
        id_map, regions = partition_labels(
            label_components(cloud_mask.to(torch.bool).contiguous()), min_cloud_area)
    else:
        id_map, regions = partition_regions(
            np.asarray(cloud_mask, bool), min_area=min_cloud_area, connectivity=8, device=device)
    profiling.count("regions", len(regions))
    profiling.count("on_device", int(isinstance(cloud_mask, torch.Tensor)
                                     and cloud_mask.device.type == "cuda"))

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
