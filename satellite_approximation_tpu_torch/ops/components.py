"""Connected-component labelling without sequential BFS
(``satellite_approximation_tpu/ops/components.py``).

Replaces the reference's CPU flood fill (ImageOperations.cpp:52-109, used by
CloudMask::PartitionCloudMask at CloudMask.cpp:63-108) — and also supplies
the ``find_connected_components`` the reference *declares and unit-tests but
never implements* (lib/approx/include/approx/laplace.h:11-20;
tests/approximation.h:55-76).

:func:`connected_components` is the plain version: min-label propagation
over the 8-neighbourhood combined with pointer jumping (label <-
label[label]), which contracts label trees so the fixpoint is reached in
O(log(diameter)) sweeps instead of O(diameter); the host reads one "changed"
flag per sweep. :func:`label_components` gives the same labels: the plain
version for a CPU tensor, kernel 10 (``csrc/components.cu``, block-based
union-find) for a CUDA tensor, or it raises.

:func:`partition_labels` turns labels into reference-ordered compact ids
where the labels lie, with arrays sized by the regions: the roots ranked by a
prefix sum, each region's area, bbox and least scan key, one fetch of those,
and the id map written on the device. On a CUDA device its two passes over
the pixels are kernels of ``csrc/components.cu`` too. Each kernel launch
adds one to ``stencil_kernels.launch_counts`` under the wrapper's name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from . import stencil_kernels as K

_INT_MAX = 2**31 - 1
# the six per-region numbers of partition_labels, in the order region_stats
# returns them, with the value each starts from
_STATS = (("area", 0), ("row_min", _INT_MAX), ("row_max", -1), ("col_min", _INT_MAX),
          ("col_max", -1), ("key_min", _INT_MAX))


def connected_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Label connected true-regions of ``mask``.

    Returns an int32 (H, W) tensor where every pixel of a component holds the
    smallest flat index (r*W + c) in that component; background pixels hold
    H*W. Use :func:`partition_regions` for compact, reference-ordered ids.
    """
    if connectivity == 8:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
    elif connectivity == 4:
        offsets = ((-1, 0), (0, -1), (0, 1), (1, 0))
    else:
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    h, w = mask.shape
    n = h * w
    sentinel = torch.tensor(n, dtype=torch.int32, device=mask.device)
    flat_idx = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(h, w)
    labels = torch.where(mask, flat_idx, sentinel)

    def neighbour_min(lab):
        p = torch.full((h + 2, w + 2), n, dtype=torch.int32, device=mask.device)
        p[1 : h + 1, 1 : w + 1] = lab
        m = lab
        for dr, dc in offsets:
            m = torch.minimum(m, p[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w])
        return torch.where(mask, m, sentinel)

    new = neighbour_min(labels)
    while not torch.equal(new, labels):
        labels = new
        new = neighbour_min(labels)
        # pointer jumping: hop to the label of our label (gather); the
        # sentinel row maps to itself.
        flat = torch.cat([new.reshape(-1), sentinel.reshape(1)])
        new = torch.index_select(flat, 0, new.reshape(-1)).reshape(h, w)
        new = torch.where(mask, torch.minimum(new, labels), sentinel)
    return new


def label_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """The labels of :func:`connected_components` for a bool (H, W) mask:
    that plain version on the CPU, kernel 10 on a CUDA device (contiguous
    masks only)."""
    name = "label_components"
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    K._check(name, mask, (torch.bool,), (None, None))
    if not K._on_cuda(name, (mask,)):
        return connected_components(mask, connectivity)
    h, w = mask.shape
    if h * w >= _INT_MAX:
        raise ValueError(f"{name}: {h}x{w} pixels do not fit int32 labels")
    labels = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if labels.numel():
        rc = K._library().sat_label_components(
            K._ptr(mask), K._ptr(labels), h, w, int(connectivity == 8), K._stream())
        K._check_rc(rc, name)
        K.launch_counts[name] += 1
    return labels


def _rank_roots(labels: torch.Tensor) -> int:
    """In place: each root (the pixel whose label is its own flat index)
    takes -1 - its rank among the roots in flat order, a prefix sum over the
    roots' flags (``nonzero``, whose count comes to the host). Returns the
    number of roots."""
    flat = labels.view(-1)
    idx = torch.arange(flat.numel(), dtype=torch.int32, device=flat.device)
    roots = torch.nonzero(flat == idx).view(-1)
    del idx
    flat[roots] = -1 - torch.arange(roots.numel(), dtype=torch.int32, device=flat.device)
    return roots.numel()


def _pixel_ranks(labels: torch.Tensor):
    """(flat indices of the foreground, their regions' ranks), int64, of
    labels whose roots :func:`_rank_roots` ranked."""
    flat = labels.reshape(-1)
    pix = torch.nonzero(flat < flat.numel()).view(-1)
    lab = flat[pix]
    root = torch.where(lab < 0, lab, flat[lab.clamp(min=0).long()])
    return pix, (-1 - root).long()


def region_stats_plain(labels: torch.Tensor, regions: int) -> torch.Tensor:
    """(6, regions) int32: each region's area, row_min, row_max, col_min,
    col_max and least reference scan key ``col * H + (H - 1 - row)``, by
    rank, from ranked labels."""
    h, w = labels.shape
    pix, rank = _pixel_ranks(labels)
    rows, cols = pix // w, pix % w
    keys = {"row_min": rows, "row_max": rows, "col_min": cols, "col_max": cols,
            "key_min": cols * h + (h - 1 - rows)}
    out = [torch.bincount(rank, minlength=regions)]
    for name, start in _STATS[1:]:
        init = torch.full((regions,), start, dtype=torch.int64, device=labels.device)
        how = "amin" if name.endswith("min") else "amax"
        out.append(init.scatter_reduce_(0, rank, keys[name], how))
    return torch.stack(out).to(torch.int32)


def region_stats(labels: torch.Tensor, regions: int) -> torch.Tensor:
    """:func:`region_stats_plain` on the CPU; on a CUDA device one launch of
    ``region_stats_kernel``."""
    name = "region_stats"
    K._check(name, labels, (torch.int32,), (None, None))
    if not K._on_cuda(name, (labels,)):
        return region_stats_plain(labels, regions)
    h, w = labels.shape
    out = torch.tensor([start for _, start in _STATS], dtype=torch.int32, device=labels.device)
    out = out[:, None].repeat(1, regions)
    if regions:
        rc = K._library().sat_region_stats(K._ptr(labels), h, w, *map(K._ptr, out), K._stream())
        K._check_rc(rc, name)
        K.launch_counts[name] += 1
    return out


def region_ids_plain(labels: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """(H, W) int32: ``remap`` (int32, one entry a rank) of each pixel's
    region, -1 on the background."""
    pix, rank = _pixel_ranks(labels)
    ids = torch.full((labels.numel(),), -1, dtype=torch.int32, device=labels.device)
    ids[pix] = remap[rank]
    return ids.view(labels.shape)


def region_ids(labels: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """:func:`region_ids_plain` on the CPU; on a CUDA device one launch of
    ``region_ids_kernel``."""
    name = "region_ids"
    K._check(name, labels, (torch.int32,), (None, None))
    K._check(name, remap, (torch.int32,), (None,))
    if not K._on_cuda(name, (labels, remap)):
        return region_ids_plain(labels, remap)
    h, w = labels.shape
    ids = torch.empty_like(labels)
    if ids.numel():
        rc = K._library().sat_region_ids(K._ptr(labels), h, w, K._ptr(remap), K._ptr(ids),
                                         K._stream())
        K._check_rc(rc, name)
        K.launch_counts[name] += 1
    return ids


@dataclasses.dataclass
class Region:
    """One connected region: compact id + bbox (rows/cols) + area.

    Mirrors the reference's Pixels/CloudQuad bookkeeping (types.h:22-45,
    CloudMask.cpp:78-103) without materializing per-pixel lists.
    """

    id: int
    row_min: int
    row_max: int
    col_min: int
    col_max: int
    area: int


def partition_labels(labels: torch.Tensor, min_area: int = 1) -> tuple[torch.Tensor, list[Region]]:
    """Compact, reference-ordered ids from the labels of
    :func:`label_components`, where they lie: (id_map, regions), id_map an
    int32 (H, W) tensor on the labels' device, -1 off the regions of at least
    ``min_area`` pixels, ids in the order of each region's least reference
    scan key (as :func:`partition_regions`). ``labels`` is consumed: its roots
    are overwritten by their ranks.

    Every array but the id map has one entry a region; the six per-region
    numbers come to the host once."""
    h, w = labels.shape
    regions = _rank_roots(labels)
    area, rmin, rmax, cmin, cmax, kmin = region_stats(labels, regions).cpu().numpy()
    keep = np.flatnonzero(area >= min_area)
    keep = keep[np.argsort(kmin[keep], kind="stable")]
    remap = np.full(regions, -1, dtype=np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    id_map = region_ids(labels, as_tensor(remap, labels.device))
    return id_map, [
        Region(id=i, row_min=int(rmin[k]), row_max=int(rmax[k]), col_min=int(cmin[k]),
               col_max=int(cmax[k]), area=int(area[k]))
        for i, k in enumerate(keep)
    ]


def partition_regions(
    mask: np.ndarray | torch.Tensor,
    min_area: int = 1,
    connectivity: int = 8,
    device=None,
) -> tuple[np.ndarray, list[Region]]:
    """Partition a mask into regions with reference-ordered compact ids.

    Returns (id_map, regions): id_map is int32 (H, W) with the compact region
    id per pixel (-1 for background or regions below ``min_area``); ids are
    assigned in the reference's scan order — column-major, bottom row first
    (CloudMask.cpp:73-76 scans i over cols, j over rows in the bottom-left
    convention) — so cloud ids match the reference's CN numbering exactly.

    Host masks with the native library available take the C++ BFS flood
    (reference scan order). Otherwise :func:`label_components` and
    :func:`partition_labels` run where a tensor lies (kernel 10 on a CUDA
    device, the plain propagation on the CPU), a host mask on ``device``
    (``None``: the CUDA device, raises without one).
    """
    if connectivity == 8 and isinstance(mask, np.ndarray):
        from ..native import flood_partition as _native_flood

        res = _native_flood(np.asarray(mask, dtype=bool), min_area)
        if res is not None:
            id_map, n_regions = res
            return id_map, _regions_from_labels(id_map, n_regions)

    if not isinstance(mask, torch.Tensor):
        mask = as_tensor(np.asarray(mask, bool), resolve_device(device))
    labels = label_components(mask.to(torch.bool).contiguous(), connectivity)
    id_map, regions = partition_labels(labels, min_area)
    return id_map.cpu().numpy(), regions


def _regions_from_labels(id_map: np.ndarray, n_regions: int) -> list[Region]:
    """Region records (bbox + area) from a compact label map."""
    from scipy import ndimage

    areas = np.bincount(id_map[id_map >= 0].ravel(), minlength=n_regions)
    slices = ndimage.find_objects(id_map + 1)
    regions = []
    for i in range(n_regions):
        sl = slices[i]
        regions.append(
            Region(
                id=i,
                row_min=int(sl[0].start),
                row_max=int(sl[0].stop - 1),
                col_min=int(sl[1].start),
                col_max=int(sl[1].stop - 1),
                area=int(areas[i]),
            )
        )
    return regions
