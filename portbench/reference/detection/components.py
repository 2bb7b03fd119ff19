# Frozen copy of satellite_approximation_tpu_torch/ops/components.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Connected-component labeling without sequential BFS
(``satellite_approximation_tpu/ops/components.py``).

Replaces the reference's CPU flood fill (ImageOperations.cpp:52-109, used by
CloudMask::PartitionCloudMask at CloudMask.cpp:63-108) — and also supplies
the ``find_connected_components`` the reference *declares and unit-tests but
never implements* (lib/approx/include/approx/laplace.h:11-20;
tests/approximation.h:55-76).

Algorithm: min-label propagation over the 8-neighbourhood combined with
pointer jumping (label <- label[label]), which contracts label trees so the
fixpoint is reached in O(log(diameter)) sweeps instead of O(diameter). The
host reads one "changed" flag per sweep; the final compaction into
reference-ordered region ids is host work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import as_tensor, resolve_device


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


def _region_stats(labels: torch.Tensor, h: int, w: int):
    """Per-region bbox/area/scan-key via segment reductions over the label
    map; every result has H*W + 1 entries, indexed by label."""
    n = h * w
    dev = labels.device
    rows = torch.arange(h, dtype=torch.int64, device=dev)[:, None].expand(h, w).reshape(-1)
    cols = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(h, w).reshape(-1)
    seg = labels.reshape(-1).to(torch.int64)
    big = 2**30
    valid = seg < n
    num = n + 1

    def seg_min(x):
        out = torch.full((num,), big, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, seg, torch.where(valid, x, big), reduce="amin")

    def seg_max(x):
        out = torch.full((num,), -big, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, seg, torch.where(valid, x, -big), reduce="amax")

    # reference scan-order key: first encounter scanning x (col) outer,
    # y-from-bottom (h-1-r) inner (CloudMask.cpp:73-76).
    scan_key = cols * h + (h - 1 - rows)
    areas = torch.bincount(seg[valid], minlength=num)
    return seg_min(rows), seg_max(rows), seg_min(cols), seg_max(cols), seg_min(scan_key), areas


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

    The labels come from :func:`connected_components`: a tensor is labelled
    where it lies, a host mask on ``device`` (``None``: the CUDA device,
    raises without one).
    """
    if not isinstance(mask, torch.Tensor):
        mask = as_tensor(np.asarray(mask, bool), resolve_device(device))
    mask_t = mask.to(torch.bool)
    h, w = mask_t.shape
    n = h * w
    labels = connected_components(mask_t, connectivity)

    stats = _region_stats(labels, h, w)
    rmin, rmax, cmin, cmax, kmin, areas_np = (s.cpu().numpy() for s in stats)

    reps = np.flatnonzero(areas_np > 0)
    reps = reps[reps < n]
    keep = reps[areas_np[reps] >= min_area]
    order = np.argsort(kmin[keep], kind="stable")
    keep = keep[order]

    regions = [
        Region(
            id=i,
            row_min=int(rmin[rep]),
            row_max=int(rmax[rep]),
            col_min=int(cmin[rep]),
            col_max=int(cmax[rep]),
            area=int(areas_np[rep]),
        )
        for i, rep in enumerate(keep)
    ]

    remap = np.full(n + 1, -1, dtype=np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    id_map = remap[labels.cpu().numpy().ravel()].reshape(h, w)
    return id_map, regions
