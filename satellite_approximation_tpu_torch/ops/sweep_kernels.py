"""Kernel 11: the similarity sweep of the cloud-shadow matching
(``csrc/sweep.cu``).

``models/detection/matching.py::_bucket_sweep`` is the one dispatch point:
on CUDA operands it calls :func:`pair_counts` here, elsewhere it runs its
torch form (``_pair_counts``, window gathers summed), which is the plain
version the kernel is held to bit for bit. The JAX package's sweep is XLA
gathers: the kernel replaces no TPU kernel.

As for kernels 1-10 (``ops/stencil_kernels.py``, whose build and library
this module uses): each launch adds one to
``stencil_kernels.launch_counts["similarity_sweep"]``.
"""

from __future__ import annotations

import torch

from . import stencil_kernels as K

NAME = "similarity_sweep"


def pair_counts(cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
                wb: int, hb: int, width: int, height: int, pf: int = 0):
    """(t, c), int32 (Nh, Nc) each: the candidate and hit counts of every
    (height, cloud) pair of one bucket, in one launch of kernel 11.

    The operands are ``matching._bucket_sweep``'s, on one CUDA device:
    ``cmask_f`` / ``psm_f`` bool and ``cmap_f`` int32 (R, S) rasters, logical
    (y, x) at (y + pf, x + pf); ``ids`` (Nc,) int32; the bounds (Nh, Nc)
    int32; ``a2`` (Nh, Nc, 2, 2) and ``delta`` (Nh, Nc, 2) f32. A pair walks
    its box clipped to ``wb`` x ``hb`` and reads the rasters only inside it,
    where the torch form reads them too."""
    rasters = (cmask_f, psm_f, cmap_f)
    K._check(NAME, cmask_f, (torch.bool,), (None, None))
    K._check(NAME, psm_f, (torch.bool,), tuple(cmask_f.shape))
    K._check(NAME, cmap_f, (torch.int32,), tuple(cmask_f.shape))
    K._check(NAME, ids, (torch.int32,), (None,))
    nc = int(ids.shape[0])
    K._check(NAME, min_x, (torch.int32,), (None, nc))
    nh = int(min_x.shape[0])
    for b in (min_y, max_x, max_y):
        K._check(NAME, b, (torch.int32,), (nh, nc))
    K._check(NAME, a2, (torch.float32,), (nh, nc, 2, 2))
    K._check(NAME, delta, (torch.float32,), (nh, nc, 2))
    operands = (*rasters, ids, min_x, min_y, max_x, max_y, a2, delta)
    if not K._on_cuda(NAME, operands):
        raise ValueError(f"{NAME}: kernel 11 takes CUDA operands; on the CPU the torch form of "
                         "matching._bucket_sweep runs")
    rows, stride = cmask_f.shape
    if rows < height + pf or stride < width + pf:
        raise ValueError(f"{NAME}: a {rows}x{stride} raster cannot hold {height}x{width} "
                         f"behind a pad of {pf}")
    counts = torch.zeros((nh, nc, 2), dtype=torch.int32, device=cmask_f.device)
    if nh and nc:
        rc = K._library().sat_similarity_sweep(
            *map(K._ptr, rasters), stride, pf, width, height,
            *map(K._ptr, operands[3:]), nh, nc, wb, hb, K._ptr(counts), K._stream())
        K._check_rc(rc, NAME)
        K.launch_counts[NAME] += 1
    return counts[..., 0], counts[..., 1]
