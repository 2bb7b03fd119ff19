"""The yardstick of the kernels' shares of their rooflines: the table of the
cards' published peaks and a frozen copy of the port's byte models of its
smoothers (``utils/roofline.py::kernel_work`` of the port, at the time the
benchmark was defined), with the multigrid hierarchy's coarsening that
those models are applied to.

A card that is not in the table is refused: a share against a guessed peak
means nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Published peaks at the card's full power limit: HBM bytes/s, f32 flop/s
# outside the tensor cores (NVIDIA's H100 SXM data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}

# the V-cycle of models/multigrid.py: levels coarsen by 2x2 ALL-pooling while
# the shorter side is over MIN_SIZE; SWEEPS sweeps before and after
MIN_SIZE = 24
SWEEPS = 7


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for the card {kind!r}; add them to PEAKS")
    return PEAKS[kind]


def allpool(m: torch.Tensor) -> torch.Tensor:
    """2x2 ALL-pool of a bool mask; odd sizes pad with False."""
    h, w = m.shape
    mp = F.pad(m, (0, w % 2, 0, h % 2))
    return (mp[0::2, 0::2] & mp[0::2, 1::2]) & (mp[1::2, 0::2] & mp[1::2, 1::2])


def level_masks(um: torch.Tensor) -> list[torch.Tensor]:
    """The unknown mask of every level, finest first, the coarsest last."""
    out = [um]
    while min(out[-1].shape) > MIN_SIZE:
        out.append(allpool(out[-1]))
    return out


def sectors(need: torch.Tensor, elt: int = 4) -> int:
    """32-byte sectors of a row-major raster of ``elt``-byte cells that hold
    a True cell of ``need``."""
    per = 32 // elt
    flat = need.reshape(-1)
    pad = (-flat.numel()) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per).any(dim=1).sum())


def smoother_work(um: torch.Tensor, c: int, top: bool) -> tuple[int, int, int]:
    """(bytes, flops, launches) that one V-cycle's two smoother launches on
    a level of mask ``um`` must move and compute at (c, H, W) f32, at the
    mask bound: the pre-smooth from zero reads b in the sectors that hold an
    unknown cell and invm in full, and writes u and r; the post-smooth reads
    u, b where unknown, invm, e_c where a coarse parent is unknown, and
    writes u (and r on the top level, where PCG takes A z from it)."""
    h, w = um.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    plane = h * w * 4
    ras = c * plane
    unk = c * 32 * sectors(um)
    coarse = F.pad(um.to(torch.uint8), (0, 2 * wc - w, 0, 2 * hc - h)).view(hc, 2, wc, 2)
    ec_unk = c * 32 * sectors(coarse.amax(dim=(1, 3)).bool())
    zero = unk + plane + 2 * ras
    corr = ras + unk + plane + ec_unk + ras + (ras if top else 0)
    flops = 2 * c * int(um.sum()) * (10 * SWEEPS + 8)
    return zero + corr, flops, 2


def vcycle_smoother_work(um: torch.Tensor, c: int) -> tuple[int, int, int]:
    """(bytes, flops, launches) of the smoothers of one V-cycle: both
    launches on every level above the coarsest."""
    levels = level_masks(um)
    total = [0, 0, 0]
    for i, m in enumerate(levels[:-1]):
        for k, v in enumerate(smoother_work(m, c, i == 0)):
            total[k] += v
    return tuple(total)


def bound_s(nbytes: float, flops: float, kind: str) -> float:
    """The least seconds the card could take: bytes or operations, the
    larger."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])
