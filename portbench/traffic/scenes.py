"""The general scene generator: Sentinel-2-like rasters made on the device
from a seed, read by every traffic mix of ``portbench/traffic/*.json``.

A copy of ``chip_smoke.synthesize`` made to take (H, W) and a cloud cover:
a blobby cloud-probability field (the max of local Gaussian bumps, each
computed only inside its ~4-sigma window), cut at the quantile that gives
the requested cover, and the clouds' shadows displaced north-west along the
sun azimuth. Fill bands are smooth u16-valued reflectance fields (two
octaves of bilinearly upsampled noise plus sensor noise), held as integers
so that the program's device-assembly route applies.

Everything is drawn from one ``torch.Generator`` on the target device, in a
few large calls: the same seed on the same device gives the same scenes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer; reduced
    modulo 2**64 so that seeds past 32 and 63 bits are taken whole)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def cloud_field(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(H, W) f32 field in [0, 1]: the max of Gaussian bumps (the
    ``synthesize`` recipe: max(60, n // 40) blobs, radii n/400+4 to n/40+8
    along each axis, n the side)."""
    n_blobs = max(60, int(math.sqrt(h * w)) // 40)
    u = torch.rand((n_blobs, 4), generator=gen, device=device, dtype=torch.float64).cpu()
    base = torch.zeros((h, w), dtype=torch.float32, device=device)
    for cyf, cxf, ryf, rxf in u.tolist():
        cy, cx = int(cyf * h), int(cxf * w)
        ry = h // 400 + 4 + int(ryf * (h // 40 + 4 - h // 400))
        rx = w // 400 + 4 + int(rxf * (w // 40 + 4 - w // 400))
        y0, y1 = max(cy - 4 * ry, 0), min(cy + 4 * ry + 1, h)
        x0, x1 = max(cx - 4 * rx, 0), min(cx + 4 * rx + 1, w)
        yy = (torch.arange(y0, y1, device=device, dtype=torch.float32)[:, None] - cy) / ry
        xx = (torch.arange(x0, x1, device=device, dtype=torch.float32)[None, :] - cx) / rx
        bump = torch.exp(-0.5 * (yy * yy + xx * xx))
        torch.maximum(base[y0:y1, x0:x1], bump, out=base[y0:y1, x0:x1])
    return base


def cover_threshold(base: torch.Tensor, cover: float) -> torch.Tensor:
    """The value t with ``base >= t`` on ``round(cover * N)`` cells (0-d)."""
    flat = base.reshape(-1)
    n = flat.numel()
    k = min(max(int(round(cover * n)), 1), n)
    return torch.kthvalue(flat, n - k + 1).values


def shadow_of(cloud: torch.Tensor) -> torch.Tensor:
    """The clouds displaced north-west (sun from the south-east), by H/180
    rows and W/240 columns, as ``synthesize`` places them."""
    h, w = cloud.shape
    dy, dx = h // 180, w // 240
    shadow = torch.zeros_like(cloud)
    shadow[: h - dy, : w - dx] = cloud[dy:, dx:]
    return shadow


def smooth_bands(count: int, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """(count, H, W) f32 integer-valued reflectance x 10000 in [1, 10000]:
    a coarse octave (cells of ~64 px), a fine one (~8 px) and sensor noise."""

    def octave(cell: int) -> torch.Tensor:
        g = torch.randn((count, 1, h // cell + 2, w // cell + 2), generator=gen, device=device)
        return F.interpolate(g, size=(h, w), mode="bilinear", align_corners=False)[:, 0]

    level = 800.0 + 2400.0 * torch.rand((count, 1, 1), generator=gen, device=device)
    x = octave(64).mul_(900.0).add_(level)
    x.add_(octave(8), alpha=250.0)
    x.add_(torch.randn((count, h, w), generator=gen, device=device), alpha=30.0)
    return x.clamp_(1.0, 10000.0).round_()


def fill_scene(h: int, w: int, cover: float, gen: torch.Generator, device) -> torch.Tensor:
    """The fill's invalid mask, (H, W) bool: clouds at ``cover`` of the
    scene and their displaced shadows."""
    base = cloud_field(h, w, gen, device)
    cloud = base >= cover_threshold(base, cover)
    return cloud | shadow_of(cloud)


def pool_covers(traffic: dict) -> list[float]:
    """The cloud cover of each scene of the mix's pool: ``pool`` covers
    spread evenly over ``cloud_cover`` = [lo, hi] (the midpoints of equal
    strata, so every seed gets the same set of covers in another order)."""
    lo, hi = traffic["cloud_cover"]
    n = int(traffic["pool"])
    return [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]


def call_order(traffic: dict, seed: int) -> list[int]:
    """The pool's scenes in the order the window cycles through them: the
    ranks of (k + seed) * golden ratio mod 1, so that every run of
    consecutive calls spreads over the covers (a window that ends part way
    through a cycle still sees low and high covers alike) and the seed only
    rotates where the cycle starts."""
    n = int(traffic["pool"])
    golden = (math.sqrt(5.0) - 1.0) / 2.0
    k0 = int(seed) % n
    keys = [((k + k0) * golden) % 1.0 for k in range(n)]
    ranks = sorted(range(n), key=keys.__getitem__)
    order = [0] * n
    for rank, k in enumerate(ranks):
        order[k] = rank
    return order


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) raster, zero outside."""
    r = int(4 * sigma)
    t = torch.arange(-r, r + 1, device=x.device, dtype=torch.float32)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    y = F.conv2d(x[None, None], k.view(1, 1, 1, -1), padding=(0, r))
    return F.conv2d(y, k.view(1, 1, -1, 1), padding=(r, 0))[0, 0]


def detect_scene(h: int, w: int, cover: float, gen: torch.Generator, device) -> dict:
    """The rasters ``detect`` decodes, as host arrays keyed by file stem
    (``synthesize``'s recipe): CLP, CLD and SCL consistent with the cloud
    field, NIR (B08) spatially correlated like 10 m imagery and darkened
    under the displaced shadows (so the height sweep finds real matches),
    and constant-gradient sun and view angles."""
    base = cloud_field(h, w, gen, device)
    t = cover_threshold(base, cover)
    cloud = base >= t
    p = torch.clamp(base * (0.55 / torch.clamp_min(t, 1e-6)), max=1.0)
    clp = torch.clamp(p * (255 * 1.2), 0, 255).to(torch.uint8)
    cld = torch.clamp(p * (100 * 1.1), 0, 100).to(torch.uint8)
    scl = torch.full((h, w), 4, dtype=torch.uint8, device=device)  # vegetation
    scl[p > 0.75] = 9  # cloud, high probability
    scl[(p > 0.65) & (p <= 0.75)] = 8  # cloud, medium probability
    g = _blur(torch.randn((h, w), generator=gen, device=device), 3.0)
    g = g / torch.clamp_min(g.std(), 1e-6)
    nir = torch.clamp(6000 + 1500 * g, 500, 10000)
    nir = torch.where(shadow_of(cloud), nir * 0.35, nir).to(torch.int32)
    gy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    gx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    grad = gy + gx
    out = {
        "CLP": clp, "CLD": cld, "SCL": scl,
        "sunZenithAngles": 35.0 + 0.5 * grad, "sunAzimuthAngles": 145.0 + 0.5 * grad,
        "viewZenithMean": 5.0 + 0.2 * grad, "viewAzimuthMean": 100.0 + 0.3 * grad,
    }
    host = {k: v.cpu().numpy() for k, v in out.items()}
    host["B08"] = nir.cpu().numpy().astype("uint16")
    return host
