"""Sharded detection stages (``satellite_approximation_tpu/parallel/detect.py``).

Each stage shards the axis that is embarrassingly parallel for it and runs
the port's single-device function on every shard, so the results are
bit-equal to the single-device route by construction:

* :func:`sharded_sweep`: the ray-cast similarity sweep with the HEIGHT axis
  sharded over every shard of the mesh, the rasters replicated
  (``matching._bucket_sweep`` on each shard: kernel 11 on a CUDA shard,
  the torch form on a CPU one). It plugs into
  ``match_clouds_shadows(sweep_fn=...)``, which keeps all the
  orchestration.
* :func:`sharded_alpha_map`: the elementwise logistic remap over row shards.
* :func:`sharded_beta_map`: the per-shadow radial falloff with the SHADOW
  axis sharded: each shard composites its shadows into its own raster
  (``refinement_torch._beta_bucket``) and one elementwise maximum merges
  them, exact in any order.
* :func:`sharded_histograms`: the (alpha, beta) histograms over row shards,
  merged by int32 sums, exact in any order.
* :func:`sharded_improved_shadow_mask`: the final-mask sampling over row
  shards (``refinement_torch._sample_final``).

A row-sharded raster is a list of tensors, one per shard in shard order,
each a block of rows of the raster padded with zero rows to a multiple of
the shard count; ``rows`` carries the raster's true height. Stages that
chain pass it on as it is (``padded_output=True``); the last one gathers
and cuts it.

:func:`mini_detect_sharded` chains the stages on a small synthetic scene
and asserts each result bit-equal to the single-device route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RefinementConfig
from ..device import as_tensor
from ..models.detection import refinement, refinement_torch
from ..models.detection.matching import _bucket_sweep
from ..ops import geometry
from ..ops.masks import fetch_mask, push_mask
from .collectives import all_gather, move, on_device, pmax, psum
from .mesh import ShardMesh


def _devices(mesh: ShardMesh) -> list[torch.device]:
    """Every shard's device in shard order: the stages shard over all axes."""
    return list(mesh.devices.reshape(-1))


def sharded_sweep(mesh: ShardMesh):
    """A ``sweep_fn`` for ``matching.match_clouds_shadows``: the bucket
    similarity sweep with the heights of each pass split over every shard
    of ``mesh``. Heights pad to a multiple of the shard count by repeating
    the last (the pad rows are dropped after), the rasters go to every
    device once a call and are reused while they stay the same tensors,
    and each shard runs ``matching._bucket_sweep`` on its heights:
    bit-equal per (height, cloud) cell. Returns the (Nh, Nc) similarities
    on the mesh's first device."""
    mesh.require_one_process("sharded_sweep")
    devs = _devices(mesh)
    n = len(devs)
    replicas: dict = {}

    def rasters(dev, src):
        held = replicas.get(dev)
        if held is None or any(a is not b for a, b in zip(held[0], src)):
            held = (src, tuple(move(t, dev) for t in src))
            replicas[dev] = held
        return held[1]

    def sweep(cmask_f, psm_f, cmap_f, ids, min_x, min_y, max_x, max_y, a2, delta,
              wb: int, hb: int, width: int, height: int, pf: int = 0, min_support: int = 5):
        nh = int(min_x.shape[0])
        pad = -nh % n
        per = (nh + pad) // n

        def padh(x):
            if pad == 0:
                return x
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)

        args = [padh(t) for t in (min_x, min_y, max_x, max_y, a2, delta)]
        parts = []
        for k, dev in enumerate(devs):
            local = [move(a[k * per : (k + 1) * per], dev) for a in args]
            with on_device(dev):
                parts.append(_bucket_sweep(
                    *rasters(dev, (cmask_f, psm_f, cmap_f, ids)), *local,
                    wb=wb, hb=hb, width=width, height=height, pf=pf, min_support=min_support,
                ))
        return all_gather(parts, 0, devs[0])[:nh]

    sweep.shards = n  # named in the matching's route
    return sweep


def _pad_rows(x, mesh: ShardMesh, dtype=None) -> tuple[list, int | None]:
    """(row shards, true rows) of a host array or tensor; a list is taken as
    row shards already (its true rows, None here, come from the caller)."""
    if isinstance(x, list):
        return x, None
    devs = _devices(mesh)
    n = len(devs)
    h = int(x.shape[0])
    hl = -(-h // n)
    pad = hl * n - h
    if isinstance(x, np.ndarray):
        x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    elif pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], dim=0)
    return [as_tensor(x[k * hl : (k + 1) * hl], dev, dtype) for k, dev in enumerate(devs)], h


def _rows(h: int | None, rows: int | None) -> int:
    if rows is not None:
        return rows
    if h is None:
        raise ValueError("row shards need their true row count (rows=)")
    return h


def _exact_rows(shards: list, h: int, mesh: ShardMesh) -> torch.Tensor:
    """Row shards gathered on the mesh's first device and cut to ``h`` rows."""
    return all_gather(shards, 0, mesh.first_device)[:h]


def sharded_alpha_map(nir_difference, mesh: ShardMesh, alpha_a: float = 17.0,
                      alpha_b: float = 0.007, padded_output: bool = False):
    """Row-sharded alpha map (``refinement_torch.alpha_map`` on each shard).
    ``padded_output``: return ``(row shards, rows)``, the form the other
    row-sharded stages take; otherwise the (H, W) tensor on the mesh's first
    device."""
    mesh.require_one_process("sharded_alpha_map")
    shards, h = _pad_rows(nir_difference, mesh, torch.float32)
    out = []
    for s in shards:
        with on_device(s.device):
            out.append(refinement_torch.alpha_map(s, alpha_a, alpha_b))
    if padded_output:
        return out, h
    return _exact_rows(out, h, mesh)


def sharded_beta_map(shadows, solutions, clp_blended, diagonal: float, mesh: ShardMesh,
                     config: RefinementConfig = RefinementConfig(), device_output: bool = False):
    """Shadow-axis-sharded beta map, the contract of ``refinement_torch.beta_map``:
    each bucket's shadows split into contiguous blocks over the shards, each
    shard composites its block into its own raster with ``_beta_bucket``,
    and an elementwise maximum over the shards (``pmax``) merges the
    rasters. ``device_output`` returns the tensor on the first device."""
    mesh.require_one_process("sharded_beta_map")
    devs = _devices(mesh)
    n = len(devs)
    h, w = clp_blended.shape
    sx, sy = geometry.sides((h, w), diagonal)
    _, buckets, max_b = refinement_torch._beta_prep(shadows, solutions, h, w, config)
    clp = {}
    rets = np.empty(mesh.dims, dtype=object)
    flat = rets.reshape(-1)
    for k, dev in enumerate(devs):
        flat[k] = torch.zeros((h + max_b, w + max_b), dtype=torch.float32, device=dev)
    for (hb, wb), members in buckets.items():
        band = refinement_torch._bucket_band(members)
        per = -(-len(members) // n)
        for k, dev in enumerate(devs):
            block = members[k * per : (k + 1) * per]
            if not block:
                continue
            with on_device(dev):
                if dev not in clp:
                    clp[dev] = torch.flipud(as_tensor(clp_blended, dev, torch.float32)).contiguous()
                ops = refinement_torch._bucket_operands(block, hb, wb, dev)
                refinement_torch._beta_bucket(
                    clp[dev], flat[k], ops["in_shadow"], ops["border"], ops["anchor"],
                    ops["extent"], ops["inf_f"], ops["lo"], config.beta_mid_percentile,
                    ops["minv"], float(sx), float(sy),
                    hb=hb, wb=wb, height=h, width=w, band=band,
                )
    ret = pmax(mesh, rets, mesh.axis_names).reshape(-1)[0]
    out = torch.flipud(ret[:h, :w]).contiguous()
    return out if device_output else out.cpu().numpy()


def sharded_histograms(alpha, beta, shadow, divisions, mesh: ShardMesh, rows: int | None = None):
    """Row-sharded (counts, sums) histograms: each shard runs
    ``refinement_torch._histograms`` on its rows, pad rows weighted 0, and
    int32 sums in shard order (``psum``, exact in any order) merge them; the
    result lies on the first device. ``rows``: the true row count when
    the inputs are row shards."""
    mesh.require_one_process("sharded_histograms")
    a, h = _pad_rows(alpha, mesh, torch.float32)
    h = _rows(h, rows)
    b, _ = _pad_rows(beta, mesh, torch.float32)
    s, _ = _pad_rows(shadow, mesh, torch.bool)
    parts = []
    start = 0
    for al, bl, sl in zip(a, b, s):
        hl = al.shape[0]
        valid = (torch.arange(start, start + hl, device=al.device) < h)[:, None]
        start += hl
        with on_device(al.device):
            parts.append(refinement_torch._histograms(al, bl, sl, tuple(divisions), valid=valid))

    def merged(d, kind):
        grid = np.empty(mesh.dims, dtype=object)
        for k, p in enumerate(parts):
            grid.reshape(-1)[k] = p[d][kind]
        return psum(mesh, grid, mesh.axis_names).reshape(-1)[0]

    return tuple((merged(d, 0), merged(d, 1)) for d in range(len(divisions)))


def sharded_probability_map(shadow_mask, alpha, beta, mesh: ShardMesh,
                            config: RefinementConfig = RefinementConfig(), rows: int | None = None):
    """``refinement_torch.probability_map`` with the histograms sharded; the
    hole fill and the surface composite run on the host (serial by nature,
    ProbabilityRefinement.cpp:162-183). ``rows``: as in :func:`sharded_histograms`."""
    mesh.require_one_process("sharded_probability_map")
    first = mesh.first_device
    hists = sharded_histograms(alpha, beta, push_mask(shadow_mask, first),
                               tuple(config.histogram_divisions), mesh, rows=rows)
    elements = [refinement.element_from_histogram(c.cpu().numpy(), s.cpu().numpy())
                for c, s in hists]
    return refinement.composite_surface(elements, config)


def sharded_improved_shadow_mask(object_shadow_mask, cloud_mask, alpha, beta, surface,
                                 threshold: float, mesh: ShardMesh, device_output: bool = False,
                                 rows: int | None = None):
    """Row-sharded final-mask sampling (``refinement_torch._sample_final``
    on each shard, the extended surface table on every device). Returns the
    (H, W) bool mask, a tensor on the first device with ``device_output``.
    ``rows``: as in :func:`sharded_histograms`."""
    mesh.require_one_process("sharded_improved_shadow_mask")
    first = mesh.first_device
    a, h = _pad_rows(alpha, mesh, torch.float32)
    h = _rows(h, rows)
    b, _ = _pad_rows(beta, mesh, torch.float32)
    ob, _ = _pad_rows(push_mask(object_shadow_mask, first), mesh, torch.bool)
    cl, _ = _pad_rows(push_mask(cloud_mask, first), mesh, torch.bool)
    ext_host = surface._extended()
    tables = {}
    out = []
    for al, bl, o, c in zip(a, b, ob, cl):
        dev = al.device
        with on_device(dev):
            if dev not in tables:
                tables[dev] = as_tensor(ext_host, dev, torch.float32)
            out.append(refinement_torch._sample_final(tables[dev], al, bl, o, c, threshold))
    final = _exact_rows(out, h, mesh)
    return final if device_output else fetch_mask(final)


def _mini_scene(n: int, seed: int = 7):
    """Small synthetic Sentinel-2-style scene (clouds, displaced NIR
    shadows, smooth angle rasters): the dry run's counterpart of
    ``chip_smoke.synthesize``."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n, n), np.float32)
    yy, xx = np.ogrid[:n, :n]
    for _ in range(10):
        cy, cx = rng.integers(n // 8, 7 * n // 8, 2)
        ry = int(rng.integers(n // 32 + 2, n // 12 + 4))
        rx = int(rng.integers(n // 32 + 2, n // 12 + 4))
        d2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        np.maximum(base, np.exp(-0.5 * d2.astype(np.float32)), out=base)
    clp = np.clip(base * 255 * 1.2, 0, 255).astype(np.uint8)
    cld = np.clip(base * 100 * 1.1, 0, 100).astype(np.uint8)
    cloud = base > 0.55

    scl = np.full((n, n), 4, np.uint8)
    scl[base > 0.75] = 9
    scl[(base > 0.65) & (base <= 0.75)] = 8

    dy, dx = -max(n // 24, 2), -max(n // 32, 2)
    shadow = np.zeros_like(cloud)
    src = cloud[max(-dy, 0) : n - max(dy, 0), max(-dx, 0) : n - max(dx, 0)]
    shadow[max(dy, 0) : n - max(-dy, 0), max(dx, 0) : n - max(-dx, 0)] = src
    g = rng.standard_normal((n, n)).astype(np.float32)
    for _ in range(6):
        g = 0.25 * (np.roll(g, 1, 0) + np.roll(g, -1, 0) + np.roll(g, 1, 1) + np.roll(g, -1, 1))
    g = g / max(float(g.std()), 1e-6)
    nir = (6000 + 1500 * g).clip(500, 10000)
    nir[shadow] *= 0.35

    grad = (yy / n + xx / n).astype(np.float32)
    return dict(
        clp=clp.astype(np.float32) / 255.0,
        cld=cld.astype(np.float32) / 100.0,
        scl=scl,
        nir=nir.astype(np.float32) / 65535.0,
        sun_zenith=35.0 + 0.5 * grad,
        sun_azimuth=145.0 + 0.5 * grad,
        view_zenith=5.0 + 0.2 * grad,
        view_azimuth=100.0 + 0.3 * grad,
    )


def mini_detect_sharded(mesh: ShardMesh, n: int = 256) -> dict:
    """Run the stage chain of ``detect`` twice on an in-memory synthetic
    scene, on the mesh's first device: the single-device device route, and
    the route with every shardable stage sharded over ``mesh`` (the sweep
    over heights, beta over shadows, alpha, histograms and the final mask
    over rows; the blur and the pit fill are held in ``parallel.stencils``).
    Raises unless the object-based shadow mask, alpha, beta and the final
    mask are bit-equal. Returns the masks (automatic_detection.cpp:80-236)."""
    mesh.require_one_process("mini_detect_sharded")
    from ..config import DetectionConfig
    from ..models.detection import cloud_mask as cm
    from ..models.detection import matching
    from ..models.detection import shadow_mask as sm

    dev = mesh.first_device
    config = DetectionConfig()
    scene = _mini_scene(n)
    diagonal = 219.0 * (n / 10980.0)  # the tile's diagonal, scaled, km

    # stages both routes share
    generated = cm.generate_cloud_mask_ignore_low_probability(
        scene["clp"], scene["cld"], scene["scl"], config.cloud_mask, device=dev
    )
    cloud_map, clouds = cm.partition_cloud_mask(
        generated.cloud_mask_no_processing, diagonal, config.min_cloud_size_for_ray_casting,
        device=dev,
    )
    psm = sm.generate_potential_shadow_mask(
        scene["nir"], generated.cloud_mask_no_processing, scene["scl"], config.shadow_mask,
        device=dev,
    )
    shape = scene["clp"].shape
    sun_pos = geometry.ls_point_equal_to_chunked(
        scene["sun_zenith"], scene["sun_azimuth"], shape, diagonal, config.distance_to_sun_km
    )
    view_pos = geometry.ls_point_equal_to_chunked(
        scene["view_zenith"], scene["view_azimuth"], shape, diagonal, config.distance_to_view_km
    )
    ref = config.refinement

    def run_route(sharded: bool):
        match = matching.match_clouds_shadows(
            clouds, cloud_map, generated.cloud_mask_no_processing, psm.mask, diagonal,
            sun_pos, view_pos, config.matching, use_native=False,
            sweep_fn=sharded_sweep(mesh) if sharded else None, device=dev,
        )
        if sharded:
            alpha = sharded_alpha_map(psm.difference_of_pitfill_nir, mesh, ref.alpha_a,
                                      ref.alpha_b)
            beta = sharded_beta_map(match.shadows, match.solutions,
                                    generated.blended_cloud_probability, diagonal, mesh, ref)
            surface = sharded_probability_map(match.shadow_mask, alpha, beta, mesh, ref)
            final = sharded_improved_shadow_mask(match.shadow_mask, generated.cloud_mask, alpha,
                                                 beta, surface, config.probability_threshold, mesh)
        else:
            alpha = refinement_torch.alpha_map(psm.difference_of_pitfill_nir, ref.alpha_a,
                                               ref.alpha_b, device=dev)
            beta = refinement_torch.beta_map(match.shadows, match.solutions,
                                             generated.blended_cloud_probability, diagonal, ref,
                                             device=dev)
            surface = refinement_torch.probability_map(match.shadow_mask, alpha, beta, ref,
                                                       device=dev)
            final = refinement_torch.improved_shadow_mask(
                match.shadow_mask, generated.cloud_mask, alpha, beta, surface,
                config.probability_threshold, device=dev,
            )
        return dict(
            object=np.asarray(match.shadow_mask),
            alpha=alpha.cpu().numpy(),
            beta=np.asarray(beta),
            final=np.asarray(final),
            n_matched=sum(1 for s in match.solutions.values() if s.similarity >= 0),
        )

    want = run_route(False)
    got = run_route(True)
    if want["n_matched"] == 0:
        raise AssertionError("the mini scene produced no cloud-shadow matches")
    for key in ("object", "alpha", "beta", "final"):
        if not np.array_equal(want[key], got[key]):
            raise AssertionError(f"sharded detect stage '{key}' differs from the single device")
    return dict(
        cloud=fetch_mask(generated.cloud_mask),
        object=got["object"],
        final=got["final"],
        n_matched=got["n_matched"],
    )
