#!/usr/bin/env python3
"""Where the device time of the port's main path goes, on one NVIDIA GPU.

torch.profiler records warm calls of ``multigrid.solve`` on bench.py's
13-band 2048^2 system (as ``chip_smoke.py`` phase 4 times it), of one V-cycle
as PCG calls it on that system, and of one 10980^2 band through
``laplace_fill`` (phase 5's band). For each call it prints the device time
by kind of kernel and the heaviest kernels, beside the call's unprofiled
wall time (median of 5, CUDA synchronised); the device's idle share is one
minus the device time over that wall time.

    python3 chip_profile.py [--top N]
    python3 chip_profile.py --detect [N] [--top N]
    python3 chip_profile.py --multi-device [--top N]
    python3 chip_profile.py --mask-write

``--detect`` profiles the detection path instead (kernel 9, the pit fill's
directional pass, is its one hand-written kernel), at N x N (4096 by
default): one warm ``detect`` of ``chip_smoke.synthesize(N)`` under backend
"auto" (the device stages), and the pit fill alone on that scene's NIR,
each with its device time, its count of device launches and the device's
idle share; then the pit fill level by level with directional cycles on the
levels of at least ``_DIRECTIONAL_MIN_SIZE`` cells, on every level and on
none: the seconds, the cycles, the rounds and sweeps, and the cells swept
as a multiple of the level's size;
then the matching in its forms (kernel 11 a bucket a pass, as ``detect``
sweeps; kernel 11 in the torch form's passes; the torch form, general and
in the vector form of the affine) and the LS geometry stage with no writer
thread beside it.

``--multi-device`` profiles one ``parallel.sharded_fill`` of the 13-band
2048^2 system on a (1,4) mesh of four shards on the card (as
``chip_smoke.py`` phase 10a runs it): its device time, launches and idle
share, then its wall split by the callees it looks up at call time (the
solve, the host hierarchy, the uploads, the PCG loop, the replicated tail,
the f64 residuals); the rest of the wall is the host assembly around the
solve.

``--mask-write`` times ``detect``'s mask writes on the benchmark's scenes
(``portbench/traffic/scenes.py`` at 25 % cover, 5490^2 and 10980^2): two
``detect`` calls a size with their write stages, then the final shadow
mask's write in its parts as one strip (the fetch, the u8 copy, the copy to
bytes, one ``zlib.compress``, the file write) and zlib's rate on each mask;
then the whole write through ``utils/tiffmb.py`` as one strip and in row
strips of each of ``STRIP_SIZES`` on the strip pool, in ``MASK_ROUNDS``
turns, on the scenes of ``MASK_SEED``.

The last line is one JSON object ``{"profile": {...}}``. Without a CUDA
device the script prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import chip_smoke as cs

# (kind, substrings of the kernel's name); the first match wins
KINDS = (
    ("port smoothers (jacobi.cu)", ("jacobi_kernel",)),
    ("port residual (residual.cu)", ("residual_kernel",)),
    ("port directional pass (pitfill.cu)", ("directional_pass_kernel",)),
    ("torch elementwise", ("elementwise_kernel",)),
    ("torch reductions", ("reduce_kernel",)),
    ("copies and fills", ("Memcpy", "Memset")),
)
OTHER = "other (matmuls, concatenations, ...)"


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return OTHER


def wall_ms(torch, fn, runs=5):
    """Median wall ms of one call of ``fn``, the device synchronised; a
    ``fn`` that returns a number has timed its own core, in seconds."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        own = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0 if own is None else own) * 1e3)
    return statistics.median(times)


def profile_call(torch, label, fn, reps, card, top, wall_runs=5):
    """Profile ``reps`` warm calls of ``fn``: log the device ms per call by
    kind and by kernel, and return the split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    wall = wall_ms(torch, fn, wall_runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = per_name.setdefault(e.name, [0.0, 0])
            entry[0] += (e.time_range.end - e.time_range.start) / 1e3 / reps
            entry[1] += 1
    if not per_name:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    device = sum(ms for ms, _ in per_name.values())
    kinds = {kind: 0.0 for kind, _ in KINDS} | {OTHER: 0.0}
    for name, (ms, _) in per_name.items():
        kinds[kind_of(name)] += ms
    launches = sum(n for _, n in per_name.values()) // reps
    cs.log(f"[profile] {label}: device {device:.3f} ms a call in {launches} launches, unprofiled "
           f"wall {wall:.3f} ms (device idle {1 - device / wall:.1%}), {reps} calls profiled "
           f"[{card}]")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        cs.log(f"[profile]   {kind:32s} {ms:9.3f} ms {ms / device:6.1%}")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        cs.log(f"[profile]     {ms:9.3f} ms {n // reps:5d} launches  {name[:150]}")
    return {"device_ms": device, "wall_ms": wall, "launches": launches, "kinds_ms": kinds}


def pit_fill_levels(torch, nir, border, card):
    """The pit fill of ``nir`` level by level, coarsest first, under three
    settings of the one constant that decides where directional cycles run
    (``_DIRECTIONAL_MIN_SIZE``): as configured, on every level, on none.
    Per level: seconds (from the end of the level before, so with the
    level's upsampling), cycles, rounds, sweeps and swept cells."""
    from satellite_approximation_tpu_torch.ops import pitfill

    out = {}
    default = pitfill._DIRECTIONAL_MIN_SIZE
    settings = ((f"cycles from {default} cells", default), ("cycles on every level", 0),
                ("no cycles", 1 << 62))
    try:
        for schedule, threshold in settings:
            pitfill._DIRECTIONAL_MIN_SIZE = threshold
            total = 0.0

            def on_level(lvl, shape, rounds, cycles):
                nonlocal t0, total
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                total += dt
                sweeps = sum(c for _, c in rounds)
                swept = sum(cells * c for cells, c in rounds) / (shape[0] * shape[1])
                cs.log(f"[profile] pit fill, {schedule}, level {lvl} ({shape[0]}x{shape[1]}): "
                       f"{dt:.3f} s, {cycles} cycles, {len(rounds)} rounds, {sweeps} sweeps, "
                       f"{swept:.0f} level-sizes swept")
                out[f"{schedule} level {lvl}"] = {"s": dt, "cycles": cycles, "rounds": len(rounds),
                                                   "sweeps": sweeps, "swept": swept}
                t0 = time.perf_counter()

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pitfill.pit_fill(nir, border, on_level=on_level)
            cs.log(f"[profile] pit fill, {schedule}: {total:.3f} s in all [{card}]")
            out[schedule] = total
    finally:
        pitfill._DIRECTIONAL_MIN_SIZE = default
    return out


def matching_forms(torch, dev, scene, n, card):
    """The stages before the matching by hand (no writer thread runs beside
    them), then ``match_clouds_shadows`` in turns in four forms: as
    ``detect`` calls it (kernel 11, one pass a bucket), kernel 11 in the
    torch form's cloud groups and height passes, and the torch form itself,
    per pixel and in the vector form of the affine (the last three through
    ``sweep_fn=``, which keeps the passes). Seconds of each call, and of the
    LS geometry stage without a writer beside it."""
    import numpy as np

    from satellite_approximation_tpu_torch.config import DEFAULT_DETECTION as cfg
    from satellite_approximation_tpu_torch.device import divide
    from satellite_approximation_tpu_torch.models.detection import cloud_mask as cm
    from satellite_approximation_tpu_torch.models.detection import matching
    from satellite_approximation_tpu_torch.models.detection import shadow_mask as sm
    from satellite_approximation_tpu_torch.models.detection.pipeline import get_diagonal_distance
    from satellite_approximation_tpu_torch.ops import geometry

    def seconds(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def norm(name, top):
        return divide(torch.as_tensor(scene[name], device=dev).to(torch.float32), float(top))

    diag = get_diagonal_distance(-114.0, 50.5, -112.5, 51.5) * (n / cs.TILE)
    scl = torch.as_tensor(scene["SCL"], device=dev)
    gen = cm.generate_cloud_mask_ignore_low_probability(
        norm("CLP", 255), norm("CLD", 100), scl, cfg.cloud_mask, device_output=True)
    cloud_map, clouds = cm.partition_cloud_mask(
        gen.cloud_mask_no_processing, diag, cfg.min_cloud_size_for_ray_casting, device=dev)
    psm = sm.generate_potential_shadow_mask(
        norm("B08", 65535), gen.cloud_mask_no_processing, scl, cfg.shadow_mask,
        device_output=True, device=dev)

    def ls_points():
        return [geometry.ls_point_equal_to_device(scene[z], scene[a], (n, n), diag, d, device=dev)
                for z, a, d in (("sunZenithAngles", "sunAzimuthAngles", cfg.distance_to_sun_km),
                                ("viewZenithMean", "viewAzimuthMean", cfg.distance_to_view_km))]

    ls_points()
    geo = [seconds(ls_points)[1] for _ in range(3)]
    sun, view = ls_points()
    cs.log(f"[profile] sun/view geometry {n}x{n} with no writer thread beside it: "
           + ", ".join(f"{t:.3f}" for t in geo) + f" s [{card}]")

    def torch_form(*args, **kwargs):
        return matching._sweep(*args, **kwargs, separable=False)

    forms = {"kernel 11, a bucket a pass (as detect)": None,
             "kernel 11 in the torch form's passes": matching._bucket_sweep,
             "torch form": torch_form,
             "torch form, vector form of the affine": matching._bucket_sweep_sep}

    def match(sweep_fn):
        return matching.match_clouds_shadows(
            clouds, cloud_map, gen.cloud_mask_no_processing, psm.mask, diag, sun, view,
            cfg.matching, use_native=False, sweep_fn=sweep_fn, device=dev)

    want = match(None)  # warm-up, and what the other forms must equal
    times = {name: [] for name in forms}
    order = list(forms) + list(forms)[::-1]
    for name in order + order:
        got, dt = seconds(lambda: match(forms[name]))
        times[name].append(dt)
        same = (np.array_equal(got.shadow_mask, want.shadow_mask)
                and {k: (v.height, v.similarity) for k, v in got.solutions.items()}
                == {k: (v.height, v.similarity) for k, v in want.solutions.items()})
        if not same:
            raise AssertionError(f"matching, {name}: differs from the default form")
    for name, ts in times.items():
        cs.log(f"[profile] matching {n}x{n}, {len(clouds)} clouds, {name}: "
               + ", ".join(f"{t:.3f}" for t in ts) + f" s [{card}]")
    return {"geometry_alone_s": geo, "matching_s": times, "clouds": len(clouds)}


def profile_detect(torch, dev, card, top, n):
    """A warm ``detect`` at n x n through the device stages, its pit fill
    alone, the pit fill level by level, and the matching's forms."""
    import numpy as np

    from satellite_approximation_tpu_torch.ops.pitfill import pit_fill

    scene = cs.synthesize(n)

    def detect():  # timed inside: the scene's file and the read-back are not detect's
        return cs.run_detect(torch, dev, scene, n, ("auto", "auto"), "profiled detect", card)[3]

    out = {"detect": profile_call(torch, f"detect {n}x{n}, backend auto", detect, 1, card, top,
                                  wall_runs=2)}
    nir = torch.as_tensor(scene["B08"].astype(np.float32) / np.float32(65535), device=dev)
    border = float(nir.median())

    def fill():
        pit_fill(nir, border)

    out["pit_fill"] = profile_call(torch, f"pit_fill {n}x{n} (border = the median)", fill, 1, card,
                                   top, wall_runs=2)
    out["pit_fill_levels"] = pit_fill_levels(torch, nir, border, card)
    out["matching_forms"] = matching_forms(torch, dev, scene, n, card)
    return out


# the strip sizes tried in turns (bytes of a strip before deflate)
STRIP_SIZES = (512 << 10, 1 << 20, 2 << 20, 4 << 20)
MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")
# (side, diagonal km): the 20 m and 10 m tiles of the detect cells
MASK_SCENES = ((5490, 155.28), (10980, 155.28))
MASK_SEED = 2**31 + 11  # a seed past 32 signed bits, as the benchmark's are
MASK_ROUNDS = 5  # the turns of the whole write


def seconds(fn, runs):
    """Median wall seconds of ``runs`` calls of ``fn``."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def mask_write(torch, dev, card, sizes=MASK_SCENES):
    """The mask writes of two ``detect`` calls a size, the final mask's
    write in its parts, and the write as one strip and in row strips of
    each of ``STRIP_SIZES``, in turns (seconds)."""
    import contextlib
    import tempfile
    import zlib
    from pathlib import Path

    import numpy as np
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from portbench.traffic import scenes
    from satellite_approximation_tpu_torch.models.detection import pipeline
    from satellite_approximation_tpu_torch.ops.masks import fetch_mask
    from satellite_approximation_tpu_torch.utils import profiling, tiffmb
    from satellite_approximation_tpu_torch.utils.profiling import StageTimer

    out = {"cpus": len(os.sched_getaffinity(0)), "pool_width": tiffmb._get_pool()[1],
           "seed": MASK_SEED, "rounds": MASK_ROUNDS}
    one_strip, strip_bytes = tiffmb.ONE_STRIP_BYTES, tiffmb.STRIP_BYTES
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        for n, diagonal in sizes:
            work = Path(tmp) / f"scene{n}"
            work.mkdir()
            template = work / "B08.tif"
            Image.fromarray(np.zeros((1, 1), np.uint16)).save(template, format="TIFF")
            scene = scenes.detect_scene(n, n, 0.25, scenes.generator(MASK_SEED, dev), dev)
            calls = []
            for traced in (False, True):  # a cold call, then a warm one with its spans
                timer = StageTimer(dev)
                profiling.clear()
                with (profile(activities=[ProfilerActivity.CPU]) if traced
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    pipeline.detect(pipeline.CloudParams.from_root(work), diagonal,
                                    use_cache=False, inputs=scene, timer=timer, device=dev)
                    wall = time.perf_counter() - t0
                writes = [(name, t) for name, t in timer.stages if name.startswith("write")]
                spans = [(r.name, r.counts) for r in profiling.records()
                         if r.name.startswith("detect.write")]
                calls.append({"wall": wall, "writes": writes, "spans": spans})
            masks = {}
            for m in MASKS:
                with Image.open(work / f"{m}.tif") as im:
                    masks[m] = np.array(im).astype(bool)
            final = torch.from_numpy(masks["shadow_mask"]).to(dev)
            sync()
            host = fetch_mask(final)
            u8 = host.astype(np.uint8)
            raw = u8.tobytes()
            packed = zlib.compress(raw)
            parts = {
                "fetch": seconds(lambda: fetch_mask(final), 5),
                "astype_u8": seconds(lambda: host.astype(np.uint8), 5),
                "tobytes": seconds(lambda: u8.tobytes(), 5),
                "deflate": seconds(lambda: zlib.compress(raw), 3),
                "file_write": seconds(lambda: (work / "final.bin").write_bytes(packed), 3),
            }
            rates = {}
            for m, mask in masks.items():
                data = mask.view(np.uint8)
                t0 = time.perf_counter()
                size = len(zlib.compress(data))
                dt = time.perf_counter() - t0
                rates[m] = {"cover": float(mask.mean()), "deflate_s": dt,
                            "mb_s": data.nbytes / dt / 1e6, "ratio": data.nbytes / size}
            # the whole write in turns: one strip, then each strip size
            kinds = ["one strip"] + [f"{b >> 10} KiB" for b in STRIP_SIZES]
            times = {k: [] for k in kinds}
            file_bytes = {}
            path = work / "write.tif"
            for _ in range(MASK_ROUNDS):
                for k, b in zip(kinds, (None,) + STRIP_SIZES):
                    tiffmb.ONE_STRIP_BYTES = one_strip if b else 1 << 62
                    tiffmb.STRIP_BYTES = b or strip_bytes
                    try:
                        sync()
                        t0 = time.perf_counter()
                        pipeline._write_mask(final, path, template)
                        times[k].append(time.perf_counter() - t0)
                    finally:
                        tiffmb.ONE_STRIP_BYTES, tiffmb.STRIP_BYTES = one_strip, strip_bytes
                    file_bytes[k] = path.stat().st_size
                    with Image.open(path) as im:
                        if not np.array_equal(np.array(im).astype(bool), masks["shadow_mask"]):
                            raise AssertionError(f"{n}^2 {k}: the mask read back differs")
            writes = {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                          "file_bytes": file_bytes[k]} for k, v in times.items()}
            out[f"{n}"] = {"calls": calls, "final_mask_parts": parts,
                           "final_mask_raw_bytes": len(raw), "final_mask_deflated_bytes": len(packed),
                           "zlib": rates, "writes": writes}
            cs.log(f"[mask-write] {n}^2 calls {calls}")
            cs.log(f"[mask-write] {n}^2 final mask parts {parts}, {len(raw)} -> {len(packed)} B")
            cs.log(f"[mask-write] {n}^2 zlib {rates}")
            cs.log(f"[mask-write] {n}^2 writes {writes} [{card}]")
            del final, scene, masks
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def profile_multi_device(torch, dev, card, top):
    """A warm ``sharded_fill`` of bench.py's system on a (1,4) mesh of
    ``dev`` shards: the profiler's split, then the wall split by callee."""
    from satellite_approximation_tpu_torch.parallel import fill as pfill
    from satellite_approximation_tpu_torch.parallel import mg as pmg
    from satellite_approximation_tpu_torch.parallel.mesh import spatial_band_mesh

    umask, imgs = cs.bench_images()
    mesh = spatial_band_mesh(4, shape=(1, 4), devices=[dev] * 4)

    iters = []

    def run():  # returns None: wall_ms times the whole call
        _, it, rel = pfill.sharded_fill(imgs, umask, mesh, tolerance=cs.FILL_TOL)
        if rel > cs.FILL_TOL:
            raise AssertionError(f"sharded fill residual {rel} > {cs.FILL_TOL}")
        iters.append(it)

    label = f"sharded_fill {cs.BANDS}x{cs.H}x{cs.W} on {mesh} to {cs.FILL_TOL}"
    out = {"sharded_fill": profile_call(torch, label, run, 1, card, top, wall_runs=3)}
    targets = {
        "sharded_mg_solve": [(pfill, "sharded_mg_solve")],
        "host hierarchy": [(pmg, "build_sharded_hierarchy")],
        "level and tail uploads": [(pmg, "_levels"), (pmg, "_tail_hierarchies")],
        "PCG loops": [(pmg, "_pcg")],
        "replicated tail (in PCG)": [(pmg, "_tail")],
    }
    with cs.spans(torch, targets) as (took, seen):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    took = {k: round(v, 6) for k, v in took.items()}
    took["host assembly and composite (rest)"] = round(wall - took["sharded_mg_solve"], 6)
    cs.log(f"[profile] {label}: wall {wall:.3f} s, {iters[-1]} iterations, "
           f"{len(seen.get('_pcg', []))} PCG loops, {len(seen.get('_tail', []))} tail calls, "
           "synchronised at each callee's end [" + card + "]")
    for name, sec in took.items():
        cs.log(f"[profile]   {name:36s} {sec:8.3f} s {sec / wall:6.1%}")
    out["split_s"] = took
    out["split_wall_s"] = wall
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=12, help="kernels listed per call")
    parser.add_argument("--detect", type=int, nargs="?", const=4096, default=None, metavar="N",
                        help="profile the detection path at N x N instead of the fill")
    parser.add_argument("--multi-device", action="store_true",
                        help="profile the sharded fill on four shards of the card instead")
    parser.add_argument("--mask-write", action="store_true",
                        help="time detect's mask writes on the benchmark's scenes instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.REPO))
    from satellite_approximation_tpu_torch.models import fill
    from satellite_approximation_tpu_torch.models import multigrid as mg
    from satellite_approximation_tpu_torch.ops import stencil_kernels as K

    dev = torch.device("cuda")
    card = cs.phase_device(torch)
    cs.phase_build(K)
    if args.detect is not None:
        print(json.dumps({"profile": {"card": card,
                                      **profile_detect(torch, dev, card, args.top, args.detect)}}))
        return 0
    if args.multi_device:
        print(json.dumps({"profile": {"card": card,
                                      **profile_multi_device(torch, dev, card, args.top)}}))
        return 0
    if args.mask_write:
        print(json.dumps({"profile": {"card": card, "mask_write": mask_write(
            torch, dev, card)}}))
        return 0
    out = {"card": card}

    umask, imgs = cs.bench_images()
    deg, b = cs.bench_rhs(umask, imgs)
    b_t = torch.from_numpy(b).to(dev)
    x0_t = torch.from_numpy(imgs * umask).to(dev)

    def solve():
        res = mg.solve(b_t, umask, deg=deg, x0=x0_t, tolerance=cs.TOL, refinement_steps=4,
                       device_output=True)
        if res.error > cs.TOL:
            raise AssertionError(f"solve residual {res.error} > {cs.TOL}")

    out["solve"] = profile_call(torch, f"multigrid.solve {cs.BANDS}x{cs.H}x{cs.W} to {cs.TOL}",
                                solve, 3, card, args.top)
    pb = mg.prebuild(mg._device_hierarchy(umask, torch.from_numpy(deg).to(dev), dev),
                     torch.float32)
    b32 = b_t.float()
    out["v_cycle"] = profile_call(
        torch, f"one V-cycle {cs.BANDS}x{cs.H}x{cs.W} f32 (top residual emitted)",
        lambda: mg._v_cycle(pb, b32, emit_top_residual=True), 20, card, args.top)
    del b_t, x0_t, pb, b32
    torch.cuda.empty_cache()

    m = cs.tile_mask(torch, cs.TILE, dev)
    img = cs.tile_image(torch, cs.TILE, dev)
    cs.band_fill(torch, m, img, dev)  # builds the hierarchy and checks the result
    out["tile"] = profile_call(
        torch, f"laplace_fill 1x{cs.TILE}x{cs.TILE} warm",
        lambda: fill.laplace_fill(img, m, tolerance=cs.TOL, device=dev), 2, card, args.top)
    print(json.dumps({"profile": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
