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

The last line is one JSON object ``{"profile": {...}}``. Without a CUDA
device the script prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import chip_smoke as cs

# (kind, substrings of the kernel's name); the first match wins
KINDS = (
    ("port smoothers (jacobi.cu)", ("jacobi_kernel",)),
    ("port residual (residual.cu)", ("residual_kernel",)),
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
    """Median wall ms of one call of ``fn``, the device synchronised."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_call(torch, label, fn, reps, card, top):
    """Profile ``reps`` warm calls of ``fn``: log the device ms per call by
    kind and by kernel, and return the split."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    wall = wall_ms(torch, fn)
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
    cs.log(f"[profile] {label}: device {device:.3f} ms a call, unprofiled wall {wall:.3f} ms "
           f"(device idle {1 - device / wall:.1%}), {reps} calls profiled [{card}]")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        cs.log(f"[profile]   {kind:32s} {ms:9.3f} ms {ms / device:6.1%}")
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        cs.log(f"[profile]     {ms:9.3f} ms {n // reps:5d} launches  {name[:150]}")
    return {"device_ms": device, "wall_ms": wall, "kinds_ms": kinds}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=12, help="kernels listed per call")
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
