"""Readings behind the limits of a cell's check: the program's readings on
a dozen seeds or more, and the control's, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 21 22 23] [--calls N] [--out readings.jsonl]

For every seed the cell's scenes are made as a run makes them; the program
answers ``--calls`` calls (default: the workload's ``check_calls``) through
the window's own entry, and the check judges them. For each control seed
the plain reference answers the same calls in the place of the program, in
the workload's ``control_dtype`` (the precision below the one the
configuration states), and is judged alike: the control has to come out as
not correct. One JSON line a reading goes to ``--out`` and to stdout.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(bench, cell: str, seed: int, calls: int | None, dtype=None, device=None) -> dict:
    """The check's readings of ``calls`` calls on ``seed``: the program's,
    or with ``dtype`` the plain reference's in that precision."""
    import torch

    from portbench import core

    ctx = core.make_context(bench, cell, seed, trace=False, device=device)
    entry = bench.module("entries", ctx.workload["entry"])
    entry.load(ctx)
    entry.build(ctx)
    state = entry.prepare(ctx)
    n = calls or int(ctx.workload.get("check_calls", 1))
    samples = []
    t0 = time.perf_counter()
    for i in range(n):
        if dtype is None:
            rec = entry.call(ctx, state, i)
        else:
            rec = entry.control(ctx, state, i, getattr(torch, dtype))
        samples.append((i, (rec, rec.pop("output"))))
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = entry.check(ctx, state, samples)
    ok, checks = core.judge(ctx.workload["limits"], got)
    return {"cell": cell, "seed": seed, "side": dtype or "program", "calls": n,
            "seconds": seconds, "check_seconds": time.perf_counter() - t0, "correct": ok,
            "readings": got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import core

    if not torch.cuda.is_available():
        core.log("no CUDA card")
        return 2
    bench = core.Bench(ROOT)
    core.card_line(torch, torch.device("cuda"))
    dtype = bench.data("workloads", args.workload)["control_dtype"]
    out = open(args.out, "a") if args.out else None
    jobs = [(s, None) for s in args.seeds] + [(s, dtype) for s in args.control_seeds]
    for seed, side in jobs:
        try:
            line = readings(bench, args.workload, seed, args.calls, side)
        except Exception as e:  # a control that crashes has failed and sets no upper end
            line = {"cell": args.workload, "seed": seed, "side": side or "program",
                    "error": f"{type(e).__name__}: {e}"}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
