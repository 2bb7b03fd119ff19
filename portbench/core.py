"""The benchmark's harness: finds a cell's files by name, sets the cell up,
runs its closed-loop window, checks what the window produced against the
plain reference and prints the result line.

Everything that belongs to one configuration, traffic mix, entry, reference
or metric is a file of its own under ``portbench/``, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment's sizes;
* ``traffic/<traffic>.json``: the mix's parameters, ``"requests"``, the
  entry whose calls it sends, and ``"generator"``, the module
  ``traffic/<generator>.py`` that makes its scenes;
* ``workloads/<cell>.json``: the entry that drives the window, its options
  and the limits of the numbers the check compares;
* ``entries/<entry>.py``: set-up, one call, the check, the spans;
* ``reference/<entry>.py``: the plain reference the check uses;
* ``metrics/<metric>.py``: ``read(run)``, the value of one metric from the
  run's record, or None where the run has nothing to read.

A later cell, mix or metric is added by adding files; no file here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from pathlib import Path

from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the process may not hold once the window has
# closed: JAX and the JAX package (compared whole, so the port's own name,
# which begins with the JAX package's, passes)
BANNED_MODULES = ("jax", "jaxlib", "flax", "satellite_approximation_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def banned_loaded(modules=None) -> list[str]:
    """The banned top-level names among ``modules`` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(BANNED_MODULES))


class Bench:
    """``BENCHMARK.json`` and the files under ``portbench/`` of one checkout."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict[tuple[str, str], object] = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def data(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``portbench/<kind>/<name>.py``, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} module {path}")
            mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod  # dataclasses look their module up there
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a cell reports: its end-to-end metrics, or with
        ``trace`` its per-layer ones (a metric without ``workloads`` is
        every cell's)."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Context:
    """What an entry sees of the run."""

    bench: Bench
    cell: str
    config: dict
    traffic: dict
    workload: dict
    seed: int
    device: object  # torch.device
    tmpdir: Path
    trace: bool = False

    def generator(self):
        return self.bench.module("traffic", self.traffic["generator"])

    def reference(self):
        return self.bench.module("reference", self.workload["entry"])


@dataclasses.dataclass
class Run:
    """The record of one run, which the metric readers read."""

    ctx: Context
    state: object
    setup: dict  # seconds of each part of the set-up
    setup_s: float
    calls: list  # one dict a call: start, end, units and the entry's facts
    window: tuple  # (first call's start, last call's end), host clock
    peak_bytes: int
    spans: dict = dataclasses.field(default_factory=dict)  # name -> seconds a call
    device_events: list = dataclasses.field(default_factory=list)  # (name, start_us, end_us)
    host_events: list = dataclasses.field(default_factory=list)  # (name, start_us, end_us)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def units(self) -> float:
        return float(sum(c["units"] for c in self.calls))


def reservoir(keep: int, seed: int):
    """A seeded uniform sample of ``keep`` calls out of however many come:
    ``offer(i, item)`` keeps or drops call i; ``items()`` the sample."""
    rng = random.Random(seed)
    slots: list = []

    def offer(i, item):
        if len(slots) < keep:
            slots.append((i, item))
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                slots[j] = (i, item)

    return offer, lambda: sorted(slots, key=lambda s: s[0])


def span(ctx, name: str):
    """A named host span in a traced run's profile (nothing otherwise): the
    idle gaps of the breakdown are labelled by the innermost one."""
    if not ctx.trace:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def window_loop(entry, ctx, state, seconds: float, offer) -> list:
    """Whole calls back to back, one caller, until ``seconds`` have passed;
    a call running at the deadline finishes and counts."""
    calls = []
    deadline = time.perf_counter() + seconds
    i = 0
    while not calls or time.perf_counter() < deadline:
        t0 = time.perf_counter()
        try:
            with span(ctx, f"portbench: {ctx.workload['entry']} call"):
                rec = entry.call(ctx, state, i)
            rec["failed"] = False
        except Exception:  # a call that raises counts as failed; the window goes on
            log(f"call {i} failed:\n{traceback.format_exc()}")
            rec = {"units": 0, "failed": True, "output": None}
        rec["start"], rec["end"] = t0, time.perf_counter()
        output = rec.pop("output", None)
        if not rec["failed"]:
            offer(i, (rec, output))
        calls.append(rec)
        i += 1
    return calls


def judge(limits: dict, readings: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}})."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("inf"))
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def read_metrics(run: Run, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        value = run.ctx.bench.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_line(torch, device) -> dict:
    """The card's name, count and power limit (nvidia-smi), printed on an
    early line."""
    import subprocess

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    kind = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=False,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    log(f"card: {kind}, power limit {limit}, {torch.cuda.device_count()} visible")
    return {"platform": "gpu", "kind": kind, "count": 1}


def make_context(bench: Bench, cell: str, seed: int, trace: bool, device=None,
                 tmpdir: Path | None = None) -> Context:
    """The context of one run of ``cell``; ``device`` None is the CUDA card."""
    import tempfile

    import torch

    spec = bench.cell(cell)
    workload = bench.data("workloads", cell)
    traffic = bench.data("traffic", spec["traffic"])
    if traffic["requests"] != workload["entry"]:
        raise ValueError(f"cell {cell!r} drives {workload['entry']!r}, but its traffic "
                         f"{spec['traffic']!r} sends {traffic['requests']!r} requests")
    return Context(
        bench=bench, cell=cell, config=bench.config(spec["config"]),
        traffic=traffic, workload=workload, seed=int(seed),
        device=torch.device("cuda" if device is None else device),
        tmpdir=Path(tmpdir or tempfile.gettempdir()), trace=trace,
    )


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, root: Path | str = ROOT, tmpdir: Path | None = None) -> dict:
    """Set up, run and check one cell; returns the result line's object.
    ``device`` None is the CUDA card (the caller has looked for it)."""
    import torch

    setup = {}
    bench = Bench(root)
    ctx = make_context(bench, cell, seed, trace, device, tmpdir)
    workload = ctx.workload
    dev = ctx.device
    card = card_line(torch, dev)
    entry = bench.module("entries", workload["entry"])
    entry.load(ctx)
    setup["import"] = time.perf_counter() - t_start

    t = time.perf_counter()
    entry.build(ctx)
    setup["kernel load"] = time.perf_counter() - t
    t = time.perf_counter()
    state = entry.prepare(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["scene generation"] = time.perf_counter() - t
    t = time.perf_counter()
    entry.warm(ctx, state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup["warm-up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in setup.items())
        + f"; setup_s {setup_s:.3f} s")

    offer, kept = reservoir(int(workload.get("check_calls", 1)), ctx.seed)
    spans: dict = {}
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            if hasattr(entry, "spans"):
                stack.enter_context(entry.spans(ctx, state, spans))
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=acts))
        calls = window_loop(entry, ctx, state, seconds, offer)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    window = (calls[0]["start"], calls[-1]["end"])
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    found = banned_loaded()
    if found:
        raise SystemExit(f"[portbench] the process holds {found} once the window has closed")
    card["memory_peak_bytes"] = peak
    failed = sum(1 for c in calls if c["failed"])
    walls = sorted(c["end"] - c["start"] for c in calls)
    log(f"window: {len(calls)} calls in {window[1] - window[0]:.3f} s, {failed} failed; "
        f"a call's wall min {walls[0]:.3f} s, median {walls[len(walls) // 2]:.3f} s, "
        f"max {walls[-1]:.3f} s; {entry.disk_bytes(ctx, state)} bytes written to disk")

    run = Run(ctx, state, setup, setup_s, calls, window, peak, spans)
    if prof is not None:
        t = time.perf_counter()
        run.device_events, run.host_events = tr.events(prof)
        prof = None
        log(f"trace: {len(run.device_events)} device and {len(run.host_events)} host events "
            f"read in {time.perf_counter() - t:.3f} s")
        card["busy_s"] = tr.union_seconds(run.device_events)
        card["window_s"] = run.window_s
    metrics = read_metrics(run, bench.metrics_for(cell, trace))

    # the check: after the window, with the peak read and the program's
    # cached device memory handed back
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    samples = kept()
    readings = entry.check(ctx, state, samples)
    ok, checks = judge(workload["limits"], readings)
    log(f"check of {len(samples)} sampled calls ({[i for i, _ in samples]}) took "
        f"{time.perf_counter() - t:.3f} s")
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": card,
    }
    if trace and run.device_events:
        result["breakdown"] = tr.breakdown(run.device_events, run.host_events)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return result
