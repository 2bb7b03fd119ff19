"""The cell ``tile10m.detect``: ``detect`` on the 10 m tile's detection
deployment (``s2-l2a-tile-10m-detect``) under the one-scene detect traffic,
and the reader ``detect.pitfill_roofline``.

Here: the cell is wired (its configuration holds what the detect entry
reads, its traffic, its workload file and limits, its place on
``detect_mpix_s`` and on every ``detect.*`` metric); a tiny copy of it (the
configuration cut to 160^2, a pixel still 10 m, under the cell's own
workload file) runs through the harness on the CPU; the reader is listed
where it reads, and on records built by hand gives the modelled share, or
None where it has nothing to read."""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, write_json
from portbench import core, roofline
from satellite_approximation_tpu_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"
SEED = 2**35 + 2020


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


CELL = "tile10m.detect"
CONFIG = "s2-l2a-tile-10m-detect"


def test_configuration_holds_the_detect_inputs():
    bench = core.Bench(ROOT)
    config = bench.config(CONFIG)
    assert (config["height"], config["width"], config["reduced"]) == (10980, 10980, [])
    assert config["pixel_m"] == 10
    assert config["diagonal_km"] == bench.config("s2-l2a-tile-10m")["diagonal_km"]
    assert set(config["detect_rasters"]) == {
        "CLP", "CLD", "SCL", "B08", "sunZenithAngles", "sunAzimuthAngles",
        "viewZenithMean", "viewAzimuthMean"}
    [entry] = [c for c in bench.spec["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == []
    # a deployment of its own: no other configuration's file or source
    others = [c for c in bench.spec["configs"] if c["name"] != CONFIG]
    assert entry["file"] not in {c["file"] for c in others}
    assert entry["source"] not in {c["source"] for c in others}


def test_cell_is_wired():
    bench = core.Bench(ROOT)
    assert bench.cell(CELL) == {
        "name": CELL, "config": CONFIG, "traffic": "detect_one_scene_cc25", "chips": 1,
        "why": bench.cell(CELL)["why"]}
    traffic = bench.data("traffic", "detect_one_scene_cc25")
    assert (traffic["requests"], traffic["pool"], traffic["cloud_cover"]) == (
        "detect", 1, [0.25, 0.25])
    workload = bench.data("workloads", CELL)
    assert (workload["entry"], workload["check_calls"], workload["control_dtype"]) == (
        "detect", 1, "bfloat16")
    limits = workload["limits"]
    assert limits["cloud_masks_differ"] == 0
    # no looser than tile20m.detect's share of its scene: 300 of 5490^2
    pixels = 10980 * 10980
    assert limits["shadow_masks_differ"] / pixels <= 300 / 5490**2
    assert limits["status_gap"] <= 1e-5


def test_cell_reports_the_detect_metrics():
    bench = core.Bench(ROOT)
    want = ["detect.shadow_stage_s", "detect.matching_s", "detect.pitfill_kernel_ms",
            "detect.device_idle", "detect.pitfill_cycles", "detect.partition_s",
            "detect.sweep_kernel_ms", "detect.pitfill_roofline"]
    assert [m["name"] for m in bench.metrics_for(CELL, True)] == want
    assert [m["name"] for m in bench.metrics_for(CELL, False)] == [
        "detect_mpix_s", "peak_mem_gib", "setup_s"]
    detect = [m["name"] for m in bench.spec["per_layer"] if m["name"].startswith("detect.")]
    assert detect == want


def test_pitfill_roofline_is_listed_where_it_reads():
    bench = core.Bench(ROOT)
    [share] = [m for m in bench.spec["per_layer"] if m["name"] == "detect.pitfill_roofline"]
    assert share["workloads"] == ["tile20m.detect", CELL]
    assert (share["unit"], share["better"], share["moves"], share["source"]) == (
        "%", "higher", "detect_mpix_s", "device_trace")
    [kernel_ms] = [m for m in bench.spec["per_layer"] if m["name"] == "detect.pitfill_kernel_ms"]
    assert share["layer"] == kernel_ms["layer"]
    assert "detect.pitfill_roofline" in [m["name"] for m in
                                         bench.metrics_for("tile20m.detect", True)]
    assert "detect.pitfill_roofline" not in [m["name"] for m in
                                             bench.metrics_for("refscene.detect", True)]


@pytest.fixture
def checkout10m(checkout):
    """The tiny checkout with ``tiny10m.detect``: the cell's configuration
    file cut to 160^2 (its diagonal with it, so a pixel stays 10 m), under
    the cell's traffic and workload file."""
    root = checkout
    config = json.loads((ROOT / f"portbench/configs/{CONFIG}.json").read_text())
    config.update(name="tiny10m", height=160, width=160,
                  diagonal_km=round(config["pixel_m"] * 160 * math.sqrt(2) / 1000, 2))
    write_json(root / "portbench/configs/tiny10m.json", config)
    write_json(root / "portbench/workloads/tiny10m.detect.json",
               json.loads((ROOT / f"portbench/workloads/{CELL}.json").read_text()))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    real = next(w for w in spec["workloads"] if w["name"] == CELL)
    spec["configs"].append({"name": "tiny10m", "source": "https://example.org/tiny10m",
                            "file": "portbench/configs/tiny10m.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append(dict(real, name="tiny10m.detect", config="tiny10m"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny10m.detect")
    write_json(root / "BENCHMARK.json", spec)
    return root


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_copy_runs_on_cpu(checkout10m, trace_on):
    res = core.run_cell("tiny10m.detect", SEED, 0.2, trace_on, time.perf_counter(),
                        device="cpu", root=checkout10m)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    if not trace_on:
        assert set(res["metrics"]) == {"detect_mpix_s", "setup_s"}  # no card: no peak
        return
    assert {"detect.shadow_stage_s", "detect.pitfill_cycles"} <= set(res["metrics"])
    # no card: no device trace, so no kernel time and no share
    assert "detect.pitfill_roofline" not in res["metrics"]


def _level(call_id, start_s, cells, cycles, launches=None):
    counts = {"level": 0, "cells": cells, "cycles": cycles, "sweeps": 1, "cells_swept": cells}
    if launches is not None:
        counts["launches"] = launches
    start = round(start_s * 1e9)
    return profiling.Record(call_id, "pitfill.level", "detect.potential shadow mask",
                            "MainThread", start, start + 10**7, counts)


KERNEL = "void (anonymous namespace)::directional_pass_kernel(Args)"


def _run(device_events):
    return SimpleNamespace(window=(10.0, 20.0), device_events=device_events,
                           ctx=SimpleNamespace(device="cuda"))


@pytest.fixture
def reader(monkeypatch):
    mod = core.Bench(ROOT).module("metrics", "detect.pitfill_roofline")
    monkeypatch.setattr(mod, "_kind", lambda device: H100)
    return mod


def _kernel_events(n, us_each):
    return [(KERNEL, 100.0 * i, 100.0 * i + us_each) for i in range(n)] + [
        ("void at::native::elementwise_kernel", 5000.0, 9000.0)]


def test_pitfill_roofline_models_the_cycles_bytes(reader, monkeypatch):
    """Two calls in the window (one before it is left out): 48 B a cell a
    cycle over the cycles run, at 3.35 TB/s, over kernel 9's summed time;
    the launches (64 a call: two budgets of 8 cycles x 4 passes) agree with
    the profiler's."""
    recs = [_level(1, 5.0, 10**8, 9, 64)]
    for cid, t0 in ((2, 11.0), (3, 15.0)):
        recs += [_level(cid, t0, 120_560_400, 12, 64), _level(cid, t0 + 0.1, 30_140_100, 7, 32),
                 _level(cid, t0 + 0.2, 29_929, 0, 0)]
    monkeypatch.setattr(profiling, "_RECORDS", recs)
    events = _kernel_events(192, 50.0)
    nbytes = 48 * 2 * (120_560_400 * 12 + 30_140_100 * 7)
    want = 100.0 * nbytes / roofline.PEAKS[H100]["hbm_bytes_per_s"] / (192 * 50e-6)
    assert reader.read(_run(events)) == pytest.approx(want, rel=1e-12)


def test_pitfill_roofline_reads_nothing_where_it_cannot(reader, monkeypatch):
    recs = [_level(2, 11.0, 120_560_400, 12, 64), _level(2, 11.1, 30_140_100, 7, 32)]
    monkeypatch.setattr(profiling, "_RECORDS", recs)
    assert reader.read(_run(_kernel_events(96, 40.0))) is not None
    # a launch the program did not count, or one it counted and the card never ran
    assert reader.read(_run(_kernel_events(97, 40.0))) is None
    assert reader.read(_run(_kernel_events(95, 40.0))) is None
    # kernel 9 did not run; no trace at all
    assert reader.read(_run(_kernel_events(0, 40.0))) is None
    assert reader.read(_run([])) is None
    # a program whose levels record no launches (older than the counter)
    monkeypatch.setattr(profiling, "_RECORDS", [_level(2, 11.0, 120_560_400, 12)])
    assert reader.read(_run(_kernel_events(64, 40.0))) is None
    # no levels in the window
    monkeypatch.setattr(profiling, "_RECORDS", [_level(2, 25.0, 120_560_400, 12, 64)])
    assert reader.read(_run(_kernel_events(64, 40.0))) is None
    monkeypatch.delattr(profiling, "records")
    assert reader.read(_run(_kernel_events(64, 40.0))) is None
