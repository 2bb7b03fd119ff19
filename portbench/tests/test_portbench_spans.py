"""The readers of the program's own spans and counters on the CPU: each on a
traced run of a tiny cell and on records built by hand (a mean a call,
records outside the window left out, None without records), and the
breakdown naming the program's fill spans."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import core, program_spans, trace
from satellite_approximation_tpu_torch.models import laplace
from satellite_approximation_tpu_torch.utils import profiling

SEED = 2**35 + 1414
FILL_READERS = ("fill.host_surface_s", "fill.transfer_s", "fill.hierarchy_builds")


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


def run(root, cell, trace_on):
    return core.run_cell(cell, SEED, 0.3, trace_on, time.perf_counter(), device="cpu", root=root)


def test_fill_readers_on_a_traced_tiny_run(checkout):
    res = run(checkout, "tiny.fill3", True)
    assert res["correct"] is True, res["checks"]
    got = {name: res["metrics"][name]["value"] for name in FILL_READERS}
    assert got["fill.hierarchy_builds"] == 0.0  # the tiny cell's solve is plain CG
    assert got["fill.transfer_s"] > 0
    # the part of the public surface's host work that the program's spans cover
    assert 0 < got["fill.host_surface_s"] <= res["metrics"]["fill.surface_s"]["value"] + 1e-3


def test_pitfill_reader_on_a_traced_tiny_run(checkout):
    res = run(checkout, "tiny.detect", True)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["detect.pitfill_cycles"]["value"] == 0.0  # the CPU runs no cycles


def _record(call_id, name, start_s, seconds, **counts):
    start = round(start_s * 1e9)
    return profiling.Record(call_id, name, None, "MainThread", start,
                            start + round(seconds * 1e9), counts)


def _hand_built():
    """Two fill calls inside the window (10.0, 20.0) and one before it."""
    recs = []
    for cid, t0, builds in ((1, 5.0, 1), (2, 11.0, 1), (3, 15.0, 0)):
        recs += [
            _record(cid, "fill.unknowns", t0 + 0.1, 0.25),
            _record(cid, "fill.exactness_check", t0 + 0.4, 0.5),
            _record(cid, "fill.hierarchy", t0 + 1.0, 0.1, hierarchy_builds=builds),
            _record(cid, "fill.upload", t0 + 1.2, 0.125),
            _record(cid, "fill.pass", t0 + 1.5, 1.0, pcg_iterations=4),
            _record(cid, "fill.fetch", t0 + 2.6, 0.0625),
            _record(cid, "fill.scatter_back", t0 + 2.8, 0.75),
            _record(cid, "fill.call", t0, 3.0),
        ]
    recs += [_record(4, "pitfill.level", 12.0, 0.1, cells=100, cycles=3, sweeps=2),
             _record(4, "pitfill.level", 12.2, 0.1, cells=400, cycles=5, sweeps=2),
             _record(4, "detect.call", 11.5, 2.0),
             _record(5, "detect.call", 14.0, 2.0)]
    return recs


@pytest.mark.parametrize("metric, want", [
    ("fill.host_surface_s", 1.5), ("fill.transfer_s", 0.1875), ("fill.hierarchy_builds", 0.5),
    ("detect.pitfill_cycles", 4.0),
])
def test_reader_on_hand_built_records(checkout, monkeypatch, metric, want):
    """A mean over the calls that start in the window; the call before it
    (a warm-up) is left out, and a call without levels counts as 0."""
    monkeypatch.setattr(profiling, "_RECORDS", _hand_built())
    reader = core.Bench(checkout).module("metrics", metric)
    r = SimpleNamespace(window=(10.0, 20.0))
    assert reader.read(r) == pytest.approx(want)
    monkeypatch.setattr(profiling, "_RECORDS", [])
    assert reader.read(r) is None


def test_reader_without_the_recorder(monkeypatch):
    """A program that keeps no records (the benchmark laid over an older
    checkout) reads as nothing, and raises nothing."""
    monkeypatch.delattr(profiling, "records")
    assert program_spans.in_window(SimpleNamespace(window=(0.0, 1e9))) is None
    assert program_spans.per_call(SimpleNamespace(window=(0.0, 1e9)), "fill", len) is None


def test_breakdown_names_the_fill_spans():
    """The gaps between the torch operations of a traced CPU fill (the
    device's place on a card) fall to the program's ``fill.*`` spans, not to
    the call around them."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 10000, size=(2, 60, 50)).astype(np.float64)
    invalid = np.zeros((60, 50), bool)
    invalid[10:50, 8:42] = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        laplace.solve_matrix(images, invalid, device="cpu")
    _, host = trace.events(prof)
    ops = [e for e in host if e[0].startswith("aten::")]
    gaps = trace.breakdown(ops, host)["idle_gaps"]
    assert any(name.startswith("fill.") and name != "fill.call" for name, _ in gaps), gaps
