"""The reader ``detect.write_wait_s``: the StageTimer stage "write shadow
masks (wait)", the calling thread's wait at the end of a ``detect`` call for
the mask writes still running on the writer threads, as a mean a call.

Here: on calls built by hand it gives the wait's mean a call, and None where
no call has stages; it is listed on the two tile detect cells, in the layer
of the other detect stage metrics; and a traced tiny detect cell reports it
through the harness on the CPU."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench import core

SEED = 2**34 + 2121
NAME = "detect.write_wait_s"


def test_reads_the_wait_stage_a_call():
    read = core.Bench(ROOT).module("metrics", NAME).read
    calls = [{"units": 9, "stages": {"write shadow masks (wait)": 0.3, "write shadow masks": 2.0}},
             {"units": 9, "stages": {"write shadow masks (wait)": 0.1}},
             {"units": 9, "stages": {"final mask": 0.5}}]  # a call that did not wait
    assert read(SimpleNamespace(calls=calls)) == pytest.approx(0.4 / 3, rel=1e-12)
    assert read(SimpleNamespace(calls=[{"units": 9}])) is None
    assert read(SimpleNamespace(calls=[])) is None


def test_listed_on_the_tile_detect_cells():
    bench = core.Bench(ROOT)
    [metric] = [m for m in bench.spec["per_layer"] if m["name"] == NAME]
    [stage] = [m for m in bench.spec["per_layer"] if m["name"] == "detect.shadow_stage_s"]
    assert metric["workloads"] == ["tile20m.detect", "tile10m.detect"]
    assert (metric["unit"], metric["better"], metric["source"], metric["moves"]) == (
        "s", "lower", "program_span", "detect_mpix_s")
    assert metric["layer"] == stage["layer"]
    assert bench.spec["per_layer"][-1] == metric  # appended, nothing before it moved
    for cell in metric["workloads"]:
        assert NAME in [m["name"] for m in bench.metrics_for(cell, True)]
        assert NAME not in [m["name"] for m in bench.metrics_for(cell, False)]
    assert NAME not in [m["name"] for m in bench.metrics_for("refscene.detect", True)]


def test_traced_tiny_detect_reports_it(checkout):
    res = core.run_cell("tiny.detect", SEED, 0.2, True, time.perf_counter(), device="cpu",
                        root=checkout)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"][NAME]["unit"] == "s"
    assert 0.0 <= res["metrics"][NAME]["value"] < 5.0
