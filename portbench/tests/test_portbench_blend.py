"""The blend cell on the CPU: what ``refscene.blend13`` reports, the reader
``fill.residual_s`` on records built by hand and on a program without the
span, and the entry ``blend`` end to end at a small scene (its calls, the
passes and iterations it records, its check and its float32 control)."""

from __future__ import annotations

import inspect
import json
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, write_json
from portbench import control, core, program_spans
from satellite_approximation_tpu_torch.utils import profiling

SEED = 2**37 + 2222  # past 32 bits, as large seeds are
CELL = "refscene.blend13"
PER_LAYER = {"fill.pcg_iterations", "fill.smoother_roofline", "fill.device_idle",
             "fill.host_surface_s", "fill.transfer_s", "fill.hierarchy_builds",
             "fill.residual_s"}


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


def test_blend_cell_reports_its_metrics():
    bench = core.Bench(ROOT)
    assert bench.cell(CELL)["chips"] == 1
    assert {m["name"] for m in bench.metrics_for(CELL, False)} == {
        "fill_mpix_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in bench.metrics_for(CELL, True)} == PER_LAYER
    [residual] = [m for m in bench.spec["per_layer"] if m["name"] == "fill.residual_s"]
    assert residual["workloads"] == [CELL, "refscene.fill13", "tile20m.fill9", "tile10m.fill4"]
    assert residual["moves"] == "fill_mpix_s" and residual["source"] == "program_span"


def test_blend_cell_runs_the_public_defaults():
    """The configuration states the public default tolerance, which the
    check's limit is."""
    from satellite_approximation_tpu_torch.models import poisson

    bench = core.Bench(ROOT)
    config = bench.config(bench.cell(CELL)["config"])
    default = inspect.signature(poisson.blend_images_poisson).parameters["tolerance"].default
    assert config["tolerance"] == default == 1e-6
    assert bench.data("workloads", CELL)["limits"] == {"residual": default, "known_changed": 0}
    assert config["reduced"] == []
    base = bench.config("s2-ref-scene-1284x1697")
    for key in ("height", "width", "fill_bands"):
        assert config[key] == base[key]


def _record(call_id, name, start_s, seconds, **counts):
    start = round(start_s * 1e9)
    return profiling.Record(call_id, name, None, "MainThread", start,
                            start + round(seconds * 1e9), counts)


def _run(records):
    return SimpleNamespace(window=(10.0, 20.0)), records


@pytest.mark.parametrize("records, want", [
    # two calls in the window, 0.25 + 0.5 and 0.125 s of residuals; one before it
    ([_record(1, "fill.call", 5.0, 1.0), _record(1, "fill.residual", 5.5, 2.0),
      _record(2, "fill.call", 11.0, 1.0), _record(2, "fill.residual", 11.1, 0.25),
      _record(2, "fill.pass", 11.0, 0.9), _record(2, "fill.residual", 11.5, 0.5),
      _record(3, "fill.call", 15.0, 1.0), _record(3, "fill.residual", 15.2, 0.125)], 0.4375),
    # a call without a pass reads 0 a call
    ([_record(2, "fill.call", 11.0, 1.0), _record(2, "fill.residual", 11.1, 0.5),
      _record(3, "fill.call", 15.0, 1.0)], 0.25),
    # the program records no such span (the parent of the span)
    ([_record(2, "fill.call", 11.0, 1.0), _record(2, "fill.pass", 11.1, 0.5)], None),
    ([], None),
])
def test_residual_reader_on_hand_built_records(monkeypatch, records, want):
    run, recs = _run(records)
    monkeypatch.setattr(profiling, "records", lambda: recs)
    got = core.Bench(ROOT).module("metrics", "fill.residual_s").read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_residual_reader_without_the_program_records(monkeypatch):
    monkeypatch.setattr(program_spans, "in_window", lambda run: None)
    assert core.Bench(ROOT).module("metrics", "fill.residual_s").read(object()) is None


@pytest.fixture
def small(checkout):
    """``small.blend3``: the blend cell's configuration at 3 bands of
    300 x 260 under the cell's own traffic and limits."""
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/s2-ref-scene-1284x1697-blend.json").read_text())
    config.update(name="small-blend", height=300, width=260, fill_bands=["B02", "B03", "B04"])
    write_json(checkout / "portbench/configs/small-blend.json", config)
    spec["configs"].append({"name": "small-blend", "source": "https://example.org/small",
                            "file": "portbench/configs/small-blend.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": "small.blend3", "config": "small-blend",
                              "traffic": "blend_pool16_cc5to60", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("small.blend3")
    write_json(checkout / "BENCHMARK.json", spec)
    write_json(checkout / "portbench/workloads/small.blend3.json",
               json.loads((ROOT / f"portbench/workloads/{CELL}.json").read_text()))
    return core.Bench(checkout)


def test_entry_calls_and_check_on_cpu(small):
    ctx = core.make_context(small, "small.blend3", SEED, trace=False, device="cpu")
    entry = small.module("entries", "blend")
    entry.load(ctx)
    entry.build(ctx)
    state = entry.prepare(ctx)
    assert state.images.shape == state.replacement.shape == (3, 300, 260)
    assert len(state.invalid) == 16 and state.units == 3 * 300 * 260
    recs = [entry.call(ctx, state, i) for i in range(2)]
    for i, rec in enumerate(recs):
        assert rec["scene"] == state.order[i] and rec["units"] == state.units
        assert rec["iterations"] > 0 and rec["passes"] >= 1
    got = entry.check(ctx, state, [(i, (rec, rec.pop("output"))) for i, rec in enumerate(recs)])
    ok, checks = core.judge(ctx.workload["limits"], got)
    assert ok, checks


def test_entry_shares_refscene_fill13s_stack_and_masks(small):
    bench = core.Bench(ROOT)
    blend = bench.module("entries", "blend")
    fill = bench.module("entries", "fill")
    ctx = core.make_context(small, "small.blend3", SEED, trace=False, device="cpu")
    a, b = blend.prepare(ctx), fill.prepare(ctx)
    assert (a.images == b.images).all() and a.order == b.order
    assert all((x == y).all() for x, y in zip(a.invalid, b.invalid))
    assert not (a.replacement == a.images).all()
    assert a.replacement.min() >= 1 and a.replacement.max() <= 10000


def test_small_cell_end_to_end_and_traced(small):
    res = core.run_cell("small.blend3", SEED, 0.3, False, time.perf_counter(), device="cpu",
                        root=small.root)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"fill_mpix_s", "setup_s"}  # no card: no peak
    res = core.run_cell("small.blend3", SEED, 0.3, True, time.perf_counter(), device="cpu",
                        root=small.root)
    assert res["correct"] is True, res["checks"]
    # the host-side readers read; the device's do not without a card
    assert set(res["metrics"]) == PER_LAYER - {"fill.smoother_roofline", "fill.device_idle"}
    assert res["metrics"]["fill.residual_s"]["value"] > 0
    assert res["metrics"]["fill.host_surface_s"]["value"] > 0


def test_program_passes_and_control_fails(small):
    good = control.readings(small, "small.blend3", SEED, 2, device="cpu")
    assert good["correct"], good
    ref64 = control.readings(small, "small.blend3", SEED, 2, dtype="float64", device="cpu")
    assert ref64["correct"], ref64  # the reference itself, in float64, passes
    ctl = control.readings(small, "small.blend3", SEED, 2, dtype="float32", device="cpu")
    assert not ctl["correct"], ctl
    assert ctl["readings"]["residual"] > 2 * good["readings"]["residual"]
