"""The reader ``fill.band_chunks`` on the CPU: traced runs of a tiny copy of
the 10 m tile's configuration and cell with the program's chunks forced to
1, 2, 3 and 4 bands, an untraced run, and records built by hand (a mean a
call over the window, None where the program records no ``fill.chunk``)."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, write_json
from portbench import core
from satellite_approximation_tpu_torch.models import fill, multigrid
from satellite_approximation_tpu_torch.utils import profiling

SEED = 2**35 + 1616
H, W = 120, 104
CELL = "tiny10m.fill4"


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()
    multigrid._HIERARCHY_CACHE.clear()


@pytest.fixture
def checkout10m(checkout):
    """The tiny checkout with ``tiny10m.fill4``: the 10 m configuration's
    file at H x W, under the cell's own traffic (16 masks at 5-60 %), the
    cell's workload with the plain CG's limit (the tiny grid's unknowns are
    too few for the multigrid route)."""
    root = checkout
    config = json.loads((ROOT / "portbench/configs/s2-l2a-tile-10m.json").read_text())
    config.update(name="tiny10m", height=H, width=W)
    write_json(root / "portbench/configs/tiny10m.json", config)
    workload = json.loads((ROOT / "portbench/workloads/tile10m.fill4.json").read_text())
    workload["limits"]["residual"] = 1e-6
    write_json(root / f"portbench/workloads/{CELL}.json", workload)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    real = next(w for w in spec["workloads"] if w["name"] == "tile10m.fill4")
    spec["configs"].append({"name": "tiny10m", "source": "https://example.org/tiny10m",
                            "file": "portbench/configs/tiny10m.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append(dict(real, name=CELL, config="tiny10m"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tile10m.fill4" in m.get("workloads", []):
            m["workloads"].append(CELL)
    write_json(root / "BENCHMARK.json", spec)
    return root


def run(root, trace_on):
    return core.run_cell(CELL, SEED, 0.3, trace_on, time.perf_counter(), device="cpu", root=root)


@pytest.mark.parametrize("bands_per_chunk, chunks", [(1, 4), (2, 2), (3, 2), (4, 1)])
def test_traced_run_reads_the_chunks(checkout10m, monkeypatch, bands_per_chunk, chunks):
    monkeypatch.setattr(fill, "chunk_elements", lambda device: bands_per_chunk * H * W)
    res = run(checkout10m, True)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["fill.band_chunks"] == {"value": float(chunks), "unit": "count"}


def test_untraced_run_reads_nothing(checkout10m, monkeypatch):
    monkeypatch.setattr(fill, "chunk_elements", lambda device: 2 * H * W)
    res = run(checkout10m, False)
    assert res["correct"] is True, res["checks"]
    assert "fill.band_chunks" not in res["metrics"]
    assert set(res["metrics"]) == {"fill_mpix_s", "setup_s"}  # no card: no peak


def _record(call_id, name, start_s):
    start = round(start_s * 1e9)
    return profiling.Record(call_id, name, None, "MainThread", start, start + 10**8, {})


def test_reader_on_hand_built_records(monkeypatch):
    """Calls of 2 and 1 chunks inside the window (10, 20), one of 4 before
    it; a program whose calls record no ``fill.chunk`` (an older checkout)
    reads as nothing."""
    recs = []
    for cid, t0, n in ((1, 5.0, 4), (2, 11.0, 2), (3, 15.0, 1)):
        recs.append(_record(cid, "fill.call", t0))
        recs += [_record(cid, "fill.chunk", t0 + 0.5 + i) for i in range(n)]
        recs.append(_record(cid, "fill.upload", t0 + 0.2))
    reader = core.Bench(ROOT).module("metrics", "fill.band_chunks")
    window = SimpleNamespace(window=(10.0, 20.0))
    monkeypatch.setattr(profiling, "_RECORDS", recs)
    assert reader.read(window) == pytest.approx(1.5)
    monkeypatch.setattr(profiling, "_RECORDS", [r for r in recs if r.name != "fill.chunk"])
    assert reader.read(window) is None
    monkeypatch.setattr(profiling, "_RECORDS", [])
    assert reader.read(window) is None
    monkeypatch.delattr(profiling, "records")
    assert reader.read(window) is None
