"""The harness on the CPU: a tiny fill cell end to end, the generator, the
trace arithmetic, discovery of added files, the import rules and the
refusal to run without a card."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, write_json
from portbench import core, roofline, trace

SEED = 2**40 + 12345  # past 32 bits, as large seeds are


def run(root, cell="tiny.fill3", trace_on=False, seed=SEED, seconds=0.3):
    return core.run_cell(cell, seed, seconds, trace_on, time.perf_counter(), device="cpu",
                         root=root)


def test_fill_cell_on_cpu(checkout):
    res = run(checkout)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"fill_mpix_s", "setup_s"}  # no card: no peak
    assert res["metrics"]["fill_mpix_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["residual"]["value"] <= 1e-6
    assert res["checks"]["known_changed"] == {"value": 0, "limit": 0}


def test_traced_cell_on_cpu(checkout):
    res = run(checkout, trace_on=True)
    assert res["correct"] is True
    # the host-side readers read; the device's do not without a card
    assert set(res["metrics"]) == {"fill.surface_s", "fill.pcg_iterations"}
    assert res["metrics"]["fill.pcg_iterations"]["value"] > 0
    assert res["metrics"]["fill.surface_s"]["value"] >= 0


def test_generator_repeats_for_a_seed():
    g = core.Bench(ROOT).module("traffic", "scenes")

    def scene(seed):
        gen = g.generator(seed, "cpu")
        return g.smooth_bands(2, 40, 50, gen, "cpu"), g.fill_scene(40, 50, 0.3, gen, "cpu")

    a, b, c = scene(2**63 + 5), scene(2**63 + 5), scene(7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    bands = a[0]
    assert torch.equal(bands, bands.round()) and bands.min() >= 1 and bands.max() <= 10000
    assert g.call_order({"pool": 16}, 99) == g.call_order({"pool": 16}, 99)
    assert sorted(g.call_order({"pool": 16}, 99)) == list(range(16))


@pytest.mark.parametrize("cover", [0.05, 0.25, 0.6])
def test_generator_cloud_cover(cover):
    g = core.Bench(ROOT).module("traffic", "scenes")
    base = g.cloud_field(300, 240, g.generator(3, "cpu"), "cpu")
    cloud = base >= g.cover_threshold(base, cover)
    assert abs(float(cloud.float().mean()) - cover) < 0.01


def test_pool_covers_are_the_same_set_for_every_seed():
    g = core.Bench(ROOT).module("traffic", "scenes")
    covers = g.pool_covers({"pool": 16, "cloud_cover": [0.05, 0.6]})
    assert len(covers) == 16 and covers[0] > 0.05 and covers[-1] < 0.6


def test_union_and_breakdown_arithmetic():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0), ("k3", 100.0, 101.0)]
    host = [("outer", 0.0, 200.0), ("aten::copy_", 21.0, 29.0), ("sync", 45.0, 99.0)]
    assert trace.merged(dev) == [(0.0, 20.0), (30.0, 40.0), (100.0, 101.0)]
    assert trace.union_seconds(dev) == pytest.approx(31e-6)
    assert trace.seconds_by_name(dev, lambda n: n == "k1") == (pytest.approx(20e-6), 2)
    bd = trace.breakdown(dev, host)
    assert bd["device_ops"][:2] == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(15e-6)]]
    # the gap 40-100 falls in "sync", the gap 20-30 in "aten::copy_"
    assert bd["idle_gaps"] == [["sync", pytest.approx(60e-6)], ["aten::copy_", pytest.approx(10e-6)]]


def fake_run(checkout, events, calls):
    bench = core.Bench(checkout)
    ctx = SimpleNamespace(bench=bench, device=torch.device("cpu"),
                          reference=lambda: bench.module("reference", "fill"))
    invalid = np.zeros((60, 60), bool)
    invalid[10:40, 12:50] = True
    state = SimpleNamespace(images=np.zeros((2, 60, 60)), invalid=[invalid])
    return core.Run(ctx=ctx, state=state, setup={}, setup_s=1.0, calls=calls,
                    window=(0.0, 0.001), peak_bytes=0, device_events=events), invalid


@pytest.mark.parametrize("metric", ["fill.device_idle", "detect.device_idle"])
def test_device_idle_reader(checkout, metric):
    r, _ = fake_run(checkout, [("k", 0.0, 250.0), ("k", 500.0, 750.0)], [])
    idle = core.Bench(checkout).module("metrics", metric).read(r)
    assert idle == pytest.approx(50.0)


def test_smoother_roofline_reader(checkout, monkeypatch):
    calls = [{"failed": False, "scene": 0, "iterations": 3, "passes": 1, "units": 1}]
    r, invalid = fake_run(checkout, [], calls)
    um = torch.as_tensor(invalid).clone()
    um[0, :] = um[-1, :] = um[:, 0] = um[:, -1] = False
    nbytes, flops, launches = roofline.vcycle_smoother_work(um, 2)
    assert launches == 2 * (len(roofline.level_masks(um)) - 1)
    events = [("void jacobi_kernel<float>(Args)", 10.0 * i, 10.0 * i + 5.0)
              for i in range(4 * launches)]
    r.device_events = events + [("void jacobi_v2_kernel<float>(Args)", 0.0, 1.0)]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    reader = core.Bench(checkout).module("metrics", "fill.smoother_roofline")
    want = 100.0 * roofline.bound_s(4 * nbytes, 4 * flops, "NVIDIA H100 80GB HBM3") / (
        4 * launches * 5e-6)
    assert reader.read(r) == pytest.approx(want)
    r.device_events = events[:-1]
    with pytest.raises(RuntimeError, match="launches"):
        reader.read(r)


def test_kernel9_reader(checkout):
    calls = [{"failed": False, "start": 0.0, "end": float(t), "units": 1} for t in range(1, 11)]
    r, _ = fake_run(checkout, [("void directional_pass_kernel(Args)", 0.0, 3000.0),
                               ("other", 0.0, 5.0)], calls)
    bench = core.Bench(checkout)
    assert bench.module("metrics", "detect.pitfill_kernel_ms").read(r) == pytest.approx(0.3)
    r.device_events = [("other", 0.0, 5.0)]
    assert bench.module("metrics", "detect.pitfill_kernel_ms").read(r) is None


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        roofline.peaks("Some Other Card")


def test_added_cell_and_metric_are_found_by_name(checkout):
    """A new traffic mix, cell and per-layer metric come from added files
    alone: nothing the benchmark already has is edited."""
    before = {p: p.read_bytes() for p in (checkout / "portbench").rglob("*") if p.is_file()}
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.fill3b", "config": "tiny", "traffic": "tiny_pool2",
                              "chips": 1, "why": "an added cell"})
    spec["per_layer"].append({"name": "tiny.calls", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "device", "moves": "fill_mpix_s",
                              "workloads": ["tiny.fill3b"]})
    spec["end_to_end"][0]["workloads"].append("tiny.fill3b")
    write_json(checkout / "BENCHMARK.json", spec)
    write_json(checkout / "portbench/traffic/tiny_pool2.json",
               {"generator": "scenes", "requests": "fill", "pool": 2,
                "cloud_cover": [0.2, 0.3]})
    write_json(checkout / "portbench/workloads/tiny.fill3b.json",
               {"entry": "fill", "check_calls": 1, "limits": {"residual": 1e-6, "known_changed": 0}})
    (checkout / "portbench/metrics/tiny.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    assert all(p.read_bytes() == b for p, b in before.items())
    res = run(checkout, cell="tiny.fill3b", trace_on=True)
    assert res["correct"] and res["metrics"]["tiny.calls"]["value"] == res["attempted"]
    assert "fill.pcg_iterations" not in res["metrics"]  # not listed for the new cell


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_anywhere(path):
    banned = _imports(path) & {"jax", "jaxlib", "flax", "satellite_approximation_tpu", "bench",
                               "benchmarks"}
    assert not banned, f"{path} imports {banned}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "portbench/reference").rglob("*.py")):
        assert "satellite_approximation_tpu_torch" not in _imports(path), path
        assert "portbench" not in _imports(path), path


def test_module_check_compares_whole_names():
    assert core.banned_loaded(["satellite_approximation_tpu_torch.models", "numpy"]) == []
    assert core.banned_loaded(["jax.numpy", "satellite_approximation_tpu.ops"]) == [
        "jax", "satellite_approximation_tpu"]


def test_run_without_a_card_fails(tmp_path):
    """No CUDA card here: the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload", "tile20m.fill9",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, check=False,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_names_each_cell_once():
    """No two cells share a name, nor a pair of configuration and traffic,
    and each cell's mix sends the requests of the entry it drives."""
    bench = core.Bench(ROOT)
    cells = bench.spec["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        entry = bench.data("workloads", w["name"])["entry"]
        assert bench.data("traffic", w["traffic"])["requests"] == entry, w["name"]


def test_traffic_of_another_entry_is_refused(checkout):
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    next(w for w in spec["workloads"] if w["name"] == "tiny.fill3")["traffic"] = \
        "tiny_detect_pool3"
    write_json(checkout / "BENCHMARK.json", spec)
    with pytest.raises(ValueError, match="sends 'detect' requests"):
        run(checkout)
