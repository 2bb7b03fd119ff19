"""The check has to fail: the control (the plain reference in float32, in
the program's place) and the faults a fill cell can have, each planted in
the timed path under an otherwise whole run, come out as not correct.

The cell here, ``small.fill2``, is large enough for the program's multigrid
route (over 256^2 unknowns), whose answers the configurations' limit of
1e-9 is stated for."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from conftest import write_json
from portbench import control, core

SEED = 3_000_000_017


@pytest.fixture
def small(checkout):
    write_json(checkout / "portbench/configs/small.json",
               {"name": "small", "height": 420, "width": 400, "fill_bands": ["B04", "B08"],
                "reduced": []})
    write_json(checkout / "portbench/traffic/small_one.json",
               {"generator": "scenes", "requests": "fill", "pool": 1, "cloud_cover": [0.5, 0.5]})
    write_json(checkout / "portbench/workloads/small.fill2.json",
               {"entry": "fill", "check_calls": 1, "control_dtype": "float32",
                "limits": {"residual": 1e-9, "known_changed": 0}})
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small", "source": "https://example.org/small",
                            "file": "portbench/configs/small.json", "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "small.fill2", "config": "small", "traffic": "small_one",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "fill" in m["name"]:
            m["workloads"].append("small.fill2")
    write_json(checkout / "BENCHMARK.json", spec)
    return core.Bench(checkout)


def run(bench):
    return core.run_cell("small.fill2", SEED, 0.05, False, time.perf_counter(), device="cpu",
                         root=bench.root)


def test_program_passes_and_control_fails(small):
    good = control.readings(small, "small.fill2", SEED, 1, device="cpu")
    assert good["correct"], good
    ref64 = control.readings(small, "small.fill2", SEED, 1, dtype="float64", device="cpu")
    assert ref64["correct"], ref64  # the reference itself, in float64, passes
    ctl = control.readings(small, "small.fill2", SEED, 1, dtype="float32", device="cpu")
    assert not ctl["correct"], ctl
    assert ctl["readings"]["residual"] > 3 * good["readings"]["residual"]


def _broken(monkeypatch, fault):
    from satellite_approximation_tpu_torch.models import laplace

    solve = laplace.solve_matrix

    def broken(images, invalid, *args, **kwargs):
        out, res = solve(images, invalid, *args, **kwargs)
        if fault == "unchanged":  # the solve hands its input back
            out = np.array(images, np.float64)
        elif fault == "half_the_bands":  # half the batch left out
            half = out.shape[0] // 2 or 1
            out = out.copy()
            out[half:] = images[half:]
        elif fault == "one_answer_altered":
            ys, xs = np.nonzero(invalid[1:-1, 1:-1])
            out = out.copy()
            out[0, ys[len(ys) // 2] + 1, xs[len(xs) // 2] + 1] += 1.0
        return out, res

    monkeypatch.setattr(laplace, "solve_matrix", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_the_bands", "one_answer_altered"])
def test_faults_in_the_timed_path_are_not_correct(small, monkeypatch, fault):
    assert run(small)["correct"] is True
    _broken(monkeypatch, fault)
    res = run(small)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["residual"]["value"] > 1e-9


@pytest.mark.gpu
def test_cell_runs_on_the_card(small):
    """The small cell end to end on a CUDA card (its kernels, the trace and
    its readers)."""
    import os

    if os.environ.get("SAT_GPU_TESTS") != "1" or not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and SAT_GPU_TESTS=1")
    res = core.run_cell("small.fill2", SEED, 1.0, True, time.perf_counter(), root=small.root)
    assert res["correct"] is True
    assert {"fill.smoother_roofline", "fill.device_idle"} <= set(res["metrics"])
    assert 0 < res["metrics"]["fill.smoother_roofline"]["value"] < 100
