"""The port's tracing layer (``utils/profiling.py``) on the CPU: spans,
counters and call ids recorded only under ``torch.profiler``, their place on
the profiler's timeline, worker threads, the fill's and the pit fill's spans,
and ``StageTimer``'s report."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from satellite_approximation_tpu_torch.config import DEFAULT_SOLVER
from satellite_approximation_tpu_torch.models import _surface, laplace, multigrid, poisson
from satellite_approximation_tpu_torch.models.detection import pipeline
from satellite_approximation_tpu_torch.ops import pitfill
from satellite_approximation_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(name):
    return [r for r in profiling.records() if r.name == name]


def test_nothing_is_recorded_without_a_profiler():
    assert profiling.span("fill.unknowns") is profiling._NULL
    assert profiling.span("fill.pass", pcg_iterations=3) is profiling._NULL
    assert profiling.call("fill") is profiling._NULL
    with profiling.call("fill"), profiling.span("fill.unknowns"):
        profiling.count("hierarchy_builds")
    fn = lambda: None  # noqa: E731
    assert profiling.carry(fn) is fn
    assert profiling.records() == []


def test_parents_call_ids_and_threads():
    with traced():
        for _ in range(2):
            with profiling.call("fill"):
                with profiling.span("fill.pass", pcg_iterations=0):
                    with profiling.span("fill.hierarchy"):
                        profiling.count("hierarchy_builds")
                        profiling.count("hierarchy_builds", 2)
                    profiling.count("pcg_iterations", 5)
        with profiling.span("fill.upload"):
            pass
    calls = by_name("fill.call")
    assert len(calls) == 2 and calls[0].call_id != calls[1].call_id
    assert all(r.parent is None for r in calls)
    passes, hiers = by_name("fill.pass"), by_name("fill.hierarchy")
    assert [r.call_id for r in passes] == [r.call_id for r in hiers] == [r.call_id for r in calls]
    assert {r.parent for r in passes} == {"fill.call"}
    assert {r.parent for r in hiers} == {"fill.pass"}
    assert [r.counts for r in passes] == [{"pcg_iterations": 5}] * 2
    assert [r.counts for r in hiers] == [{"hierarchy_builds": 3}] * 2
    (outside,) = by_name("fill.upload")
    assert outside.call_id is None and outside.parent is None
    main = threading.current_thread().name
    for r in profiling.records():
        assert r.thread == main
        assert r.start_ns <= r.end_ns
        # only Python numbers and strings: no tensor is kept alive
        values = [r.call_id, r.name, r.parent, r.thread, r.start_ns, r.end_ns,
                  *r.counts.keys(), *r.counts.values()]
        assert all(v is None or type(v) in (int, float, str) for v in values)
    # inner spans close first
    assert hiers[0].end_ns <= passes[0].end_ns <= calls[0].end_ns


def test_recording_stops_with_the_profiler():
    with traced():
        with profiling.span("fill.upload"):
            pass
    with profiling.span("fill.fetch"):
        pass
    assert [r.name for r in profiling.records()] == ["fill.upload"]


def test_worker_task_carries_the_callers_call_id():
    """A task handed to ``detect``'s overlap executor runs under the span
    open where it was submitted; a task handed over without ``carry`` runs
    where the profiler, which is per thread, is off, and records nothing."""

    def task(name):
        with profiling.span(name):
            return threading.current_thread().name

    pool = pipeline._get_overlap_executor()
    with traced():
        with profiling.call("detect"):
            worker = pool.submit(profiling.carry(lambda: task("detect.write cloud mask"))).result(
                timeout=60)
            pool.submit(lambda: task("detect.cloud partition")).result(timeout=60)
    (call,) = by_name("detect.call")
    (rec,) = by_name("detect.write cloud mask")
    assert rec.call_id == call.call_id and rec.parent == "detect.call"
    assert rec.thread == worker != threading.current_thread().name
    assert worker.startswith("sat-overlap")
    assert by_name("detect.cloud partition") == []


def test_span_duration_matches_the_profiler():
    """The recorder's clock and the profiler's host event of the same span
    agree within 5 % or 50 us. The two read their clocks a few statements
    apart, so a thread descheduled in between (a loaded host) parts them by
    milliseconds: the closest of five spans is held to the limit."""
    with traced() as prof:
        for _ in range(5):
            with profiling.span("fill.scatter_back"):
                time.sleep(0.005)
    ours = [(r.end_ns - r.start_ns) / 1e9 for r in by_name("fill.scatter_back")]
    theirs = [e.duration_ns() / 1e9 for e in prof.profiler.kineto_results.events()
              if e.name() == "fill.scatter_back"]
    assert len(ours) == len(theirs) == 5
    assert min(ours) > 1e-3
    assert min(abs(a - b) - max(0.05 * b, 50e-6) for a, b in zip(ours, theirs)) <= 0, (
        ours, theirs)


# the spans of a traced fill or blend call on the device route
FILL_SPANS = {"fill.call", "fill.unknowns", "fill.exactness_check", "fill.laplace_fill",
              "fill.scatter_back", "fill.hierarchy", "fill.upload", "fill.entry_residual",
              "fill.pass", "fill.residual", "fill.fetch", "fill.chunk", "fill.join"}


def _multigrid_case():
    rng = np.random.default_rng(14)
    images = rng.integers(0, 10000, size=(2, 96, 112)).astype(np.float64)
    invalid = np.zeros((96, 112), bool)
    invalid[10:80, 15:95] = True
    config = dataclasses.replace(DEFAULT_SOLVER, mg_threshold_pixels=1024)
    return images, invalid, config


def test_solve_matrix_spans_and_hierarchy_builds(monkeypatch):
    """Two calls on one mask: the first builds the multigrid hierarchy, the
    second finds it cached; every fill span carries its call's id and is
    recorded on the caller's thread, though the host surface's passes run
    on a pool (blocks of 4 KiB here), and the passes' iterations add up to
    the call's."""
    monkeypatch.setattr(_surface, "BLOCK_BYTES", 4096)
    images, invalid, config = _multigrid_case()
    multigrid._HIERARCHY_CACHE.clear()
    results = []
    with traced():
        for _ in range(2):
            results.append(laplace.solve_matrix(images, invalid, config, device="cpu")[1])
    multigrid._HIERARCHY_CACHE.clear()
    calls = by_name("fill.call")
    assert len(calls) == 2
    assert [r.counts for r in by_name("fill.hierarchy")] == [
        {"hierarchy_builds": 1}, {"hierarchy_builds": 0}]
    for call, result in zip(calls, results):
        mine = [r for r in profiling.records() if r.call_id == call.call_id]
        assert {r.name for r in mine} == FILL_SPANS
        assert {r.thread for r in mine} == {threading.current_thread().name}
        [check] = [r for r in mine if r.name == "fill.exactness_check"]
        assert check.counts["surface_threads"] == _surface._get_pool()[1]
        assert check.counts["stacks"] == 1
        [chunk] = [r for r in mine if r.name == "fill.chunk"]
        assert chunk.parent == "fill.laplace_fill" and chunk.counts == {"bands": images.shape[0]}
        passes = [r for r in mine if r.name == "fill.pass"]
        assert {r.parent for r in passes} == {"fill.chunk"}
        assert sum(r.counts["pcg_iterations"] for r in passes) == result.iterations > 0
        residuals = [r for r in mine if r.name == "fill.residual"]
        assert {r.parent for r in residuals} == {"fill.pass"}
        assert len(residuals) == len(passes)
        assert all(r.counts == {"cells": images.size, "guidance": 0} for r in residuals)


@pytest.mark.parametrize("overload", ["mask", "patch"])
def test_blend_spans_carry_the_call_id(overload):
    """Each blend call opens one ``fill.call``; the surface spans of
    ``solve_matrix`` (the exactness check over both stacks) and the
    solve's, each refinement pass's ``fill.residual`` among them (the
    guidance residual over every cell of the stack), carry its id."""
    images, invalid, config = _multigrid_case()
    repl = images[::-1] + 7.0
    if overload == "mask":
        args = (images, repl, invalid)
    else:  # the patch's non-sentinel pixels are the unknowns
        patch = repl[:, 10:80, 15:95].copy()
        patch[:, :3, :] = 1.0
        repl = np.concatenate([patch, patch[:1]])  # three channels at least
        args = (np.concatenate([images, images[:1]]), repl, None, 10, 15)
    multigrid._HIERARCHY_CACHE.clear()
    with traced():
        for _ in range(2):
            poisson.blend_images_poisson(*args, config=config, device="cpu")
    multigrid._HIERARCHY_CACHE.clear()
    calls = by_name("fill.call")
    assert len(calls) == 2 and len({r.call_id for r in calls}) == 2
    assert {r.call_id for r in profiling.records()} == {r.call_id for r in calls}
    bands, h, w = repl.shape
    for call in calls:
        mine = [r for r in profiling.records() if r.call_id == call.call_id]
        assert {r.name for r in mine} == FILL_SPANS
        assert [r.name for r in mine].count("fill.call") == 1
        [check] = [r for r in mine if r.name == "fill.exactness_check"]
        assert check.counts["stacks"] == 2 and check.parent == "fill.call"
        residuals = [r for r in mine if r.name == "fill.residual"]
        assert len(residuals) == sum(r.name == "fill.pass" for r in mine) >= 1
        assert all(r.counts == {"cells": bands * h * w, "guidance": 1} for r in residuals)
        assert {r.parent for r in residuals} == {"fill.pass"}


def test_blend_records_nothing_without_a_profiler():
    images, invalid, config = _multigrid_case()
    poisson.blend_images_poisson(images, images + 3.0, invalid, config=config, device="cpu")
    multigrid._HIERARCHY_CACHE.clear()
    assert profiling.records() == []


def test_pit_fill_records_each_level():
    """One ``pitfill.level`` a pyramid level, coarsest first, with the same
    numbers ``on_level`` sees."""
    x = torch.rand(150, 140, generator=torch.Generator().manual_seed(14)) * 0.9
    seen = []
    with traced():
        with profiling.call("detect"):
            pitfill.pit_fill(x, 0.45, on_level=lambda *a: seen.append(a))
    levels = by_name("pitfill.level")
    assert [r.counts["level"] for r in levels] == [lvl for lvl, *_ in seen] == [2, 1, 0]
    for rec, (lvl, shape, rounds, cycles) in zip(levels, seen):
        assert rec.counts["cells"] == shape[0] * shape[1]
        assert rec.counts["cycles"] == cycles == 0  # the CPU runs no cycles
        assert rec.counts["sweeps"] == sum(n for _, n in rounds) > 0
        assert rec.counts["cells_swept"] == sum(c * n for c, n in rounds) > 0
        assert rec.parent == "detect.call"


@pytest.mark.parametrize("cycles_on_cpu", [False, True])
def test_pit_fill_levels_count_no_launches_on_the_cpu(monkeypatch, cycles_on_cpu):
    """Every ``pitfill.level`` records ``launches``, kernel 9's launches in
    that level: 0 on the CPU, also where the plain version runs the cycles."""
    monkeypatch.setattr(pitfill, "_DIRECTIONAL_ON_CPU", cycles_on_cpu)
    x = torch.rand(150, 140, generator=torch.Generator().manual_seed(15)) * 0.9
    with traced():
        with profiling.call("detect"):
            pitfill.pit_fill(x, 0.45)
    levels = by_name("pitfill.level")
    assert [r.counts["launches"] for r in levels] == [0, 0, 0]
    assert (sum(r.counts["cycles"] for r in levels) > 0) == cycles_on_cpu


def test_pit_fill_level_launches_are_its_own(monkeypatch):
    """``launches`` is the change of kernel 9's launch count inside the
    level: a budget that launches its 8 cycles x 4 passes (as the card's
    does, whatever cycle it ends on) counts on the level that ran it, and a
    level without cycles counts none."""
    from satellite_approximation_tpu_torch.ops import pitfill_kernels
    from satellite_approximation_tpu_torch.ops import stencil_kernels as K

    budgets = []

    def launching(orig, border, f0, max_cycles, cycles=None):
        budgets.append(orig.shape)
        K.launch_counts[pitfill_kernels.NAME] += 4 * max_cycles
        return pitfill._directional_budget(orig, border, f0, max_cycles, cycles)

    monkeypatch.setattr(pitfill, "_DIRECTIONAL_ON_CPU", True)
    monkeypatch.setattr(pitfill_kernels, "directional_budget", launching)
    monkeypatch.setitem(K.launch_counts, pitfill_kernels.NAME, 5)
    x = torch.rand(300, 280, generator=torch.Generator().manual_seed(16)) * 0.9
    with traced():
        with profiling.call("detect"):
            pitfill.pit_fill(x, 0.45)
    levels = by_name("pitfill.level")
    assert [r.counts["cells"] for r in levels] == [38 * 35, 75 * 70, 150 * 140, 300 * 280]
    want = [4 * pitfill._DIRECTIONAL_BUDGET * budgets.count((h, w))
            for h, w in ((38, 35), (75, 70), (150, 140), (300, 280))]
    assert [r.counts["launches"] for r in levels] == want
    assert want[:2] == [0, 0] and all(want[2:])


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer("cpu")
    with traced():
        with timer.stage("cloud mask"):
            pass
        with timer.stage("matching/sweep 64x32 n=3", "matching/sweep", wb=64, hb=32, n=3):
            pass
    assert [name for name, _ in timer.stages] == ["cloud mask", "matching/sweep 64x32 n=3"]
    assert all(isinstance(t, float) for _, t in timer.stages)
    assert [(r.name, r.counts) for r in profiling.records()] == [
        ("detect.cloud mask", {}), ("detect.matching/sweep", {"wb": 64, "hb": 32, "n": 3})]


def test_stage_timer_report_keeps_overlap_out_of_the_total():
    """Stages inside another stage and stages on worker threads are listed
    apart; the total is the outermost stages of the timer's own thread."""
    timer = profiling.StageTimer()
    timer._log += [("read inputs", 1.0, False, False), ("matching/native scan", 0.5, False, True),
                   ("cloud-shadow matching", 2.0, False, False),
                   ("write cloud mask", 4.0, True, False)]
    report = timer.report().splitlines()
    assert report[:3] == ["read inputs: 1.000s (33.3%)", "cloud-shadow matching: 2.000s (66.7%)",
                          "total: 3.000s"]
    assert report[3:] == ["inside the stages above:", "  matching/native scan: 0.500s",
                          "on worker threads, overlapping the total:", "  write cloud mask: 4.000s"]


def test_stage_timer_marks_nested_and_worker_stages():
    timer = profiling.StageTimer()
    with timer.stage("cloud-shadow matching"):
        with timer.stage("matching/cast transforms"):
            pass
    t = threading.Thread(target=_one_stage, args=(timer, "write shadow masks"))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert [(n, w, nested) for n, _, w, nested in timer._log] == [
        ("matching/cast transforms", False, True), ("cloud-shadow matching", False, False),
        ("write shadow masks", True, False)]
    outer = dict(timer.stages)["cloud-shadow matching"]
    assert timer.report().splitlines()[1] == f"total: {outer:.3f}s"


def _one_stage(timer, name):
    with timer.stage(name):
        pass
