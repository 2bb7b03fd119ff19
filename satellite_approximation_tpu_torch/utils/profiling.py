"""Profiling & tracing helpers (``satellite_approximation_tpu/utils/profiling.py``).

The reference's observability is spdlog stopwatches around solves and
pipeline stages plus PerfInfo CSV rows. Here: a stage-timing context manager
that accumulates a report, and thin wrappers over ``torch.profiler`` and
NVTX ranges for device traces.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from .log import create_logger

_logger = create_logger("utils.profiling")


class StageTimer:
    """Accumulate named stage wall times; ``report()`` renders a summary.

    ``device``: the device the stages run on. CUDA work is asynchronous, so
    with a CUDA device every stage ends with a synchronise; without it a
    stage would read as the time to launch its kernels.

    Stages may be appended from worker threads (the big-scene schedule writes
    the mask files concurrently with device stages); ``list.append`` is
    GIL-atomic so the record is safe, but ``report()`` sums raw wall times —
    concurrent stages DOUBLE-COUNT in the total and the percentages, so the
    report is per-stage attribution, not an end-to-end wall-clock breakdown.
    Overlapped stages are named as such ("... (wait)") by their call sites.

    ``routes``: which implementation each routed stage took in the last run
    ("shadow stage" -> "device", ...), filled in by the pipeline.
    """

    def __init__(self, device=None):
        self.stages: list[tuple[str, float]] = []
        self.routes: dict[str, str] = {}
        self.device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.stages.append((name, dt))
            _logger.debug("%s: %.3fs", name, dt)

    def report(self) -> str:
        total = sum(t for _, t in self.stages)
        lines = [f"{name}: {t:.3f}s ({100 * t / total:.1f}%)" for name, t in self.stages]
        lines.append(f"total: {total:.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Path | str):
    """Capture a ``torch.profiler`` trace (CPU and, where present, CUDA
    activity) into ``log_dir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in device traces: a ``record_function`` span, and an
    NVTX range when a CUDA device is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
