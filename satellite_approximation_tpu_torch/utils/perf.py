"""Per-solve performance telemetry.

Replaces the reference's PerfInfo CSV appender (poisson.h:12-21,
poisson.cpp:14-19, 218-261) — with a *configurable* output path instead of
the hardcoded developer-machine path at poisson.cpp:287-289 (a known
reference bug, SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path


@dataclasses.dataclass
class PerfInfo:
    """CSV row schema: region_size, tolerance, max_iterations, iterations,
    error, solve_time (ms)."""

    region_size: int = 0
    tolerance: float = 0.0
    max_iterations: int = 0
    iterations: int = 0
    error: float = 0.0
    solve_time: float = 0.0

    def write(self, output: Path | str) -> None:
        output = Path(output)
        output.parent.mkdir(parents=True, exist_ok=True)
        with open(output, "a") as f:
            f.write(
                f"{self.region_size},{self.tolerance},{self.max_iterations},"
                f"{self.iterations},{self.error},{self.solve_time}\n"
            )


class Stopwatch:
    """Wall-clock stopwatch (spdlog::stopwatch analog, laplace.cpp:129-131)."""

    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def restart(self) -> None:
        self.start = time.perf_counter()
