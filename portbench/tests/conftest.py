"""Fixtures of the harness's CPU tests: a copy of the benchmark in a
temporary checkout with tiny cells of its own."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny cell's unknowns are too few for the program's multigrid route,
# whose limit is 1e-9; its plain CG solves to 1e-7
TINY_CONFIG = {
    "name": "tiny", "height": 190, "width": 160, "pixel_m": 20, "diagonal_km": 4.9,
    "fill_bands": ["B02", "B03", "B04"], "reduced": [],
}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_checkout(tmp: Path) -> Path:
    """A checkout holding the benchmark's files and two tiny cells:
    ``tiny.fill3`` (3 bands of 190 x 160, a pool of 3 masks at 10-40 %) and
    ``tiny.detect`` (the same scenes detected)."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                            "file": "portbench/configs/tiny.json", "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny.fill3", "config": "tiny", "traffic": "tiny_fill_pool3",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "fill" in m["name"]:
            m["workloads"].append("tiny.fill3")
    spec["workloads"].append({"name": "tiny.detect", "config": "tiny",
                              "traffic": "tiny_detect_pool3",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "detect" in m["name"]:
            m["workloads"].append("tiny.detect")
    write_json(tmp / "BENCHMARK.json", spec)
    write_json(tmp / "portbench/configs/tiny.json", TINY_CONFIG)
    write_json(tmp / "portbench/workloads/tiny.detect.json",
               {"entry": "detect", "check_calls": 2, "control_dtype": "bfloat16",
                "limits": {"cloud_masks_differ": 0, "shadow_masks_differ": 0,
                           "status_gap": 0.0}})
    for kind in ("fill", "detect"):
        write_json(tmp / f"portbench/traffic/tiny_{kind}_pool3.json",
                   {"generator": "scenes", "requests": kind, "pool": 3, "cloud_cover": [0.1, 0.4]})
    write_json(tmp / "portbench/workloads/tiny.fill3.json",
               {"entry": "fill", "check_calls": 2,
                "limits": {"residual": 1e-6, "known_changed": 0}})
    return tmp


@pytest.fixture
def checkout(tmp_path):
    return tiny_checkout(tmp_path)
