"""Entry ``detect``: cloud and cloud-shadow detection of one Sentinel-2 date
through ``satellite_approximation_tpu_torch.detect`` (``use_cache=False``,
every raster handed over in memory, a ``StageTimer`` on the device), which
writes its four masks as GeoTIFFs and returns a ``Status``.

Each call writes into a folder of its own under the run's temporary
directory (``TMPDIR``), beside a small georeferencing template ``B08.tif``,
so the sampled calls' files can be read back once the window has closed.
The check compares those four masks and the Status with the plain
reference's (``reference/detection/``), pixel for pixel.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path

import numpy as np
import torch

MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")
UPSTREAM = MASKS[:2]  # made before the sun and view points enter the matching


@dataclasses.dataclass
class State:
    scenes: list  # one dict of host rasters, keyed by file stem, a scene of the pool
    order: list  # the scenes in the order the window calls them
    units: int  # scene pixels a call
    workdir: Path  # the calls' folders
    template: Path


def load(ctx) -> None:
    from satellite_approximation_tpu_torch.models.detection import pipeline  # noqa: F401


def build(ctx) -> None:
    """Load the port's CUDA kernels (kernel 9 among them) and its C++
    library (both built into ``csrc/build/`` at a checkout's first run)."""
    from satellite_approximation_tpu_torch import native

    native.available()
    if ctx.device.type == "cuda":
        from satellite_approximation_tpu_torch.ops import stencil_kernels

        stencil_kernels._library()


def prepare(ctx) -> State:
    from PIL import Image

    g = ctx.generator()
    h, w = ctx.config["height"], ctx.config["width"]
    gen = g.generator(ctx.seed, ctx.device)
    scenes = [g.detect_scene(h, w, cover, gen, ctx.device) for cover in g.pool_covers(ctx.traffic)]
    workdir = ctx.tmpdir / f"portbench-{ctx.cell}-{ctx.seed}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    template = workdir / "template.tif"
    Image.fromarray(np.zeros((1, 1), np.uint16)).save(template, format="TIFF")
    return State(scenes, g.call_order(ctx.traffic, ctx.seed), h * w, workdir, template)


def call(ctx, state: State, i: int) -> dict:
    from satellite_approximation_tpu_torch.models.detection import pipeline
    from satellite_approximation_tpu_torch.utils.profiling import StageTimer

    k = state.order[i % len(state.order)]
    folder = state.workdir / f"call-{i}"
    folder.mkdir()
    os.link(state.template, folder / "B08.tif")
    timer = StageTimer(ctx.device)
    status = pipeline.detect(
        pipeline.CloudParams.from_root(folder), ctx.config["diagonal_km"], use_cache=False,
        inputs=state.scenes[k], timer=timer, device=ctx.device)
    stages: dict = {}
    for name, seconds in timer.stages:
        stages[name] = stages.get(name, 0.0) + seconds
    return {
        "units": state.units,
        "scene": k,
        "stages": stages,
        "status": [status.percent_clouds, status.percent_shadows, status.percent_invalid],
        "output": folder,
    }


def warm(ctx, state: State) -> None:
    """One call at the cell's shapes; its folder goes."""
    call(ctx, state, -1)
    shutil.rmtree(state.workdir / "call--1")


def disk_bytes(ctx, state: State) -> int:
    return sum(p.stat().st_size for p in state.workdir.rglob("*.tif") if p.stat().st_nlink == 1)


def _read(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im).astype(bool)


def check(ctx, state: State, samples) -> dict:
    """Over the sampled calls: the most pixels by which the cloud mask or
    the potential-shadow mask differs from the reference's, the same for
    the object-based and the final shadow mask (whose matching moves with
    the rounding of the sun and view points), and the largest gap between
    a Status number and the reference's. The calls' folders go afterwards."""
    ref = ctx.reference()
    worst = {"cloud_masks_differ": 0, "shadow_masks_differ": 0, "status_gap": 0.0}
    try:
        for _, (rec, out) in samples:
            want = ref.detect(state.scenes[rec["scene"]], ctx.config["diagonal_km"], ctx.device)
            got = out if isinstance(out, dict) else {m: _read(out / f"{m}.tif") for m in MASKS}
            for m in MASKS:
                key = "cloud_masks_differ" if m in UPSTREAM else "shadow_masks_differ"
                differ = int(np.count_nonzero(got[m] != want["masks"][m]))
                worst[key] = max(worst[key], differ)
            gaps = [abs(a - b) for a, b in zip(rec["status"], want["status"])]
            worst["status_gap"] = max(worst["status_gap"], *gaps)
            if ctx.device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(state.workdir, ignore_errors=True)
    return worst


def control(ctx, state: State, i: int, dtype) -> dict:
    """Call ``i`` answered by the plain reference with its normalized
    rasters rounded to ``dtype``, in the program's place."""
    ref = ctx.reference()
    k = state.order[i % len(state.order)]
    got = ref.detect(state.scenes[k], ctx.config["diagonal_km"], ctx.device, lower=dtype)
    return {"units": state.units, "scene": k, "status": got["status"], "output": got["masks"]}
