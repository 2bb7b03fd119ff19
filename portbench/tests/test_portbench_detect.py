"""The detect entry on the CPU: a tiny cell end to end against the plain
reference, the control (the reference with its normalized rasters rounded
to bfloat16) and the faults a detect cell can have, planted in the timed
path, all come out as not correct. The reference, which runs the plain
host routes only, agrees with both of the program's routes: the host route
it takes on small scenes and the device-stage route it takes on a tile."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, core

SEED = 2**33 + 77


def run(root, trace_on=False, seconds=0.2):
    return core.run_cell("tiny.detect", SEED, seconds, trace_on, time.perf_counter(),
                         device="cpu", root=root)


def test_detect_cell_on_cpu(checkout):
    res = run(checkout)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"detect_mpix_s", "setup_s"}  # no card: no peak
    assert res["checks"] == {"cloud_masks_differ": {"value": 0, "limit": 0},
                             "shadow_masks_differ": {"value": 0, "limit": 0},
                             "status_gap": {"value": 0.0, "limit": 0.0}}
    assert not list(checkout.glob("**/call-*"))  # the calls' folders are gone


def test_traced_detect_on_cpu(checkout):
    res = run(checkout, trace_on=True)
    assert res["correct"] is True
    assert {"detect.shadow_stage_s", "detect.matching_s"} == set(res["metrics"])


def test_control_is_not_correct(checkout):
    bench = core.Bench(checkout)
    good = control.readings(bench, "tiny.detect", SEED, 2, device="cpu")
    assert good["correct"], good
    ctl = control.readings(bench, "tiny.detect", SEED, 2, dtype="bfloat16", device="cpu")
    assert not ctl["correct"], ctl
    assert ctl["readings"]["cloud_masks_differ"] > 0


def _plant(monkeypatch, fault):
    from satellite_approximation_tpu_torch.models.detection import pipeline, shadow_mask

    if fault == "unchanged":  # the pit fill hands its input back
        monkeypatch.setattr(shadow_mask, "pit_fill", lambda original, border: original)
    elif fault == "one_answer_altered":  # one pixel of the cloud mask flipped as written
        write = pipeline._write_mask

        def flipped(mask, out_path, template):
            if out_path.name == "cloud_mask.tif":
                mask = np.array(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
                mask[mask.shape[0] // 2, mask.shape[1] // 2] ^= True
            write(mask, out_path, template)

        monkeypatch.setattr(pipeline, "_write_mask", flipped)


@pytest.mark.parametrize("fault", ["unchanged", "one_answer_altered"])
def test_faults_in_the_timed_path_are_not_correct(checkout, monkeypatch, fault):
    _plant(monkeypatch, fault)
    res = run(checkout)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["cloud_masks_differ"]["value"] > 0


def _scene(h=300, w=260, cover=0.3, seed=SEED):
    from portbench.traffic import scenes

    return scenes.detect_scene(h, w, cover, scenes.generator(seed, "cpu"), "cpu")


def _program_masks(scene, diagonal, config, tmp: Path) -> dict:
    from PIL import Image

    from satellite_approximation_tpu_torch.models.detection import pipeline

    Image.fromarray(np.zeros((1, 1), np.uint16)).save(tmp / "B08.tif", format="TIFF")
    status = pipeline.detect(pipeline.CloudParams.from_root(tmp), diagonal, use_cache=False,
                             inputs=scene, config=config, device="cpu")
    masks = {}
    for m in ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask"):
        with Image.open(tmp / f"{m}.tif") as im:
            masks[m] = np.array(im).astype(bool)
    return {"masks": masks,
            "status": [status.percent_clouds, status.percent_shadows, status.percent_invalid]}


@pytest.mark.parametrize("route", ["host", "device_stages"])
@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 5])
def test_reference_agrees_with_each_route_of_the_program(tmp_path, route, seed):
    """``device_stages`` forces the program's tile route on the CPU: the
    torch geometry, the device matching sweep, the torch beta map and
    refinement, none of which the reference runs."""
    from satellite_approximation_tpu_torch.config import DEFAULT_DETECTION

    from portbench.reference import detect as ref

    config = DEFAULT_DETECTION
    if route == "device_stages":
        config = dataclasses.replace(
            config, matching=dataclasses.replace(config.matching, backend="torch"),
            refinement=dataclasses.replace(config.refinement, backend="torch"))
    scene = _scene(seed=seed)
    got = _program_masks(scene, 7.9, config, tmp_path)
    want = ref.detect(scene, 7.9, "cpu")
    assert any(want["masks"]["object_based_shadows"].ravel())  # clouds were matched
    for m, mask in want["masks"].items():
        assert np.array_equal(got["masks"][m], mask), m
    assert got["status"] == want["status"]


def test_matching_scan_against_the_program_sweeps():
    """The reference's own scan gives the program's solutions, with the
    native scan and with the device sweep."""
    from satellite_approximation_tpu_torch.models.detection import matching as pm

    from portbench.reference.detection import cloud_mask as rcm
    from portbench.reference.detection import matching as rm
    from portbench.reference.detection.pipeline import _normalized

    scene = _scene(h=340, w=300, cover=0.35, seed=11)
    clp = _normalized(scene["CLP"], 255, "cpu")
    cld = _normalized(scene["CLD"], 100, "cpu")
    scl = torch.as_tensor(scene["SCL"])
    gen = rcm.generate_cloud_mask_ignore_low_probability(clp, cld, scl)
    cmap, clouds = rcm.partition_cloud_mask(gen.cloud_mask_no_processing, 8.0, 3, device="cpu")
    psm = np.roll(gen.cloud_mask_no_processing, (9, -7), axis=(0, 1))  # shadows cast south-east
    sun = np.array([-3.0e8, 4.0e8, 1.3e9])
    view = np.array([2.0, 6.0, 785.0])
    want = rm.match_clouds_shadows(clouds, cmap, gen.cloud_mask_no_processing, psm, 8.0, sun,
                                   view, device="cpu")
    assert sum(s.similarity > 0 for s in want.solutions.values()) >= 3
    for native in (True, False):
        got = pm.match_clouds_shadows(clouds, cmap, gen.cloud_mask_no_processing, psm, 8.0, sun,
                                      view, use_native=native, device="cpu")
        assert np.array_equal(got.shadow_mask, want.shadow_mask)
        assert got.trimmed_mean_height == want.trimmed_mean_height
        for cid, sol in want.solutions.items():
            assert (got.solutions[cid].height, got.solutions[cid].similarity) == (
                sol.height, sol.similarity)
            assert got.shadows[cid].area == want.shadows[cid].area
            assert got.shadows[cid].bounds == want.shadows[cid].bounds
