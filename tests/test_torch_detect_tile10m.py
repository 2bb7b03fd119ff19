"""``detect`` at the 10 m tile's pixel size on the CPU, held to the
benchmark's plain reference (``portbench/reference/detection/``, which runs
every stage on its plain host route and imports nothing of the port).

A 10980^2 tile (configuration ``s2-l2a-tile-10m``) takes the device-stage
route: the scene is a big one, so on the card every stage from the cloud
mask on runs there, the matching sweeps its buckets and the mask writes
overlap. Here the same placement is forced on the CPU (the size gate
``BIG_SCENE_PIXELS`` patched down, both backends "torch", so the torch sweep
stands in for kernel 11) on 256^2 scenes of the benchmark's generator whose
diagonal makes a pixel 10 m. The matching's cast offsets are in km, so at
10 m they are twice as many pixels as at 20 m; a window may pass the
largest of the matching's buckets, which a thin strip cloud reaches here,
and stays in the sweep in a bucket of the next power of two.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from portbench.reference import detect as reference
from portbench.reference.detection import cloud_mask as ref_cm
from portbench.reference.detection import matching as ref_match
from portbench.reference.detection import refinement as ref_refinement
from portbench.traffic import scenes
from satellite_approximation_tpu_torch import config as t_config
from satellite_approximation_tpu_torch.models.detection import cloud_mask as t_cm
from satellite_approximation_tpu_torch.models.detection import matching as t_match
from satellite_approximation_tpu_torch.models.detection import pipeline
from satellite_approximation_tpu_torch.models.detection import refinement as t_ref
from satellite_approximation_tpu_torch.models.detection import refinement_torch as t_refdev
from satellite_approximation_tpu_torch.utils import profiling
from satellite_approximation_tpu_torch.utils.profiling import StageTimer
from torch_parity import strip_scene

N = 256
PIXEL_KM = 0.010
DIAG_KM = N * math.sqrt(2) * PIXEL_KM
MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


def _device_route_config():
    c = t_config.DEFAULT_DETECTION
    return dataclasses.replace(
        c, matching=dataclasses.replace(c.matching, backend="torch"),
        refinement=dataclasses.replace(c.refinement, backend="torch"))


def _program(scene, tmp_path, timer):
    folder = tmp_path / "date"
    folder.mkdir()
    Image.fromarray(np.zeros((1, 1), np.uint16)).save(folder / "template.tif", format="TIFF")
    os.link(folder / "template.tif", folder / "B08.tif")
    status = pipeline.detect(pipeline.CloudParams.from_root(folder), DIAG_KM, use_cache=False,
                             inputs=scene, config=_device_route_config(), timer=timer,
                             device="cpu")
    masks = {}
    for m in MASKS:
        with Image.open(folder / f"{m}.tif") as im:
            masks[m] = np.array(im).astype(bool)
    return masks, [status.percent_clouds, status.percent_shadows, status.percent_invalid]


@pytest.mark.parametrize("seed", [2**31 + 11, 5000000019, 7])
def test_device_route_at_10m_pixels_against_the_reference(tmp_path, monkeypatch, seed):
    """The cell's placement on a 10 m scene: every mask and the Status
    equal to the reference's. Cloud masks bit-equal by definition; the
    shadow masks and the Status also with no tolerance, as the benchmark's
    CPU tests of the tile route hold them: on the CPU the torch sun/view
    reduction gives the chunked host one's points, and the card's ~4e-8
    gap (which the cell's limits cover) does not arise."""
    monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", N * N)
    scene = scenes.detect_scene(N, N, 0.25, scenes.generator(seed, "cpu"), "cpu")
    timer = StageTimer("cpu")
    got, status = _program(scene, tmp_path, timer)
    want = reference.detect(scene, DIAG_KM, "cpu")

    assert timer.routes["shadow stage"] == "device (cpu)"
    assert timer.routes["sun/view geometry"] == "device (cpu)"
    assert timer.routes["cloud partition"] == "device (cpu)"
    assert timer.routes["beta map"] == "device (cpu)"
    assert timer.routes["matching"] == "device sweep (cpu)"
    assert "write shadow masks" in [name for name, _, worker, _ in timer._log if worker]
    assert any(name.startswith("matching/sweep ") for name, _ in timer.stages)

    assert want["masks"]["object_based_shadows"].any()  # clouds were matched
    for m in MASKS:
        assert np.array_equal(got[m], want["masks"][m]), m
    assert status == want["status"]


@pytest.mark.parametrize("whole", [False, True], ids=["passes", "one-pass"])
@pytest.mark.parametrize("length, bucket", [(4200, 8192), (3000, 4096)])
def test_windows_past_the_largest_bucket_stay_in_the_sweep(monkeypatch, length, bucket, whole):
    """A strip of 4200 px casts windows wider than the largest bucket
    (``_BUCKETS[-1]``): on the torch form's passes and on kernel 11's
    one-pass route (forced on the CPU) it is swept in a bucket of 8192 px,
    a strip of 3000 px in one of 4096, and the shadow and the solution are
    the reference's. The sweep's spans count the 4200 px strip ``oversized``
    (the cloud the JAX package scans on its native backend), the 3000 px
    one not."""
    mask, psm, sun, view, diag = strip_scene(length)
    cmap, clouds = t_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
    assert len(clouds) == 1
    _, _, (mnx, mxx, _, _), _ = t_match._cast_transforms(
        clouds, t_match.height_sweep(t_config.MatchingConfig()), mask.shape, diag, sun, view)
    assert bool((mxx - mnx + 1).max() > t_match._BUCKETS[-1]) == (length > 4096)

    monkeypatch.setattr(t_match, "_whole_bucket", lambda dev: whole)
    timer = StageTimer("cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.call("detect"):
            got = t_match.match_clouds_shadows(clouds, cmap, mask, psm, diag, sun, view,
                                               t_config.MatchingConfig(backend="torch"),
                                               timer=timer, device="cpu")
    assert timer.routes["matching"] == "device sweep (cpu)"
    sweeps = [n for n, _ in timer.stages if n.startswith("matching/sweep ")]
    assert sweeps and all(n.startswith(f"matching/sweep {bucket}x") for n in sweeps)
    spans = [r for r in profiling.records() if r.name == "detect.matching/sweep"]
    assert len(spans) == len(sweeps)
    assert sum(r.counts["oversized"] for r in spans) == int(length > t_match._BUCKETS[-1])

    ref_map, ref_clouds = ref_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
    want = ref_match.match_clouds_shadows(ref_clouds, ref_map, mask, psm, diag, sun, view,
                                          device="cpu")
    assert want.shadow_mask.any()  # the strip matched its shadow
    assert np.array_equal(got.shadow_mask, want.shadow_mask)
    [(cid, sol)] = want.solutions.items()
    assert (got.solutions[cid].height, got.solutions[cid].similarity) == (
        sol.height, sol.similarity)


def test_beta_window_wider_than_the_largest_bucket():
    """The strip's matched shadow is 4200 px long, so its influence window
    (grown by the 80 px influence radius on each side) is 4360 px wide,
    past the matching's largest bucket (4096): the device beta map, which
    the tile's route takes, gives it a bucket that holds it (it padded it
    to 4096, a negative pad, and raised on some 10 m tile scenes) and the
    map of the host route and of the reference."""
    mask, psm, sun, view, diag = strip_scene(4200)
    cmap, clouds = t_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
    match = t_match.match_clouds_shadows(clouds, cmap, mask, psm, diag, sun, view, device="cpu")
    [shadow] = [s for s in match.shadows.values() if s.area]
    bx0, _, bx1, _ = shadow.bounds
    assert bx1 - bx0 + 1 + 2 * 80 > t_match._BUCKETS[-1]
    clp = np.random.default_rng(5).random(mask.shape, dtype=np.float32)

    got = t_refdev.beta_map(match.shadows, match.solutions, clp, diag, device="cpu")
    host = t_ref.beta_map(match.shadows, match.solutions, clp, diag)
    ref_map, ref_clouds = ref_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
    ref = ref_match.match_clouds_shadows(ref_clouds, ref_map, mask, psm, diag, sun, view,
                                         device="cpu")
    want = ref_refinement.beta_map(ref.shadows, ref.solutions, clp, diag)
    assert got.max() > 0
    assert np.array_equal(host, want)
    assert np.array_equal(got, want)
