"""Where ``detect`` runs each stage (``models/detection/placement.py``):
``place`` against tables of the rule written out case by case, on both
device types, with and without the C++ library, under every pair of
backends; ``detect`` on the CPU recording exactly ``Placement.routes``; and
the routes of the two benchmark scenes on a CUDA device."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from satellite_approximation_tpu_torch import config as t_config
from satellite_approximation_tpu_torch import native
from satellite_approximation_tpu_torch.models.detection import pipeline as t_pipe
from satellite_approximation_tpu_torch.models.detection import placement
from satellite_approximation_tpu_torch.parallel.mesh import make_mesh
from satellite_approximation_tpu_torch.utils import geotiff as t_geotiff
from satellite_approximation_tpu_torch.utils import profiling
from torch_parity import detection_config, mini_diagonal, mini_scene

SMALL, BIG = 1284 * 1697, 5490 * 5490

# size, device, library, RefinementConfig.backend -> the letter of each
# field that is true ("." where it is false): D device_stages,
# S shadow_on_host, R refine_on_device, O overlap_writes, P partition_on_host
STAGES = """
small cpu  lib   host   ....P
small cpu  lib   torch  D.R..
small cpu  lib   auto   ....P
small cpu  nolib host   .....
small cpu  nolib torch  D.R..
small cpu  nolib auto   .....
small cuda lib   host   ....P
small cuda lib   torch  D.R..
small cuda lib   auto   ....P
small cuda nolib host   .....
small cuda nolib torch  D.R..
small cuda nolib auto   .....
big   cpu  lib   host   .S..P
big   cpu  lib   torch  D.RO.
big   cpu  lib   auto   .S..P
big   cpu  nolib host   .....
big   cpu  nolib torch  D.RO.
big   cpu  nolib auto   ..R..
big   cuda lib   host   .S..P
big   cuda lib   torch  D.RO.
big   cuda lib   auto   D.RO.
big   cuda nolib host   .....
big   cuda nolib torch  D.RO.
big   cuda nolib auto   D.RO.
"""
FIELDS = {"D": "device_stages", "S": "shadow_on_host", "R": "refine_on_device",
          "O": "overlap_writes", "P": "partition_on_host"}

# size, device, library, MatchingConfig.backend -> native_matching (no mesh)
MATCHING = """
small cpu  lib   native yes
small cpu  lib   torch  no
small cpu  lib   auto   yes
small cpu  nolib native yes
small cpu  nolib torch  no
small cpu  nolib auto   no
small cuda lib   native yes
small cuda lib   torch  no
small cuda lib   auto   yes
small cuda nolib native yes
small cuda nolib torch  no
small cuda nolib auto   no
big   cpu  lib   native yes
big   cpu  lib   torch  no
big   cpu  lib   auto   yes
big   cpu  nolib native yes
big   cpu  nolib torch  no
big   cpu  nolib auto   no
big   cuda lib   native yes
big   cuda lib   torch  no
big   cuda lib   auto   no
big   cuda nolib native yes
big   cuda nolib torch  no
big   cuda nolib auto   no
"""


def _table(text):
    rows = {}
    for line in text.strip().splitlines():
        *key, value = line.split()
        rows[tuple(key)] = value
    return rows


STAGE_ROWS, MATCHING_ROWS = _table(STAGES), _table(MATCHING)
CASES = list(itertools.product(("small", "big"), ("cpu", "cuda"), ("lib", "nolib"),
                               ("host", "torch", "auto"), ("native", "torch", "auto")))


def _expected(size, device, lib, refine, match):
    flags = STAGE_ROWS[size, device, lib, refine]
    want = {field: letter in flags for letter, field in FIELDS.items()}
    want["native_matching"] = MATCHING_ROWS[size, device, lib, match] == "yes"
    want["mesh"] = None
    return want


def _place(monkeypatch, size, device, lib, refine, match, mesh=None):
    monkeypatch.setattr(native, "available", lambda: lib == "lib")
    pixels = {"small": SMALL, "big": BIG}[size]
    return placement.place(pixels, torch.device(device),
                           detection_config(t_config, refine, match), mesh)


@pytest.mark.parametrize("size,device,lib,refine,match", CASES)
def test_place_follows_the_rule(monkeypatch, size, device, lib, refine, match):
    got = _place(monkeypatch, size, device, lib, refine, match)
    assert dataclasses.asdict(got) == _expected(size, device, lib, refine, match)


@pytest.mark.parametrize("size,device,refine", [("small", "cpu", "torch"), ("big", "cuda", "torch"),
                                                ("big", "cuda", "auto")])
@pytest.mark.parametrize("match", ["native", "torch", "auto"])
def test_mesh_shards_the_device_route(monkeypatch, size, device, refine, match):
    """On the device route a mesh is kept and the matching sweeps on it,
    whatever the matching backend; the routes name the shards."""
    mesh = make_mesh((3,), ("d",), "cpu")
    got = _place(monkeypatch, size, device, "lib", refine, match, mesh)
    assert got.device_stages and got.mesh is mesh and not got.native_matching
    routes = got.routes(torch.device(device))
    sharded = "device, sharded over 3 shards"
    assert routes["beta map"] == routes["alpha, histograms, final sampling"] == sharded
    assert routes["matching"] == f"device sweep ({device}), sharded over 3 shards"


@pytest.mark.parametrize("size,device,refine", [("small", "cpu", "auto"), ("big", "cpu", "host"),
                                                ("small", "cuda", "auto")])
def test_mesh_is_dropped_off_the_device_route(monkeypatch, size, device, refine):
    mesh = make_mesh((3,), ("d",), "cpu")
    got = _place(monkeypatch, size, device, "lib", refine, "auto", mesh)
    assert got == _place(monkeypatch, size, device, "lib", refine, "auto")
    assert "sharded" not in " ".join(got.routes(torch.device(device)).values())


def test_big_scene_reads_the_gate_at_each_call(monkeypatch):
    assert placement.big_scene(t_config.BIG_SCENE_PIXELS)
    assert not placement.big_scene(t_config.BIG_SCENE_PIXELS - 1)
    monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
    assert placement.big_scene(1)


def test_benchmark_scenes_on_a_cuda_device(monkeypatch):
    """The 5490^2 tile takes the device route and the 1284 x 1697 scene
    the host route, under the default config with the library present."""
    monkeypatch.setattr(native, "available", lambda: True)
    cuda = torch.device("cuda")
    on_dev = "device (cuda)"
    tile = placement.place(5490 * 5490, cuda, t_config.DEFAULT_DETECTION, None)
    assert tile.routes(cuda) == {
        "cloud mask": on_dev,
        "cloud partition": on_dev,
        "shadow stage": on_dev,
        "sun/view geometry": on_dev,
        "beta map": on_dev,
        "matching": "device sweep (cuda)",
        "alpha, histograms, final sampling": on_dev,
    }
    assert tile.overlap_writes
    scene = placement.place(1284 * 1697, cuda, t_config.DEFAULT_DETECTION, None)
    assert scene.routes(cuda) == {
        "cloud mask": on_dev,
        "cloud partition": "host, native flood",
        "shadow stage": on_dev,
        "sun/view geometry": "host, chunked numpy",
        "beta map": "host, numpy/scipy",
        "matching": "host, native scan",
        "alpha, histograms, final sampling": "host, numpy or native",
    }
    assert not scene.overlap_writes


N = 96


@pytest.fixture(scope="module")
def scene():
    return mini_scene(N)


# the CPU rows; "native" matching needs the library, so the rows without it
# leave that backend out
CPU_ROWS = [(size, lib, refine, match) for size, device, lib, refine, match in CASES
            if device == "cpu" and not (lib == "nolib" and match == "native")]


@pytest.mark.parametrize("size,lib,refine,match", CPU_ROWS)
def test_detect_records_its_placement(scene, tmp_path, monkeypatch, size, lib, refine, match):
    if lib == "nolib":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("the C++ library is not built here (no g++)")
    if size == "big":
        monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
    cfg = detection_config(t_config, refine, match)
    cpu = torch.device("cpu")
    want = placement.place(N * N, cpu, cfg, None)
    assert dataclasses.asdict(want) == _expected(size, "cpu", lib, refine, match)
    work = tmp_path / "d"
    work.mkdir()
    t_geotiff.write_geotiff(scene["B08"], work / "B08.tif")
    timer = profiling.StageTimer(cpu)
    status = t_pipe.detect(t_pipe.CloudParams.from_root(work), mini_diagonal(N), use_cache=False,
                           inputs=dict(scene), config=cfg, timer=timer, device="cpu")
    assert status.shadows_computed and np.isfinite(status.percent_shadows)
    assert timer.routes == want.routes(cpu)
