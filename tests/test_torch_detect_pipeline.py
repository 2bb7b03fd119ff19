"""``detect`` of the port as a whole against the JAX package's ``detect`` on
the CPU, on ``mini_scene(256)`` rebuilt from a numpy seed: both routes (the
host route: native scan or sweep, numpy/scipy refinement; the all-device
route: torch sweep and refinement) write four masks equal bit for bit to the
reference's, with ``Status`` fields within 1e-12. Beside it: the edge cases
of the entry point, the copied GeoTIFF IO against the JAX package's reader,
the folder functions, and the C++ library's build under concurrent processes.

The reference runs the JAX package's Python routes (see
``torch_parity.jax_package_without_native``)."""

import dataclasses
import multiprocessing
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from satellite_approximation_tpu import config as j_config
from satellite_approximation_tpu.models.detection import pipeline as j_pipe
from satellite_approximation_tpu.utils import geotiff as j_geotiff
from satellite_approximation_tpu_torch import config as t_config
from satellite_approximation_tpu_torch import native
from satellite_approximation_tpu_torch.models.detection import pipeline as t_pipe
from satellite_approximation_tpu_torch.ops.masks import fetch_mask
from satellite_approximation_tpu_torch.utils import geotiff as t_geotiff
from satellite_approximation_tpu_torch.utils import profiling, tiffmb, types
from torch_parity import (  # noqa: F401 — native_route is a fixture
    NATIVE_ROUTES,
    detection_config,
    jax_package_without_native,
    mini_diagonal,
    mini_scene,
    native_route,
)

N = 256
DIAG = mini_diagonal(N)
MASKS = ("cloud_mask", "potential_shadows", "object_based_shadows", "shadow_mask")


def run(mod, geotiff, work: Path, scene, config, **kwargs):
    """``mod.detect`` from pre-decoded rasters; (status, masks read back)."""
    work.mkdir()
    geotiff.write_geotiff(scene["B08"], work / "B08.tif")
    params = mod.CloudParams.from_root(work)
    status = mod.detect(params, DIAG, use_cache=False, inputs=dict(scene), config=config, **kwargs)
    masks = {n: j_geotiff.GeoTIFF.open(work / f"{n}.tif").read().astype(bool) for n in MASKS}
    return status, masks


@pytest.fixture(scope="module")
def scene():
    return mini_scene(N)


@pytest.fixture(scope="module")
def reference(scene, tmp_path_factory):
    with jax_package_without_native():
        status, masks = run(j_pipe, j_geotiff, tmp_path_factory.mktemp("jax") / "d", scene,
                            detection_config(j_config, "host", "jax"))
    assert masks["cloud_mask"].any() and masks["object_based_shadows"].any()
    assert status.percent_shadows > 0
    return status, masks


def assert_same(status, masks, reference):
    ref_status, ref_masks = reference
    for name in MASKS:
        assert np.array_equal(masks[name], ref_masks[name]), name
    got, want = dataclasses.asdict(status), dataclasses.asdict(ref_status)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, bool):
            assert got[key] is value
        else:
            assert got[key] == pytest.approx(value, abs=1e-12), key


class TestDetectAgainstJax:
    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    @pytest.mark.parametrize("route", ["host", "all-device", "auto"])
    def test_masks_and_status(self, scene, reference, tmp_path, route, native_route):
        backends = {"host": ("host", "native" if native.available() else "auto"),
                    "all-device": ("torch", "torch"), "auto": ("auto", "auto")}[route]
        timer = profiling.StageTimer("cpu")
        status, masks = run(t_pipe, t_geotiff, tmp_path / "d", scene,
                            detection_config(t_config, *backends), device="cpu", timer=timer)
        assert_same(status, masks, reference)
        on_device = route == "all-device"
        assert timer.routes["beta map"].startswith("device") == on_device
        assert timer.routes["sun/view geometry"].startswith("device") == on_device
        swept = route == "all-device" or not native.available()
        assert timer.routes["matching"].startswith("device sweep") == swept
        names = [name for name, _ in timer.stages]
        for stage in ("read inputs", "cloud mask", "cloud partition", "potential shadow mask",
                      "sun/view geometry", "cloud-shadow matching", "alpha map", "beta map",
                      "probability surface", "final mask"):
            assert stage in names
        assert "total:" in timer.report()

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_big_scene_routing_on_the_cpu(self, scene, reference, tmp_path, native_route, monkeypatch):
        """With the big-scene gate forced down, "auto" on the CPU takes the
        host-native shadow stage where the library is, and otherwise leaves
        the shadow stage's rasters as tensors for the device refinement."""
        monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
        timer = profiling.StageTimer()
        status, masks = run(t_pipe, t_geotiff, tmp_path / "d", scene,
                            detection_config(t_config, "auto", "auto"), device="cpu", timer=timer)
        assert_same(status, masks, reference)
        host = native.available()
        assert timer.routes["shadow stage"].startswith("host") == host
        assert timer.routes["alpha, histograms, final sampling"].startswith("host") == host

    def test_big_scene_device_route_overlaps_its_writes(self, scene, reference, tmp_path, monkeypatch):
        """backend "torch" on a big scene: the mask writes run on workers and
        are joined before ``detect`` returns; the cloud partition runs on the
        calling thread, right before the matching, with nothing to wait
        for."""
        monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
        timer = profiling.StageTimer()
        status, masks = run(t_pipe, t_geotiff, tmp_path / "d", scene,
                            detection_config(t_config, "torch", "torch"), device="cpu", timer=timer)
        assert_same(status, masks, reference)
        main = [name for name, _, worker, nested in timer._log if not (worker or nested)]
        assert "cloud partition (wait)" not in main
        assert main.index("cloud partition") + 1 == main.index("cloud-shadow matching")
        assert "write shadow masks" in [name for name, _, worker, _ in timer._log if worker]

    def test_big_scene_writes_its_masks_in_strips(self, scene, reference, tmp_path, monkeypatch):
        """The device route's four mask writes, with the strip sizes patched
        small, in row strips on the strip pool: each file reads back equal
        to the mask the call computed, and each write stage counts its
        strips and the pool's width."""
        monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
        monkeypatch.setattr(tiffmb, "ONE_STRIP_BYTES", 4096)
        monkeypatch.setattr(tiffmb, "STRIP_BYTES", 2048)  # 8 rows of 256
        computed = {}
        write = t_pipe._write_mask

        def keep(mask, out_path, template):
            computed[out_path.stem] = fetch_mask(mask).copy()
            write(mask, out_path, template)

        monkeypatch.setattr(t_pipe, "_write_mask", keep)
        profiling.clear()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                status, masks = run(t_pipe, t_geotiff, tmp_path / "d", scene,
                                    detection_config(t_config, "torch", "torch"), device="cpu")
            writes = [r for r in profiling.records()
                      if r.name in ("detect.write cloud mask", "detect.write shadow masks")]
        finally:
            profiling.clear()
        assert_same(status, masks, reference)
        assert sorted(computed) == sorted(MASKS)
        for name in MASKS:
            path = tmp_path / "d" / f"{name}.tif"
            with Image.open(path) as im:
                assert np.array_equal(np.array(im).astype(bool), computed[name]), name
            assert np.array_equal(t_geotiff.GeoTIFF.open(path).read().astype(bool), computed[name])
            assert np.array_equal(masks[name], computed[name]), name  # the JAX package's reader
        assert len(writes) == 4
        width = tiffmb._get_pool()[1]
        assert all(r.counts == {"strips": N // 8, "encode_threads": width} for r in writes)
        assert all(r.thread.startswith("sat-overlap") for r in writes)

    def test_files_on_disk_instead_of_inputs(self, scene, reference, tmp_path):
        work = tmp_path / "d"
        work.mkdir()
        for stem, raster in scene.items():
            t_geotiff.write_geotiff(raster, work / f"{stem}.tif")
        status = t_pipe.detect(t_pipe.CloudParams.from_root(work), DIAG, device="cpu")
        masks = {n: t_geotiff.GeoTIFF.open(work / f"{n}.tif").read().astype(bool) for n in MASKS}
        assert_same(status, masks, reference)


class TestDetectEdges:
    def test_cache_returns_none(self, scene, tmp_path):
        work = tmp_path / "d"
        config = detection_config(t_config, "host", "auto")
        run(t_pipe, t_geotiff, work, scene, config, device="cpu")
        params = t_pipe.CloudParams.from_root(work)
        assert t_pipe.detect(params, DIAG, use_cache=True, inputs=dict(scene), device="cpu") is None
        params.shadow_path().unlink()
        assert t_pipe.detect(params, DIAG, use_cache=True, inputs=dict(scene), device="cpu") is not None

    @pytest.mark.parametrize("threshold,skipped", [(0.05, True), (0.99, False)])
    def test_skip_shadow_detection(self, scene, reference, tmp_path, threshold, skipped):
        work = tmp_path / "d"
        work.mkdir()
        t_geotiff.write_geotiff(scene["B08"], work / "B08.tif")
        params = t_pipe.CloudParams.from_root(work)
        skip = t_pipe.SkipShadowDetection(True, threshold)
        status = t_pipe.detect(params, DIAG, skip, use_cache=False, inputs=dict(scene), device="cpu")
        with jax_package_without_native():
            (tmp_path / "j").mkdir()
            j_geotiff.write_geotiff(scene["B08"], tmp_path / "j" / "B08.tif")
            want = j_pipe.detect(j_pipe.CloudParams.from_root(tmp_path / "j"), DIAG,
                                 j_pipe.SkipShadowDetection(True, threshold), use_cache=False,
                                 inputs=dict(scene))
        assert dataclasses.asdict(status) == dataclasses.asdict(want)
        assert status.shadows_computed is not skipped
        assert params.shadow_path().exists() is not skipped and params.cloud_path().exists()
        assert "threshold" in repr(skip)

    def test_empty_cloud_mask(self, tmp_path):
        clear = mini_scene(96)
        clear["CLP"][:] = 0
        clear["CLD"][:] = 0
        clear["SCL"][:] = 4
        status, masks = run(t_pipe, t_geotiff, tmp_path / "d", clear,
                            detection_config(t_config, "torch", "torch"), device="cpu")
        assert status.percent_clouds == 0.0 and status.shadows_computed
        assert not masks["cloud_mask"].any() and not masks["object_based_shadows"].any()
        with jax_package_without_native():
            want, want_masks = run(j_pipe, j_geotiff, tmp_path / "j", clear,
                                   detection_config(j_config, "host", "jax"))
        assert dataclasses.asdict(status) == dataclasses.asdict(want)
        assert all(np.array_equal(masks[n], want_masks[n]) for n in MASKS)

    def test_mesh_policy(self, scene, tmp_path, monkeypatch):
        """"auto" and None run on one device however many cards the host has;
        an explicit ShardMesh shards the device stages, bit-equal; an unknown
        setting raises ValueError."""
        from satellite_approximation_tpu_torch.parallel.mesh import make_mesh

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        params = t_pipe.CloudParams.from_root(tmp_path)
        for bad in (object(), ("d", 2)):
            with pytest.raises(ValueError, match="unknown mesh setting"):
                t_pipe.detect(params, DIAG, inputs=dict(scene), mesh=bad, device="cpu")
        small = mini_scene(64)
        for mesh in ("auto", None):
            status, _ = run(t_pipe, t_geotiff, tmp_path / f"m{mesh}", small,
                            t_config.DEFAULT_DETECTION, mesh=mesh, device="cpu")
            assert status.clouds_computed
        cfg = detection_config(t_config, "torch", "torch")
        mesh = make_mesh((3,), ("d",), "cpu")
        timer = profiling.StageTimer(torch.device("cpu"))
        status, masks = run(t_pipe, t_geotiff, tmp_path / "sharded", scene, cfg, mesh=mesh,
                            timer=timer, device="cpu")
        assert timer.routes["beta map"] == "device, sharded over 3 shards"
        assert timer.routes["matching"].endswith("sharded over 3 shards")
        want, want_masks = run(t_pipe, t_geotiff, tmp_path / "single", scene, cfg, mesh=None,
                               device="cpu")
        assert dataclasses.asdict(status) == dataclasses.asdict(want)
        assert all(np.array_equal(masks[n], want_masks[n]) for n in MASKS)

    def test_device_none_needs_cuda(self, scene, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pipe.detect(t_pipe.CloudParams.from_root(tmp_path), DIAG, inputs=dict(scene))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pipe.detect_in_folder(tmp_path, DIAG)

    def test_missing_angles_name_the_file(self, scene, tmp_path):
        inputs = {k: v for k, v in scene.items() if k != "sunZenithAngles"}
        work = tmp_path / "d"
        work.mkdir()
        t_geotiff.write_geotiff(scene["B08"], work / "B08.tif")
        with pytest.raises(RuntimeError, match="Sun Zenith"):
            t_pipe.detect(t_pipe.CloudParams.from_root(work), DIAG, use_cache=False, inputs=inputs,
                          device="cpu")

    def test_diagonal_and_params(self):
        assert t_pipe.get_diagonal_distance(-114.0, 50.5, -112.5, 51.5) == j_pipe.get_diagonal_distance(
            -114.0, 50.5, -112.5, 51.5)
        ours, theirs = t_pipe.CloudParams.from_root("/x/2019-05-22"), j_pipe.CloudParams.from_root("/x/2019-05-22")
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for name in ("cloud_path", "shadow_potential_path", "object_based_shadow_path", "shadow_path"):
            assert getattr(ours, name)() == getattr(theirs, name)()
        assert dataclasses.asdict(t_pipe.Status()) == dataclasses.asdict(j_pipe.Status())


class TestNormalization:
    @pytest.mark.parametrize("dtype,max_value", [(np.uint8, 255), (np.uint8, 100), (np.uint16, 65535)])
    def test_every_value(self, dtype, max_value, tmp_path):
        """Bit-identical to numpy's f32 division for EVERY u8 value over 255
        and 100 and every u16 value over 65535 (the JAX package's
        TestDeviceNormalize), through the uint16-as-int16 upload."""
        raw = np.arange(np.iinfo(dtype).max + 1, dtype=np.int64).astype(dtype).reshape(-1, 16)
        want = raw.astype(np.float32) / np.float32(max_value)
        got = t_pipe._read_normalized_u8(tmp_path / "X.tif", max_value, {"X": raw}, "cpu")
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(np.asarray(j_pipe._read_normalized_u8(tmp_path / "X.tif", max_value, {"X": raw})), want)

    def test_float_input_and_disk_read(self, tmp_path):
        raw = np.random.default_rng(50).integers(0, 65536, (20, 30)).astype(np.uint16)
        t_geotiff.write_geotiff(raw, tmp_path / "B08.tif")
        got = t_pipe._read_normalized_u8(tmp_path / "B08.tif", 65535, None, "cpu").numpy()
        assert np.array_equal(got, raw.astype(np.float32) / np.float32(65535))
        as_float = t_pipe._read_normalized_u8(tmp_path / "B08.tif", 2.0, {"B08": raw.astype(np.float64)}, "cpu")
        assert np.array_equal(as_float.numpy(), raw.astype(np.float32) / np.float32(2.0))


class TestGeoTiffIO:
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
    @pytest.mark.parametrize("template", [False, True])
    def test_round_trip_against_jax_reader(self, dtype, template, tmp_path):
        r = np.random.default_rng(51)
        data = (r.random((33, 47)) * 200).astype(dtype)
        tmpl = None
        if template:
            tmpl = tmp_path / "tmpl.tif"
            j_geotiff.write_geotiff(data, tmpl)
        t_geotiff.write_geotiff(data, tmp_path / "t.tif", template_path=tmpl)
        j_geotiff.write_geotiff(data, tmp_path / "j.tif", template_path=tmpl)
        for path in (tmp_path / "t.tif", tmp_path / "j.tif"):
            ours, theirs = t_geotiff.GeoTIFF.open(path).read(), j_geotiff.GeoTIFF.open(path).read()
            assert ours.dtype == data.dtype and np.array_equal(ours, data) and np.array_equal(theirs, data)
        assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()

    def test_multiband(self, tmp_path):
        data = np.random.default_rng(52).random((3, 20, 25)).astype(np.float32)
        t_geotiff.write_geotiff(data, tmp_path / "t.tif")
        theirs, ours = j_geotiff.GeoTIFF.open(tmp_path / "t.tif"), t_geotiff.GeoTIFF.open(tmp_path / "t.tif")
        assert ours.num_bands == theirs.num_bands == 3
        assert np.array_equal(theirs.read_all(), data) and np.array_equal(ours.read_all(), data)
        assert np.array_equal(ours.read(2), data[1]) and np.array_equal(ours.read_bands([3, 1]), data[[2, 0]])


def write_date_folder(folder: Path, scene) -> None:
    folder.mkdir(parents=True)
    for stem, raster in scene.items():
        j_geotiff.write_geotiff(raster, folder / f"{stem}.tif")
    # the red band marks a folder as multispectral
    j_geotiff.write_geotiff(scene["B08"], folder / "B04.tif")


class TestFolderFunctions:
    def test_detect_in_folder_and_results(self, tmp_path):
        """Two date folders through ``detect_in_folder`` (prefetched reads,
        the database rows) and back through ``get_detection_results``,
        against the JAX package's own on a copy."""
        from satellite_approximation_tpu_torch.utils.db import DataBase

        small = {"2019-05-22": mini_scene(96, seed=7), "2019-06-01": mini_scene(96, seed=8)}
        for root in ("t", "j"):
            for date, sc in small.items():
                write_date_folder(tmp_path / root / date, sc)
        diag = mini_diagonal(96)
        got = t_pipe.detect_in_folder(tmp_path / "t", diag, device="cpu")
        with jax_package_without_native():
            want = j_pipe.detect_in_folder(tmp_path / "j", diag)
        assert {str(k): dataclasses.asdict(v) for k, v in got.items()} == {
            str(k): dataclasses.asdict(v) for k, v in want.items()}
        assert len(got) == 2
        for date in small:
            for name in MASKS:
                assert np.array_equal(t_geotiff.GeoTIFF.open(tmp_path / "t" / date / f"{name}.tif").read(),
                                      j_geotiff.GeoTIFF.open(tmp_path / "j" / date / f"{name}.tif").read())
        again = t_pipe.get_detection_results(tmp_path / "t")
        assert {str(k): dataclasses.asdict(v) for k, v in again.items()} == {
            str(k): dataclasses.asdict(v) for k, v in got.items()}
        assert t_pipe.detect_in_folder(tmp_path / "t", diag, device="cpu") == {}  # all cached
        db = DataBase(tmp_path / "t")
        db.close()

    def test_single_folder_and_clouds_only(self, tmp_path):
        from satellite_approximation_tpu_torch.utils.db import DataBase

        sc = mini_scene(96, seed=9)
        write_date_folder(tmp_path / "t" / "2019-07-01", sc)
        write_date_folder(tmp_path / "c" / "2019-07-01", sc)
        diag = mini_diagonal(96)
        status = t_pipe.detect_single_folder(tmp_path / "t" / "2019-07-01", diag, device="cpu")
        assert status.shadows_computed
        assert t_pipe.detect_single_folder(tmp_path / "t" / "2019-07-01", diag, device="cpu") is None
        db = DataBase(tmp_path / "c")
        clouds = t_pipe.detect_clouds(tmp_path / "c" / "2019-07-01", db, device="cpu")
        db.close()
        assert clouds.percent_clouds == status.percent_clouds and not clouds.shadows_computed
        assert np.array_equal(
            t_geotiff.GeoTIFF.open(tmp_path / "c" / "2019-07-01" / "cloud_mask.tif").read(),
            t_geotiff.GeoTIFF.open(tmp_path / "t" / "2019-07-01" / "cloud_mask.tif").read())


class TestTypesAndProfiling:
    @pytest.mark.parametrize("shape", [(0,), (7, 9), (64, 64)])
    def test_percent_non_zero(self, shape):
        from satellite_approximation_tpu.utils import types as j_types

        a = (np.random.default_rng(53).random(shape) > 0.7).astype(np.uint8)
        want = j_types.percent_non_zero(a)
        assert types.percent_non_zero(a) == want
        assert types.percent_non_zero(torch.from_numpy(a)) == want
        assert types.percent_non_zero(torch.from_numpy(a.astype(bool))) == want
        assert types.count_non_zero(torch.from_numpy(a)) == j_types.count_non_zero(a)
        if a.size:
            assert types.printable_stats(torch.from_numpy(a)) == j_types.printable_stats(a)

    def test_stage_timer_synchronizes_a_cuda_device(self, monkeypatch):
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
        timer = profiling.StageTimer("cuda")
        with timer.stage("a"):
            pass
        assert calls == [torch.device("cuda")]
        for device in (None, "cpu"):
            with profiling.StageTimer(device).stage("b"):
                pass
        assert len(calls) == 1 and timer.stages[0][0] == "a"

    def test_span_on_the_profilers_timeline(self):
        """A span is a range among the profiler's host events, around the
        operations run inside it."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("detect.cloud mask"):
                torch.ones(8).sum()
        events = {e.name(): e for e in prof.profiler.kineto_results.events()}
        outer, inner = events["detect.cloud mask"], events["aten::sum"]
        assert outer.start_ns() <= inner.start_ns()
        assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()


def _build_in(build_dir: str, queue) -> None:
    from satellite_approximation_tpu_torch import native as n

    n.BUILD_DIR = Path(build_dir)
    lib = n.get_lib()
    out = n.pit_fill_flood(np.full((4, 4), 0.5, np.float32), 0.25) if lib is not None else None
    queue.put((lib is not None, None if out is None else float(out.sum())))


class TestNativeBuild:
    def test_library_present_where_a_compiler_is(self):
        assert native.available() == (shutil.which("g++") is not None and native.SOURCE.exists())
        if native.available():
            path = native.build()
            assert path.parent == native.BUILD_DIR and path.name.startswith("libsatnative_")
            assert native.build() == path  # found, not rebuilt

    def test_concurrent_builds_never_load_a_partial_library(self, tmp_path):
        """Four processes build into one empty directory at once: each either
        finds a whole library or builds its own and renames it into place."""
        if shutil.which("g++") is None:
            assert not native.available()
            return
        ctx = multiprocessing.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=_build_in, args=(str(tmp_path), queue)) for _ in range(4)]
        for p in procs:
            p.start()
        results = [queue.get(timeout=600) for _ in procs]
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive() and p.exitcode == 0
        assert results == [(True, 8.0)] * 4
        assert len(list(tmp_path.glob("libsatnative_*.so"))) == 1
        assert not [p for p in tmp_path.iterdir() if p.is_dir()]  # no temporary left behind

    def test_no_compiler_means_python_routes(self, monkeypatch):
        monkeypatch.setattr(shutil, "which", lambda name: None)
        assert native.build() is None
        native.get_lib.cache_clear()
        try:
            assert not native.available()
            assert native.pit_fill_flood(np.zeros((3, 3), np.float32), 0.0) is None
            assert native.hole_fill(np.zeros((2, 2), np.float32), np.zeros((2, 2), bool)) is None
        finally:
            native.get_lib.cache_clear()
