"""The port's public surface beyond the solvers and ``detect``, held against
the JAX package on the CPU with the same seeded numpy inputs in ``tmp_path``:
image IO (``utils/imageio.py``, ``utils/rasterio_.py``), the compute report
(``utils/compute.py``), the ``utils`` re-exports, the spectral indices
(``indices.py``), the replacement-date pick (``models/closest.py``) and the
date-folder fill with its SQLite resume
(``models/laplace.py::fill_missing_data_folder``).

Everything but the folder fill is bit-equal; the folder fill writes the same
files and DB rows, known pixels bit-equal, filled values within 1e-5 (the
solver contract), on plain CG and, with ``mg_threshold_pixels=0``, on the
multigrid path (the kernels' plain versions)."""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import satellite_approximation_tpu as jax_pkg
import satellite_approximation_tpu.utils as j_utils
from satellite_approximation_tpu import indices as j_indices
from satellite_approximation_tpu.config import SolverConfig as JaxSolverConfig
from satellite_approximation_tpu.models import closest as j_closest
from satellite_approximation_tpu.models import laplace as j_laplace
from satellite_approximation_tpu.models import multigrid as j_multigrid
from satellite_approximation_tpu.utils import imageio as j_imageio
from satellite_approximation_tpu.utils import rasterio_ as j_rasterio
from satellite_approximation_tpu.utils.db import DataBase as JaxDataBase
import satellite_approximation_tpu_torch as port
import satellite_approximation_tpu_torch.utils as t_utils
from satellite_approximation_tpu_torch import indices as t_indices
from satellite_approximation_tpu_torch.config import SolverConfig
from satellite_approximation_tpu_torch.models import closest as t_closest
from satellite_approximation_tpu_torch.models import laplace as t_laplace
from satellite_approximation_tpu_torch.models.detection.pipeline import Status
from satellite_approximation_tpu_torch.utils import compute as t_compute
from satellite_approximation_tpu_torch.utils import errors as t_errors
from satellite_approximation_tpu_torch.utils import imageio as t_imageio
from satellite_approximation_tpu_torch.utils import rasterio_ as t_rasterio
from satellite_approximation_tpu_torch.utils.dates import Date
from satellite_approximation_tpu_torch.utils.db import ApproxMethod, DataBase
from satellite_approximation_tpu_torch.utils.geotiff import GeoTIFF, write_geotiff
from torch_parity import small_mask, smooth


def assert_identical(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


# ------------------------------------------------------------------ surface


def test_all_covers_the_jax_package():
    assert set(jax_pkg.__all__) <= set(port.__all__)
    assert "resolve_device" in port.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_utils_reexports():
    assert t_utils.__all__ == j_utils.__all__
    for name in ("f32", "f64", "i32", "u8", "u16"):
        assert getattr(t_utils, name) is getattr(j_utils, name)
    assert t_utils.percent_non_zero(np.eye(4)) == j_utils.percent_non_zero(np.eye(4))
    assert t_utils.Date.from_string("2019-05-22") == t_utils.Date(2019, 5, 22)
    assert issubclass(t_utils.IOError_, Exception)


# ------------------------------------------------------------------ image IO


@pytest.mark.parametrize("shape,mode", [((24, 31), "RGB"), ((17, 8), "L"), ((9, 40), "RGBA")])
def test_imageio_round_trip(tmp_path, shape, mode):
    rng = np.random.default_rng(sum(shape))
    channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    pixels = (rng.random((*shape, channels)) * 255).astype(np.uint8)
    path = tmp_path / "in.png"
    Image.fromarray(pixels[..., 0] if channels == 1 else pixels, mode=mode).save(path)

    assert_identical(t_imageio.read_image_raw(path), j_imageio.read_image_raw(path))
    got, want = t_imageio.read_image(path), j_imageio.read_image(path)
    assert_identical(got, want)
    assert got.shape == (3, *shape)
    t_imageio.write_image(got, tmp_path / "port.png")
    j_imageio.write_image(want, tmp_path / "jax.png")
    assert_identical(np.asarray(Image.open(tmp_path / "port.png")),
                     np.asarray(Image.open(tmp_path / "jax.png")))


def test_imageio_errors(tmp_path):
    with pytest.raises(t_errors.IOError_) as got:
        t_imageio.read_image(tmp_path / "missing.png")
    with pytest.raises(j_utils.IOError_) as want:
        j_imageio.read_image(tmp_path / "missing.png")
    assert str(got.value) == str(want.value)
    with pytest.raises(t_errors.IOError_):
        t_imageio.read_image_raw(tmp_path / "missing.png")
    with pytest.raises(t_errors.IOError_, match="Expected 3 channels"):
        t_imageio.write_image(np.zeros((2, 4, 4)), tmp_path / "x.png")


@pytest.mark.parametrize("reader,dtype", [
    ("read_single_channel_float", np.float32),
    ("read_single_channel_uint8", np.uint8),
    ("read_single_channel_uint16", np.uint16),
    ("read_single_channel_uint32", np.uint32),
])
def test_rasterio_typed_readers_and_writers(tmp_path, reader, dtype):
    rng = np.random.default_rng(7)
    raster = (rng.random((13, 21)) * np.iinfo(np.uint8).max).astype(dtype)
    template = tmp_path / "template.tif"
    write_geotiff(raster, template)
    getattr(t_rasterio, reader.replace("read", "write"))(tmp_path / "port.tif", raster, template)
    getattr(j_rasterio, reader.replace("read", "write"))(tmp_path / "jax.tif", raster, template)
    for path in (tmp_path / "port.tif", tmp_path / "jax.tif"):
        got = getattr(t_rasterio, reader)(path)
        assert_identical(got, getattr(j_rasterio, reader)(path))
        assert_identical(got, raster)
    with pytest.raises(t_errors.IOError_, match="Extension must be tif"):
        getattr(t_rasterio, reader)(tmp_path / "port.png")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterio_rgba(tmp_path, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (11, 19), dtype=np.uint64).astype(np.uint32)
    t_rasterio.write_rgba(tmp_path / "port.png", packed)
    j_rasterio.write_rgba(tmp_path / "jax.png", packed)
    got = t_rasterio.read_rgba(tmp_path / "port.png")
    assert_identical(got, j_rasterio.read_rgba(tmp_path / "jax.png"))
    assert_identical(got, packed)
    assert_identical(t_rasterio.decompose_rgba(packed), j_rasterio.decompose_rgba(packed))
    assert_identical(t_rasterio.decompose_rgba_256(packed), j_rasterio.decompose_rgba_256(packed))


# ------------------------------------------------------------------ compute report


def test_platform_report_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_compute.init_main_context() is None
    info = t_compute.platform_and_device_info()
    assert info == "backend: cpu\n  device 0: cpu (platform=cpu)\nlocal device count: 1"
    # the words of the JAX package's report (tests/test_surface_parity.py)
    assert "backend" in info and "device 0" in info


def test_platform_report_with_cuda(monkeypatch):
    class Props:
        name, major, minor, total_memory = "NVIDIA H100 80GB HBM3", 9, 0, 85 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    line = "NVIDIA H100 80GB HBM3 (platform=cuda, compute capability 9.0, memory=85.00 GiB)"
    assert t_compute.platform_and_device_info() == (
        f"backend: cuda\n  device 0: {line}\n  device 1: {line}\nlocal device count: 2"
    )


# ------------------------------------------------------------------ indices

INDICES = ["NDVI", "NDMI", "mNDWI", "SWI"]


@pytest.mark.parametrize("name", INDICES + ["ndvi", "EVI"])
def test_index_tables(name):
    index = t_indices.from_str(name)
    want = j_indices.from_str(name)
    assert (index is None) == (want is None)
    if index is None:
        return
    assert index.value == want.value
    files = t_indices.required_files(index)
    assert files == j_indices.required_files(want)
    assert not t_indices.missing_files(files, index)
    for k in range(len(files)):
        partial = files[:k] + files[k + 1:]
        assert t_indices.missing_files(partial, index) == j_indices.missing_files(partial, want)
        assert t_indices.missing_files(partial, index)


def _index_folder(tmp_path: Path) -> Path:
    rng = np.random.default_rng(11)
    folder = tmp_path / "2019-05-22"
    folder.mkdir()
    for band in ("B03", "B04", "B08", "B11"):
        values = (rng.random((12, 15)) * 10000).astype(np.float32)
        values[0, :3] = 0.0  # 0/0 -> 0 and x/0 -> 0
        values[1, 0] = -values[1, 1]  # a sum of zero with a nonzero difference
        write_geotiff(values, folder / f"{band}.tif")
    return folder


@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("name", INDICES)
def test_compute_index_matches_jax(tmp_path, name, use_cache):
    src = _index_folder(tmp_path)
    template = src / "B08.tif"
    outs = {}
    for tag, mod in (("port", t_indices), ("jax", j_indices)):
        folder = tmp_path / tag / src.name
        folder.mkdir(parents=True)
        for f in src.iterdir():
            (folder / f.name).write_bytes(f.read_bytes())
        first = mod.compute_index(folder, template, mod.Indices[name], use_cache=use_cache)
        assert (folder / f"{name}.tif").exists()
        # a second call: read from the cache, or computed anew
        second = mod.compute_index(folder, template, mod.Indices[name], use_cache=use_cache)
        written = GeoTIFF.open(folder / f"{name}.tif").read()
        outs[tag] = first, second, written
    for got, want in zip(outs["port"], outs["jax"]):
        assert_identical(got, want)
    first, second, written = outs["port"]
    assert np.isfinite(first).all() and first[0, 0] == 0.0
    assert_identical(written, first.astype(np.float32))
    if use_cache:
        assert_identical(second, first.astype(np.float32).astype(np.float64))
    else:
        assert_identical(second, first)


# ------------------------------------------------------------------ closest date


@pytest.fixture
def close_db(tmp_path):
    """One DB: dates around 2019-05-10 with their invalid fractions."""
    with DataBase(tmp_path) as db:
        for date, invalid in (
            ("2019-04-02", 0.01), ("2019-04-28", 0.20), ("2019-05-01", 0.30),
            ("2019-05-10", 0.50), ("2019-05-12", 0.45), ("2019-05-30", 0.05),
            ("2019-06-20", 0.02), ("2019-07-15", 0.00), ("2020-02-01", 0.60),
        ):
            db.write_detection_result(Date.from_string(date), Status(percent_invalid=invalid))
    return tmp_path


@pytest.mark.parametrize("date,weight", [
    ("2019-05-10", 0.0), ("2019-05-10", 0.3), ("2019-05-10", 1.0),
    ("2019-06-20", 0.0),  # the current date is cleaner than every candidate: kept
    ("2019-04-02", 0.3),  # the same, with the distance weighted in
    ("2020-02-01", 0.5),  # no date within a month: ""
    ("2019-07-15", 1.0),
])
def test_find_good_close_image_matches_jax(close_db, date, weight):
    with DataBase(close_db) as t_db:
        got = t_closest.find_good_close_image(date, weight, t_db)
    j_db = JaxDataBase(close_db)
    try:
        want = j_closest.find_good_close_image(date, weight, j_db)
    finally:
        j_db.close()
    assert isinstance(got, str) and got == want


@pytest.mark.parametrize("weight", [-0.1, 1.5])
def test_find_good_close_image_rejects_weight(close_db, weight):
    with DataBase(close_db) as db, pytest.raises(t_errors.GenericError, match="between 0 and 1"):
        t_closest.find_good_close_image("2019-05-10", weight, db)


# ------------------------------------------------------------------ folder fill

BANDS = ["B02", "B03", "B04"]


def build_tree(base: Path, h: int, w: int) -> dict[str, np.ndarray]:
    """A base folder of five date folders at (h, w) with masks and status
    rows: a normal date; one over the skip threshold; one without its
    shadow_mask.tif (but with its status row); one whose shadows were never
    computed; one with B03 already recorded in the DB. Returns the bands'
    values, keyed "<date>/<band>"."""
    base.mkdir(parents=True, exist_ok=True)
    values = {}
    dates = {
        "2019-05-10": 0.05, "2019-05-12": 0.90, "2019-05-14": 0.04,
        "2019-05-16": 0.02, "2019-05-18": 0.03,
    }
    with DataBase(base) as db:
        for k, (date, invalid) in enumerate(dates.items()):
            folder = base / date
            folder.mkdir()
            clouds = small_mask(h, w, seed=20 + k)
            shadows = np.roll(small_mask(h, w, seed=40 + k), 3, axis=1) & ~clouds
            write_geotiff(clouds.astype(np.uint8), folder / "cloud_mask.tif")
            if date != "2019-05-14":
                write_geotiff(shadows.astype(np.uint8), folder / "shadow_mask.tif")
            for j, band in enumerate(BANDS):
                v = smooth(h, w, 100 * k + j)
                values[f"{date}/{band}"] = v
                write_geotiff(v, folder / f"{band}.tif")
            db.write_detection_result(Date.from_string(date), Status(
                percent_invalid=invalid, clouds_computed=True,
                shadows_computed=date != "2019-05-16"))
        db.write_approx_results("2019-05-18", "B03", ApproxMethod.Laplace)
    return values


def outputs(base: Path) -> tuple[dict, dict]:
    """({date: approx status}, {relative path: raster}) of a filled tree."""
    rows, files = {}, {}
    with DataBase(base) as db:
        for folder in sorted(p for p in base.iterdir() if p.is_dir()):
            rows[folder.name] = db.get_approx_status(folder.name, ApproxMethod.Laplace)
            for f in sorted((folder / "approximated_data").glob("*.tif")):
                files[str(f.relative_to(base))] = GeoTIFF.open(f).read()
    return rows, files


@pytest.fixture
def jax_f32_precond(monkeypatch):
    """The JAX package picks a bf16 V-cycle on grids <= 4096; the port's
    default is f32."""
    monkeypatch.setattr(j_multigrid, "PRECOND_DTYPE", jnp.float32)


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("route", ["cg", "multigrid"])
def test_fill_missing_data_folder_matches_jax(tmp_path, jax_f32_precond, route, use_cache):
    h, w = (40, 48) if route == "cg" else (64, 64)
    mg = dict(mg_threshold_pixels=0) if route == "multigrid" else {}
    values = build_tree(tmp_path / "port", h, w)
    build_tree(tmp_path / "jax", h, w)
    kw = dict(use_cache=use_cache, skip_threshold=0.5)
    t_laplace.fill_missing_data_folder(tmp_path / "port", BANDS, config=SolverConfig(**mg),
                                       device="cpu", **kw)
    # the JAX package's test platform has 8 virtual CPU devices
    j_laplace.fill_missing_data_folder(tmp_path / "jax", BANDS,
                                       config=JaxSolverConfig(mesh="off", **mg), **kw)
    rows, files = outputs(tmp_path / "port")
    want_rows, want_files = outputs(tmp_path / "jax")
    assert rows == want_rows
    assert files.keys() == want_files.keys()

    resumed = ["B02", "B04"] if use_cache else BANDS
    assert sorted(rows["2019-05-18"]) == BANDS  # the recorded B03 and the new rows
    expect_dates = {"2019-05-10": BANDS, "2019-05-14": BANDS, "2019-05-18": resumed}
    assert sorted(files) == sorted(
        f"{d}/approximated_data/{b}_{rows[d][b]}.tif" for d, bs in expect_dates.items() for b in bs)
    for name, got in files.items():
        date, band = name.split("/")[0], name.split("/")[-1].split("_")[0]
        src = values[f"{date}/{band}"]
        assert got.dtype == np.float32 and got.shape == src.shape
        clouds = GeoTIFF.open(tmp_path / "port" / date / "cloud_mask.tif").read().astype(bool)
        shadow_path = tmp_path / "port" / date / "shadow_mask.tif"
        shadows = GeoTIFF.open(shadow_path).read().astype(bool) if shadow_path.exists() else False
        known = ~(clouds | shadows)
        known[[0, -1], :] = known[:, [0, -1]] = True  # the border is always known
        assert_identical(got[known], src[known])
        assert_identical(got[known], want_files[name][known])
        np.testing.assert_allclose(got, want_files[name], rtol=0, atol=1e-5)
        assert not np.array_equal(got[~known], src[~known])


def test_fill_missing_data_folder_second_run_solves_nothing(tmp_path, monkeypatch):
    build_tree(tmp_path, 40, 48)
    kw = dict(skip_threshold=0.5, device="cpu")
    t_laplace.fill_missing_data_folder(tmp_path, BANDS, **kw)
    before = outputs(tmp_path)
    stamps = {p: p.stat().st_mtime_ns for p in tmp_path.rglob("approximated_data/*.tif")}

    def no_solve(*args, **kwargs):
        raise AssertionError("a cached band was solved again")

    monkeypatch.setattr(t_laplace, "solve_matrix", no_solve)
    t_laplace.fill_missing_data_folder(tmp_path, BANDS, **kw)
    after = outputs(tmp_path)
    assert after[0] == before[0] and after[1].keys() == before[1].keys()
    assert {p: p.stat().st_mtime_ns for p in stamps} == stamps


def test_fill_missing_data_folder_edges(tmp_path, monkeypatch, caplog):
    # not a directory: a warning, nothing written
    t_laplace.fill_missing_data_folder(tmp_path / "absent", BANDS, device="cpu")
    assert not (tmp_path / "absent").exists()
    # no CUDA device and no device given: the resolver's error
    build_tree(tmp_path / "tree", 24, 28)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_laplace.fill_missing_data_folder(tmp_path / "tree", BANDS)
    assert outputs(tmp_path / "tree")[1] == {}
