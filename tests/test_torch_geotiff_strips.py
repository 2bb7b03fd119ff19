"""The deflated strips of the port's TIFF writer (``utils/tiffmb.py``) on the
CPU: a raster past the one-strip limit is cut into row strips compressed on
the module's pool, which read back equal through PIL, both packages'
``GeoTIFF.open`` and the codec's own reader, in band order, with the same
bytes at any pool width; a raster at or under the limit keeps today's one
strip a band, byte for byte; and the counters ``strips`` and
``encode_threads``. The strip sizes are patched small so that small arrays
take the pool, as ``test_torch_surface.py`` patches ``BLOCK_BYTES``."""

from __future__ import annotations

import math
import os
import struct
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from satellite_approximation_tpu.utils import geotiff as j_geotiff
from satellite_approximation_tpu.utils import tiffmb as j_tiffmb
from satellite_approximation_tpu_torch.utils import geotiff, profiling, tiffmb

# the patched limits: a raster past 512 bytes is cut into strips of 200
ONE_STRIP, STRIP = 512, 200


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def small_strips(monkeypatch):
    monkeypatch.setattr(tiffmb, "ONE_STRIP_BYTES", ONE_STRIP)
    monkeypatch.setattr(tiffmb, "STRIP_BYTES", STRIP)


@pytest.fixture
def fresh_pool(monkeypatch):
    """The pool made anew under the test's patches, and shut down after."""
    monkeypatch.setattr(tiffmb, "_pool", None)
    monkeypatch.setattr(tiffmb, "_width", None)
    yield
    if tiffmb._pool is not None:
        tiffmb._pool.shutdown()


def raster(shape, dtype, seed=0) -> np.ndarray:
    """u8: a mask-like 0/1 raster of runs; u16: values over the whole range."""
    r = np.random.default_rng(seed)
    if dtype == np.uint8:
        return (np.cumsum(r.random(shape) < 0.05, axis=-1) % 2).astype(np.uint8)
    return r.integers(0, 1 << 16, size=shape).astype(dtype)


def strips_expected(shape, itemsize, one_strip=ONE_STRIP, strip=STRIP) -> int:
    """Strips of one band: one at or under the limit, else runs of rows."""
    h, w = shape[-2], shape[-1]
    if math.prod(shape) * itemsize <= one_strip:
        return 1
    return math.ceil(h / min(h, max(1, strip // (w * itemsize))))


def strip_tags(path):
    tags, _ = tiffmb.read_tiff_tags(path.read_bytes())
    offs = tags[tiffmb.STRIP_OFFSETS]
    cnts = tags[tiffmb.STRIP_BYTE_COUNTS]
    as_tuple = (lambda v: v if isinstance(v, tuple) else (v,))
    return as_tuple(offs), as_tuple(cnts), tags[tiffmb.ROWS_PER_STRIP]


def counts_of(fn):
    """``fn()`` inside a span under an active profiler; the span's counts."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("detect.write shadow masks"):
            fn()
    [rec] = [r for r in profiling.records() if r.name == "detect.write shadow masks"]
    return rec.counts


def one_strip_tiff(data: np.ndarray) -> bytes:
    """Today's deflated encoding of a 2-D raster without extra tags, written
    out: a classic little-endian TIFF, its IFD right after the header with
    every value inline, then the whole raster as one deflated strip."""
    h, w = data.shape
    strip = zlib.compress(data.tobytes())
    entries = [(256, 4, w), (257, 4, h), (258, 3, data.itemsize * 8), (259, 3, 8), (262, 3, 1),
               (273, 4, 8 + 2 + 11 * 12 + 4), (277, 3, 1), (278, 4, h), (279, 4, len(strip)),
               (284, 3, 2), (339, 3, 1)]
    out = struct.pack("<2sHIH", b"II", 42, 8, len(entries))
    for tag, ftype, value in entries:
        out += struct.pack("<HHI", tag, ftype, 1)
        out += struct.pack("<H2x" if ftype == 3 else "<I", value)
    return out + struct.pack("<I", 0) + strip + b"\0" * (len(strip) & 1)


# 1 row; heights that are not a multiple of the strip (37 rows of 4 or 2);
# 1 x N; N x 1; one pixel (under the limit)
SHAPES = [(1, 700), (37, 50), (700, 1), (1, 1)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES)
def test_strips_read_back_through_every_reader(small_strips, tmp_path, shape, dtype):
    data = raster(shape, dtype, seed=shape[0])
    path = tmp_path / "m.tif"
    geotiff.write_geotiff_deflated(data, path)
    offs, cnts, rows = strip_tags(path)
    assert len(offs) == len(cnts) == strips_expected(shape, data.itemsize)
    assert rows == (shape[0] if len(offs) == 1 else max(1, STRIP // (shape[1] * data.itemsize)))
    with Image.open(path) as im:
        assert np.array_equal(np.array(im), data)
    codec, _ = tiffmb.read_multiband_tiff(path)
    assert codec.dtype == dtype and np.array_equal(codec[0], data)
    for reader in (geotiff.GeoTIFF, j_geotiff.GeoTIFF):
        got = reader.open(path).read()
        assert got.dtype == dtype and np.array_equal(got, data), reader


@pytest.mark.parametrize("width", [1, 2, 8])
def test_bytes_do_not_depend_on_the_pool_width(small_strips, monkeypatch, tmp_path, width):
    data = raster((3, 61, 50), np.uint16, seed=5)
    tiffmb.write_multiband_tiff(data, tmp_path / "inline.tif", compression="deflate")
    monkeypatch.setattr(tiffmb, "_width", width)
    monkeypatch.setattr(tiffmb, "_pool", ThreadPoolExecutor(width) if width > 1 else None)
    try:
        counts = counts_of(lambda: tiffmb.write_multiband_tiff(
            data, tmp_path / "pooled.tif", compression="deflate"))
    finally:
        if tiffmb._pool is not None:
            tiffmb._pool.shutdown()
    assert counts == {"strips": 3 * 31, "encode_threads": width}
    assert (tmp_path / "pooled.tif").read_bytes() == (tmp_path / "inline.tif").read_bytes()


@pytest.mark.parametrize("shape,dtype", [((33, 47), np.uint8), ((2048, 2048), np.uint8),
                                         ((1024, 2048), np.uint16)])
def test_at_or_under_the_limit_byte_equal_to_one_strip(tmp_path, shape, dtype):
    """Under the real limit (4 MiB, the last two exactly at it) a raster is
    one strip, encoded as it always was."""
    data = raster(shape, dtype, seed=7)
    assert data.nbytes <= tiffmb.ONE_STRIP_BYTES
    counts = counts_of(lambda: geotiff.write_geotiff_deflated(data, tmp_path / "m.tif"))
    assert counts == {"strips": 1, "encode_threads": 1}
    assert (tmp_path / "m.tif").read_bytes() == one_strip_tiff(data)


def test_past_the_limit_in_strips_of_about_a_mebibyte(tmp_path):
    """One column past 4 MiB: strips of 511 rows (1 MiB // 2049 bytes)."""
    data = raster((2048, 2049), np.uint8, seed=8)
    path = tmp_path / "m.tif"
    counts = counts_of(lambda: geotiff.write_geotiff_deflated(data, path))
    assert counts == {"strips": 5, "encode_threads": tiffmb._get_pool()[1]}
    offs, cnts, rows = strip_tags(path)
    assert (len(offs), rows) == (5, 511)
    pieces = [zlib.decompress(path.read_bytes()[o:o + c]) for o, c in zip(offs, cnts)]
    assert [len(p) for p in pieces] == [511 * 2049] * 4 + [4 * 2049]
    with Image.open(path) as im:
        assert np.array_equal(np.array(im), data)


@pytest.mark.parametrize("case", ["one strip, tagged", "one strip, 3 bands", "uncompressed",
                                  "tiled"])
def test_other_layouts_byte_equal_to_the_jax_package_writer(small_strips, tmp_path, case):
    """The JAX package's writer is the codec as it was: a deflated raster at
    or under the limit, and every uncompressed or tiled one past it, come
    out byte for byte as it writes them."""
    tags = [(geotiff.MODEL_PIXEL_SCALE, 12, (20.0, 20.0, 0.0)),
            (geotiff.GDAL_NODATA, 2, "0")]
    kwargs = {
        "one strip, tagged": dict(values=raster((20, 25), np.uint8), extra_tags=tags,
                                  compression="deflate"),
        "one strip, 3 bands": dict(values=raster((3, 8, 10), np.uint16), compression="deflate"),
        "uncompressed": dict(values=raster((3, 37, 50), np.uint16), extra_tags=tags),
        "tiled": dict(values=raster((2, 37, 50), np.uint8), tile=(16, 32), compression="deflate"),
    }[case]
    tiffmb.write_multiband_tiff(path=tmp_path / "t.tif", **kwargs)
    j_tiffmb.write_multiband_tiff(path=tmp_path / "j.tif", **kwargs)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()


def test_multiband_strips_keep_the_band_order(small_strips, tmp_path):
    data = np.stack([raster((37, 50), np.uint16, seed=b) for b in range(3)])
    path = tmp_path / "bands.tif"
    geotiff.write_geotiff(data, path)
    offs, cnts, rows = strip_tags(path)
    per_band = strips_expected((37, 50), 2)
    assert rows == 2 and len(offs) == 3 * per_band == 57
    assert list(offs) == sorted(offs)
    buf = path.read_bytes()
    for b in range(3):  # each band's first strip holds the band's first rows
        o, c = offs[b * per_band], cnts[b * per_band]
        assert zlib.decompress(buf[o:o + c]) == data[b, :rows].tobytes()
    codec, _ = tiffmb.read_multiband_tiff(path)
    assert np.array_equal(codec, data)
    for reader in (geotiff.GeoTIFF, j_geotiff.GeoTIFF):
        opened = reader.open(path)
        assert np.array_equal(opened.read_all(), data), reader
        assert np.array_equal(opened.read_bands([3, 1]), data[[2, 0]]), reader


def test_counters(small_strips):
    counts = counts_of(lambda: geotiff.write_geotiff(raster((2, 10, 10), np.uint8),
                                                     os.devnull))
    assert counts == {"strips": 2, "encode_threads": 1}  # 200 bytes: a strip a band, inline
    counts = counts_of(lambda: geotiff.write_geotiff_deflated(raster((37, 50), np.uint8),
                                                              os.devnull))
    assert counts == {"strips": 10, "encode_threads": tiffmb._get_pool()[1]}
    # each write adds its own: a span that holds two reads the sums
    counts = counts_of(lambda: [geotiff.write_geotiff_deflated(raster((37, 50), np.uint8),
                                                               os.devnull) for _ in range(2)])
    assert counts == {"strips": 20, "encode_threads": 2 * tiffmb._get_pool()[1]}


def test_nothing_counted_without_a_profiler(small_strips, tmp_path):
    geotiff.write_geotiff_deflated(raster((37, 50), np.uint8), tmp_path / "m.tif")
    assert profiling.records() == []


@pytest.mark.parametrize("cpus,width", [(1, 1), (2, 1), (3, 2), (9, 8), (40, 16)])
def test_pool_width_from_affinity(small_strips, fresh_pool, monkeypatch, tmp_path, cpus, width):
    """The CPUs the process may run on less the calling thread's, 1 to 16;
    at width 1 every strip is compressed inline."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    data = raster((37, 50), np.uint8, seed=9)
    counts = counts_of(lambda: geotiff.write_geotiff_deflated(data, tmp_path / "m.tif"))
    assert counts == {"strips": 10, "encode_threads": width}
    assert (tiffmb._pool is None) == (width == 1)
    with Image.open(tmp_path / "m.tif") as im:
        assert np.array_equal(np.array(im), data)


def test_concurrent_writers_on_a_wide_pool(small_strips, fresh_pool, monkeypatch, tmp_path):
    """Twelve writers at once on a pool of 16 (more threads than this host
    has cores), switching threads every microsecond: each file is byte for
    byte the one written alone."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(64)), raising=False)
    data = [raster((3, 37, 50), np.uint16, seed=s) for s in range(12)]
    alone = []
    for s, d in enumerate(data):
        tiffmb.write_multiband_tiff(d, tmp_path / f"alone{s}.tif", compression="deflate")
        alone.append((tmp_path / f"alone{s}.tif").read_bytes())
    errors, done = [], []

    def writer(s):
        try:
            for k in range(5):
                path = tmp_path / f"w{s}-{k}.tif"
                tiffmb.write_multiband_tiff(data[s], path, compression="deflate")
                assert path.read_bytes() == alone[s]
            done.append(s)
        except Exception as e:  # handed to the test's thread below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert sorted(done) == list(range(12)) and tiffmb._width == 16
