"""Minimal multi-band TIFF/BigTIFF codec (no GDAL, no tifffile).

The reference reads ANY GDAL-supported raster via RasterIO and writes with
CreateCopy (lib/utils/include/utils/geotiff.h:98-273). This
framework's primary reader is PIL; this module covers what PIL cannot:

* **write**: planar multi-band rasters of any band count/dtype (PIL cannot
  encode arbitrary-band float TIFFs) — used by the GeoTIFF writer for
  poisson_main's 5-band output (poisson-main.cpp:66-71). Optional deflate
  compression, tiled layout, and BigTIFF (rasters beyond 4 GB — a 13-band
  f32 Sentinel-2 tile is 6.3 GB and *requires* BigTIFF offsets). A deflated
  raster past ``ONE_STRIP_BYTES`` is cut into row strips of about
  ``STRIP_BYTES``, compressed in parallel on a thread pool of the module's
  own (zlib releases the GIL); a smaller one is one strip a band, encoded on
  the caller's thread. Each deflated write adds to the innermost open span
  (``utils/profiling.py``) the counters ``strips`` (strips encoded) and
  ``encode_threads`` (the pool's width, 1 inline): a span that holds N
  writes reads their sums.
* **read**: classic and BigTIFF; strip- and tile-organized; uncompressed,
  deflate (8 / 32946) and LZW (5) compression; horizontal-differencing
  predictor (tag 317 = 2). This is the fallback `GeoTIFF.open` uses when
  PIL rejects a file (planar multi-band, BigTIFF).

Pure-Python LZW is slow for huge rasters — fine for the fallback role
(PIL handles classic compressed files natively; this path sees them only
for BigTIFF/planar layouts).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from . import profiling

# TIFF tag ids
IMAGE_WIDTH = 256
IMAGE_LENGTH = 257
BITS_PER_SAMPLE = 258
COMPRESSION = 259
PHOTOMETRIC = 262
STRIP_OFFSETS = 273
SAMPLES_PER_PIXEL = 277
ROWS_PER_STRIP = 278
STRIP_BYTE_COUNTS = 279
PLANAR_CONFIG = 284
PREDICTOR = 317
TILE_WIDTH = 322
TILE_LENGTH = 323
TILE_OFFSETS = 324
TILE_BYTE_COUNTS = 325
SAMPLE_FORMAT = 339

# TIFF field types
T_BYTE, T_ASCII, T_SHORT, T_LONG, T_RATIONAL = 1, 2, 3, 4, 5
T_SBYTE, T_UNDEF, T_SSHORT, T_SLONG, T_SRATIONAL, T_FLOAT, T_DOUBLE = (
    6, 7, 8, 9, 10, 11, 12,
)
T_LONG8, T_SLONG8, T_IFD8 = 16, 17, 18  # BigTIFF types

_TYPE_SIZE = {
    T_BYTE: 1, T_ASCII: 1, T_SHORT: 2, T_LONG: 4, T_RATIONAL: 8,
    T_SBYTE: 1, T_UNDEF: 1, T_SSHORT: 2, T_SLONG: 4, T_SRATIONAL: 8,
    T_FLOAT: 4, T_DOUBLE: 8, T_LONG8: 8, T_SLONG8: 8, T_IFD8: 8,
}
_TYPE_FMT = {
    T_BYTE: "B", T_SHORT: "H", T_LONG: "I", T_SBYTE: "b",
    T_SSHORT: "h", T_SLONG: "i", T_FLOAT: "f", T_DOUBLE: "d",
    T_LONG8: "Q", T_SLONG8: "q", T_IFD8: "Q",
}

# numpy dtype -> (bits, sample_format)
_DTYPE_INFO = {
    np.dtype(np.uint8): (8, 1),
    np.dtype(np.uint16): (16, 1),
    np.dtype(np.uint32): (32, 1),
    np.dtype(np.int16): (16, 2),
    np.dtype(np.int32): (32, 2),
    np.dtype(np.float32): (32, 3),
    np.dtype(np.float64): (64, 3),
}
_INFO_DTYPE = {v: k for k, v in _DTYPE_INFO.items()}

DEFLATE_CODES = (8, 32946)  # Adobe deflate + legacy deflate
LZW_CODE = 5

# A deflated raster of at most this many bytes is one strip a band, on the
# caller's thread; a larger one is cut into strips of about STRIP_BYTES each
ONE_STRIP_BYTES = 4 << 20
STRIP_BYTES = 1 << 20
MAX_THREADS = 16

_pool = None
_width = None
_pool_lock = threading.Lock()


def _get_pool():
    """The strip pool and its width: the CPUs this process may run on, less
    the calling thread's, 1 to ``MAX_THREADS``; no pool at width 1."""
    global _pool, _width
    with _pool_lock:
        if _width is None:
            cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                    else os.cpu_count() or 1)
            _width = min(max(cpus - 1, 1), MAX_THREADS)
        if _pool is None and _width > 1:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=_width, thread_name_prefix="sat-strips")
    return _pool, _width


def _deflate_strips(values: np.ndarray) -> tuple[int, list[bytes]]:
    """(rows a strip, each strip deflated) of a contiguous (C, H, W) array,
    band by band and top to bottom within a band. Each strip is one
    ``zlib.compress`` at zlib's default level over the strip's rows, so the
    bytes do not depend on the pool's width."""
    c, h, w = values.shape
    if values.nbytes <= ONE_STRIP_BYTES:
        rows, strips = h, [values[band] for band in range(c)]
        pool, width = None, 1
    else:
        rows = min(h, max(1, STRIP_BYTES // (w * values.itemsize)))
        strips = [values[band, r:r + rows] for band in range(c) for r in range(0, h, rows)]
        pool, width = _get_pool()
    if pool is None:
        segments = [zlib.compress(s) for s in strips]
    else:
        segments = list(pool.map(zlib.compress, strips))
    profiling.count("strips", len(strips))
    profiling.count("encode_threads", width)
    return rows, segments


def _encode_value(ftype: int, values) -> bytes:
    if ftype == T_ASCII:
        if isinstance(values, bytes):
            data = values
        else:
            data = str(values).encode("ascii", "replace")
        if not data.endswith(b"\0"):
            data += b"\0"
        return data
    fmt = _TYPE_FMT[ftype]
    if not isinstance(values, (tuple, list, np.ndarray)):
        values = (values,)
    return struct.pack(f"<{len(values)}{fmt}", *values)


def write_multiband_tiff(
    values: np.ndarray,
    path: Path | str,
    extra_tags: list[tuple[int, int, object]] | None = None,
    *,
    bigtiff: bool | None = None,
    tile: tuple[int, int] | None = None,
    compression: str | None = None,
) -> None:
    """Write (C, H, W) or (H, W) ``values`` as one planar multi-band TIFF.

    extra_tags: list of (tag_id, tiff_type, value) — e.g. GeoTIFF tags
    pulled from a template via :func:`geo_tags_from_pil`.

    bigtiff: force BigTIFF (version 43, 8-byte offsets). Default: auto —
    classic TIFF unless the payload approaches the 4 GB offset limit.
    tile: (tile_height, tile_width) for a tiled layout (multiples of 16 per
    the TIFF spec); default is strips: one a band, or row strips of about
    ``STRIP_BYTES`` a band where a deflated raster passes
    ``ONE_STRIP_BYTES``.
    compression: None or "deflate".
    """
    values = np.asarray(values)
    if values.ndim == 2:
        values = values[None]
    if values.ndim != 3:
        raise ValueError(f"expected (C, H, W) array, got shape {values.shape}")
    dt = values.dtype
    if dt not in _DTYPE_INFO:
        raise ValueError(f"unsupported dtype {dt}")
    bits, sfmt = _DTYPE_INFO[dt]
    c, h, w = values.shape
    if dt.byteorder not in ("=", "|", "<"):
        values = values.astype(dt.newbyteorder("<"))
    values = np.ascontiguousarray(values)

    comp_code = 1
    if compression == "deflate":
        comp_code = 8
    elif compression is not None:
        raise ValueError(f"unsupported compression {compression!r} (use 'deflate')")

    # --- build the data segments (strips or tiles), band-sequential ---
    segments: list[bytes] = []
    if tile is None:
        if comp_code != 1:
            rows, segments = _deflate_strips(values)
        else:
            rows, segments = h, [values[band].tobytes() for band in range(c)]
        seg_tags = [
            (ROWS_PER_STRIP, T_LONG, rows),
        ]
        off_tag, cnt_tag = STRIP_OFFSETS, STRIP_BYTE_COUNTS
    else:
        th, tw = tile
        if th % 16 or tw % 16:
            raise ValueError("tile dims must be multiples of 16 (TIFF spec)")
        for band in range(c):
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw), dt)
                    sub = values[band, ty : ty + th, tx : tx + tw]
                    blk[: sub.shape[0], : sub.shape[1]] = sub
                    seg = blk.tobytes()
                    segments.append(zlib.compress(seg) if comp_code != 1 else seg)
        seg_tags = [
            (TILE_WIDTH, T_LONG, tw),
            (TILE_LENGTH, T_LONG, th),
        ]
        off_tag, cnt_tag = TILE_OFFSETS, TILE_BYTE_COUNTS

    total_data = sum(len(s) + (len(s) & 1) for s in segments)
    if bigtiff is None:
        bigtiff = total_data > 0xFFFF0000  # headroom under the 4 GB limit

    off_type = T_LONG8 if bigtiff else T_LONG
    entries: list[tuple[int, int, bytes]] = [
        (IMAGE_WIDTH, T_LONG, _encode_value(T_LONG, w)),
        (IMAGE_LENGTH, T_LONG, _encode_value(T_LONG, h)),
        (BITS_PER_SAMPLE, T_SHORT, _encode_value(T_SHORT, (bits,) * c)),
        (COMPRESSION, T_SHORT, _encode_value(T_SHORT, comp_code)),
        (PHOTOMETRIC, T_SHORT, _encode_value(T_SHORT, 1)),
        (SAMPLES_PER_PIXEL, T_SHORT, _encode_value(T_SHORT, c)),
        (cnt_tag, off_type, _encode_value(off_type, tuple(len(s) for s in segments))),
        (PLANAR_CONFIG, T_SHORT, _encode_value(T_SHORT, 2)),
        (SAMPLE_FORMAT, T_SHORT, _encode_value(T_SHORT, (sfmt,) * c)),
    ]
    entries += [(t, ft, _encode_value(ft, v)) for t, ft, v in seg_tags]
    for tag, ftype, val in extra_tags or ():
        entries.append((tag, ftype, _encode_value(ftype, val)))

    # segment offsets resolve after layout; reserve the slot now
    n_entries = len(entries) + 1
    if bigtiff:
        header_size = 16
        entry_size = 20
        ifd_size = 8 + n_entries * entry_size + 8
        inline_max = 8
    else:
        header_size = 8
        entry_size = 12
        ifd_size = 2 + n_entries * entry_size + 4
        inline_max = 4
    ifd_offset = header_size
    overflow_offset = ifd_offset + ifd_size

    payload_offsets: dict[int, int] = {}
    overflow = bytearray()
    all_entries = entries + [
        (off_tag, off_type, _encode_value(off_type, (0,) * len(segments)))
    ]
    for tag, ftype, data in all_entries:
        if len(data) > inline_max:
            if len(overflow) % 2:
                overflow += b"\0"
            payload_offsets[tag] = overflow_offset + len(overflow)
            overflow += data
    data_offset = overflow_offset + len(overflow)
    if data_offset % 2:
        data_offset += 1

    seg_offsets = []
    pos = data_offset
    for s in segments:
        seg_offsets.append(pos)
        pos += len(s) + (len(s) & 1)

    so_data = _encode_value(off_type, tuple(seg_offsets))
    if len(so_data) > inline_max:
        p = payload_offsets[off_tag] - overflow_offset
        overflow[p : p + len(so_data)] = so_data
    else:
        all_entries[-1] = (off_tag, off_type, so_data)

    def entry_bytes(tag: int, ftype: int, data: bytes) -> bytes:
        count = (
            len(data)
            if ftype in (T_ASCII, T_BYTE, T_SBYTE, T_UNDEF)
            else len(data) // _TYPE_SIZE[ftype]
        )
        if bigtiff:
            if len(data) <= 8:
                return struct.pack(
                    "<HHQ8s", tag, ftype, count, data.ljust(8, b"\0")
                )
            return struct.pack("<HHQQ", tag, ftype, count, payload_offsets[tag])
        if len(data) <= 4:
            return struct.pack("<HHI4s", tag, ftype, count, data.ljust(4, b"\0"))
        return struct.pack("<HHII", tag, ftype, count, payload_offsets[tag])

    full = sorted(all_entries, key=lambda e: e[0])
    with open(path, "wb") as fh:
        if bigtiff:
            fh.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, ifd_offset))
            fh.write(struct.pack("<Q", n_entries))
        else:
            fh.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
            fh.write(struct.pack("<H", n_entries))
        for tag, ftype, data in full:
            fh.write(entry_bytes(tag, ftype, data))
        fh.write(struct.pack("<Q" if bigtiff else "<I", 0))  # no next IFD
        fh.write(overflow)
        fh.write(b"\0" * (data_offset - overflow_offset - len(overflow)))
        for s in segments:
            fh.write(s)
            if len(s) & 1:
                fh.write(b"\0")


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, 9->12 bits with early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitpos = 0
    nbits = len(data) * 8
    table: list[bytes] = []
    width = 9
    prev: bytes | None = None

    def read_code() -> int:
        nonlocal bitpos
        if bitpos + width > nbits:
            return EOI
        byte0 = bitpos >> 3
        window = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\0"), "big")
        shift = 32 - (bitpos & 7) - width
        code = (window >> shift) & ((1 << width) - 1)
        bitpos += width
        return code

    while True:
        code = read_code()
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # early change: the encoder widens one code before the table fills
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _decompress(seg: bytes, comp: int) -> bytes:
    if comp == 1:
        return seg
    if comp in DEFLATE_CODES:
        return zlib.decompress(seg)
    if comp == LZW_CODE:
        return _lzw_decode(seg)
    raise ValueError(f"unsupported TIFF compression {comp}")


def _undo_predictor2(arr: np.ndarray, axis: int = -1) -> np.ndarray:
    """Horizontal differencing (tag 317 = 2): cumulative sum along the WIDTH
    axis with the dtype's natural modulo wraparound (integer types only).

    Each sample channel is differenced independently along its row (TIFF 6.0
    §14), so ``axis`` must point at the width dimension of ``arr``'s layout —
    e.g. axis=1 for a (tile_h, tile_w, samples) block, axis=-2 for a chunky
    (h, w, spp) strip. The earlier axis=-1 default silently no-opped planar
    tiles (samples axis of size 1) and cross-mixed samples in chunky tiles.
    """
    if arr.dtype.kind not in "ui":
        raise ValueError("predictor 2 applies to integer samples only")
    return np.cumsum(arr, axis=axis, dtype=arr.dtype)


def _parse_header(buf: bytes):
    order = buf[:2]
    little = order == b"II"
    bo = "<" if little else ">"
    (magic,) = struct.unpack_from(f"{bo}H", buf, 2)
    if magic == 42:
        (ifd_off,) = struct.unpack_from(f"{bo}I", buf, 4)
        return little, False, ifd_off
    if magic == 43:
        offsize, zero = struct.unpack_from(f"{bo}HH", buf, 4)
        if offsize != 8 or zero != 0:
            raise ValueError("malformed BigTIFF header")
        (ifd_off,) = struct.unpack_from(f"{bo}Q", buf, 8)
        return little, True, ifd_off
    raise ValueError(f"not a TIFF (magic {magic})")


def _read_ifd_value(buf, ftype, count, raw, little):
    bo = "<" if little else ">"
    size = _TYPE_SIZE[ftype] * count
    if size <= len(raw):
        data = raw[:size]
    else:
        fmt = "Q" if len(raw) == 8 else "I"
        (off,) = struct.unpack(f"{bo}{fmt}", raw)
        data = buf[off : off + size]
    if ftype == T_ASCII:
        return data.rstrip(b"\0").decode("ascii", "replace")
    if ftype in (T_RATIONAL, T_SRATIONAL):
        f = "I" if ftype == T_RATIONAL else "i"
        nums = struct.unpack(f"{bo}{2 * count}{f}", data)
        return tuple(nums[i] / nums[i + 1] for i in range(0, len(nums), 2))
    fmt = _TYPE_FMT.get(ftype)
    if fmt is None:
        return data
    vals = struct.unpack(f"{bo}{count}{fmt}", data)
    return vals[0] if count == 1 else vals


def read_tiff_tags(buf: bytes) -> tuple[dict, bool]:
    """First-IFD tags of a classic or Big TIFF -> (tags, little_endian)."""
    little, big, ifd_off = _parse_header(buf)
    bo = "<" if little else ">"
    tags: dict[int, object] = {}
    if big:
        (n,) = struct.unpack_from(f"{bo}Q", buf, ifd_off)
        base = ifd_off + 8
        esize = 20
    else:
        (n,) = struct.unpack_from(f"{bo}H", buf, ifd_off)
        base = ifd_off + 2
        esize = 12
    for i in range(int(n)):
        if big:
            tag, ftype = struct.unpack_from(f"{bo}HH", buf, base + i * esize)
            (count,) = struct.unpack_from(f"{bo}Q", buf, base + i * esize + 4)
            raw = buf[base + i * esize + 12 : base + i * esize + 20]
        else:
            tag, ftype, count = struct.unpack_from(f"{bo}HHI", buf, base + i * esize)
            raw = buf[base + i * esize + 8 : base + i * esize + 12]
        if ftype in _TYPE_SIZE:
            tags[tag] = _read_ifd_value(buf, ftype, int(count), raw, little)
    return tags, little


def read_multiband_tiff(path: Path | str) -> tuple[np.ndarray, dict]:
    """Read a classic or Big TIFF -> ((C, H, W), tags).

    Strip- and tile-organized layouts, both planar configurations,
    uncompressed/deflate/LZW, horizontal-differencing predictor — enough
    for everything :func:`write_multiband_tiff` produces plus typical
    GDAL-written rasters (the reference reads those via RasterIO,
    geotiff.h:234-273).
    """
    buf = Path(path).read_bytes()
    tags, little = read_tiff_tags(buf)

    w = int(tags[IMAGE_WIDTH])
    h = int(tags[IMAGE_LENGTH])
    spp = int(tags.get(SAMPLES_PER_PIXEL, 1))
    comp = int(tags.get(COMPRESSION, 1))
    predictor = int(tags.get(PREDICTOR, 1))
    if predictor not in (1, 2):
        raise ValueError(f"{path}: unsupported predictor {predictor}")
    bps = tags.get(BITS_PER_SAMPLE, 8)
    bits = int(bps[0] if isinstance(bps, tuple) else bps)
    sf = tags.get(SAMPLE_FORMAT, 1)
    sfmt = int(sf[0] if isinstance(sf, tuple) else sf)
    dt = _INFO_DTYPE.get((bits, sfmt))
    if dt is None:
        raise ValueError(f"{path}: unsupported sample format ({bits} bits, fmt {sfmt})")
    dt = dt.newbyteorder("<" if little else ">")
    planar = int(tags.get(PLANAR_CONFIG, 1)) == 2
    tiled = TILE_OFFSETS in tags

    def as_tuple(v):
        return (v,) if not isinstance(v, tuple) else v

    if tiled:
        th = int(tags[TILE_LENGTH])
        tw = int(tags[TILE_WIDTH])
        offs = as_tuple(tags[TILE_OFFSETS])
        cnts = as_tuple(tags[TILE_BYTE_COUNTS])
        across = -(-w // tw)
        down = -(-h // th)
        per_plane = across * down
        planes = spp if planar else 1
        samples = 1 if planar else spp
        out = np.empty((planes, h, w * samples), dt)
        for p in range(planes):
            for t in range(per_plane):
                o, cnt = offs[p * per_plane + t], cnts[p * per_plane + t]
                raw = _decompress(buf[o : o + cnt], comp)
                blk = np.frombuffer(raw, dtype=dt, count=th * tw * samples)
                blk = blk.reshape(th, tw * samples)
                if predictor == 2:
                    # cumsum along the tile-width axis, per sample
                    blk = _undo_predictor2(
                        blk.reshape(th, tw, samples), axis=1
                    ).reshape(th, tw * samples)
                ty, tx = (t // across) * th, (t % across) * tw
                ys = min(th, h - ty)
                xs = min(tw, w - tx)
                out[p, ty : ty + ys, tx * samples : (tx + xs - xs) * samples + xs * samples] = blk[
                    :ys, : xs * samples
                ]
        if planar:
            arr = out.reshape(spp, h, w)
        else:
            arr = np.moveaxis(out.reshape(h, w, spp), -1, 0)
        return np.ascontiguousarray(arr.astype(dt.newbyteorder("="))), tags

    offs = as_tuple(tags[STRIP_OFFSETS])
    cnts = as_tuple(tags[STRIP_BYTE_COUNTS])
    data = b"".join(_decompress(buf[o : o + c], comp) for o, c in zip(offs, cnts))
    flat = np.frombuffer(data, dtype=dt)
    if planar:
        arr = flat.reshape(spp, h, w)
        if predictor == 2:
            arr = _undo_predictor2(arr)
    else:
        arr = flat.reshape(h, w, spp)
        if predictor == 2:
            # chunky rows interleave samples: cumsum along the width axis
            arr = _undo_predictor2(arr, axis=-2)
        arr = np.moveaxis(arr, -1, 0)
    return np.ascontiguousarray(arr.astype(dt.newbyteorder("="))), tags
