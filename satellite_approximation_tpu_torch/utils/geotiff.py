"""GeoTIFF read/write with template-copy semantics — no GDAL required.

Replaces two reference IO layers:
* lib/utils/include/utils/geotiff.h — ``GeoTIFF<T>`` (GDAL RasterIO reads,
  geotransform + geodetic helpers) and ``GeoTiffWriter<T>`` (CreateCopy from
  a template dataset preserving CRS/geotransform, geotiff.h:98-195);
* lib/cloud_shadow_detection/source/Imageio.cpp — raw libtiff scanline
  readers. The reference returns vertically flipped matrices to serve its
  bottom-left convention (Imageio.cpp:7-150); this framework is top-left
  row-major everywhere, so reads are *not* flipped.

Built on PIL's libtiff bindings; GeoTIFF tags (ModelPixelScale,
ModelTiepoint, GeoKeyDirectory, GeoAsciiParams, GeoDoubleParams) are parsed
for the geotransform and copied verbatim when writing with a template.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
from PIL import Image, TiffImagePlugin

from .errors import IOError_

# GeoTIFF tag ids
MODEL_PIXEL_SCALE = 33550
MODEL_TIEPOINT = 33922
MODEL_TRANSFORMATION = 34264
GEO_KEY_DIRECTORY = 34735
GEO_DOUBLE_PARAMS = 34736
GEO_ASCII_PARAMS = 34737
GDAL_METADATA = 42112
GDAL_NODATA = 42113

GEO_TAGS = (
    MODEL_PIXEL_SCALE,
    MODEL_TIEPOINT,
    MODEL_TRANSFORMATION,
    GEO_KEY_DIRECTORY,
    GEO_DOUBLE_PARAMS,
    GEO_ASCII_PARAMS,
    GDAL_METADATA,
    GDAL_NODATA,
)

Image.MAX_IMAGE_PIXELS = None  # full Sentinel-2 tiles are 10980^2


def _geotransform_from_tags(tags) -> tuple[float, ...] | None:
    """GDAL-style geotransform from GeoTIFF tags
    (geotiff.h:322-331 documents the layout)."""
    if MODEL_TRANSFORMATION in tags:
        m = tags[MODEL_TRANSFORMATION]
        return (m[3], m[0], m[1], m[7], m[4], m[5])
    if MODEL_PIXEL_SCALE in tags and MODEL_TIEPOINT in tags:
        sx, sy = tags[MODEL_PIXEL_SCALE][0], tags[MODEL_PIXEL_SCALE][1]
        tp = tags[MODEL_TIEPOINT]
        i, j, x, y = tp[0], tp[1], tp[3], tp[4]
        return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
    return None


@dataclasses.dataclass
class GeoTIFF:
    """An opened GeoTIFF: pixel data + geotransform + geodetic helpers.

    Mirrors the reference's ``GeoTIFF<T>`` surface (geotiff.h:198-427):
    ``read``, north/south/east/west, indexAt/valueAt/bilinearValueAt/uvAt/
    midPointOfPixel, valueDomain/demValueDomain.
    """

    path: Path
    width: int
    height: int
    geo_transform: tuple[float, ...] | None
    tags: dict
    _frames: list[np.ndarray]

    @classmethod
    def open(cls, path: Path | str) -> "GeoTIFF":
        path = Path(path)
        try:
            im = Image.open(path)
            im.load()
        except Exception as e:  # noqa: BLE001
            # PIL has no mode for N-band planar rasters (the format our
            # multi-band writer and GDAL produce) and rejects BigTIFF —
            # fall back to the minimal codec (utils/tiffmb: BigTIFF, tiles,
            # deflate/LZW), then to rasterio/GDAL if it happens to be
            # installed (the reference reads anything GDAL does,
            # geotiff.h:234-273; rasterio is optional in this image).
            try:
                return cls._open_multiband(path)
            except Exception:  # noqa: BLE001
                rio = cls._open_rasterio(path)
                if rio is not None:
                    return rio
                raise IOError_(f"Failed to open GeoTIFF: {e}", path) from e
        frames = []
        tags = dict(im.tag_v2) if hasattr(im, "tag_v2") else {}
        try:
            n = getattr(im, "n_frames", 1)
        except Exception:  # noqa: BLE001
            n = 1
        big_endian = getattr(im.tag_v2, "prefix", b"II") == b"MM"
        for k in range(n):
            im.seek(k)
            arr = np.asarray(im)
            # PIL's 'F' rawmode ignores the TIFF byte order for float
            # samples; big-endian float rasters come back bit-garbled.
            if big_endian and arr.dtype == np.float32 and im.mode == "F":
                arr = arr.view(np.uint32).byteswap().view(np.float32)
            if arr.dtype.byteorder not in ("=", "|"):
                arr = arr.astype(arr.dtype.newbyteorder("="))
            frames.append(arr)
        im.seek(0)
        gt = _geotransform_from_tags(tags)
        return cls(
            path=path,
            width=im.width,
            height=im.height,
            geo_transform=gt,
            tags=tags,
            _frames=frames,
        )

    @classmethod
    def _open_multiband(cls, path: Path) -> "GeoTIFF":
        from .tiffmb import read_multiband_tiff

        arr, tags = read_multiband_tiff(path)
        return cls(
            path=path,
            width=arr.shape[2],
            height=arr.shape[1],
            geo_transform=_geotransform_from_tags(tags),
            tags=tags,
            _frames=list(arr),
        )

    @classmethod
    def _open_rasterio(cls, path: Path) -> "GeoTIFF | None":
        """Optional GDAL-grade fallback for exotic rasters (JPEG-in-TIFF,
        sparse files, external overviews, ...). Returns None when rasterio
        is not installed — the two native readers cover everything the
        checked-in pipeline produces."""
        try:
            import rasterio  # type: ignore[import-not-found]
        except ImportError:
            return None
        with rasterio.open(path) as ds:
            arr = ds.read()  # (C, H, W)
            t = ds.transform
            gt = (t.c, t.a, t.b, t.f, t.d, t.e)
            return cls(
                path=path,
                width=ds.width,
                height=ds.height,
                geo_transform=gt,
                tags={},
                _frames=list(arr),
            )

    # ----- reads (geotiff.h:234-273; band index is 1-based like GDAL) -----

    def read(self, band: int = 1) -> np.ndarray:
        """One band as a (H, W) array. Multi-band images may be stored as
        multiple TIFF pages or as the last axis of a single page."""
        f = self._frames[0]
        if f.ndim == 3:
            if band < 1 or band > f.shape[2]:
                raise IOError_(f"Band {band} out of range (1..{f.shape[2]})", self.path)
            return f[:, :, band - 1]
        if band < 1 or band > len(self._frames):
            raise IOError_(f"Band {band} out of range (1..{len(self._frames)})", self.path)
        return self._frames[band - 1]

    def read_bands(self, bands: list[int]) -> np.ndarray:
        """Stack of bands, shape (len(bands), H, W) (geotiff.h read(bands))."""
        return np.stack([self.read(b) for b in bands])

    def read_all(self) -> np.ndarray:
        f = self._frames[0]
        if f.ndim == 3:
            return np.moveaxis(f, -1, 0)
        return np.stack(self._frames)

    @property
    def num_bands(self) -> int:
        f = self._frames[0]
        return f.shape[2] if f.ndim == 3 else len(self._frames)

    # ----- geodetic helpers (geotiff.h:331-404) -----

    def _gt(self):
        if self.geo_transform is None:
            raise IOError_("GeoTIFF has no geotransform", self.path)
        return self.geo_transform

    def east_west_step(self) -> float:
        return self._gt()[1]

    def north_south_step(self) -> float:
        return self._gt()[5]

    def north(self) -> float:
        return self._gt()[3]

    def west(self) -> float:
        return self._gt()[0]

    def south(self) -> float:
        return self.north() + self.height * self.north_south_step()

    def east(self) -> float:
        return self.west() + self.width * self.east_west_step()

    def index_at(self, lat: float, lng: float) -> tuple[int, int]:
        """(col, row) of a lat/lng, clamped in-image (geotiff.h:391-400)."""
        x = int((lng - self.west()) / self.east_west_step())
        y = int((lat - self.north()) / self.north_south_step())
        return (
            int(np.clip(x, 0, self.width - 1)),
            int(np.clip(y, 0, self.height - 1)),
        )

    def value_at(self, lat: float, lng: float, values: np.ndarray):
        x, y = self.index_at(lat, lng)
        return values[y, x]

    def bilinear_value_at(self, lat: float, lng: float, values: np.ndarray) -> float:
        """Bilinear sample at a lat/lng (geotiff.h:352-381)."""
        x = (lng - self.west()) / self.east_west_step()
        y = (lat - self.north()) / self.north_south_step()
        x1, x2 = np.floor(x), np.ceil(x)
        y1, y2 = np.floor(y), np.ceil(y)
        if x2 == x1:
            x2 = x1 + 1
        if y2 == y1:
            y2 = y1 + 1

        def v(fx, fy):
            xi = int(np.clip(int(fx), 0, self.width - 1))
            yi = int(np.clip(int(fy), 0, self.height - 1))
            return float(values[yi, xi])

        s = 1.0 / ((x2 - x1) * (y2 - y1))
        return s * (
            v(x1, y1) * (x2 - x) * (y2 - y)
            + v(x1, y2) * (x2 - x) * (y - y1)
            + v(x2, y1) * (x - x1) * (y2 - y)
            + v(x2, y2) * (x - x1) * (y - y1)
        )

    def uv_at(self, lat: float, lng: float) -> tuple[float, float]:
        x, y = self.index_at(lat, lng)
        return (x / self.width, y / self.height)

    def mid_point_of_pixel(self, col: int, row: int) -> tuple[float, float]:
        """(lat, lng) of a pixel center (geotiff.h:402-404, with the
        reference's row/col transposition bug fixed)."""
        lat = self.north() + self.north_south_step() * (row + 0.5)
        lng = self.west() + self.east_west_step() * (col + 0.5)
        return (lat, lng)

    @staticmethod
    def value_domain(values: np.ndarray) -> tuple[float, float]:
        return (float(values.min()), float(values.max()))

    @staticmethod
    def dem_value_domain(values: np.ndarray) -> tuple[float, float]:
        """Min/max ignoring DEM no-data sentinel <= -32767 (geotiff.h:414-427)."""
        valid = values > -32767.0
        if not valid.any():
            return (float("nan"), float("nan"))
        return (float(values[valid].min()), float(values[valid].max()))


def write_geotiff(
    values: np.ndarray,
    output_path: Path | str,
    template_path: Path | str | None = None,
    compression: str | None = "tiff_adobe_deflate",
) -> None:
    """Write a (H, W) or (C, H, W) array as a GeoTIFF, copying geo metadata
    from a template file — the reference's GeoTiffWriter CreateCopy
    semantics, incl. its multi-band variant (geotiff.h:98-195, used at
    automatic_detection.cpp:106-108, 217-233 and poisson-main.cpp:66-71).

    2-D writes go through PIL (compressed); 3-D writes produce one planar
    multi-band TIFF via the minimal codec (deflate when compression is
    requested; BigTIFF offsets engage automatically past the classic 4 GB
    limit — a 13-band f32 tile is 6.3 GB)."""
    values = np.asarray(values)
    if values.ndim == 3:
        from .tiffmb import write_multiband_tiff

        write_multiband_tiff(
            values,
            output_path,
            extra_tags=_geo_tags_from_template(template_path),
            compression="deflate" if compression else None,
        )
        return
    if values.ndim != 2:
        raise IOError_(f"write_geotiff expects a 2-D or 3-D array, got shape {values.shape}")
    im = Image.fromarray(values)

    info = TiffImagePlugin.ImageFileDirectory_v2()
    if template_path is not None:
        with Image.open(template_path) as tmpl:
            ttags = tmpl.tag_v2
            for tag in GEO_TAGS:
                if tag in ttags:
                    info[tag] = ttags[tag]
                    if tag in ttags.tagtype:
                        info.tagtype[tag] = ttags.tagtype[tag]

    kwargs = {"tiffinfo": info}
    if compression:
        kwargs["compression"] = compression
    im.save(Path(output_path), format="TIFF", **kwargs)


def write_geotiff_deflated(
    values: np.ndarray, output_path: Path | str, template_path: Path | str | None = None
) -> None:
    """A (H, W) array as a deflate-compressed single-band GeoTIFF through the
    minimal codec (``utils/tiffmb.py``), geo metadata copied from the
    template as in :func:`write_geotiff`. zlib releases the GIL while it
    compresses, where PIL's libtiff encoder holds it for the whole raster
    (~1 s for a 5490^2 mask): a writer thread that uses this leaves the
    other threads' Python running. A raster past the codec's
    ``ONE_STRIP_BYTES`` is deflated as row strips on the codec's pool."""
    from .tiffmb import write_multiband_tiff

    values = np.asarray(values)
    if values.ndim != 2:
        raise IOError_(f"write_geotiff_deflated expects a 2-D array, got shape {values.shape}")
    write_multiband_tiff(values, output_path, extra_tags=_geo_tags_from_template(template_path),
                         compression="deflate")


def _geo_tags_from_template(
    template_path: Path | str | None,
) -> list[tuple[int, int, object]]:
    """(tag, tiff_type, value) triples of a template's geo tags, for the
    minimal multi-band writer."""
    if template_path is None:
        return []
    out = []
    try:
        with Image.open(template_path) as tmpl:
            ttags = tmpl.tag_v2
            for tag in GEO_TAGS:
                if tag in ttags:
                    ftype = ttags.tagtype.get(tag, 12)
                    val = ttags[tag]
                    if isinstance(val, TiffImagePlugin.IFDRational):
                        val = float(val)
                    out.append((tag, ftype, val))
    except Exception:  # noqa: BLE001
        # The template may itself be a multi-band planar file PIL can't
        # open; pull tags via the minimal parser (types are fixed per tag).
        from .tiffmb import read_multiband_tiff

        _GEO_TAG_TYPES = {
            MODEL_PIXEL_SCALE: 12, MODEL_TIEPOINT: 12, MODEL_TRANSFORMATION: 12,
            GEO_KEY_DIRECTORY: 3, GEO_DOUBLE_PARAMS: 12, GEO_ASCII_PARAMS: 2,
            GDAL_METADATA: 2, GDAL_NODATA: 2,
        }
        _, tags = read_multiband_tiff(template_path)
        for tag in GEO_TAGS:
            if tag in tags:
                out.append((tag, _GEO_TAG_TYPES[tag], tags[tag]))
    return out
