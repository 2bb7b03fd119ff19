"""Single-band and RGBA raster IO (the reference's raw libtiff path).

Replaces lib/cloud_shadow_detection/{Imageio.h,Imageio.cpp}: typed
single-channel readers/writers (f32/u8/u16/u32) plus packed-RGBA helpers.
The reference returns vertically flipped matrices for its bottom-left
convention (Imageio.cpp:28-32); this framework is top-left row-major, so
no flip happens here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from .errors import IOError_
from .geotiff import GeoTIFF, write_geotiff


def _read(path: Path | str, dtype) -> np.ndarray:
    path = Path(path)
    if path.suffix.lower() not in (".tif", ".tiff"):
        raise IOError_("Extension must be tif", path)
    return GeoTIFF.open(path).read().astype(dtype)


def read_single_channel_float(path: Path | str) -> np.ndarray:
    return _read(path, np.float32)


def read_single_channel_uint8(path: Path | str) -> np.ndarray:
    return _read(path, np.uint8)


def read_single_channel_uint16(path: Path | str) -> np.ndarray:
    return _read(path, np.uint16)


def read_single_channel_uint32(path: Path | str) -> np.ndarray:
    return _read(path, np.uint32)


def read_rgba(path: Path | str) -> np.ndarray:
    """Packed 0xAABBGGRR words per pixel, matching the reference's RGBA
    representation (Imageio.cpp ReadRGBA; ImageOperations decomposeRBGA)."""
    im = Image.open(path).convert("RGBA")
    rgba = np.asarray(im).astype(np.uint32)
    return (
        rgba[..., 0]
        | (rgba[..., 1] << 8)
        | (rgba[..., 2] << 16)
        | (rgba[..., 3] << 24)
    )


def write_single_channel(path: Path | str, image: np.ndarray, template: Path | str | None = None) -> None:
    write_geotiff(np.asarray(image), path, template_path=template)


write_single_channel_float = write_single_channel
write_single_channel_uint8 = write_single_channel
write_single_channel_uint16 = write_single_channel
write_single_channel_uint32 = write_single_channel


def write_rgba(path: Path | str, packed: np.ndarray) -> None:
    """Write packed 0xAABBGGRR words as an RGBA image."""
    packed = np.asarray(packed, dtype=np.uint32)
    rgba = np.stack(
        [
            (packed >> 0) & 0xFF,
            (packed >> 8) & 0xFF,
            (packed >> 16) & 0xFF,
            (packed >> 24) & 0xFF,
        ],
        axis=-1,
    ).astype(np.uint8)
    Image.fromarray(rgba, mode="RGBA").save(Path(path))


def decompose_rgba(packed: np.ndarray) -> np.ndarray:
    """Packed words -> (H, W, 4) float in [0,1]
    (ImageOperations.cpp decomposeRBGA:146-160)."""
    packed = np.asarray(packed, dtype=np.uint32)
    return np.stack(
        [
            ((packed >> 0) & 0xFF).astype(np.float32) / 255.0,
            ((packed >> 8) & 0xFF).astype(np.float32) / 255.0,
            ((packed >> 16) & 0xFF).astype(np.float32) / 255.0,
            ((packed >> 24) & 0xFF).astype(np.float32) / 255.0,
        ],
        axis=-1,
    )


def decompose_rgba_256(packed: np.ndarray) -> np.ndarray:
    """Packed words -> (H, W, 4) uint8 (ImageOperations.cpp:162-173)."""
    packed = np.asarray(packed, dtype=np.uint32)
    return np.stack(
        [
            ((packed >> 0) & 0xFF),
            ((packed >> 8) & 0xFF),
            ((packed >> 16) & 0xFF),
            ((packed >> 24) & 0xFF),
        ],
        axis=-1,
    ).astype(np.uint8)
