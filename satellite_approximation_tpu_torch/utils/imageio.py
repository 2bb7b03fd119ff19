"""Gamma-decoded RGB image IO for the inpainting demos.

Replaces lib/approx/source/utils.cpp:16-67: images read through a 2.2 gamma
decode into [0,1] float channels (R, G, B order — the reference unpacks
OpenCV BGR into that order), and written back with the inverse encode.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from .errors import IOError_

GAMMA = 2.2


def read_image(path: Path | str) -> np.ndarray:
    """(3, H, W) float64 gamma-decoded channels (approx/utils.cpp:16-35)."""
    try:
        im = Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001
        raise IOError_(f"Failed to open image: {e}", path) from e
    rgb = np.asarray(im, dtype=np.float64) / 255.0
    decoded = np.power(rgb, 1.0 / GAMMA)
    return np.moveaxis(decoded, -1, 0)


def write_image(channels: np.ndarray, output_path: Path | str) -> None:
    """Inverse of :func:`read_image` (approx/utils.cpp:37-67)."""
    channels = np.asarray(channels)
    if channels.shape[0] != 3:
        raise IOError_(f"Expected 3 channels, got {channels.shape[0]}")
    encoded = np.power(np.clip(channels, 0.0, 1.0), GAMMA) * 255.0
    rgb = np.moveaxis(encoded, 0, -1).astype(np.uint8)
    Image.fromarray(rgb).save(Path(output_path))


def read_image_raw(path: Path | str) -> np.ndarray:
    """(H, W, C) uint8 without gamma handling (for marker images)."""
    try:
        im = Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001
        raise IOError_(f"Failed to open image: {e}", path) from e
    return np.asarray(im)
