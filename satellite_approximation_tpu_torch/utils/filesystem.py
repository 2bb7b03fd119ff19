"""Date-folder discovery conventions.

Replaces lib/utils/{filesystem.h,filesystem.cpp}: a folder named
``YYYY-MM-DD`` containing ``B04.tif`` holds multispectral data; a date folder
without it is radar; anything else is not satellite data.
"""

from __future__ import annotations

import enum
import re
from pathlib import Path

_DATE_DIR_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


class DirectoryContents(enum.Enum):
    NoSatelliteData = 0
    MultiSpectral = 1
    Radar = 2


def find_directory_contents(path: Path | str) -> DirectoryContents:
    """Classify a folder by the reference's naming convention
    (filesystem.cpp:5-15)."""
    path = Path(path)
    if not _DATE_DIR_RE.match(path.name):
        return DirectoryContents.NoSatelliteData
    if (path / "B04.tif").exists():
        return DirectoryContents.MultiSpectral
    return DirectoryContents.Radar


def multispectral_folders(base: Path | str) -> list[Path]:
    """All multispectral date folders under ``base``, sorted by name
    (the per-date walk of automatic_detection.cpp:288-294)."""
    base = Path(base)
    return sorted(
        p
        for p in base.iterdir()
        if p.is_dir() and find_directory_contents(p) == DirectoryContents.MultiSpectral
    )
