"""Prefetching raster loader for multi-date pipelines.

The reference walks date folders strictly sequentially, decoding every TIFF
on the critical path (automatic_detection.cpp:286-324). Here a thread pool
decodes the next dates' rasters while the accelerator works on the current
one — PIL's zlib decode releases the GIL, so decode genuinely overlaps both
compute and the host-side pipeline stages.
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import Iterator

import numpy as np

from .filesystem import multispectral_folders
from .geotiff import GeoTIFF

DETECTION_RASTERS = (
    "B08", "CLP", "CLD", "SCL",
    "sunZenithAngles", "sunAzimuthAngles", "viewZenithMean", "viewAzimuthMean",
)


def load_detection_inputs(folder: Path | str, names=DETECTION_RASTERS) -> dict[str, np.ndarray]:
    """All rasters of one date folder, decoded in parallel.

    Missing or undecodable rasters are silently omitted from the result so
    the consumer (``detect``) falls back to its own disk read and raises
    its usual contextual error on the critical path.
    """
    folder = Path(folder)

    def _read(p: Path) -> np.ndarray | None:
        try:
            return GeoTIFF.open(p).read()
        except Exception:  # noqa: BLE001
            return None

    with cf.ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(_read, folder / f"{name}.tif") for name in names}
        out = {name: fut.result() for name, fut in futures.items()}
    return {name: arr for name, arr in out.items() if arr is not None}


class FolderPrefetcher:
    """Iterate date folders with the next ``prefetch`` folders decoding in
    the background."""

    def __init__(
        self,
        base: Path | str | None = None,
        names=DETECTION_RASTERS,
        prefetch: int = 2,
        folders: list[Path] | None = None,
    ):
        if folders is None:
            if base is None:
                raise ValueError("FolderPrefetcher needs a base folder or an explicit folder list")
            folders = multispectral_folders(base)
        self.folders = list(folders)
        self.names = names
        self.prefetch = max(prefetch, 1)

    def __len__(self) -> int:
        return len(self.folders)

    def __iter__(self) -> Iterator[tuple[Path, dict[str, np.ndarray]]]:
        if not self.folders:
            return
        with cf.ThreadPoolExecutor(max_workers=self.prefetch) as pool:
            pending = {}
            for folder in self.folders[: self.prefetch]:
                pending[folder] = pool.submit(load_detection_inputs, folder, self.names)
            for k, folder in enumerate(self.folders):
                nxt = k + self.prefetch
                if nxt < len(self.folders):
                    pending[self.folders[nxt]] = pool.submit(
                        load_detection_inputs, self.folders[nxt], self.names
                    )
                yield folder, pending.pop(folder).result()
