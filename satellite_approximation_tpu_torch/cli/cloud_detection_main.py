"""Cloud/shadow detection CLI: run the full pipeline on a date folder.

Mirror of executables/main-cloud-detection.cpp, generalized: the scene bbox
(for the geodetic diagonal) is read from the GeoTIFF geotransform instead of
the reference's hardcoded Alberta coordinates (main-cloud-detection.cpp:30-33),
with a --bbox override. Detection runs on ``--device`` (default: the CUDA
device).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..device import resolve_device
from ..models.detection.pipeline import (
    CloudParams,
    SkipShadowDetection,
    detect,
    get_diagonal_distance,
)
from ..utils.geotiff import GeoTIFF


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("folder", help="date folder with B08/CLP/CLD/SCL/angle rasters")
    parser.add_argument(
        "--bbox",
        nargs=4,
        type=float,
        metavar=("MIN_LONG", "MIN_LAT", "MAX_LONG", "MAX_LAT"),
        help="scene bbox override; default derives from the B08 geotransform",
    )
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--skip-shadows-above", type=float, default=None)
    parser.add_argument("--device", default=None, help="torch device; default: the CUDA device")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    params = CloudParams.from_root(Path(args.folder))
    if args.bbox:
        diag = get_diagonal_distance(*args.bbox)
    else:
        tiff = GeoTIFF.open(params.nir_path)
        diag = get_diagonal_distance(tiff.west(), tiff.south(), tiff.east(), tiff.north())

    skip = SkipShadowDetection()
    if args.skip_shadows_above is not None:
        skip = SkipShadowDetection(True, args.skip_shadows_above)

    status = detect(params, diag, skip, use_cache=not args.no_cache, device=device)
    if status is None:
        print("cached: outputs already exist")
    else:
        print(
            f"clouds: {status.percent_clouds:.4f}"
            + (f", shadows: {status.percent_shadows:.4f}" if status.percent_shadows is not None else "")
            + f", invalid: {status.percent_invalid:.4f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
