"""Satellite Poisson fill CLI: <input_tif> <replacement_tif>.

Mirror of executables/poisson-main.cpp: read bands 1-5 of both GeoTIFFs,
derive the cloud mask from band 6 (morphologically closed, radius 5), run
the mask-overload Poisson blend, write the result to
``poisson_simple_replace/`` next to the input. The closing and the blend run
on ``--device`` (default: the CUDA device).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..device import as_tensor, resolve_device
from ..models.poisson import blend_images_poisson
from ..ops.morphology import close
from ..utils.geotiff import GeoTIFF, write_geotiff


def preprocess_cloud_band(band: np.ndarray, device=None) -> np.ndarray:
    """Band 6 -> bool mask, closed with an ellipse of radius 5
    (poisson-main.cpp:10-21) on ``device``."""
    mask = as_tensor(np.asarray(band) != 0, resolve_device(device))
    return close(mask, 5).cpu().numpy()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input_tif")
    parser.add_argument("replacement_tif")
    parser.add_argument("--bands", type=int, default=5)
    parser.add_argument("--device", default=None, help="torch device; default: the CUDA device")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    input_path = Path(args.input_tif)
    tiff = GeoTIFF.open(input_path)
    bands = list(range(1, args.bands + 1))
    inputs = tiff.read_bands(bands).astype(np.float64)
    mask = preprocess_cloud_band(tiff.read(args.bands + 1), device)
    replacement = GeoTIFF.open(args.replacement_tif).read_bands(bands).astype(np.float64)

    result = blend_images_poisson(inputs, replacement, invalid_mask=mask, device=device)

    # One multi-band file, matching the reference's GeoTiffWriter output
    # (poisson-main.cpp:66-71 writes all 5 bands into a single GeoTIFF).
    out_dir = input_path.parent / "poisson_simple_replace"
    out_dir.mkdir(exist_ok=True)
    write_geotiff(
        np.asarray(result).astype(np.float32),
        out_dir / input_path.name,
        template_path=input_path,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
