"""Laplace fill demo CLI: <base_image> <invalid_image> <output>.

Mirror of executables/laplace-main.cpp: the marker image's red/green
channels define the mask (red >= 220 AND green <= 150); every channel of
the base image is Laplace-filled, on ``--device`` (default: the CUDA
device).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from PIL import Image

from ..device import resolve_device
from ..models.laplace import apply_laplace
from ..utils.imageio import read_image_raw


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("base_image")
    parser.add_argument("invalid_image")
    parser.add_argument("output")
    parser.add_argument("--red-threshold", type=float, default=220.0)
    parser.add_argument("--device", default=None, help="torch device; default: the CUDA device")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    image = read_image_raw(args.base_image).astype(np.float64)
    marker = read_image_raw(args.invalid_image)
    out = apply_laplace(image, marker, red_threshold=args.red_threshold, device=device)
    Image.fromarray(np.clip(out, 0, 255).astype(np.uint8)).save(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
