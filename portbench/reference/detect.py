"""The plain reference of the ``detect`` entry: the four masks and the
Status numbers of one scene, from ``reference/detection/`` (every stage on
its plain host route, whatever the scene's size, and a matching scan of its
own; see its ``pipeline.py``). It imports nothing of the program under
test."""

from __future__ import annotations

import importlib


def detect(scene: dict, diagonal_km: float, device, lower=None) -> dict:
    """{"masks": {file stem: host bool array}, "status": [percent clouds,
    percent shadows, percent invalid]} of ``scene`` (host rasters keyed by
    file stem). ``lower``: the dtype the normalized rasters are rounded
    through, for the control."""
    pipeline = importlib.import_module("portbench.reference.detection.pipeline")
    got = pipeline.detect_masks(scene, diagonal_km, device, lower=lower)
    return {"masks": got["masks"],
            "status": [got["percent_clouds"], got["percent_shadows"], got["percent_invalid"]]}
