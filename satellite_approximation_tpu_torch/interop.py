"""State carried across from the JAX package.

Detection has no weights either: what crosses between the packages are
configurations and the objects one stage hands the next. The converters
below build the port's objects from plain forms (the ``dataclasses.asdict``
of the JAX package's objects: nested dicts of numbers and numpy arrays), so
a test can run one stage in one package and the next stage in the other.
This module imports nothing of the JAX package; the caller does the
``asdict``.

The fill has no weights; its state is the multigrid hierarchy of a mask: the
(umask, deg) pair of every level plus the dense inverse of the coarsest
operator. :func:`hierarchy_from_numpy` turns that state, fetched from the JAX
package as numpy arrays, into the port's :class:`Hierarchy`, so both packages
can run a V-cycle or a PCG solve on the same state.
"""

from __future__ import annotations

import numpy as np

from .config import (
    CloudMaskConfig,
    DetectionConfig,
    MatchingConfig,
    RefinementConfig,
    ShadowMaskConfig,
)
from .device import as_tensor, resolve_device
from .models.detection.cloud_mask import CloudObject
from .models.detection.matching import OptimalSolution, ShadowObject
from .models.multigrid import Hierarchy
from .ops.components import Region
from .ops.geometry import Quad


def hierarchy_from_numpy(levels, coarse_inv, device=None) -> Hierarchy:
    """``levels``: sequence of (umask, deg) array pairs, finest first;
    ``coarse_inv``: the coarsest operator's dense inverse or None. Masks
    become bool, degrees and the inverse f32, all on ``device``."""
    dev = resolve_device(device)
    lv = tuple(
        (as_tensor(np.asarray(m, bool), dev), as_tensor(np.asarray(d, np.float32), dev))
        for m, d in levels
    )
    ci = None if coarse_inv is None else as_tensor(np.asarray(coarse_inv, np.float32), dev)
    return Hierarchy(lv, ci)


def _backend(value: str) -> str:
    return "torch" if value == "jax" else value


def detection_config_from_dict(d: dict) -> DetectionConfig:
    """A ``DetectionConfig`` from the ``asdict`` of the JAX package's: the
    backend value "jax" becomes "torch", ``jax_height_chunk`` becomes
    ``height_chunk``."""
    matching = dict(d["matching"])
    matching["backend"] = _backend(matching["backend"])
    if "jax_height_chunk" in matching:
        matching["height_chunk"] = matching.pop("jax_height_chunk")
    refinement = dict(d["refinement"])
    refinement["backend"] = _backend(refinement["backend"])
    for key in ("histogram_divisions", "histogram_weights"):
        refinement[key] = tuple(refinement[key])
    top = {k: v for k, v in d.items()
           if k not in ("cloud_mask", "shadow_mask", "matching", "refinement")}
    return DetectionConfig(
        cloud_mask=CloudMaskConfig(**d["cloud_mask"]),
        shadow_mask=ShadowMaskConfig(**d["shadow_mask"]),
        matching=MatchingConfig(**matching),
        refinement=RefinementConfig(**refinement),
        **top,
    )


def region_from_dict(d: dict) -> Region:
    return Region(**{k: int(v) for k, v in d.items()})


def cloud_object_from_dict(d: dict) -> CloudObject:
    """A ``CloudObject`` from its plain form: ``region`` and ``quad`` nested
    dicts, the quad's corners arrays of 3."""
    quad = Quad(**{k: np.asarray(v, np.float64) for k, v in d["quad"].items()})
    bbox = {k: int(d[k]) for k in ("min_x", "max_x", "min_y", "max_y")}
    return CloudObject(id=int(d["id"]), region=region_from_dict(d["region"]), quad=quad, **bbox)


def solution_from_dict(d: dict) -> OptimalSolution:
    return OptimalSolution(height=float(d["height"]), similarity=float(d["similarity"]),
                           M=np.asarray(d["M"], np.float64), id=int(d["id"]))


def shadow_object_from_dict(d: dict) -> ShadowObject:
    """A ``ShadowObject`` from its plain form; a rejected shadow has
    ``None`` for bounds, window and anchor."""
    if d["window"] is None:
        return ShadowObject(id=int(d["id"]), bounds=None, area=0, window=None, anchor=None)
    return ShadowObject(
        id=int(d["id"]),
        bounds=tuple(int(v) for v in d["bounds"]),
        area=int(d["area"]),
        window=np.asarray(d["window"], bool),
        anchor=tuple(int(v) for v in d["anchor"]),
    )


__all__ = [
    "Hierarchy",
    "cloud_object_from_dict",
    "detection_config_from_dict",
    "hierarchy_from_numpy",
    "region_from_dict",
    "shadow_object_from_dict",
    "solution_from_dict",
]
