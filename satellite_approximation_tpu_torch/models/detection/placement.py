"""Where ``detect`` runs each stage, decided once a call by :func:`place`.

On the device route (``device_stages``) every stage from the cloud mask to
the final mask runs on the device, sharded over the mesh where there is
one. Off it the cloud mask is fetched from the device and the later stages
run on the host, but for a big scene: its shadow stage takes the native
priority flood where the library is, and otherwise stays on the device with
the refinement. :func:`big_scene` is the package's one size gate.
"""

from __future__ import annotations

import dataclasses

from ... import config as settings
from ... import native


def big_scene(pixels: int) -> bool:
    """A full-tile-class raster (the gate is read at each call)."""
    return pixels >= settings.BIG_SCENE_PIXELS


def native_matching(pixels: int, device, backend: str) -> bool:
    """The native scan (else the device sweep on ``device``) for
    ``MatchingConfig.backend``: "auto" takes it where the library is, but
    for a big scene on a CUDA device."""
    if backend in ("native", "torch"):
        return backend == "native"
    return native.available() and not (big_scene(pixels) and device.type == "cuda")


def matching_route(native_scan: bool, device, shards: int | None = None) -> str:
    """The matching's entry in ``StageTimer.routes``."""
    if native_scan:
        return "host, native scan"
    return f"device sweep ({device})" + (f", sharded over {shards} shards" if shards else "")


@dataclasses.dataclass(frozen=True)
class Placement:
    device_stages: bool  # cloud mask output, shadow stage, geometry, beta, refinement
    shadow_on_host: bool  # the shadow stage as the host-native priority flood
    refine_on_device: bool  # alpha, the probability surface and the final mask
    native_matching: bool  # the native scan, else the device sweep
    overlap_writes: bool  # the mask writes on workers, behind the device stages
    mesh: object  # what the device stages shard over, or None
    # the cloud partition runs where its mask lies: a host mask takes the
    # native flood where the library is
    partition_on_host: bool

    def routes(self, device) -> dict[str, str]:
        """The call's ``StageTimer.routes``."""
        on_dev = f"device ({device})"
        shards = None if self.mesh is None else self.mesh.size
        sharded = None if shards is None else f"device, sharded over {shards} shards"
        return {
            "cloud mask": on_dev,
            "cloud partition": "host, native flood" if self.partition_on_host else on_dev,
            "shadow stage": "host, native priority flood" if self.shadow_on_host else on_dev,
            "sun/view geometry": on_dev if self.device_stages else "host, chunked numpy",
            "beta map": sharded or (on_dev if self.device_stages else "host, numpy/scipy"),
            "matching": matching_route(self.native_matching, device, shards),
            "alpha, histograms, final sampling": sharded or (
                on_dev if self.refine_on_device else "host, numpy or native"),
        }


def place(pixels: int, device, config, mesh) -> Placement:
    """The placement of ``detect`` on ``pixels`` pixels on ``device`` under
    the ``DetectionConfig`` ``config`` and the resolved ``mesh`` (or None).
    ``RefinementConfig.backend`` "torch" takes the device route; "auto"
    takes it for a big scene on a CUDA device, and off it refines a big
    scene on the device where its shadow stage stayed there (a beta made on
    the host is then uploaded once)."""
    big = big_scene(pixels)
    lib = native.available()
    backend = config.refinement.backend
    device_stages = backend == "torch" or (backend == "auto" and big and device.type == "cuda")
    shadow_on_host = big and not device_stages and lib
    mesh = mesh if device_stages else None
    return Placement(
        device_stages=device_stages,
        shadow_on_host=shadow_on_host,
        refine_on_device=device_stages or (backend == "auto" and big and not shadow_on_host),
        native_matching=mesh is None and native_matching(pixels, device, config.matching.backend),
        overlap_writes=device_stages and big,
        mesh=mesh,
        partition_on_host=not device_stages and lib,
    )
