"""Solver configuration of the port (``SolverConfig`` of
``satellite_approximation_tpu/config.py``; the detection configs come with
the detection slice)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Masked Laplace/Poisson solver settings.

    The reference uses Eigen CG with tol=1e-6 and max_iters = n/2 for Poisson
    and Eigen's defaults (machine eps) for Laplace. Here the matrix-free CG
    runs in f32 inside a double-float refinement loop.
    """

    tolerance: float = 1e-6
    max_iterations: int | None = None
    refinement_steps: int = 2
    use_multigrid: bool = True
    mg_threshold_pixels: int = 256 * 256  # below this plain CG wins
    # "auto": the device path when the f64 inputs are exactly f32-representable
    # (every u8/u16-derived raster); "force": always, rounding inputs to f32;
    # "never": host-assembled f64 right-hand side.
    device_assembly: str = "auto"
    # Multi-device routing. The port runs one device: None, "off", or "auto"
    # with one device visible. Sharded fills are slice D of the port.
    mesh: object = "auto"


DEFAULT_SOLVER = SolverConfig()


def check_single_device(mesh, device: torch.device) -> None:
    """Raise ``NotImplementedError`` for a ``mesh`` setting that asks for
    more than one device; the sharded fill is not ported yet (slice D)."""
    if mesh is None or mesh == "off":
        return
    if mesh == "auto" and (device.type != "cuda" or torch.cuda.device_count() <= 1):
        return
    raise NotImplementedError(
        f"SolverConfig.mesh={mesh!r} asks for a multi-device fill, which is slice D of the "
        "PyTorch port (torch.distributed) and not ported yet; use mesh='off'"
    )
