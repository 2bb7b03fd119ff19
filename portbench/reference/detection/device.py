# Frozen copy of satellite_approximation_tpu_torch/device.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Device selection for the port's entry points.

Every public entry point takes ``device=``. ``None`` means the CUDA device;
without one it raises instead of quietly running on the CPU, so a run that
was meant for the card never reports CPU numbers. Pass ``device="cpu"`` to
run the plain PyTorch versions of the kernels on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def divide(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value`` as one correctly rounded IEEE division in ``t``'s dtype.
    With a Python number for a divisor, torch's CUDA kernel multiplies by
    the reciprocal instead, which differs from the division in the last bit
    for about one value in four; a 0-d tensor divisor takes the true
    division on every device."""
    return t / torch.full((), value, dtype=t.dtype, device=t.device)


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch refuses to share a read-only buffer
    t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()
