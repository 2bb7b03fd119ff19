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


def as_tensor(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch refuses to share a read-only buffer
    t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()
