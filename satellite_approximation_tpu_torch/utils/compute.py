"""Compute-environment introspection (``satellite_approximation_tpu/utils/compute.py``).

The reference's ComputeEnvironment creates a global OpenCL context/queue on
platform[0]/device[0] and can dump device info
(ComputeEnvironment.cpp:6-80). Under PyTorch there is nothing to initialize —
the CUDA context, streams and the allocator are created on first use — so
``init_main_context`` exists only for drop-in compatibility, and
``platform_and_device_info`` reports what torch sees.
"""

from __future__ import annotations

import torch


def init_main_context() -> None:
    """No-op: PyTorch owns device initialization (reference
    ComputeEnvironment::InitMainContext, automatic_detection.cpp:87)."""


def platform_and_device_info() -> str:
    """Human-readable device report (reference PlatformAndDeviceInfo,
    ComputeEnvironment.cpp:16-80): ``backend: cuda`` and each CUDA device's
    index, name, compute capability and total memory; on a host without
    CUDA, ``backend: cpu`` and the CPU as device 0. A report, not a compute
    path: it does not raise without a card."""
    if not torch.cuda.is_available():
        return "\n".join([
            "backend: cpu",
            "  device 0: cpu (platform=cpu)",
            "local device count: 1",
        ])
    count = torch.cuda.device_count()
    lines = ["backend: cuda"]
    for i in range(count):
        p = torch.cuda.get_device_properties(i)
        lines.append(
            f"  device {i}: {p.name} (platform=cuda, compute capability "
            f"{p.major}.{p.minor}, memory={p.total_memory / 2**30:.2f} GiB)"
        )
    lines.append(f"local device count: {count}")
    return "\n".join(lines)
