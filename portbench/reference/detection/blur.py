# Frozen copy of satellite_approximation_tpu_torch/ops/blur.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Separable Gaussian blur with the reference's exact kernel and boundary
(``satellite_approximation_tpu/ops/blur.py``).

Replacement for the OpenCL kernel in
lib/cloud_shadow_detection/source/GaussianBlur.cpp:26-110:

* kernel radius R = int(2*sigma); taps w[i] = exp(-i^2/(2 sigma^2)) / (sqrt(2 pi) sigma),
  normalized so w0 + 2*sum(w[1:]) == 1 (GaussianBlur.cpp:95-110);
* horizontal pass then vertical pass (GaussianBlur.cpp:133-160);
* boundary: index v reflects as ``-v`` below 0 (mirror about pixel center 0)
  and ``2*end - v - 1`` at/above ``end`` (symmetric including the edge pixel)
  — note the two sides use *different* reflection conventions
  (GaussianBlur.cpp:27-29); both are reproduced exactly via asymmetric padding.

A weighted sum of shifted slices, one tap at a time and each tap a separate
multiply and add: a fused multiply-add, a convolution or another summation
order would change the last bit, and the blurred rasters are thresholded
into masks.
"""

from __future__ import annotations

import numpy as np
import torch


def strip_kernel(sigma: float) -> np.ndarray:
    """1-D half-kernel [w0, w1, ..., wR], matching GaussianBlur.cpp:95-110."""
    size = int(2.0 * sigma) + 1
    k = np.zeros(size, dtype=np.float32)
    norm = np.float32(1.0) / (np.sqrt(np.float32(2.0) * np.float32(np.pi)) * np.float32(sigma))
    rcoeff = np.float32(1.0) / (np.float32(2.0) * np.float32(sigma) * np.float32(sigma))
    total = np.float32(0.0)
    for i in range(size):
        v = norm * np.exp(np.float32(-i * i) * rcoeff, dtype=np.float32)
        k[i] = v if sigma > 1e-6 else np.float32(i == 0)
        total += np.float32(2.0) * k[i] if i > 0 else k[i]
    k *= np.float32(1.0) / total
    return k


def _take(x, axis: int, start: int, stop: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop)
    return x[tuple(idx)]


def _pad_reflect_asym(xp, x, radius: int, axis: int):
    """Pad: leading side mirrors about pixel 0 excluding the edge (``-v``),
    trailing side symmetric including the edge (``2*end-v-1``).
    ``xp`` is the array namespace (numpy or torch) — the host and device
    blurs share this code so their boundary handling and summation order can
    never drift apart."""
    n = x.shape[axis]
    lead = xp.flip(_take(x, axis, 1, radius + 1), (axis,))
    trail = xp.flip(_take(x, axis, n - radius, n), (axis,))
    return xp.concatenate([lead, x, trail], axis)


def _blur_axis(x, kernel: np.ndarray, axis: int, xp=torch):
    radius = len(kernel) - 1
    if radius == 0:
        return x * float(kernel[0])
    n = x.shape[axis]
    padded = _pad_reflect_asym(xp, x, radius, axis)

    def take(offset):
        return _take(padded, axis, radius + offset, radius + offset + n)

    # out = w0*x + sum_i w_i*(x[+i] + x[-i]) — mirrors the OpenCL loop
    # (GaussianBlur.cpp:43-50) including its summation order.
    out = float(kernel[0]) * take(0)
    for i in range(1, radius + 1):
        out = out + float(kernel[i]) * (take(i) + take(-i))
    return out


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a (..., H, W) float tensor.

    Matches GaussianBlur::GaussianBlurFilter (GaussianBlur.cpp:113-160):
    horizontal (last axis) pass feeding the vertical (-2 axis) pass.
    """
    kernel = strip_kernel(float(sigma))
    x = image.to(torch.float32)
    x = _blur_axis(x, kernel, axis=x.ndim - 1)
    x = _blur_axis(x, kernel, axis=x.ndim - 2)
    return x
