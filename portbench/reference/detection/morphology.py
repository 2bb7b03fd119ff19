# Frozen copy of satellite_approximation_tpu_torch/ops/morphology.py, the plain
# reference of the benchmark's detect cells: imports rewired to this
# package; only the plain host routes kept (no native C++ library,
# no device-stage route).
"""Binary morphology: dilate/erode/close with elliptical structuring
elements, plus OpenCV-compatible Gaussian smoothing
(``satellite_approximation_tpu/ops/morphology.py``).

Replaces the OpenCV calls in the reference's cloud-mask cleanup
(lib/cloud_shadow_detection/source/CloudMask.cpp:42-58): dilate with an
ellipse of radius 15, morphological close with radius 5, then an 11x11
Gaussian blur. Binary dilation/erosion count the set pixels under the
structuring element in integers, which is exact in any order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .blur import _take


def _cv_round(x: np.ndarray | float):
    """OpenCV cvRound: round half to even (banker's rounding)."""
    return np.rint(x).astype(np.int64)


def ellipse_kernel(radius: int) -> np.ndarray:
    """OpenCV ``getStructuringElement(MORPH_ELLIPSE, (2r+1, 2r+1))`` replica.

    Follows OpenCV's row-wise chord computation, including its
    round-half-to-even ``saturate_cast<int>`` — validated bit-exact against
    cv2 in tests. Used by the reference at CloudMask.cpp:47-53.
    """
    ksize = 2 * radius + 1
    r = c = radius
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    elem = np.zeros((ksize, ksize), dtype=np.uint8)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(_cv_round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, ksize)
            elem[i, j1:j2] = 1
    return elem


def _kernel_chords(kernel: np.ndarray) -> list[tuple[int, int, int]] | None:
    """(dy, j1, j2) per kernel row when every row's set pixels form one
    contiguous chord (true for OpenCV ellipses); None otherwise."""
    kh, kw = kernel.shape
    r_y, r_x = kh // 2, kw // 2
    chords = []
    for i in range(kh):
        cols = np.nonzero(kernel[i])[0]
        if cols.size == 0:
            continue
        j1, j2 = int(cols[0]), int(cols[-1])
        if not np.all(kernel[i, j1 : j2 + 1]):
            return None
        chords.append((i - r_y, j1 - r_x, j2 - r_x))
    return chords


def _count_conv(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """SAME-padded 0/1 convolution counting set pixels under the kernel;
    (..., H, W) bool in, int32 counts out.

    Chord-decomposed: one int32 row-cumsum, then two shifted slices per
    kernel row (the chord sum is a prefix-sum difference) — ~2*kh adds
    instead of a kh*kw-tap convolution. Kernels whose rows are not single
    chords (none in practice) go through ``F.conv2d`` in f32 with TF32 off,
    exact as long as the kernel holds fewer than 2^24 pixels."""
    chords = _kernel_chords(kernel)
    kh, kw = kernel.shape
    r_y, r_x = kh // 2, kw // 2
    if chords is None:
        x = mask.to(torch.float32).reshape(-1, 1, *mask.shape[-2:])
        k = torch.as_tensor(kernel, dtype=torch.float32, device=mask.device)[None, None]
        with torch.backends.cudnn.flags(allow_tf32=False):
            out = F.conv2d(x, k, padding=(r_y, r_x))
        return out.reshape(mask.shape).to(torch.int32)

    h, w = mask.shape[-2], mask.shape[-1]
    # rows pad r_y each side; cols pad r_x+1 left (room for the j1-1 prefix
    # index of a full-width chord) and r_x right — all zeros (SAME border)
    xp = F.pad(mask.to(torch.int32), (r_x + 1, r_x, r_y, r_y))
    c = torch.cumsum(xp, dim=-1, dtype=torch.int32)
    out = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for dy, j1, j2 in chords:
        cr = _take(c, c.ndim - 2, r_y + dy, r_y + dy + h)
        hi = _take(cr, c.ndim - 1, r_x + 1 + j2, r_x + 1 + j2 + w)
        lo = _take(cr, c.ndim - 1, r_x + j1, r_x + j1 + w)  # index (j1-1)+1 in padded space
        out += hi - lo
    return out


def dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation by an elliptical SE. Out-of-image treated as background
    (OpenCV constant-border default for dilate)."""
    return _count_conv(mask, ellipse_kernel(radius)) > 0


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion by an elliptical SE; out-of-image treated as foreground
    (OpenCV constant-border default for erode). erode(m) == ~dilate(~m)."""
    return ~(_count_conv(~mask, ellipse_kernel(radius)) > 0)


def close(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Morphological close = erode(dilate(mask)) (cv::MORPH_CLOSE)."""
    return erode(dilate(mask, radius), radius)


def cv_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV ``getGaussianKernel``: when sigma<=0 it derives
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8 (e.g. ksize=11 -> sigma=2.0)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


def cv_gaussian_blur(image: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur matching cv::GaussianBlur's kernel and its
    default BORDER_REFLECT_101 boundary (numpy 'reflect'). Used by the
    reference's cloud-mask edge cleanup (CloudMask.cpp:56-58). One tap at a
    time, each a separate multiply and add in f32."""
    kernel = cv_gaussian_kernel(ksize, sigma).astype(np.float32)
    radius = ksize // 2
    x = image.to(torch.float32)

    def blur_axis(a, axis):
        n = a.shape[axis]
        lead = torch.flip(_take(a, axis, 1, radius + 1), (axis,))
        trail = torch.flip(_take(a, axis, n - radius - 1, n - 1), (axis,))
        p = torch.cat([lead, a, trail], axis)
        out = torch.zeros_like(a)
        for i in range(ksize):
            out = out + float(kernel[i]) * _take(p, axis, i, i + n)
        return out

    x = blur_axis(x, x.ndim - 1)
    x = blur_axis(x, x.ndim - 2)
    return x
