"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same numpy inputs, made from a seed, go through the JAX package (on the
CPU, where its Pallas kernels are replaced by their XLA routes) and through
the port (on the CPU, where each CUDA kernel is replaced by its plain PyTorch
version). Kernel tests that need the card use the ``cuda_device`` fixture
and the ``gpu`` marker: they run only with ``SAT_GPU_TESTS=1`` on a CUDA
host.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

# the suite runs with several workers; keep each worker's intra-op pool small
torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the kernels run only on the card."""
    if os.environ.get("SAT_GPU_TESTS") != "1":
        pytest.skip("CUDA kernel test: set SAT_GPU_TESTS=1 on a host with an H100")
    if not torch.cuda.is_available():
        pytest.skip("SAT_GPU_TESTS=1 but no CUDA device is available")
    return torch.device("cuda")


def make_mask(h, w, seed=3, n=40, margin=40, div=24):
    """Synthetic cloud field, a union of ellipses — bench.py's ``make_mask``
    with its margin and radius divisor as parameters, so that small grids
    can take it (bench.py's defaults give ~8-12% coverage at 2048^2)."""
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), dtype=bool)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(n):
        cy, cx = r.integers(margin, h - margin), r.integers(margin, w - margin)
        ry, rx = r.integers(2, max(h // div, 3)), r.integers(2, max(w // div, 3))
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    return m


def small_mask(h, w, seed=3):
    return make_mask(h, w, seed=seed, n=10, margin=4, div=6)


def smooth(h, w, seed):
    """bench.py's ``smooth``: a random field under four 4-neighbour means."""
    r = np.random.default_rng(seed)
    x = r.random((h, w), dtype=np.float32)
    for _ in range(4):
        x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1) + np.roll(x, -1, 1))
    return x


def bench_system(h, w, bands, seed=3):
    """bench.py's system at (bands, h, w): (imgs, umask, deg, b, x0)."""
    umask = small_mask(h, w, seed)
    deg = np.full((h, w), 4.0, dtype=np.float32)
    deg[0, :] -= 1
    deg[-1, :] -= 1
    deg[:, 0] -= 1
    deg[:, -1] -= 1
    imgs = np.stack([smooth(h, w, s) for s in range(bands)])
    known = imgs * (~umask)
    p = np.pad(known, ((0, 0), (1, 1), (1, 1)))
    b = (
        p[:, 0:h, 1 : w + 1] + p[:, 2 : h + 2, 1 : w + 1]
        + p[:, 1 : h + 1, 0:w] + p[:, 1 : h + 1, 2 : w + 2]
    ) * umask
    return imgs, umask, deg, b, imgs * umask


def random_mask(h, w, seed, p=0.4):
    """A mask with many degree-1/2/3 boundary cells."""
    return np.random.default_rng(seed).random((h, w)) > p


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def assert_within_ulps(got, want, ulps: int = 2) -> None:
    """max |got - want| <= ``ulps`` f32 ulps of max |want| (the scale of a
    cascade residual's rounding)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    bound = ulps * np.spacing(np.float32(np.max(np.abs(want))))
    diff = float(np.max(np.abs(got - want)))
    assert diff <= bound, f"max diff {diff} > {ulps} ulp of max|want| ({bound})"


def assert_bitwise(got, want) -> None:
    """Equal bit for bit, the sign of zero included."""
    g, w = got.detach().cpu(), want.detach().cpu()
    assert g.dtype == w.dtype and g.shape == w.shape
    view = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(g.contiguous().view(view), w.contiguous().view(view)), (
        f"max |diff| {float((g.float() - w.float()).abs().max())}"
    )
