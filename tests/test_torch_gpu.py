"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and the fill on the card against the fill on the CPU.

These tests import neither jax nor the JAX package, so they run on a CUDA
host without JAX; there the repository's conftest (which imports jax) is
skipped:

    SAT_GPU_TESTS=1 PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_gpu.py

Without ``SAT_GPU_TESTS=1`` and a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from satellite_approximation_tpu_torch.models import fill
from satellite_approximation_tpu_torch.models import multigrid as mg
from satellite_approximation_tpu_torch.models.cg import neighbor_degree
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import (  # noqa: F401 — cuda_device is a fixture
    CPU,
    assert_bitwise,
    bench_system,
    cuda_device,
    random_mask,
)

PRE = mg._smoother_omegas(mg._PRE_SMOOTH)
POST = tuple(reversed(mg._smoother_omegas(mg._POST_SMOOTH)))
# partial tiles in both directions, a single exact tile, a thin strip
SHAPES = [(2, 137, 201), (1, 48, 48), (1, 30, 1000)]


def _cases(device, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    um = random_mask(h, w, seed)
    invm = K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(neighbor_degree((h, w))))
    b, u = (torch.from_numpy(rng.random(shape).astype(np.float32)) for _ in range(2))
    e_c = torch.from_numpy(rng.standard_normal((c, (h + 1) // 2, (w + 1) // 2)).astype(np.float32))
    return [t.to(device=device, dtype=dtype) for t in (b, u, e_c, invm)]


def _pairs(got, want):
    return zip(got, want) if isinstance(got, tuple) else [(got, want)]


@pytest.mark.gpu
class TestKernelsOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("emit", [False, True])
    def test_jacobi_kernels_bitwise(self, cuda_device, dtype, shape, emit):
        b, u, e_c, invm = _cases(cuda_device, dtype, shape, 21)
        for g, w in _pairs(K.jacobi_zero(b, invm, PRE, emit), K.jacobi_zero_plain(b, invm, PRE, emit)):
            assert_bitwise(g, w)
        got = K.jacobi_corr(u, b, invm, e_c, POST, emit)
        for g, w in _pairs(got, K.jacobi_corr_plain(u, b, invm, e_c, POST, emit)):
            assert_bitwise(g, w)

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_residual_kernels_bitwise(self, cuda_device, invm_dtype, shape):
        rng = np.random.default_rng(22)
        um = random_mask(*shape[1:], 22, p=0.45)
        invm = K.invm_for_kernel(
            torch.from_numpy(um), torch.from_numpy(neighbor_degree(shape[1:]))
        ).to(device=cuda_device, dtype=invm_dtype)
        m = torch.from_numpy(um).to(cuda_device)

        def t(x):
            return torch.from_numpy(x.astype(np.float32)).to(cuda_device)

        img = t(np.round(rng.random(shape) * 1e4))
        x_hi = t(rng.random(shape) * 9e3) * m
        x_lo = t(rng.standard_normal(shape) * 1e-4) * m
        for g, w in zip(K.residual_entry(img, invm), K.residual_entry_plain(img, invm)):
            assert_bitwise(g, w)
        assert_bitwise(
            K.residual_pair(img, x_hi, x_lo, invm), K.residual_pair_plain(img, x_hi, x_lo, invm)
        )

    def test_launches_are_counted_and_cpu_mix_raises(self, cuda_device):
        b, u, e_c, invm = _cases(cuda_device, torch.float32, (1, 64, 64), 23)
        K.reset_launch_counts()
        K.jacobi_zero(b, invm, PRE)
        K.jacobi_corr(u, b, invm, e_c, POST)
        assert K.launch_counts["jacobi_zero"] == 1 and K.launch_counts["jacobi_corr"] == 1
        with pytest.raises(ValueError):
            K.jacobi_zero(b, invm.cpu(), PRE)
        with pytest.raises(ValueError):
            K.jacobi_zero(b[:, :, :32], invm[:, :32], PRE)  # not contiguous


@pytest.mark.gpu
def test_fill_on_card_matches_cpu(cuda_device):
    """The whole fill on the card (kernels) against the CPU (plain
    versions): the same solution to the solve's own precision."""
    imgs, m, *_ = bench_system(160, 224, 2)
    kw = dict(tolerance=1e-9, refinement_steps=4, device_output=False)
    on_card = fill.laplace_fill(imgs, m, device=cuda_device, **kw)
    on_cpu = fill.laplace_fill(imgs, m, device=CPU, **kw)
    assert on_card.error <= 1e-9 and on_cpu.error <= 1e-9
    assert abs(on_card.iterations - on_cpu.iterations) <= 1
    np.testing.assert_allclose(on_card.x, on_cpu.x, rtol=0, atol=1e-6)
