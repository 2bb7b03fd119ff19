"""The port's four stencil kernels (ops/stencil_kernels.py): each plain
PyTorch version held against its JAX XLA counterpart on the CPU, and the
wrappers' operand checks. The CUDA kernels themselves are tested on the card
by tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_approximation_tpu.models import fill as JF
from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models.cg import masked_laplacian as j_masked_laplacian
from satellite_approximation_tpu.models.cg import neighbor_degree, shift_sum as j_shift_sum
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import assert_bitwise, assert_within_ulps, np32, random_mask

SHAPES = [(2, 96, 128), (3, 130, 97)]
PRE = JM._smoother_omegas(JM._PRE_SMOOTH)
POST = tuple(reversed(JM._smoother_omegas(JM._POST_SMOOTH)))
# Smoother outputs: XLA's CPU fusion may round the sweep arithmetic (and the
# f32 reciprocal 1/deg) differently from one-op-at-a-time torch, and the
# error is carried through K sweeps; O(1) inputs keep it below this.
SMOOTH_ATOL = 5e-6


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    b = rng.random((c, h, w)).astype(np.float32)
    u = rng.random((c, h, w)).astype(np.float32)
    e_c = rng.standard_normal((c, (h + 1) // 2, (w + 1) // 2)).astype(np.float32)
    um = random_mask(h, w, seed)
    return b, u, e_c, um, neighbor_degree((h, w))


def _invm(um, dg, dtype=torch.float32):
    return K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(dg)).to(dtype)


class TestJacobiZeroPlain:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_jax_smooth_residual(self, shape):
        b, _, _, um, dg = _problem(shape, 0)
        want_u, want_r = JM._smooth_residual(
            jnp.zeros(shape, jnp.float32), jnp.asarray(b), jnp.asarray(um),
            jnp.asarray(dg), PRE, u_is_zero=True,
        )
        got_u, got_r = K.jacobi_zero_plain(torch.from_numpy(b), _invm(um, dg), PRE, True)
        np.testing.assert_allclose(np32(got_u), np32(want_u), rtol=0, atol=SMOOTH_ATOL)
        assert_within_ulps(got_r, want_r)

    def test_without_residual_matches_jax_smooth(self):
        shape = SHAPES[1]
        b, _, _, um, dg = _problem(shape, 1)
        want = JM._smooth(
            jnp.zeros(shape, jnp.float32), jnp.asarray(b), jnp.asarray(um),
            jnp.asarray(dg), PRE, u_is_zero=True,
        )
        got = K.jacobi_zero(torch.from_numpy(b), _invm(um, dg), PRE, emit_residual=False)
        np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=SMOOTH_ATOL)

    def test_wrapper_on_cpu_is_the_plain_version(self):
        b, _, _, um, dg = _problem(SHAPES[0], 2)
        bt, inv = torch.from_numpy(b), _invm(um, dg)
        before = dict(K.launch_counts)
        got = K.jacobi_zero(bt, inv, PRE, emit_residual=True)
        want = K.jacobi_zero_plain(bt, inv, PRE, True)
        for g, w in zip(got, want):
            assert_bitwise(g, w)
        assert K.launch_counts == before  # CPU tensors launch no kernel


class TestJacobiCorrPlain:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("emit", [False, True])
    def test_matches_jax_prolong_add_post_smooth(self, shape, emit):
        b, u, e_c, um, dg = _problem(shape, 3)
        jb, jum, jdg = jnp.asarray(b), jnp.asarray(um), jnp.asarray(dg)
        u1 = jnp.asarray(u) + JM._prolong(jnp.asarray(e_c), shape) * jum.astype(jnp.float32)
        got = K.jacobi_corr_plain(
            torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg), torch.from_numpy(e_c),
            POST, emit,
        )
        if emit:
            want_u, want_r = JM._smooth_residual(u1, jb, jum, jdg, POST)
            np.testing.assert_allclose(np32(got[0]), np32(want_u), rtol=0, atol=SMOOTH_ATOL)
            assert_within_ulps(got[1], want_r)
        else:
            want_u = JM._smooth(u1, jb, jum, jdg, POST)
            np.testing.assert_allclose(np32(got), np32(want_u), rtol=0, atol=SMOOTH_ATOL)


class TestJacobiBf16Plain:
    """bf16 storage, f32 arithmetic: the kernels' contract. Oracle: the JAX
    sweep loop in f32 with the bf16-stored invm as the Jacobi weight and
    the rounded degree (tests/test_pallas.py::TestBf16Degree), rounded to
    bf16 once at the end. One-op-at-a-time rounding can differ from the
    fused oracle by an f32 ulp, which can move a bf16 rounding by one bf16
    ulp."""

    @staticmethod
    def _oracle(u0, b16, invm16, omegas, emit):
        inv0 = jnp.asarray(np32(invm16))
        unknown = inv0 > 0
        dgf = jnp.where(unknown, jnp.round(1.0 / jnp.where(unknown, inv0, 1.0)), 1.0)
        bf = jnp.asarray(np32(b16))

        def nsum(uf):
            p = jnp.pad(jnp.where(unknown, uf, 0.0), ((0, 0), (1, 1), (1, 1)))
            return ((p[:, :-2, 1:-1] + p[:, 2:, 1:-1]) + p[:, 1:-1, :-2]) + p[:, 1:-1, 2:]

        uf = u0
        for om in omegas:
            au = dgf * uf - nsum(uf)
            uf = jnp.where(unknown, uf + (om * (bf - au)) * inv0, uf)
        out = [np.asarray(uf.astype(jnp.bfloat16).astype(jnp.float32))]
        if emit:
            r = jnp.where(unknown, bf - (dgf * uf - nsum(uf)), 0.0)
            out.append(np.asarray(r.astype(jnp.bfloat16).astype(jnp.float32)))
        return out

    @staticmethod
    def _close(got, want):
        got = np32(got)
        np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=2.0**-8 * np.abs(want).max())

    def test_zero_start(self):
        b, _, _, um, dg = _problem(SHAPES[1], 4)
        b16 = torch.from_numpy(b).to(torch.bfloat16)
        inv16 = _invm(um, dg, torch.bfloat16)
        got = K.jacobi_zero_plain(b16, inv16, PRE, True)
        assert got[0].dtype == got[1].dtype == torch.bfloat16
        inv0 = jnp.asarray(np32(inv16))
        u0 = jnp.where(inv0 > 0, (PRE[0] * jnp.asarray(np32(b16))) * inv0, 0.0)
        for g, w in zip(got, self._oracle(u0, b16, inv16, PRE[1:], True)):
            self._close(g, w)

    def test_corr(self):
        b, u, e_c, um, dg = _problem(SHAPES[0], 5)
        bf16 = torch.bfloat16
        u16, b16, e16 = (torch.from_numpy(x).to(bf16) for x in (u, b, e_c))
        inv16 = _invm(um, dg, bf16)
        got = K.jacobi_corr_plain(u16, b16, inv16, e16, POST, True)
        inv0 = jnp.asarray(np32(inv16))
        corr = JM._prolong(jnp.asarray(np32(e16)), u.shape)
        u0 = jnp.asarray(np32(u16)) + jnp.where(inv0 > 0, corr, 0.0)
        for g, w in zip(got, self._oracle(u0, b16, inv16, POST, True)):
            self._close(g, w)


def _jax_cascade_residual(img, x_hi, x_lo, um, dg):
    """fill._fused_refine_solve's laplace-mode residual (the XLA cascade)."""
    umf = um.astype(jnp.float32)
    k = (4.0 - dg.astype(jnp.float32)) * umf
    y_hi = img * (1.0 - umf) + x_hi
    s, c = JF._cascade(list(JF._shift_taps(y_hi)) + [-4.0 * x_hi, k * x_hi])
    l1, l2, l3, l4 = JF._shift_taps(x_lo)
    lo = l1 + l2 + l3 + l4 - 4.0 * x_lo + k * x_lo
    return (s + (c + lo)) * umf


class TestResidualPlain:
    @staticmethod
    def _problem(shape, seed):
        rng = np.random.default_rng(seed)
        c, h, w = shape
        img = (rng.random((c, h, w)) * 10000).astype(np.float32)
        um = random_mask(h, w, seed, p=0.45)
        return img, um, neighbor_degree((h, w))

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    def test_entry_matches_jax_cascade(self, shape, invm_dtype):
        img, um, dg = self._problem(shape, 11)
        jimg, jum, jdg = jnp.asarray(img), jnp.asarray(um), jnp.asarray(dg)
        umf = jum.astype(jnp.float32)
        x_hi = jimg * umf
        want_r = _jax_cascade_residual(jimg, x_hi, jnp.zeros_like(x_hi), jum, jdg)
        want_b = j_shift_sum(jimg * (1.0 - umf)) * umf
        got_r, got_b = K.residual_entry(torch.from_numpy(img), _invm(um, dg, invm_dtype))
        assert_within_ulps(got_r, want_r)
        assert_within_ulps(got_b, want_b)

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    def test_pair_matches_jax_cascade(self, shape, invm_dtype):
        img, um, dg = self._problem(shape, 12)
        rng = np.random.default_rng(13)
        x_hi = (rng.random(shape) * 9000).astype(np.float32) * um
        x_lo = (rng.standard_normal(shape) * 1e-4).astype(np.float32) * um
        want = _jax_cascade_residual(
            jnp.asarray(img), jnp.asarray(x_hi), jnp.asarray(x_lo), jnp.asarray(um),
            jnp.asarray(dg),
        )
        got = K.residual_pair(
            torch.from_numpy(img), torch.from_numpy(x_hi), torch.from_numpy(x_lo),
            _invm(um, dg, invm_dtype),
        )
        assert_within_ulps(got, want)

    def test_entry_residual_is_the_true_residual(self):
        """Against an f64 evaluation: the cascade recovers b - A x to ~2^-48."""
        img, um, dg = self._problem((1, 64, 80), 14)
        r, b = K.residual_entry(torch.from_numpy(img), _invm(um, dg))
        x = img.astype(np.float64) * um
        known = img.astype(np.float64) * (~um)
        ax = np.asarray(j_masked_laplacian(jnp.asarray(x), jnp.asarray(um), jnp.asarray(dg)))
        b64 = np.asarray(j_shift_sum(jnp.asarray(known))) * um
        want = (b64 - ax) * um
        np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=2e-3)
        # b is a plain f32 sum of four known values: three roundings
        np.testing.assert_allclose(b.numpy(), b64, rtol=3 * 2.0**-24)


class TestWrapperChecks:
    """The wrappers refuse what the kernels do not take, before any device
    dispatch — so these run on CPU tensors."""

    def test_wrong_dtype_raises(self):
        b = torch.zeros(1, 8, 8, dtype=torch.float64)
        with pytest.raises(TypeError):
            K.jacobi_zero(b, torch.zeros(8, 8, dtype=torch.float64), PRE)
        with pytest.raises(TypeError):
            K.residual_entry(torch.zeros(1, 8, 8, dtype=torch.float16), torch.zeros(8, 8))

    def test_mixed_storage_dtypes_raise(self):
        with pytest.raises(TypeError):
            K.jacobi_zero(torch.zeros(1, 8, 8), torch.zeros(8, 8, dtype=torch.bfloat16), PRE)

    def test_wrong_shape_raises(self):
        u = torch.zeros(2, 8, 8)
        with pytest.raises(ValueError):
            K.jacobi_corr(u, u, torch.zeros(8, 8), torch.zeros(2, 3, 4), POST)
        with pytest.raises(ValueError):
            K.jacobi_zero(torch.zeros(8, 8), torch.zeros(8, 8), PRE)
        with pytest.raises(ValueError):
            K.residual_pair(u, u, torch.zeros(2, 8, 7), torch.zeros(8, 8))

    def test_too_many_sweeps_for_the_halo_raise(self):
        u = torch.zeros(1, 8, 8)
        with pytest.raises(ValueError):
            K.jacobi_corr(u, u, torch.zeros(8, 8), torch.zeros(1, 4, 4), (0.8,) * 8, True)
        with pytest.raises(ValueError):
            K.jacobi_zero(u, torch.zeros(8, 8), (0.8,) * 9, False)


def test_jax_is_on_cpu():
    """The oracle side of every parity test here is the XLA route."""
    assert jax.default_backend() == "cpu"
