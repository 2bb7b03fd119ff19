"""Kernels 3, 6, 7 and 8 of the port (ops/stencil_kernels.py): the smoother
from a given iterate, the zero-start smoother with the half residual, the
smoother with separate mask and degree operands, and the stride-2 idioms.
Each plain PyTorch version is held against its JAX counterpart on the CPU
(the XLA route of multigrid._smooth/_smooth_residual, numpy slicing), and
the wrappers' operand checks. The CUDA kernels are tested on the card by
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models.cg import neighbor_degree
from satellite_approximation_tpu_torch import ops
from satellite_approximation_tpu_torch.models import multigrid as PM
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import assert_bitwise, np32, random_mask

PRE = JM._smoother_omegas(JM._PRE_SMOOTH)
# ragged against the 48-cell tile; an odd height; the size of the JAX
# package's own half-restrict test (tests/test_pallas.py::TestHalfRestrict)
SHAPES = [(2, 96, 128), (3, 97, 130), (2, 600, 760)]
# smoother outputs: XLA's CPU fusion may round the sweep arithmetic (and the
# f32 reciprocal 1/deg) differently from one-op-at-a-time torch, and the
# error is carried through K sweeps; O(1) inputs keep it below this
ATOL = 5e-6
OMEGAS = {"tuple": PRE, "scalar": (0.8,) * 6}


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    c, h, w = shape
    b = rng.random((c, h, w)).astype(np.float32)
    u = rng.random((c, h, w)).astype(np.float32)
    um = random_mask(h, w, seed)
    return b, u, um, neighbor_degree((h, w))


def _invm(um, dg, dtype=torch.float32):
    return K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(dg)).to(dtype)


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=ATOL)


class TestJacobiFromIterate:
    """Kernel 3: K sweeps from a given u."""

    @pytest.mark.parametrize("shape", SHAPES[:2])
    @pytest.mark.parametrize("kind", sorted(OMEGAS))
    def test_plain_matches_jax_smooth_and_smooth_residual(self, shape, kind):
        omegas = OMEGAS[kind]
        b, u, um, dg = _problem(shape, 31)
        ju, jb, jum, jdg = _jax(u, b, um, dg)
        ut, bt, inv = torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg)
        _close(K.jacobi_plain(ut, bt, inv, omegas, False), JM._smooth(ju, jb, jum, jdg, omegas))
        got = K.jacobi_plain(ut, bt, inv, omegas, True)
        want = JM._smooth_residual(ju, jb, jum, jdg, omegas)
        for g, w in zip(got, want):
            _close(g, w)

    @pytest.mark.parametrize("emit", [False, True])
    @pytest.mark.parametrize("kind", sorted(OMEGAS))
    def test_ops_fused_jacobi_matches_jax(self, emit, kind):
        """ops.fused_jacobi, the counterpart of ops.fused_jacobi_tpu: scalar
        omega or a K-tuple, umask and deg in, the kernel's invm built
        inside."""
        omegas = OMEGAS[kind]
        b, u, um, dg = _problem(SHAPES[1], 32)
        ju, jb, jum, jdg = _jax(u, b, um, dg)
        omega = omegas if kind == "tuple" else 0.8
        got = ops.fused_jacobi(
            torch.from_numpy(u), torch.from_numpy(b), torch.from_numpy(um), torch.from_numpy(dg),
            sweeps=len(omegas), omega=omega, emit_residual=emit,
        )
        smooth = JM._smooth_residual if emit else JM._smooth
        want = smooth(ju, jb, jum, jdg, omegas)
        for g, w in zip(*((got, want) if emit else ((got,), (want,)))):
            _close(g, w)

    def test_fused_jacobi_defaults_match_the_jax_signature(self):
        """sweeps=8, omega=0.8, no residual — as fused_jacobi_tpu."""
        b, u, um, dg = _problem((1, 40, 52), 33)
        ju, jb, jum, jdg = _jax(u, b, um, dg)
        got = ops.fused_jacobi(
            torch.from_numpy(u), torch.from_numpy(b), torch.from_numpy(um), torch.from_numpy(dg)
        )
        _close(got, JM._smooth(ju, jb, jum, jdg, (0.8,) * 8))
        with pytest.raises(ValueError):
            ops.fused_jacobi(torch.from_numpy(u), torch.from_numpy(b), torch.from_numpy(um),
                             torch.from_numpy(dg), sweeps=3, omega=(0.8, 0.8))

    def test_port_smooth_routes_match_jax(self):
        """multigrid._smooth/_smooth_residual, from zero and from a given u."""
        b, u, um, dg = _problem(SHAPES[0], 34)
        ju, jb, jum, jdg = _jax(u, b, um, dg)
        pu, pb_, pum, pdg = (torch.from_numpy(x) for x in (u, b, um, dg))
        for zero in (False, True):
            _close(PM._smooth(pu, pb_, pum, pdg, PRE, u_is_zero=zero),
                   JM._smooth(ju, jb, jum, jdg, PRE, u_is_zero=zero))
            got = PM._smooth_residual(pu, pb_, pum, pdg, PRE, u_is_zero=zero)
            want = JM._smooth_residual(ju, jb, jum, jdg, PRE, u_is_zero=zero)
            for g, w in zip(got, want):
                _close(g, w)

    def test_from_zero_equals_the_zero_start_kernel(self):
        """Kernel 3 at u = 0 equals kernel 1, up to the sign of zero."""
        b, _, um, dg = _problem(SHAPES[0], 35)
        bt, inv = torch.from_numpy(b), _invm(um, dg)
        got = K.jacobi(torch.zeros_like(bt), bt, inv, PRE, True)
        want = K.jacobi_zero(bt, inv, PRE, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_bf16_storage_rounds_once_at_the_store(self):
        """bf16 u, b, invm: the f32 sweeps on the widened operands, rounded
        to bf16 at the end."""
        b, u, um, dg = _problem(SHAPES[0], 36)
        u16, b16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (u, b))
        inv16 = _invm(um, dg, torch.bfloat16)
        got_u, got_r = K.jacobi(u16, b16, inv16, PRE, True)
        assert got_u.dtype == got_r.dtype == torch.bfloat16
        want_u, want_r = K.jacobi_plain(u16.float(), b16.float(), inv16.float(), PRE, True)
        assert_bitwise(got_u, want_u.to(torch.bfloat16))
        assert_bitwise(got_r, want_r.to(torch.bfloat16))


class TestHalfResidual:
    """Kernel 6: the zero-start smoother emitting r[2i] + r[2i + 1]."""

    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_jax_row_pass(self, shape):
        b, _, um, dg = _problem(shape, 41)
        _, jb, jum, jdg = _jax(b, b, um, dg)
        _, r = JM._smooth_residual(jnp.zeros_like(jb), jb, jum, jdg, PRE, u_is_zero=True)
        r = np.asarray(r)
        if r.shape[-2] % 2:
            r = np.pad(r, ((0, 0), (0, 1), (0, 0)))
        want = r[:, 0::2, :] + r[:, 1::2, :]
        u, half = K.jacobi_zero_plain(torch.from_numpy(b), _invm(um, dg), PRE, "half")
        assert half.shape == (shape[0], (shape[1] + 1) // 2, shape[2])
        _close(half, want)
        assert u.shape == shape

    @pytest.mark.parametrize("shape", SHAPES[:2])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bit_equal_to_the_row_pass_of_the_full_residual(self, shape, dtype):
        b, _, um, dg = _problem(shape, 42)
        bt, inv = torch.from_numpy(b).to(dtype), _invm(um, dg, dtype)
        u_full, r_full = K.jacobi_zero(bt, inv, PRE, True)
        u_half, half = K.jacobi_zero(bt, inv, PRE, "half")
        assert_bitwise(u_half, u_full)
        assert_bitwise(half, K.restrict_rows(r_full))
        # and the restrict of the half residual is the V-cycle's restrict
        assert_bitwise(PM._restrict_cols(half), PM._restrict(r_full))

    def test_half_is_the_only_string_mode(self):
        b, _, um, dg = _problem((1, 16, 16), 43)
        with pytest.raises(ValueError):
            K.jacobi_zero(torch.from_numpy(b), _invm(um, dg), PRE, "rows")


class TestJacobiV2:
    """Kernel 7: separate mask and degree operands, masking by multiplies."""

    @pytest.mark.parametrize("shape", SHAPES[:2])
    @pytest.mark.parametrize("emit", [False, True])
    def test_plain_matches_jax_smooth(self, shape, emit):
        b, u, um, dg = _problem(shape, 51)
        ju, jb, jum, jdg = _jax(u, b, um, dg)
        got = K.jacobi_v2_plain(
            torch.from_numpy(u), torch.from_numpy(b), torch.from_numpy(um), torch.from_numpy(dg),
            6, 0.8, emit,
        )
        smooth = JM._smooth_residual if emit else JM._smooth
        want = smooth(ju, jb, jum, jdg, (0.8,) * 6)
        for g, w in zip(*((got, want) if emit else ((got,), (want,)))):
            _close(g, w)

    def test_equals_kernel_3_with_omega_repeated(self):
        """As benchmarks/x_kernel_v2.py holds the two kernels: the same
        values; zeros of the residual on known cells may differ in sign
        (multiplies against selects)."""
        b, u, um, dg = _problem(SHAPES[1], 52)
        ut, bt, umt, dgt = (torch.from_numpy(x) for x in (u, b, um, dg))
        got = K.jacobi_v2(ut, bt, umt, dgt, 6, 0.8, True)
        want = K.jacobi(ut, bt, _invm(um, dg), (0.8,) * 6, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_bf16_storage_and_deg_in_storage_dtype(self):
        b, u, um, dg = _problem(SHAPES[0], 53)
        u16, b16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (u, b))
        d16 = torch.from_numpy(dg).to(torch.bfloat16)
        got = K.jacobi_v2(u16, b16, torch.from_numpy(um), d16, 5, 0.7, True)
        want = K.jacobi_v2_plain(u16.float(), b16.float(), torch.from_numpy(um), d16.float(),
                                 5, 0.7, True)
        for g, w in zip(got, want):
            assert_bitwise(g, w.to(torch.bfloat16))

    def test_operand_checks(self):
        u = torch.zeros(1, 8, 8)
        m, d = torch.ones(8, 8, dtype=torch.bool), torch.full((8, 8), 4.0)
        with pytest.raises(ValueError):
            K.jacobi_v2(u, u, m, d, 8, 0.8, True)  # 8 sweeps + residual ring > 8
        with pytest.raises(TypeError):
            K.jacobi_v2(u, u, m.float(), d, 2, 0.8)  # the mask is bool
        with pytest.raises(ValueError):
            K.jacobi_v2(u, u, m[:4], d, 2, 0.8)


class TestStride2:
    """Kernel 8: the probe's idioms A-E (benchmarks/x_stride_probe.py)."""

    def test_probe_checks(self):
        """The probe's own input and checks: (128, 512) f32 from seed 0."""
        x = np.random.default_rng(0).random((128, 512), np.float32)
        xt = torch.from_numpy(x)
        assert np.array_equal(K.stride2(xt, "rows").numpy(), x[0::2, :])  # A
        assert np.array_equal(K.stride2(xt, "cols").numpy(), x[:, 0::2])  # B
        assert np.array_equal(K.stride2(xt, "cols").numpy(), x.reshape(128, 256, 2)[:, :, 0])  # C
        assert np.array_equal(K.stride2(xt, "both").numpy(), x[0::2, 0::2])  # D
        y = K.stride2(xt, "interleave").numpy()  # E
        assert y.shape == x.shape
        assert np.array_equal(y[:, 0::2], x[:, :256]) and np.array_equal(y[:, 1::2], x[:, :256] + 1)

    @pytest.mark.parametrize("shape", [(3, 37, 51), (2, 2, 64, 16)])
    def test_batched_and_odd_extents(self, shape):
        x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        xt = torch.from_numpy(x)
        for mode, want in (("rows", x[..., 0::2, :]), ("cols", x[..., :, 0::2]),
                           ("both", x[..., 0::2, 0::2])):
            got = K.stride2(xt, mode)
            assert got.is_contiguous() and np.array_equal(got.numpy(), want)
        if shape[-1] % 2 == 0:
            y = K.stride2(xt, "interleave").numpy()
            half = x[..., : shape[-1] // 2]
            assert np.array_equal(y[..., 0::2], half) and np.array_equal(y[..., 1::2], half + 1)

    def test_operand_checks(self):
        with pytest.raises(ValueError):
            K.stride2(torch.zeros(4, 5), "interleave")  # odd width
        with pytest.raises(ValueError):
            K.stride2(torch.zeros(4, 4), "diagonal")
        with pytest.raises(TypeError):
            K.stride2(torch.zeros(4, 4, dtype=torch.float64), "rows")
        with pytest.raises(TypeError):
            K.stride2(torch.zeros(4), "rows")


class TestWrapperChecks:
    def test_general_smoother_operand_checks(self):
        u = torch.zeros(1, 8, 8)
        inv = torch.zeros(8, 8)
        with pytest.raises(ValueError):
            K.jacobi(u, u, inv, (0.8,) * 8, True)  # 8 sweeps + residual ring > 8
        with pytest.raises(TypeError):
            K.jacobi(u, u.to(torch.bfloat16), inv, PRE)
        with pytest.raises(ValueError):
            K.jacobi(u, torch.zeros(1, 8, 7), inv, PRE)
        K.jacobi(u, u, inv, (0.8,) * 7, True)  # 7 + 1 fits

    def test_cpu_operands_launch_nothing(self):
        b, u, um, dg = _problem((1, 24, 30), 61)
        ut, bt, inv = torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg)
        before = dict(K.launch_counts)
        K.jacobi(ut, bt, inv, PRE, True)
        K.jacobi_zero(bt, inv, PRE, "half")
        K.jacobi_v2(ut, bt, torch.from_numpy(um), torch.from_numpy(dg), 4, 0.8, True)
        K.stride2(ut, "both")
        assert K.launch_counts == before
        assert {"jacobi", "jacobi_zero_half", "jacobi_v2", "stride2"} <= set(K.launch_counts)
