"""The edges that the port's redesigned kernels rely on, held on the CPU
against the JAX package: jacobi.cu skips every tile whose interior has no
unknown cell and writes the outputs the plain version gives known cells
(the sign of each zero included); residual.cu stores +0 on every strip of 4
cells without an unknown cell and reads the neighbours' values only for
unknown cells; stride.cu and residual.cu take a 16-byte path where the
width and the addresses allow it and a per-cell one elsewhere; jacobi_v2.cu
writes a window's given u and one evaluation of r when its first sweep
changes nothing, and streams a window without an unknown cell.

The port's plain versions (which the CPU runs, and against which the
kernels are held bit for bit on the card by tests/test_torch_gpu.py) are
compared with the JAX package's XLA route of multigrid._smooth /
_smooth_residual within 5e-6, with its laplace-mode residual cascade within
2 ulp, and with numpy slicing exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_parity import cascade_residual
from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models.cg import neighbor_degree, shift_sum
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import assert_bitwise, assert_within_ulps, edge_mask, np32

PRE = JM._smoother_omegas(JM._PRE_SMOOTH)
POST = tuple(reversed(JM._smoother_omegas(JM._POST_SMOOTH)))
# XLA's CPU fusion may round the sweep arithmetic differently from
# one-op-at-a-time torch, carried through K sweeps (as tests/test_torch_smoother.py)
ATOL = 5e-6
KINDS = ["none", "corner", "ring48", "ring112", "dense"]
# ragged against the 48-cell tile in both directions, and an odd height
SHAPES = [(2, 250, 301), (1, 241, 230)]


def _problem(shape, kind, seed=7):
    c, h, w = shape
    rng = np.random.default_rng(seed)
    um = edge_mask(h, w, kind, seed=seed)
    b = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal(shape).astype(np.float32)
    # zeros of both signs on known cells (and on unknown ones)
    u[:, ::7, ::5] = -0.0
    u[:, 3::11, 2::9] = 0.0
    e_c = rng.standard_normal((c, (h + 1) // 2, (w + 1) // 2)).astype(np.float32)
    return b, u, e_c, um, neighbor_degree((h, w))


def _invm(um, dg):
    return K.invm_for_kernel(torch.from_numpy(um), torch.from_numpy(dg))


def _close(got, want):
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=ATOL)


def _bits(x):
    return np32(x).view(np.int32)


def _jax_post_smooth(u, b, um, dg, e_c, emit):
    """The JAX V-cycle's post-smooth: u + prolong(e_c) * m, then the
    reversed weights (multigrid._v_cycle, its XLA route)."""
    ju, jb, jum, jdg = (jnp.asarray(x) for x in (u, b, um, dg))
    ju = ju + JM._prolong(jnp.asarray(e_c), ju.shape) * jum.astype(ju.dtype)
    return (JM._smooth_residual if emit else JM._smooth)(ju, jb, jum, jdg, POST)


class TestSmoothersAtTheTileSkipEdges:
    """Kernels 1, 2, 3 and 6: masks with no unknown cell, one unknown cell in
    a corner of a few tiles, unknown cells only in a tile's ring, and 60 %."""

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_zero_start_matches_jax(self, shape, kind):
        b, _, _, um, dg = _problem(shape, kind)
        jb, jum, jdg = (jnp.asarray(x) for x in (b, um, dg))
        u, r = K.jacobi_zero(torch.from_numpy(b), _invm(um, dg), PRE, True)
        want_u, want_r = JM._smooth_residual(jnp.zeros_like(jb), jb, jum, jdg, PRE, u_is_zero=True)
        _close(u, want_u)
        _close(r, want_r)
        # known cells: u and r are +0, as the plain version's selects give them
        assert (_bits(u)[:, ~um] == 0).all() and (_bits(r)[:, ~um] == 0).all()

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_from_u_matches_jax_and_copies_known_cells(self, shape, kind):
        b, u, _, um, dg = _problem(shape, kind)
        ju, jb, jum, jdg = (jnp.asarray(x) for x in (u, b, um, dg))
        got_u, got_r = K.jacobi(torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg), PRE, True)
        want_u, want_r = JM._smooth_residual(ju, jb, jum, jdg, PRE)
        _close(got_u, want_u)
        _close(got_r, want_r)
        # known cells keep u bit for bit, -0.0 included; their residual is +0
        assert np.array_equal(_bits(got_u)[:, ~um], u.view(np.int32)[:, ~um])
        assert (_bits(got_r)[:, ~um] == 0).all()

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_correction_matches_jax_and_adds_zero_on_known_cells(self, shape, kind):
        b, u, e_c, um, dg = _problem(shape, kind)
        got_u, got_r = K.jacobi_corr(torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg),
                                     torch.from_numpy(e_c), POST, True)
        want_u, want_r = _jax_post_smooth(u, b, um, dg, e_c, True)
        _close(got_u, want_u)
        _close(got_r, want_r)
        # the plain version adds where(unknown, corr, +0) everywhere: a known
        # -0.0 comes out +0.0, every other known value unchanged
        want_known = (u + np.float32(0.0)).view(np.int32)[:, ~um]
        assert np.array_equal(_bits(got_u)[:, ~um], want_known)
        assert (_bits(got_u)[:, ~um] != np.int32(-2**31)).all()
        assert (_bits(got_r)[:, ~um] == 0).all()
        _close(K.jacobi_corr(torch.from_numpy(u), torch.from_numpy(b), _invm(um, dg),
                             torch.from_numpy(e_c), POST, False),
               _jax_post_smooth(u, b, um, dg, e_c, False))

    @pytest.mark.parametrize("h", [241, 97, 1])
    @pytest.mark.parametrize("kind", ["corner", "ring48", "dense"])
    def test_half_residual_odd_heights_match_jax_row_pass(self, h, kind):
        b, _, _, um, dg = _problem((2, h, 130), kind)
        jb, jum, jdg = (jnp.asarray(x) for x in (b, um, dg))
        _, r = JM._smooth_residual(jnp.zeros_like(jb), jb, jum, jdg, PRE, u_is_zero=True)
        r = np.pad(np.asarray(r), ((0, 0), (0, h % 2), (0, 0)))
        u, half = K.jacobi_zero(torch.from_numpy(b), _invm(um, dg), PRE, "half")
        assert half.shape == (2, (h + 1) // 2, 130)
        _close(half, r[:, 0::2, :] + r[:, 1::2, :])
        # row pairs of known cells are +0
        known_pairs = ~np.pad(um, ((0, h % 2), (0, 0))).reshape((h + 1) // 2, 2, 130).any(axis=1)
        assert (_bits(half)[:, known_pairs] == 0).all()

    def test_no_unknown_cell_outputs(self):
        """A band with no unknown cell: every output is fixed."""
        b, u, e_c, um, dg = _problem((2, 100, 97), "none")
        bt, ut, inv = torch.from_numpy(b), torch.from_numpy(u), _invm(um, dg)
        zu, zr = K.jacobi_zero(bt, inv, PRE, True)
        assert (_bits(zu) == 0).all() and (_bits(zr) == 0).all()
        gu, gr = K.jacobi(ut, bt, inv, PRE, True)
        assert np.array_equal(_bits(gu), u.view(np.int32)) and (_bits(gr) == 0).all()
        cu = K.jacobi_corr(ut, bt, inv, torch.from_numpy(e_c), POST, False)
        assert np.array_equal(_bits(cu), (u + np.float32(0.0)).view(np.int32))


class TestResidualCascadeAtTheStripEdges:
    """Kernels 4 and 5: no unknown cell, lone unknown cells, unknown cells
    only in a tile's ring, and 60 %, at ragged widths, with f32 and bf16
    invm and zeros of both signs in the image (and in x_lo on known cells)."""

    @staticmethod
    def _inputs(shape, kind, seed=31):
        c, h, w = shape
        rng = np.random.default_rng(seed)
        um = edge_mask(h, w, kind, seed=seed)
        img = np.round(rng.random(shape) * 1e4).astype(np.float32)
        img[:, ::7, ::5] = -0.0
        img[:, 3::11, 2::9] = 0.0
        x_hi = (rng.random(shape) * 9e3).astype(np.float32) * um
        x_lo = (rng.standard_normal(shape) * 1e-4).astype(np.float32) * um  # -0.0 where negative
        return img, x_hi, x_lo, um, neighbor_degree((h, w))

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_entry_matches_jax_cascade(self, shape, kind, invm_dtype):
        img, _, _, um, dg = self._inputs(shape, kind)
        jimg, jum = jnp.asarray(img), jnp.asarray(um)
        umf = jum.astype(jnp.float32)
        x_hi = jimg * umf
        want_r = cascade_residual(jimg, x_hi, jnp.zeros_like(x_hi), jum, jnp.asarray(dg))
        want_b = shift_sum(jimg * (1.0 - umf)) * umf
        r, b = K.residual_entry(torch.from_numpy(img), _invm(um, dg).to(invm_dtype))
        assert_within_ulps(r, want_r)
        assert_within_ulps(b, want_b)
        # known cells: r and b are +0
        assert (_bits(r)[:, ~um] == 0).all() and (_bits(b)[:, ~um] == 0).all()

    @pytest.mark.parametrize("invm_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_pair_matches_jax_cascade(self, shape, kind, invm_dtype):
        img, x_hi, x_lo, um, dg = self._inputs(shape, kind)
        want = cascade_residual(*(jnp.asarray(x) for x in (img, x_hi, x_lo, um, dg)))
        r = K.residual_pair(*(torch.from_numpy(x) for x in (img, x_hi, x_lo)),
                            _invm(um, dg).to(invm_dtype))
        assert_within_ulps(r, want)
        assert (_bits(r)[:, ~um] == 0).all()


V2_SWEEPS, V2_OMEGA = 6, 0.8


def _v2_plain(u, b, um, dg, sweeps, emit, dtype=torch.float32):
    return K.jacobi_v2_plain(torch.from_numpy(u).to(dtype), torch.from_numpy(b).to(dtype),
                             torch.from_numpy(um), torch.from_numpy(dg), sweeps, V2_OMEGA, emit)


def _known_system(shape, seed):
    """Every cell known; u and b standard normal (finite, never -0)."""
    rng = np.random.default_rng(seed)
    u, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return u, b, np.zeros(shape[1:], dtype=bool), neighbor_degree(shape[1:])


class TestJacobiV2AtTheStaticWindowEdges:
    """Kernel 7's plain version, against which jacobi_v2.cu is held bit for
    bit on the card: against the JAX smoother on masks with no unknown cell,
    one unknown cell on a tile's interior edge, unknown cells only in a
    tile's ring, and 60 %; and the facts the kernel's static-window shortcut
    rests on (a known window is a fixed point unless a u is -0 or a value is
    not finite)."""

    @pytest.mark.parametrize("emit", [False, True])
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kind", KINDS)
    def test_plain_matches_jax(self, kind, shape, emit):
        b, u, _, um, dg = _problem(shape, kind)
        got = _v2_plain(u, b, um, dg, V2_SWEEPS, emit)
        smooth = JM._smooth_residual if emit else JM._smooth
        want = smooth(*(jnp.asarray(x) for x in (u, b, um, dg)), (V2_OMEGA,) * V2_SWEEPS)
        for g, w in zip(*((got, want) if emit else ((got,), (want,)))):
            _close(g, w)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_known_window_is_a_fixed_point(self, dtype):
        """u comes back bit for bit after any number of sweeps, and r is one
        evaluation of (b - A u) * m on the given u."""
        u, b, um, dg = _known_system((2, 70, 90), 60)
        ut, bt = torch.from_numpy(u).to(dtype), torch.from_numpy(b).to(dtype)
        m, d = torch.zeros(um.shape), torch.from_numpy(dg).to(dtype).float()
        uf = ut.float()
        r = ((bt.float() - (d * uf - K._tap_sum(uf * m))) * m).to(dtype)
        for sweeps in (1, 4, 7):
            got_u, got_r = _v2_plain(u, b, um, dg, sweeps, True, dtype)
            assert_bitwise(got_u, ut)
            assert_bitwise(got_r, r)

    def test_known_negative_zero_turns_positive_where_the_update_is_not_negative(self):
        """A known -0 becomes +0 where omega * (b - A u) has no sign bit (the
        update is that value times inv = +0), and stays -0 elsewhere; every
        other u is unchanged. With b != 0 the sign is b's in every sweep."""
        u, b, um, dg = _known_system((1, 40, 50), 61)
        u[:, ::3, ::2] = -0.0
        neg0 = np.signbit(u) & (u == 0)
        ut, m, d = torch.from_numpy(u), torch.zeros(um.shape), torch.from_numpy(dg)
        x = (V2_OMEGA * (torch.from_numpy(b) - (d * ut - K._tap_sum(ut * m)))).numpy()
        assert (x[neg0] > 0).any() and (x[neg0] < 0).any()
        got = np32(_v2_plain(u, b, um, dg, 1, False))
        assert np.array_equal(np.signbit(got[neg0]), np.signbit(x[neg0]))
        assert (got[neg0] == 0).all()
        assert np.array_equal(got.view(np.int32)[~neg0], u.view(np.int32)[~neg0])
        got = np32(_v2_plain(u, b, um, dg, V2_SWEEPS, False))
        assert np.array_equal(np.signbit(got[neg0]), b[neg0] < 0)

    @pytest.mark.parametrize("value", [np.inf, np.nan])
    def test_known_non_finite_value_reaches_its_neighbours(self, value):
        """inf * 0 and NaN * 0 are NaN: after K sweeps u is NaN within K
        cells (4-neighbour steps) of a known non-finite u, and r within
        K + 1; everything farther is unchanged."""
        u, b, um, dg = _known_system((1, 41, 41), 62)
        u[0, 20, 20] = value
        yy, xx = np.mgrid[:41, :41]
        dist = np.abs(yy - 20) + np.abs(xx - 20)
        for sweeps in (1, 3, 6):
            got_u, got_r = (np32(t)[0] for t in _v2_plain(u, b, um, dg, sweeps, True))
            assert np.isnan(got_u[dist <= sweeps]).all()
            assert np.array_equal(got_u[dist > sweeps].view(np.int32),
                                  u[0][dist > sweeps].view(np.int32))
            assert np.isnan(got_r[dist <= sweeps + 1]).all()
            assert (got_r[dist > sweeps + 1] == 0).all()


class TestStride2Widths:
    """Kernel 8's plain version against numpy slicing, at the widths where
    the kernel leaves its 16-byte path (not a multiple of 4), the even ones
    among them for the interleave."""

    @pytest.mark.parametrize("width", [1, 2, 3, 6, 7, 9, 33, 34])
    @pytest.mark.parametrize("lead", [(2,), (3, 2), ()])
    @pytest.mark.parametrize("rows", [5, 1, 6])
    def test_plain_matches_numpy(self, width, lead, rows):
        x = np.random.default_rng(width).standard_normal((*lead, rows, width)).astype(np.float32)
        xt = torch.from_numpy(x)
        for mode, want in (("rows", x[..., 0::2, :]), ("cols", x[..., :, 0::2]),
                           ("both", x[..., 0::2, 0::2])):
            got = K.stride2_plain(xt, mode)
            assert got.is_contiguous() and np.array_equal(got.numpy(), want)
        if width % 2 == 0:
            y = K.stride2_plain(xt, "interleave").numpy()
            half = x[..., : width // 2]
            assert np.array_equal(y[..., 0::2], half) and np.array_equal(y[..., 1::2], half + 1)
