"""The port's V-cycle from a given iterate (models/multigrid._v_cycle with
``u``) held against the JAX package's general V-cycle on the CPU, on one
hierarchy carried across by interop.hierarchy_from_numpy; and the zero-start
route the PCG takes, unchanged by it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models.cg import neighbor_degree
from satellite_approximation_tpu_torch import interop
from satellite_approximation_tpu_torch.models import multigrid as PM
from satellite_approximation_tpu_torch.models.cg import masked_laplacian
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import CPU, assert_bitwise, bench_system, np32, small_mask

# the V-cycle contract of the port (ROADMAP.md): within 1e-5 per pixel
ATOL = 1e-5


def _state(h=96, w=128, bands=2, dense_coarse=True):
    """One hierarchy, built by JAX and carried across; b and the iterate
    x0 = img * m of bench.py's system."""
    _, m, _, b, x0 = bench_system(h, w, bands)
    jh = JM._device_hierarchy(m, neighbor_degree(m.shape))
    levels = [(np.asarray(um), np.asarray(dg)) for um, dg in jh.levels]
    ci = np.asarray(jh.coarse_inv) if dense_coarse else None
    ph = interop.hierarchy_from_numpy(levels, ci, device="cpu")
    jci = jh.coarse_inv if dense_coarse else None
    return jh.levels, jci, PM.prebuild(ph, torch.float32), b.astype(np.float32), x0.astype(
        np.float32
    )


def _jax_v_cycle(levels, ci, b, u, emit=False):
    return JM._v_cycle(levels, jnp.asarray(b), jnp.asarray(u), 0, ci, None, u_is_zero=False,
                       emit_top_residual=emit)


def _pairs(got, want, emit):
    return zip(got, want) if emit else [(got, want)]


class TestGeneralVCycle:
    @pytest.mark.parametrize("dense_coarse", [True, False])
    @pytest.mark.parametrize("emit", [False, True])
    def test_matches_jax_from_a_given_iterate(self, dense_coarse, emit):
        """With and without the dense coarse inverse (the budgeted coarse
        CG from the given iterate's residual)."""
        levels, ci, pb, b, x0 = _state(dense_coarse=dense_coarse)
        want = _jax_v_cycle(levels, ci, b, x0, emit)
        got = PM._v_cycle(pb, torch.from_numpy(b), torch.from_numpy(x0), emit_top_residual=emit)
        for g, w in _pairs(got, want, emit):
            np.testing.assert_allclose(np32(g), np32(w), rtol=0, atol=ATOL)
        u = np32(got[0] if emit else got)
        assert np.abs(u - x0).max() > 1e-2  # a real correction of the iterate

    @pytest.mark.parametrize("emit", [False, True])
    def test_single_level_hierarchy_matches_jax(self, emit):
        """A grid no larger than the coarsest size: the coarse solve of
        (b - A u) * m, added to u, is the whole cycle."""
        m = small_mask(20, 22, 7)
        dg = neighbor_degree(m.shape)
        jh = JM._device_hierarchy(m, dg)
        assert len(jh.levels) == 1
        ph = interop.hierarchy_from_numpy(
            [(np.asarray(a), np.asarray(d)) for a, d in jh.levels], np.asarray(jh.coarse_inv),
            device="cpu",
        )
        rng = np.random.default_rng(3)
        b = (rng.random((2, 20, 22)) * m).astype(np.float32)
        u = (rng.random((2, 20, 22)) * m).astype(np.float32)
        want = _jax_v_cycle(jh.levels, jh.coarse_inv, b, u, emit)
        got = PM._v_cycle(PM.prebuild(ph, torch.float32), torch.from_numpy(b),
                          torch.from_numpy(u), emit_top_residual=emit)
        for g, w in _pairs(got, want, emit):
            np.testing.assert_allclose(np32(g), np32(w), rtol=0, atol=ATOL)

    def test_from_zero_is_bit_equal_to_the_zero_start_route(self):
        _, _, pb, b, _ = _state()
        bt = torch.from_numpy(b)
        for emit in (False, True):
            got = PM._v_cycle(pb, bt, torch.zeros_like(bt), emit_top_residual=emit)
            want = PM._v_cycle(pb, bt, emit_top_residual=emit)
            for g, w in _pairs(got, want, emit):
                assert_bitwise(g, w)

    def test_stationary_cycles_contract(self):
        """u <- V(b, u), as benchmarks/x_vcontraction.py iterates it: the
        f64 residual falls by at least 2x a cycle above the f32 floor."""
        _, m, deg, b, x0 = bench_system(96, 128, 1)
        _, _, pb, b32, u = _state(bands=1)
        bt, u = torch.from_numpy(b32), torch.from_numpy(u)
        mt, dt = torch.from_numpy(m), torch.from_numpy(deg).double()

        def rel(x):
            r = (bt.double() - masked_laplacian(x.double(), mt, dt)) * mt
            return float(r.norm() / bt.double().norm())

        prev = rel(u)
        for _ in range(4):
            u = PM._v_cycle(pb, bt, u)
            cur = rel(u)
            assert cur < 0.5 * prev, (cur, prev)
            prev = cur


def _restrict_pr1(r):
    """_restrict as it was before the row pass was shared with kernel 6."""
    h, w = r.shape[-2], r.shape[-1]
    rp = F.pad(r, (0, w % 2, 0, h % 2))
    rows = rp[..., 0::2, :] + rp[..., 1::2, :]
    return rows[..., :, 0::2] + rows[..., :, 1::2]


def _v_cycle_zero_start(pb, b, lvl=0, emit_top_residual=False):
    """The zero-start V-cycle as the PCG ran it before the general iterate:
    kernel 1, restrict, recursion, kernel 2."""
    um, deg = pb.levels[lvl]
    if lvl == len(pb.levels) - 1:
        e = PM._coarse_solve(b, um, deg, pb.coarse_inv)
        if emit_top_residual:
            return e, (b - masked_laplacian(e, um, deg)) * um.to(e.dtype)
        return e
    pre = PM._smoother_omegas(PM._PRE_SMOOTH)
    post = tuple(reversed(pre))
    u, r = K.jacobi_zero(b, pb.invms[lvl], pre, emit_residual=True)
    r_c = _restrict_pr1(r) * pb.levels[lvl + 1][0].to(r.dtype)
    e_c = _v_cycle_zero_start(pb, r_c, lvl + 1)
    return K.jacobi_corr(u, b, pb.invms[lvl], e_c, post, emit_residual=emit_top_residual)


class TestZeroStartRouteUnchanged:
    @pytest.mark.parametrize("shape", [(2, 96, 128), (1, 97, 131)])
    def test_bit_equal_to_the_zero_start_algorithm(self, shape):
        _, m, _, b, _ = bench_system(*shape[1:], shape[0])
        hier = PM._device_hierarchy(m, torch.from_numpy(neighbor_degree(m.shape)), CPU)
        pb = PM.prebuild(hier, torch.float32)
        bt = torch.from_numpy(b.astype(np.float32))
        for emit in (False, True):
            got = PM._v_cycle(pb, bt, emit_top_residual=emit)
            want = _v_cycle_zero_start(pb, bt, emit_top_residual=emit)
            for g, w in _pairs(got, want, emit):
                assert_bitwise(g, w)

    def test_pcg_never_reaches_the_general_smoother(self, monkeypatch):
        """u = None everywhere on the PCG route: kernel 3 is never called."""
        def refuse(*args, **kwargs):
            raise AssertionError("the PCG route reached the general-iterate smoother")

        monkeypatch.setattr(PM, "jacobi", refuse)
        _, _, pb, b, _ = _state()
        x, it, rel = PM._pcg_core(torch.from_numpy(b), torch.zeros(b.shape), 1e-6, PM.Hierarchy(
            pb.levels, pb.coarse_inv), max_iterations=40, prebuilt=pb)
        assert 2 <= it < 40 and float(rel.max()) <= 1e-12
