"""The port's multigrid (models/multigrid.py) held against the JAX package on
the CPU: hierarchies bit-equal, the state carried across by
interop.hierarchy_from_numpy, one V-cycle and a full PCG solve on the same
hierarchy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models.cg import neighbor_degree
from satellite_approximation_tpu_torch import interop
from satellite_approximation_tpu_torch.models import multigrid as PM
from satellite_approximation_tpu_torch.models.cg import neighbor_degree_tensor
from torch_parity import CPU, bench_system, np32, random_mask, small_mask


def _port_hierarchy(m):
    h, w = m.shape
    return PM._device_hierarchy(m, neighbor_degree_tensor(h, w, CPU), CPU)


def _jax_hierarchy(m):
    return JM._device_hierarchy(m, neighbor_degree(m.shape))


def _numpy_state(hier):
    levels = [(np.asarray(m), np.asarray(d)) for m, d in hier.levels]
    ci = None if hier.coarse_inv is None else np.asarray(hier.coarse_inv)
    return levels, ci


class TestHierarchy:
    @pytest.mark.parametrize(
        "shape,seed", [((130, 97), 0), ((96, 128), 1), ((77, 530), 2)]
    )
    def test_levels_bitwise_equal_jax(self, shape, seed):
        m = random_mask(*shape, seed, p=0.6)
        m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
        want = JM._build_levels_device(jnp.asarray(m))
        got = PM._build_levels(torch.from_numpy(m))
        assert len(got) == len(want) >= 2
        for (gm, gd), (wm, wd) in zip(got, want):
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))

    @pytest.mark.parametrize("shape", [(100, 100), (128, 96)])
    def test_saturating_ladder_bitwise_equal_jax(self, shape):
        """An all-unknown input: every level from the first saturated one on
        takes deg = 4."""
        m = np.ones(shape, bool)
        want = JM._build_levels_device(jnp.asarray(m))
        got = PM._build_levels(torch.from_numpy(m))
        assert len(got) == len(want)
        for (gm, gd), (wm, wd) in zip(got, want):
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        assert (got[-1][1] == 4.0).all()

    @pytest.mark.parametrize("shape", [(130, 97), (300, 300)])
    def test_host_builder_equals_jax(self, shape):
        m = random_mask(*shape, 4, p=0.5)
        m[0, 0] = False
        want = JM.build_hierarchy(m, neighbor_degree(shape))
        got = PM.build_hierarchy(m, neighbor_degree(shape))
        assert len(got) == len(want)
        for (gm, gd), (wm, wd) in zip(got, want):
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gd, wd)

    def test_device_builder_matches_host_builder(self):
        m = small_mask(130, 97, 5)
        host = PM.build_hierarchy(m, neighbor_degree(m.shape))
        dev = PM._build_levels(torch.from_numpy(m))
        assert len(host) - 1 == len(dev)
        for (hm, hd), (dm, dd) in zip(host[1:], dev):
            np.testing.assert_array_equal(dm.numpy(), hm)
            np.testing.assert_array_equal(dd.numpy(), hd)

    def test_hierarchy_from_numpy_equals_port_hierarchy(self):
        m = small_mask(130, 97, 6)
        carried = interop.hierarchy_from_numpy(*_numpy_state(_jax_hierarchy(m)), device="cpu")
        own = _port_hierarchy(m)
        assert len(carried.levels) == len(own.levels) >= 3
        for (cm, cd), (om, od) in zip(carried.levels, own.levels):
            assert cm.dtype == om.dtype == torch.bool
            np.testing.assert_array_equal(cm.numpy(), om.numpy())
            np.testing.assert_array_equal(cd.numpy(), od.numpy())
        # different LAPACK call order: 1e-5 relative
        np.testing.assert_allclose(
            own.coarse_inv.numpy(), carried.coarse_inv.numpy(), rtol=1e-5,
            atol=1e-5 * float(carried.coarse_inv.abs().max()),
        )

    def test_dense_coarse_inverse_matches_jax(self):
        m = random_mask(24, 20, 7, p=0.3)
        dg = neighbor_degree(m.shape)
        want = np.asarray(JM._dense_coarse_inverse(jnp.asarray(m), jnp.asarray(dg)))
        got = PM._dense_coarse_inverse(torch.from_numpy(m), torch.from_numpy(dg)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    def test_cache_reuses_and_evicts_lru(self, monkeypatch):
        monkeypatch.setattr(PM, "_HIERARCHY_CACHE", type(PM._HIERARCHY_CACHE)())
        monkeypatch.setattr(PM, "_HIERARCHY_CACHE_CAP", 2)
        a, b, c = (small_mask(64, 64, s) for s in (1, 2, 3))
        ha = _port_hierarchy(a)
        assert _port_hierarchy(a.copy()).levels[1][0] is ha.levels[1][0]
        _port_hierarchy(b)
        _port_hierarchy(a)  # a is now the most recent
        _port_hierarchy(c)  # evicts b, keeps a
        keys = list(PM._HIERARCHY_CACHE)
        assert keys == [PM._mask_key(a, CPU), PM._mask_key(c, CPU)]
        flipped = a.copy()
        flipped[10, 10] = not flipped[10, 10]
        assert PM._mask_key(flipped, CPU) != PM._mask_key(a, CPU)
        # a tensor mask (packed on its device) keys like the same numpy mask
        odd = random_mask(13, 11, 9)
        assert PM._mask_key(torch.from_numpy(odd), CPU) == PM._mask_key(odd, CPU)


class TestTransfers:
    @pytest.mark.parametrize("hw", [(130, 97), (96, 128), (1, 3)])
    def test_restrict_and_prolong_bitwise_equal_jax(self, hw):
        rng = np.random.default_rng(8)
        r = rng.standard_normal((2, *hw)).astype(np.float32)
        np.testing.assert_array_equal(
            PM._restrict(torch.from_numpy(r)).numpy(), np.asarray(JM._restrict(jnp.asarray(r)))
        )
        e = rng.standard_normal((2, (hw[0] + 1) // 2, (hw[1] + 1) // 2)).astype(np.float32)
        from satellite_approximation_tpu_torch.ops.stencil_kernels import prolong

        np.testing.assert_array_equal(
            prolong(torch.from_numpy(e), (2, *hw)).numpy(),
            np.asarray(JM._prolong(jnp.asarray(e), (2, *hw))),
        )


def _shared_state(h=96, w=128, bands=2):
    """One hierarchy, built by JAX and carried across, and a right-hand side."""
    _, m, _, b, _ = bench_system(h, w, bands)
    jh = _jax_hierarchy(m)
    ph = interop.hierarchy_from_numpy(*_numpy_state(jh), device="cpu")
    return jh, ph, b.astype(np.float32)


class TestVCycle:
    @pytest.mark.parametrize("emit", [False, True])
    def test_one_v_cycle_matches_jax(self, emit):
        jh, ph, b = _shared_state()
        want = JM._v_cycle(
            jh.levels, jnp.asarray(b), jnp.zeros(b.shape, jnp.float32), 0, jh.coarse_inv,
            None, u_is_zero=True, emit_top_residual=emit,
        )
        got = PM._v_cycle(PM.prebuild(ph, torch.float32), torch.from_numpy(b),
                          emit_top_residual=emit)
        if not emit:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), rtol=0, atol=1e-5)
        assert np.abs(np32(want[0])).max() > 1e-2  # a real correction, not zeros

    def test_bf16_storage_v_cycle_stays_close_to_f32(self):
        """bf16 storage of the V-cycle (kernels compute in f32): a
        preconditioner at bf16 precision."""
        _, ph, b = _shared_state()
        bt = torch.from_numpy(b)
        z32 = PM._v_cycle(PM.prebuild(ph, torch.float32), bt)
        z16 = PM._v_cycle(PM.prebuild(ph, torch.bfloat16), bt.to(torch.bfloat16))
        assert z16.dtype == torch.bfloat16
        scale = float(z32.abs().max())
        assert float((z16.float() - z32).abs().max()) <= 0.05 * scale


class TestPCG:
    @pytest.mark.parametrize("dense_coarse", [True, False])
    def test_pcg_solve_matches_jax(self, dense_coarse):
        """Same hierarchy, same b: iterates within 1e-5 per pixel and
        iteration counts within one. Without the dense coarse inverse both
        take the Polak-Ribiere beta and the budgeted coarse CG."""
        jh, ph, b = _shared_state()
        if not dense_coarse:
            jh = JM.Hierarchy(jh.levels, None)
            ph = PM.Hierarchy(ph.levels, None)
        tol = np.float32(1e-6)
        xj, itj, relj = JM._pcg_run(
            jnp.asarray(b), jnp.zeros(b.shape, jnp.float32), tol, jh,
            max_iterations=60, precond_dtype=jnp.float32,
        )
        xp, itp, relp = PM._pcg_core(
            torch.from_numpy(b), torch.zeros(b.shape), tol, ph, max_iterations=60,
            precond_dtype=torch.float32,
        )
        assert abs(int(itj) - itp) <= 1
        assert 2 <= itp < 60
        np.testing.assert_allclose(np32(xp), np32(xj), rtol=0, atol=1e-5)
        assert float(relp.max()) <= float(tol) ** 2


class TestSolveRhsMode:
    def test_multigrid_solve_matches_jax(self, monkeypatch):
        """multigrid.solve, the bench entry ("rhs" mode), on bench.py's
        system at small size."""
        monkeypatch.setattr(JM, "PRECOND_DTYPE", jnp.float32)
        imgs, m, deg, b, x0 = bench_system(96, 128, 3)
        want = JM.solve(b, m, deg=deg, x0=x0, tolerance=1e-6, refinement_steps=4)
        got = PM.solve(b, m, deg=deg, x0=x0, tolerance=1e-6, refinement_steps=4, device="cpu")
        assert got.x.shape == b.shape and got.x.dtype == np.float64
        np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-5)
        assert got.error <= 1e-6 and want.error <= 1e-6
        assert abs(got.iterations - want.iterations) <= 1
        # and the fill it certifies is the fill of the image
        np.testing.assert_allclose(got.x, imgs * m, rtol=0, atol=1.0)
