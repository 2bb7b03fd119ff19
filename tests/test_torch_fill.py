"""The port's fill end to end (models/fill.py, laplace.py, poisson.py) held
against the JAX package on the CPU, on bench.py-style inputs at small size;
plus the port's surface: device selection, options, import isolation."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satellite_approximation_tpu.config import SolverConfig as JaxSolverConfig
from satellite_approximation_tpu.models import fill as JF
from satellite_approximation_tpu.models import laplace as JL
from satellite_approximation_tpu.models import multigrid as JM
from satellite_approximation_tpu.models import poisson as JP
import satellite_approximation_tpu_torch as port
from satellite_approximation_tpu_torch.config import SolverConfig
from satellite_approximation_tpu_torch.device import resolve_device
from satellite_approximation_tpu_torch.models import cg as PC
from satellite_approximation_tpu_torch.models import fill as PF
from satellite_approximation_tpu_torch.models import laplace as PL
from satellite_approximation_tpu_torch.models import poisson as PP
from torch_parity import bench_system, smooth, small_mask

REPO = Path(__file__).resolve().parent.parent
# multigrid on small grids, single device on the JAX side (its test
# platform has 8 virtual CPU devices, which "auto" would shard over)
MG = dict(mg_threshold_pixels=0, mesh="off")


@pytest.fixture
def jax_f32_precond(monkeypatch):
    """The JAX package picks a bf16 V-cycle on grids <= 4096 (which also
    turns off its A·z recurrence); the port's default is f32."""
    monkeypatch.setattr(JM, "PRECOND_DTYPE", jnp.float32)


def _images(h, w, bands, seed0=0):
    return np.stack([smooth(h, w, seed0 + s) for s in range(bands)]).astype(np.float64)


class TestLaplaceFill:
    def test_matches_jax(self, jax_f32_precond):
        imgs, m, *_ = bench_system(96, 128, 3)
        want = JF.laplace_fill(imgs, m, tolerance=1e-6, device_output=False)
        got = PF.laplace_fill(imgs, m, tolerance=1e-6, device_output=False, device="cpu")
        assert got.x.shape == imgs.shape and got.x.dtype == np.float32
        assert np.isfinite(got.x).all()
        np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-5)
        assert got.error <= 1e-6 and want.error <= 1e-6
        assert abs(got.iterations - want.iterations) <= 1
        np.testing.assert_array_equal(got.x[:, ~m], imgs[:, ~m].astype(np.float32))

    @pytest.mark.parametrize(
        "h,w,kind",
        [
            (20, 20, "blob"),  # one level: the dense coarse solve is the top
            (30, 1000, "random"),  # coarsest 15x500 > the dense cap: coarse CG, PR beta
            (64, 72, "all"),  # every interior pixel unknown
        ],
    )
    def test_edge_hierarchies_match_jax(self, jax_f32_precond, h, w, kind):
        rng = np.random.default_rng(h)
        img = rng.random((2, h, w)).astype(np.float32)
        if kind == "blob":
            m = np.zeros((h, w), bool)
            m[5:15, 4:16] = True
        else:
            m = rng.random((h, w)) > 0.5 if kind == "random" else np.ones((h, w), bool)
            m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
        want = JF.laplace_fill(img, m, tolerance=1e-7, device_output=False)
        got = PF.laplace_fill(img, m, tolerance=1e-7, device_output=False, device="cpu")
        np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-5)
        assert got.error <= 1e-7 and want.error <= 1e-7
        assert abs(got.iterations - want.iterations) <= 1

    def test_options_agree(self):
        """Chunks, a band sink, the masked-values output, a 2-D input and a
        u16 upload all give the single-chunk f32 result."""
        imgs, m, *_ = bench_system(64, 80, 3)
        imgs = np.round(imgs * 1000)
        kw = dict(tolerance=1e-7, device_output=False, device="cpu")
        full = PF.laplace_fill(imgs, m, **kw)
        chunked = PF.laplace_fill(imgs, m, max_chunk_elements=2 * 64 * 80, **kw)
        np.testing.assert_allclose(chunked.x, full.x, rtol=0, atol=1e-4)
        seen = []
        sunk = PF.laplace_fill(
            imgs, m, max_chunk_elements=64 * 80,
            band_sink=lambda s, e, x: seen.append((s, e, x.numpy().copy())), **kw,
        )
        assert sunk.x is None and [(s, e) for s, e, _ in seen] == [(0, 1), (1, 2), (2, 3)]
        np.testing.assert_allclose(np.concatenate([x for *_, x in seen]), full.x, atol=1e-4)
        vals = PF.laplace_fill(imgs, m, masked_values_output=True, **kw)
        assert vals.x.dtype == np.float64 and vals.x.shape == (3, int(m.sum()))
        np.testing.assert_allclose(vals.x, full.x[:, m], rtol=0, atol=1e-4)
        one = PF.laplace_fill(imgs[1], m, **kw)
        np.testing.assert_allclose(one.x, full.x[1], rtol=0, atol=1e-4)
        u16 = PF.laplace_fill(imgs.astype(np.uint16), m, **kw)
        np.testing.assert_array_equal(u16.x, full.x)
        with pytest.raises(ValueError):
            PF.laplace_fill(imgs, m, masked_values_output=True, band_sink=print, **kw)

    def test_tensor_inputs_stay_on_device(self):
        imgs, m, *_ = bench_system(64, 80, 2)
        t = torch.from_numpy(imgs.astype(np.float32))
        got = PF.laplace_fill(t, torch.from_numpy(m), tolerance=1e-6, device="cpu")
        assert isinstance(got.x, torch.Tensor) and got.x.device.type == "cpu"
        assert got.error <= 1e-6


class TestPublicLaplace:
    def test_filling_missing_portions_matches_jax(self):
        """The public alias at small size: plain CG under the double-float
        loop (below the multigrid threshold) on both sides."""
        imgs = _images(40, 52, 2)
        m = small_mask(40, 52, 4)
        want = JL.filling_missing_portions_smooth_boundaries(imgs, m)
        got = port.filling_missing_portions_smooth_boundaries(imgs, m, device="cpu")
        assert got.shape == imgs.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("assembly", ["auto", "never"])
    def test_solve_matrix_multigrid_matches_jax(self, jax_f32_precond, assembly):
        """The multigrid route of the public solve, on the device path and
        on the host-assembled f64 path."""
        imgs = _images(96, 128, 2)
        if assembly == "never":
            imgs = imgs + 1e-9  # not f32-representable: the f64 route
        m = small_mask(96, 128, 5)
        out_j, res_j = JL.solve_matrix(imgs, m, JaxSolverConfig(device_assembly=assembly, **MG))
        out_p, res_p = PL.solve_matrix(
            imgs, m, SolverConfig(device_assembly=assembly, **MG), device="cpu"
        )
        np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-5)
        assert res_p.error <= 1e-9 and res_j.error <= 1e-9
        assert abs(res_p.iterations - res_j.iterations) <= 1

    def test_apply_laplace_marker(self):
        rng = np.random.default_rng(9)
        image = rng.random((40, 44, 3)).astype(np.float32).astype(np.float64)
        marker = np.round(image * 200)
        marker[10:20, 12:30, 0] = 250
        marker[10:20, 12:30, 1] = 10
        got = port.apply_laplace(image, marker, device="cpu")
        want = JL.apply_laplace(image, marker)
        assert got.shape == image.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_no_invalid_pixels(self):
        img = np.ones((8, 9))
        np.testing.assert_array_equal(
            PL.fill_missing_portion_smooth_boundary(img, np.zeros((8, 9), bool), device="cpu"), img
        )

    def test_size_mismatch_raises(self):
        with pytest.raises(ValueError):
            PL.solve_matrix(np.ones((8, 9)), np.zeros((9, 8), bool), device="cpu")


class TestPoisson:
    def test_blend_mask_overload_matches_jax(self, jax_f32_precond):
        imgs = _images(96, 128, 2)
        repl = _images(96, 128, 2, seed0=7)
        m = small_mask(96, 128, 6)
        cfg_j, cfg_p = JaxSolverConfig(**MG), SolverConfig(**MG)
        want = JP.blend_images_poisson(imgs, repl, m, config=cfg_j)
        got = port.blend_images_poisson(imgs, repl, m, config=cfg_p, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # the solve beneath it (poisson mode of the fill): both certify the
        # tolerance, iteration counts within one
        kw = dict(tolerance=1e-6, replacement=repl, masked_values_output=True)
        res_j = JF.laplace_fill(imgs, m, **kw)
        res_p = PF.laplace_fill(imgs, m, device="cpu", **kw)
        assert res_p.error <= 1e-6 and res_j.error <= 1e-6
        assert abs(res_p.iterations - res_j.iterations) <= 1
        np.testing.assert_allclose(res_p.x, res_j.x, rtol=0, atol=1e-5)

    def test_blend_default_config_and_list_api(self):
        imgs = _images(40, 52, 2)
        repl = _images(40, 52, 2, seed0=3)
        m = small_mask(40, 52, 7)
        want = JP.blend_images_poisson(list(imgs), list(repl), m)
        got = port.blend_images_poisson(list(imgs), list(repl), m, device="cpu")
        assert isinstance(got, list) and len(got) == 2
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0, atol=1e-5)

    def test_offset_overload_and_highlight(self, tmp_path):
        rng = np.random.default_rng(10)
        inputs = rng.random((3, 30, 40)).astype(np.float32).astype(np.float64)
        patch = rng.random((3, 10, 12)).astype(np.float32).astype(np.float64) + 2
        patch[:, :2, :] = 1.0  # sentinel rows
        perf = tmp_path / "perf.csv"
        want = JP.blend_images_poisson(inputs, patch, None, 5, 7)
        got = port.blend_images_poisson(inputs, patch, None, 5, 7, perf_path=perf, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert len(perf.read_text().strip().split(",")) == 6
        np.testing.assert_array_equal(
            port.highlight_area_replaced(inputs, patch, 5, 7, (1, 2, 3)),
            JP.highlight_area_replaced(inputs, patch, 5, 7, (1, 2, 3)),
        )
        np.testing.assert_array_equal(PP.valid_pixel_mask(patch), JP.valid_pixel_mask(patch))
        with pytest.raises(ValueError):
            port.blend_images_poisson(inputs, patch, None, 25, 7, device="cpu")


class TestCG:
    def test_solve_masked_poisson_matches_jax(self):
        from satellite_approximation_tpu.models import cg as JC

        imgs, m, deg, b, x0 = bench_system(40, 52, 2)
        want = JC.solve_masked_poisson(b, m, deg=deg, tolerance=1e-7, max_iterations=2000)
        got = PC.solve_masked_poisson(
            b, m, deg=deg, tolerance=1e-7, max_iterations=2000, device="cpu"
        )
        np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-5)
        assert got.error <= 1e-7

    def test_banded_chunks_join_the_bands(self, monkeypatch):
        imgs, m, deg, b, x0 = bench_system(40, 52, 3)
        whole = PC.solve_masked_poisson(b, m, deg=deg, x0=x0, max_iterations=2000, device="cpu")
        monkeypatch.setattr(PC, "chunk_elements", lambda dev: 40 * 52)
        parts = PC.solve_banded_chunks(
            PC.solve_masked_poisson, b, device="cpu", umask=m, deg=deg, x0=x0,
            max_iterations=2000,
        )
        assert parts.x.shape == b.shape
        np.testing.assert_allclose(parts.x, whole.x, rtol=0, atol=1e-5)


class TestDevice:
    def test_none_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        m = small_mask(24, 24, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            port.filling_missing_portions_smooth_boundaries(np.ones((24, 24)), m)
        with pytest.raises(RuntimeError, match="CUDA"):
            PF.laplace_fill(np.ones((24, 24)), m)

    def test_multi_device_mesh_names_slice_d(self, monkeypatch):
        """The fill's mesh policy (``parallel.mesh.resolve_mesh``): None, "off"
        and "auto" solve on one device however many cards the host has, an
        explicit ShardMesh routes the public fill sharded, anything else
        raises ValueError."""
        from satellite_approximation_tpu_torch.parallel import fill as pfill
        from satellite_approximation_tpu_torch.parallel.mesh import (
            resolve_mesh,
            spatial_band_mesh,
        )

        with pytest.raises(ValueError, match="unknown mesh setting"):
            resolve_mesh(object())
        with pytest.raises(ValueError, match="unknown mesh setting"):
            port.fill_missing_portion_smooth_boundary(
                _images(48, 40, 1), small_mask(48, 40, 2),
                config=SolverConfig(mg_threshold_pixels=0, mesh="slice D"), device="cpu")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        for setting in ("off", None, "auto"):
            assert resolve_mesh(setting) is None

        mesh = spatial_band_mesh(2, shape=(1, 2), devices="cpu")
        assert resolve_mesh(mesh) is mesh
        calls = []
        real = pfill.sharded_fill
        monkeypatch.setattr(pfill, "sharded_fill", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
        imgs, m = _images(64, 56, 2), small_mask(64, 56, 3)
        port.fill_missing_portion_smooth_boundary(
            imgs, m, config=SolverConfig(mg_threshold_pixels=0, mesh="auto"), device="cpu")
        assert calls == []
        got = port.fill_missing_portion_smooth_boundary(
            imgs, m, config=SolverConfig(mg_threshold_pixels=0, mesh=mesh), device="cpu")
        assert calls == [mesh]
        want = port.fill_missing_portion_smooth_boundary(
            imgs, m, config=SolverConfig(**MG), device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_import_leaves_jax_out(self):
        code = (
            "import sys, satellite_approximation_tpu_torch, "
            "satellite_approximation_tpu_torch.interop, "
            "satellite_approximation_tpu_torch.models.fill; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.split('.')[0] == 'satellite_approximation_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
