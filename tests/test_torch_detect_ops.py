"""The port's detection ops (``satellite_approximation_tpu_torch/ops``)
against the JAX package's on the CPU: the same inputs, made from a numpy
seed, through both. Integer and boolean results (masks, label maps, regions,
kernels, the pit fill, which is a unique fixpoint) must be equal bit for bit;
f32 blurs within 2 ulp of the raster's scale; the least-squares points
within 1e-6 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_approximation_tpu.models import laplace as j_laplace
from satellite_approximation_tpu.ops import blur as j_blur
from satellite_approximation_tpu.ops import components as j_comp
from satellite_approximation_tpu.ops import geometry as j_geo
from satellite_approximation_tpu.ops import image as j_image
from satellite_approximation_tpu.ops import masks as j_masks
from satellite_approximation_tpu.ops import morphology as j_morph
from satellite_approximation_tpu.ops import pitfill as j_pit
from satellite_approximation_tpu.ops import stats as j_stats
from satellite_approximation_tpu_torch import native
from satellite_approximation_tpu_torch import ops as t_ops_pkg
from satellite_approximation_tpu_torch.models import laplace as t_laplace
from satellite_approximation_tpu_torch.ops import blur as t_blur
from satellite_approximation_tpu_torch.ops import components as t_comp
from satellite_approximation_tpu_torch.ops import geometry as t_geo
from satellite_approximation_tpu_torch.ops import image as t_image
from satellite_approximation_tpu_torch.ops import masks as t_masks
from satellite_approximation_tpu_torch.ops import morphology as t_morph
from satellite_approximation_tpu_torch.ops import pitfill as t_pit
from satellite_approximation_tpu_torch.ops import stats as t_stats
from torch_parity import (  # noqa: F401 — native_route is a fixture
    NATIVE_ROUTES,
    assert_within_ulps,
    native_route,
    smooth,
)


def T(a):
    return torch.from_numpy(np.array(a))  # a copy: torch wants a writable buffer


def rng(seed):
    return np.random.default_rng(seed)


class TestMasks:
    def test_scl_enum_and_colours_equal(self):
        assert {m.name: int(m) for m in t_masks.SCL} == {m.name: int(m) for m in j_masks.SCL}
        assert {int(k): v for k, v in t_masks.SCL_COLOURS.items()} == {
            int(k): v for k, v in j_masks.SCL_COLOURS.items()}

    @pytest.mark.parametrize("classes", [(8, 9), (3, 2), (3, 2, 6), (7, 8, 9), ()])
    def test_scl_mask(self, classes):
        scl = rng(0).integers(0, 12, (37, 53)).astype(np.uint8)
        got = t_masks.scl_mask(T(scl), tuple(t_masks.SCL(c) for c in classes)).numpy()
        want = np.asarray(j_masks.scl_mask(jnp.asarray(scl), tuple(j_masks.SCL(c) for c in classes)))
        assert got.dtype == np.bool_ and np.array_equal(got, want)

    def test_scl_rgba(self):
        scl = rng(1).integers(0, 13, (20, 30)).astype(np.uint8)
        assert np.array_equal(t_masks.scl_rgba(scl), j_masks.scl_rgba(scl))

    @pytest.mark.parametrize("dtype,max_value", [(np.uint8, 255), (np.uint8, 100), (np.uint16, 65535)])
    def test_normalize_every_value(self, dtype, max_value):
        """Bit-identical to numpy's f32 division for EVERY representable
        value (the JAX package's TestDeviceNormalize)."""
        raw = np.arange(np.iinfo(dtype).max + 1, dtype=np.int64).astype(dtype)
        want = raw.astype(np.float32) / np.float32(max_value)
        got = t_masks.normalize(T(raw.astype(np.int32)), max_value).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)

    def test_threshold_and_cover(self):
        x = rng(2).random((40, 50)).astype(np.float32)
        m = t_masks.threshold(T(x), 0.3)
        assert np.array_equal(m.numpy(), np.asarray(j_masks.threshold(jnp.asarray(x), 0.3)))
        assert int(t_masks.cover_count(m)) == int(j_masks.cover_count(jnp.asarray(m.numpy())))
        got = t_masks.cover_percentage(m)
        assert got.dtype == torch.float32
        assert float(got) == float(j_masks.cover_percentage(jnp.asarray(m.numpy())))

    @pytest.mark.parametrize("shape", [(5, 7), (16, 16), (1, 1)])
    def test_fetch_push_roundtrip(self, shape):
        m = rng(3).random(shape) > 0.5
        pushed = t_masks.push_mask(m, "cpu")
        assert pushed.dtype == torch.bool and np.array_equal(pushed.numpy(), m)
        assert t_masks.push_mask(pushed, "cpu") is pushed or torch.equal(
            t_masks.push_mask(pushed, "cpu"), pushed)
        fetched = t_masks.fetch_mask(pushed)
        assert fetched.dtype == np.bool_ and np.array_equal(fetched, m)
        assert t_masks.fetch_mask(m) is m
        assert np.array_equal(fetched, j_masks.fetch_mask(j_masks.push_mask(m)))


class TestStats:
    @pytest.mark.parametrize("x", [-1.0, 0.07, 0.1, 0.2, 5.0])
    def test_linear_step(self, x):
        args = (x, (0.07, 0.4), (0.2, 0.7))
        assert t_stats.linear_step(*args) == j_stats.linear_step(*args)
        assert t_stats.linear_step(x, args[2], args[1]) == j_stats.linear_step(x, args[2], args[1])

    @pytest.mark.parametrize("percent", [0.0, 0.004, 0.3, 0.7, 1.0, 1.5])
    def test_percentile_and_masked_percentile(self, percent):
        v = rng(4).random(300).astype(np.float32)
        m = rng(5).random(300) > 0.4
        assert t_stats.percentile(v, percent) == j_stats.percentile(v, percent)
        got = float(t_stats.masked_percentile(T(v), T(m), percent))
        assert got == float(j_stats.masked_percentile(jnp.asarray(v), jnp.asarray(m), percent))
        assert got == np.float32(t_stats.percentile(v[m], percent))

    @pytest.mark.parametrize("n", [0, 1, 7, 40])
    def test_trimmed_average(self, n):
        v = rng(6).random(n).astype(np.float32)
        a, b = t_stats.trimmed_average(v, 0.1, 0.9), j_stats.trimmed_average(v, 0.1, 0.9)
        assert (np.isnan(a) and np.isnan(b)) or a == b


class TestImage:
    def test_obscure_and_angles(self):
        x = rng(7).random((9, 11)).astype(np.float32)
        m = rng(8).random((9, 11)) > 0.5
        assert np.array_equal(t_image.obscure(T(x), T(m), 2.0).numpy(),
                              np.asarray(j_image.obscure(jnp.asarray(x), jnp.asarray(m), 2.0)))
        np.testing.assert_allclose(t_image.to_degrees(T(x)).numpy(),
                                   np.asarray(j_image.to_degrees(jnp.asarray(x))), rtol=1e-6)
        np.testing.assert_allclose(t_image.to_radians(T(x)).numpy(),
                                   np.asarray(j_image.to_radians(jnp.asarray(x))), rtol=1e-6)

    def test_host_helpers(self):
        x = rng(9).random((9, 11)).astype(np.float32)
        m = rng(10).random((9, 11)) > 0.5
        assert np.array_equal(t_image.partition_unobscured_obscured(x, m),
                              j_image.partition_unobscured_obscured(x, m))
        for bounds in ((1, 2, 8, 7), (-3, -3, 40, 40), (5, 5, 5, 9)):
            assert t_image.sub_cover_count(m, bounds) == j_image.sub_cover_count(m, bounds)
        assert t_image.at(x, 3, 2) == j_image.at(x, 3, 2)
        y = x.copy()
        t_image.set_at(y, 3, 2, 9.0)
        assert t_image.at(y, 3, 2) == 9.0


class TestBlur:
    @pytest.mark.parametrize("sigma", [1.0, 4.0, 0.4, 2.5])
    def test_strip_kernel_equal(self, sigma):
        assert np.array_equal(t_blur.strip_kernel(sigma), j_blur.strip_kernel(sigma))

    @pytest.mark.parametrize("sigma", [1.0, 4.0])
    @pytest.mark.parametrize("shape", [(64, 80), (17, 33), (3, 40, 41)])
    def test_gaussian_blur(self, sigma, shape):
        x = rng(11).random(shape).astype(np.float32)
        got = t_blur.gaussian_blur(T(x), sigma).numpy()
        assert_within_ulps(got, np.asarray(j_blur.gaussian_blur(jnp.asarray(x), sigma)), 2)
        # the numpy twin shares the code: equal bit for bit, to the port's
        # tensor blur and to the JAX package's twin
        host = t_blur.gaussian_blur_host(x, sigma)
        assert np.array_equal(got, host)
        assert np.array_equal(host, j_blur.gaussian_blur_host(x, sigma))

    def test_blur_of_a_mask_thresholds_alike(self):
        m = (rng(12).random((96, 128)) > 0.8).astype(np.float32)
        got = t_blur.gaussian_blur(T(m), 1.0).numpy() >= 0.1
        want = np.asarray(j_blur.gaussian_blur(jnp.asarray(m), 1.0)) >= 0.1
        assert np.array_equal(got, want)


class TestMorphology:
    @pytest.mark.parametrize("radius", [0, 1, 2, 5, 15, 22])
    def test_ellipse_kernel_and_chords(self, radius):
        k = t_morph.ellipse_kernel(radius)
        assert np.array_equal(k, j_morph.ellipse_kernel(radius))
        assert t_morph._kernel_chords(k) == j_morph._kernel_chords(k)

    @pytest.mark.parametrize("op", ["dilate", "erode", "close"])
    @pytest.mark.parametrize("radius,density", [(5, 0.97), (15, 0.995), (2, 0.6)])
    def test_binary_ops(self, op, radius, density):
        m = rng(13).random((90, 130)) > density
        got = getattr(t_morph, op)(T(m), radius).numpy()
        assert got.dtype == np.bool_
        assert np.array_equal(got, np.asarray(getattr(j_morph, op)(jnp.asarray(m), radius)))

    def test_batched_dilate(self):
        m = rng(14).random((3, 40, 50)) > 0.9
        got = t_morph.dilate(T(m), 4).numpy()
        assert np.array_equal(got, np.asarray(j_morph.dilate(jnp.asarray(m), 4)))

    @pytest.mark.parametrize("chords", [True, False])
    def test_count_conv(self, chords):
        m = rng(15).random((40, 50)) > 0.8
        k = np.ones((3, 5), np.uint8)
        if not chords:  # rows with gaps, and no symmetry: the convolution route
            k[1, 2] = k[0, 0] = k[2, 1] = k[2, 3] = 0
        assert (t_morph._kernel_chords(k) is not None) == chords
        got = t_morph._count_conv(T(m), k).numpy()
        assert np.array_equal(got, np.asarray(j_morph._count_conv(jnp.asarray(m), k)))

    @pytest.mark.parametrize("ksize,sigma", [(11, 0.0), (5, 1.2), (3, 0.0)])
    def test_cv_gaussian(self, ksize, sigma):
        assert np.array_equal(t_morph.cv_gaussian_kernel(ksize, sigma),
                              j_morph.cv_gaussian_kernel(ksize, sigma))
        x = rng(16).random((60, 70)).astype(np.float32)
        got = t_morph.cv_gaussian_blur(T(x), ksize, sigma).numpy()
        assert_within_ulps(got, np.asarray(j_morph.cv_gaussian_blur(jnp.asarray(x), ksize, sigma)), 2)

    def test_cleanup_blur_rounds_alike(self):
        m = (rng(17).random((80, 90)) > 0.9).astype(np.float32)
        got = torch.round(t_morph.cv_gaussian_blur(T(m), 11)).numpy() > 0
        want = np.asarray(jnp.round(j_morph.cv_gaussian_blur(jnp.asarray(m), 11))) > 0
        assert np.array_equal(got, want)


def nir_field(h, w, seed):
    """A correlated field with pits, in (0, 1)."""
    return (0.1 + 0.8 * smooth(h, w, seed)).astype(np.float32)


class TestPitFill:
    def test_min8_and_maxpool(self):
        x = rng(18).random((13, 17)).astype(np.float32)
        assert np.array_equal(t_pit._min8(T(x), 0.3).numpy(), np.asarray(j_pit._min8(jnp.asarray(x), 0.3)))
        for shape in ((13, 17), (8, 8), (1, 5)):
            y = rng(19).random(shape).astype(np.float32)
            assert np.array_equal(t_pit._maxpool2(T(y)).numpy(), np.asarray(j_pit._maxpool2(jnp.asarray(y))))

    @pytest.mark.parametrize("shape,border", [((200, 170), 0.45), ((64, 64), 0.5), ((131, 257), 0.3),
                                              ((40, 300), 0.6), ((96, 96), 0.0), ((96, 96), 1.0)])
    def test_pit_fill_equals_jax(self, shape, border):
        x = nir_field(*shape, seed=20)
        got = t_pit.pit_fill(T(x), border).numpy()
        assert np.array_equal(got, np.asarray(j_pit.pit_fill(jnp.asarray(x), border)))
        assert (got >= x).all()

    def test_white_noise_and_tensor_border(self):
        x = rng(21).random((150, 150)).astype(np.float32)
        got = t_pit.pit_fill(T(x), torch.tensor(0.4)).numpy()
        assert np.array_equal(got, np.asarray(j_pit.pit_fill(jnp.asarray(x), 0.4)))

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_pit_fill_equals_priority_flood(self, native_route):
        """The C++ priority flood where there is one; its other case holds
        the plain, unaccelerated fixpoint from all ones."""
        x = nir_field(180, 140, seed=22)
        got = t_pit.pit_fill(T(x), 0.45).numpy()
        flood = native.pit_fill_flood(x, 0.45)
        if native_route == "python":
            assert flood is None
            flood = t_pit._fixpoint(T(x), 0.45, torch.ones(x.shape)).numpy()
        assert np.array_equal(got, flood)

    def test_schedules_agree(self):
        """Any schedule that ends on a sweep that changes nothing gives the
        same surface: here a budget that is not a power of two, and the JAX
        package's host-driven schedule with its directional scans."""
        x = nir_field(150, 120, seed=23)
        want = t_pit.pit_fill(T(x), 0.45)
        assert np.array_equal(want.numpy(), np.asarray(j_pit.pit_fill_host(x, 0.45)))
        f, changed = T(np.ones_like(x)), True
        while changed:
            f, changed = t_pit._fixpoint_budget(T(x), 0.45, f.contiguous(), 7)
        assert torch.equal(f, t_pit._fixpoint(T(x), 0.45, torch.ones(x.shape)))

    @pytest.mark.parametrize("tiled", [False, True])
    def test_level_callback_reports_and_changes_nothing(self, monkeypatch, tiled):
        """``on_level`` sees every level, coarsest first, with the sweeps it
        queued and no directional cycle (none run on the CPU); the surface
        is the one without a callback."""
        if tiled:
            monkeypatch.setattr(t_pit, "_TILED_MIN_SIZE", 1)
            monkeypatch.setattr(t_pit, "_TILE", 32)
            monkeypatch.setattr(t_pit, "_HALO", 8)
        x = nir_field(200, 170, seed=24)
        levels = []
        got = t_pit.pit_fill(T(x), 0.45, on_level=lambda *a: levels.append(a))
        assert torch.equal(got, t_pit.pit_fill(T(x), 0.45))
        assert [lvl for lvl, _, _, _ in levels] == [2, 1, 0]
        assert [shape for _, shape, _, _ in levels] == [(50, 43), (100, 85), (200, 170)]
        for _, shape, rounds, cycles in levels:
            assert cycles == 0
            assert rounds and all(cells > 0 and count >= 1 for cells, count in rounds)
            if not tiled:  # whole-raster budgets: 8, 16, 32, then 64 sweeps of the level
                assert [cells for cells, _ in rounds] == [shape[0] * shape[1]] * len(rounds)
                assert [c for _, c in rounds] == [min(8 << i, 64) for i in range(len(rounds))]

    @pytest.mark.parametrize("tile,halo,share", [(32, 8, 0.6), (16, 16, 1.0), (64, 4, 0.0)])
    @pytest.mark.parametrize("shape", [(200, 170), (129, 300)])
    def test_active_tile_rounds(self, monkeypatch, tile, halo, share, shape):
        """The schedule of large levels, forced onto small ones: rounds over
        the active tiles only (share 1.0), whole-raster rounds only (0.0),
        and the mix, on rasters that are no whole number of tiles."""
        x = nir_field(*shape, seed=25)
        want = np.asarray(j_pit.pit_fill(jnp.asarray(x), 0.45))
        monkeypatch.setattr(t_pit, "_TILED_MIN_SIZE", 1)
        monkeypatch.setattr(t_pit, "_TILE", tile)
        monkeypatch.setattr(t_pit, "_HALO", halo)
        monkeypatch.setattr(t_pit, "_TILED_MAX_SHARE", share)
        assert np.array_equal(t_pit.pit_fill(T(x), 0.45).numpy(), want)
        noise = rng(26).random(shape).astype(np.float32)
        assert np.array_equal(t_pit.pit_fill(T(noise), torch.tensor(0.4)).numpy(),
                              np.asarray(j_pit.pit_fill(jnp.asarray(noise), 0.4)))


def region_dicts(regions):
    return [dataclasses.asdict(r) for r in regions]


class TestComponents:
    @pytest.mark.parametrize("connectivity", [4, 8])
    @pytest.mark.parametrize("density", [0.3, 0.6, 0.9])
    def test_connected_components(self, connectivity, density):
        m = rng(25).random((60, 80)) > density
        got = t_comp.connected_components(T(m), connectivity).numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got, np.asarray(j_comp.connected_components(jnp.asarray(m), connectivity)))

    def test_bad_connectivity(self):
        with pytest.raises(ValueError):
            t_comp.connected_components(torch.zeros((3, 3), dtype=torch.bool), 6)

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    @pytest.mark.parametrize("min_area", [1, 3, 20])
    def test_partition_regions(self, native_route, min_area):
        m = rng(26).random((70, 90)) > 0.62
        id_map, regions = t_comp.partition_regions(m, min_area, device="cpu")
        j_map, j_regions = j_comp.partition_regions(jnp.asarray(m), min_area)  # device route
        assert id_map.dtype == np.int32 and np.array_equal(id_map, j_map)
        assert region_dicts(regions) == region_dicts(j_regions) and len(regions) > 3
        # a tensor mask takes the label-propagation route whatever the library
        t_map, t_regions = t_comp.partition_regions(T(m), min_area)
        assert np.array_equal(t_map, id_map) and region_dicts(t_regions) == region_dicts(regions)

    def test_partition_regions_connectivity_4(self):
        m = rng(27).random((30, 40)) > 0.5
        id_map, regions = t_comp.partition_regions(m, 2, connectivity=4, device="cpu")
        j_map, j_regions = j_comp.partition_regions(m, 2, connectivity=4)
        assert np.array_equal(id_map, j_map) and region_dicts(regions) == region_dicts(j_regions)

    def test_empty_mask(self):
        id_map, regions = t_comp.partition_regions(torch.zeros((8, 9), dtype=torch.bool))
        assert regions == [] and (id_map == -1).all()

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_find_connected_components(self, native_route):
        m = rng(28).random((25, 30)) > 0.7
        got_map, got_regions = t_laplace.find_connected_components(m, min_area=2, device="cpu")
        want_map, want_regions = j_laplace.find_connected_components(m, min_area=2)
        assert np.array_equal(got_map, want_map) and got_regions == want_regions

    @pytest.mark.parametrize("entry", ["partition_regions", "find_connected_components"])
    def test_no_device_given_means_cuda(self, entry, monkeypatch):
        """Without the C++ flood a host mask is labelled on ``device``;
        ``None`` is the CUDA device and raises on a host that has none, it
        never falls back to the CPU."""
        from satellite_approximation_tpu_torch import native

        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        m = rng(29).random((12, 14)) > 0.6
        call = t_comp.partition_regions if entry == "partition_regions" else (
            t_laplace.find_connected_components)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(m)
        assert len(call(m, device="cpu")[1]) > 0


def angle_rasters(h, w, seed):
    r = rng(seed)
    gy, gx = np.ogrid[:h, :w]
    grad = (gy / h + gx / w).astype(np.float32)
    zen = (30.0 + 2.0 * grad + 0.01 * r.random((h, w))).astype(np.float32)
    azi = (140.0 + 3.0 * grad + 0.01 * r.random((h, w))).astype(np.float32)
    return zen, azi


class TestGeometry:
    def test_numpy_functions_equal(self):
        assert t_geo.haversine_distance((-114.0, 50.5), (-112.5, 51.5)) == j_geo.haversine_distance(
            (-114.0, 50.5), (-112.5, 51.5))
        assert t_geo.sides((90, 120), 12.0) == j_geo.sides((90, 120), 12.0)
        i, j = np.arange(5), np.arange(5)[::-1]
        pos = t_geo.pixel_to_world((90, 120), 12.0, i, j, 0.1, 0.9)
        assert np.array_equal(pos, j_geo.pixel_to_world((90, 120), 12.0, i, j, 0.1, 0.9))
        assert np.array_equal(t_geo.world_to_index((90, 120), 12.0, pos),
                              j_geo.world_to_index((90, 120), 12.0, pos))
        d = np.linspace(0, 30, 50)
        assert np.array_equal(t_geo.quadratic_radial_basis(d, 3.0, 20.0, 0.2),
                              j_geo.quadratic_radial_basis(d, 3.0, 20.0, 0.2))

    def test_quad_and_affine(self):
        c = rng(29).random((4, 3))
        m = np.eye(4)
        m[:3, 3] = (1.0, 2.0, 3.0)
        tq, jq = t_geo.Quad.from_corners(c), j_geo.Quad.from_corners(c)
        assert np.array_equal(tq.transform(m).corners(), jq.transform(m).corners())
        eye, p0, nrm = np.array([0.3, 0.2, 50.0]), np.zeros(3), np.array([0.0, 0.0, 1.0])
        assert np.array_equal(t_geo.perspective(tq, eye, p0, nrm).corners(),
                              j_geo.perspective(jq, eye, p0, nrm).corners())
        c2 = rng(30).random((4, 3))
        assert np.array_equal(t_geo.affine_transform(tq, t_geo.Quad.from_corners(c2)),
                              j_geo.affine_transform(jq, j_geo.Quad.from_corners(c2)))

    def test_grid_functions_equal(self):
        zen, azi = angle_rasters(24, 30, 31)
        grid = t_geo.vector_grid(np.radians(zen), np.radians(azi))
        assert np.array_equal(grid, j_geo.vector_grid(np.radians(zen), np.radians(azi)))
        shape, diag = (24, 30), 5.0
        for name, args in (("ls_point_equal_to", (785.0,)), ("ls_point", ()),
                           ("ls_point_greater_than", (10.0,)), ("ls_point_less_than", (900.0,))):
            got = getattr(t_geo, name)(grid, shape, diag, *args)
            assert np.array_equal(got, getattr(j_geo, name)(grid, shape, diag, *args)), name
        p = t_geo.ls_point(grid, shape, diag)
        assert t_geo.sum_of_square_distance(grid, shape, diag, p) == j_geo.sum_of_square_distance(
            grid, shape, diag, p)
        assert t_geo.average_dot_product(grid, shape, diag, p) == j_geo.average_dot_product(
            grid, shape, diag, p)
        assert np.array_equal(t_geo.average_direction(grid), j_geo.average_direction(grid))

    @pytest.mark.parametrize("z", [785.0, 1.5e9])
    @pytest.mark.parametrize("shape", [(64, 80), (130, 50)])
    def test_ls_point_device(self, z, shape):
        """Within 1e-6 relative of the JAX package's device reduction, of the
        host chunked one and of the f64 host solve."""
        zen, azi = angle_rasters(*shape, seed=32)
        got = t_geo.ls_point_equal_to_device(zen, azi, shape, 12.0, z, device="cpu")
        scale = np.abs(got).max()
        for want in (
            j_geo.ls_point_equal_to_device(zen, azi, shape, 12.0, z, quantize=False),
            t_geo.ls_point_equal_to_chunked(zen, azi, shape, 12.0, z, rows_per_chunk=17),
            t_geo.ls_point_equal_to(t_geo.vector_grid(np.radians(zen), np.radians(azi)), shape, 12.0, z),
        ):
            assert np.abs(got - want).max() <= 1e-6 * scale
        assert np.array_equal(
            t_geo.ls_point_equal_to_chunked(zen, azi, shape, 12.0, z),
            j_geo.ls_point_equal_to_chunked(zen, azi, shape, 12.0, z))
        # a tensor passes through, so an early upload gives the same point
        up = t_geo.upload_angles(zen, "cpu"), t_geo.upload_angles(azi, "cpu")
        assert np.array_equal(t_geo.ls_point_equal_to_device(*up, shape, 12.0, z), got)

    def test_quantized_upload_is_close_not_equal(self):
        zen, azi = angle_rasters(64, 80, 33)
        exact = t_geo._push_angles(zen, "cpu").numpy()
        assert np.array_equal(exact, zen)
        q = t_geo._push_angles(zen, "cpu", quantize=True).numpy()
        assert np.abs(q - zen).max() <= (zen.max() - zen.min()) / 65535.0
        got = t_geo.ls_point_equal_to_device(zen, azi, (64, 80), 12.0, 785.0, quantize=True, device="cpu")
        want = t_geo.ls_point_equal_to_device(zen, azi, (64, 80), 12.0, 785.0, device="cpu")
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_ops_exports():
    """The exports of the JAX package's ``ops`` beside ``fused_jacobi``."""
    from satellite_approximation_tpu import ops as j_ops

    theirs = set(j_ops.__all__) - {"fused_jacobi_tpu", "pallas_available"}
    assert theirs | {"fused_jacobi"} == set(t_ops_pkg.__all__)
    assert all(hasattr(t_ops_pkg, name) for name in t_ops_pkg.__all__)
