"""The five detection stages of the port (``models/detection``: cloud mask,
potential shadow mask, matching, host refinement, device refinement) against
the JAX package's, stage by stage on the CPU. One stage runs in the JAX
package, its output crosses as plain numpy (``interop``), and the next stage
runs in both packages on it. Masks, label maps, regions, similarities,
selected heights and histograms must be equal bit for bit; the f32 surfaces
(blended CLP, alpha, beta, the probability surface) within 2 ulp of their
scale (1.0: they are probabilities), and the masks thresholded from them
equal. Where a surface passes the port's C++ hole fill (f32 accumulation)
the tolerance against the Python one (f64) is 2e-6, the JAX package's own
between its two; the reference always runs the JAX package's Python routes.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from satellite_approximation_tpu import config as j_config
from satellite_approximation_tpu.models.detection import cloud_mask as j_cm
from satellite_approximation_tpu.models.detection import matching as j_match
from satellite_approximation_tpu.models.detection import refinement as j_ref
from satellite_approximation_tpu.models.detection import refinement_jax as j_refdev
from satellite_approximation_tpu.models.detection import shadow_mask as j_sm
from satellite_approximation_tpu.ops import geometry as j_geo
from satellite_approximation_tpu_torch import config as t_config
from satellite_approximation_tpu_torch import interop, native
from satellite_approximation_tpu_torch.models.detection import cloud_mask as t_cm
from satellite_approximation_tpu_torch.models.detection import matching as t_match
from satellite_approximation_tpu_torch.models.detection import refinement as t_ref
from satellite_approximation_tpu_torch.models.detection import refinement_torch as t_refdev
from satellite_approximation_tpu_torch.models.detection import shadow_mask as t_sm
from satellite_approximation_tpu_torch.ops import sweep_kernels
from satellite_approximation_tpu_torch.utils import profiling
from satellite_approximation_tpu_torch.utils.profiling import StageTimer
from torch_parity import (  # noqa: F401 — native_route is a fixture
    NATIVE_ROUTES,
    SWEEP_BUCKETS,
    SWEEP_KINDS,
    assert_within_ulps,
    bucket_scene,
    jax_package_without_native,
    match_scene,
    mini_diagonal,
    mini_scene,
    native_route,
    normalized,
    sweep_case,
    true_box_counts,
)

N = 192
DIAG = mini_diagonal(N)


def T(a):
    return torch.from_numpy(np.array(a))  # a copy: torch wants a writable buffer


def plain(obj):
    return dataclasses.asdict(obj)


def clouds_to_port(clouds):
    return [interop.cloud_object_from_dict(plain(c)) for c in clouds]


@pytest.fixture(scope="module")
def jax_stages():
    with jax_package_without_native():
        return _jax_stages()


def _jax_stages():
    """Every stage's output in the JAX package on ``mini_scene(N)``."""
    raw = mini_scene(N)
    x = normalized(raw)
    gen = j_cm.generate_cloud_mask_ignore_low_probability(x["clp"], x["cld"], x["scl"])
    psm = j_sm.generate_potential_shadow_mask(x["nir"], gen.cloud_mask_no_processing, x["scl"])
    cloud_map, clouds = j_cm.partition_cloud_mask(gen.cloud_mask_no_processing, DIAG, 3)
    shape = (N, N)
    sun = j_geo.ls_point_equal_to_chunked(
        raw["sunZenithAngles"], raw["sunAzimuthAngles"], shape, DIAG, 1.5e9)
    view = j_geo.ls_point_equal_to_chunked(
        raw["viewZenithMean"], raw["viewAzimuthMean"], shape, DIAG, 785.0)
    match = j_match.match_clouds_shadows(
        clouds, cloud_map, gen.cloud_mask_no_processing, psm.mask, DIAG, sun, view,
        j_config.MatchingConfig(backend="jax"))
    alpha = j_ref.alpha_map(psm.difference_of_pitfill_nir)
    beta = j_ref.beta_map(match.shadows, match.solutions, gen.blended_cloud_probability, DIAG)
    surface = j_ref.probability_map(match.shadow_mask, alpha, beta)
    final = j_ref.improved_shadow_mask(match.shadow_mask, gen.cloud_mask, alpha, beta, surface, 0.15)
    assert len(clouds) >= 4 and match.shadow_mask.any() and final.any()
    assert sum(s.window is not None for s in match.shadows.values()) >= 3
    return dict(raw=raw, x=x, gen=gen, psm=psm, cloud_map=cloud_map, clouds=clouds, sun=sun,
                view=view, match=match, alpha=alpha, beta=beta, surface=surface, final=final)


class TestCloudMask:
    def test_ignore_low_probability(self, jax_stages):
        x, want = jax_stages["x"], jax_stages["gen"]
        got = t_cm.generate_cloud_mask_ignore_low_probability(x["clp"], x["cld"], x["scl"], device="cpu")
        assert np.array_equal(got.cloud_mask, want.cloud_mask)
        assert np.array_equal(got.cloud_mask_no_processing, want.cloud_mask_no_processing)
        assert_within_ulps(got.blended_cloud_probability, want.blended_cloud_probability, 2, scale=1.0)
        dev = t_cm.generate_cloud_mask_ignore_low_probability(
            T(x["clp"]), T(x["cld"]), T(x["scl"]), device_output=True)
        assert isinstance(dev.cloud_mask, torch.Tensor)
        assert np.array_equal(dev.cloud_mask.numpy(), got.cloud_mask)

    def test_low_probability_inclusive(self, jax_stages):
        x = jax_stages["x"]
        got = t_cm.generate_cloud_mask(x["clp"], x["cld"], x["scl"], device="cpu")
        want = j_cm.generate_cloud_mask(x["clp"], x["cld"], x["scl"])
        assert np.array_equal(got.cloud_mask, want.cloud_mask) and got.cloud_mask.any()
        assert_within_ulps(got.blended_cloud_probability, want.blended_cloud_probability, 2, scale=1.0)

    def test_random_rasters(self):
        """Threshold-dense inputs: blurred CLP around 0.5 nearly everywhere."""
        r = np.random.default_rng(40)
        clp = (r.integers(0, 256, (96, 128)).astype(np.uint8)).astype(np.float32) / np.float32(255)
        cld = (r.integers(0, 101, (96, 128)).astype(np.uint8)).astype(np.float32) / np.float32(100)
        scl = r.integers(0, 12, (96, 128)).astype(np.uint8)
        got = t_cm.generate_cloud_mask_ignore_low_probability(clp, cld, scl, device="cpu")
        want = j_cm.generate_cloud_mask_ignore_low_probability(clp, cld, scl)
        assert np.array_equal(got.cloud_mask_no_processing, want.cloud_mask_no_processing)
        assert np.array_equal(got.cloud_mask, want.cloud_mask)

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_partition(self, jax_stages, native_route):
        mask = jax_stages["gen"].cloud_mask_no_processing
        cloud_map, clouds = t_cm.partition_cloud_mask(mask, DIAG, 3, device="cpu")
        assert np.array_equal(cloud_map, jax_stages["cloud_map"])
        assert len(clouds) == len(jax_stages["clouds"])
        for got, want in zip(clouds, jax_stages["clouds"]):
            g, w = plain(got), plain(want)
            assert np.array_equal(got.quad.corners(), want.quad.corners())
            g.pop("quad"), w.pop("quad")
            assert g == w
        t_map, _ = t_cm.partition_cloud_mask(T(mask), DIAG, 3)
        assert np.array_equal(t_map, cloud_map)


class TestShadowMask:
    @pytest.mark.parametrize("percent", [0.0, 0.001, 0.3, 0.4, 0.55, 0.7, 1.0])
    @pytest.mark.parametrize("keep", [0.0, 0.02, 0.5, 1.0])
    def test_dynamic_percentile(self, percent, keep):
        r = np.random.default_rng(41)
        v = r.random((60, 70)).astype(np.float32)
        m = r.random((60, 70)) < keep
        got = t_sm._dynamic_percentile(T(v), T(m), torch.tensor(percent, dtype=torch.float32))
        want = j_sm._dynamic_percentile(jnp.asarray(v), jnp.asarray(m), jnp.float32(percent))
        assert got.dtype == torch.float32 and float(got) == float(want)

    @pytest.mark.parametrize("cover", [0.02, 0.1, 0.15, 0.4])
    def test_percentile_rank_follows_cloud_cover(self, jax_stages, cover):
        """The linear ramp between the cloud covers 0.07 and 0.2, in f32."""
        x = jax_stages["x"]
        r = np.random.default_rng(42)
        cloud = r.random((N, N)) < cover
        got, _ = t_sm._psm_pre(T(x["nir"]), T(cloud), T(x["scl"]), t_config.ShadowMaskConfig())
        want, _ = j_sm._psm_pre(jnp.asarray(x["nir"]), jnp.asarray(cloud), jnp.asarray(x["scl"]),
                                j_config.ShadowMaskConfig())
        assert float(got) == float(want)

    def test_small_scene_route(self, jax_stages):
        x, want = jax_stages["x"], jax_stages["psm"]
        cloud = jax_stages["gen"].cloud_mask_no_processing
        got = t_sm.generate_potential_shadow_mask(x["nir"], cloud, x["scl"], device="cpu")
        assert isinstance(got.mask, np.ndarray) and got.mask.any()
        assert np.array_equal(got.mask, want.mask)
        assert np.array_equal(got.pitfill_result, want.pitfill_result)
        assert np.array_equal(got.difference_of_pitfill_nir, want.difference_of_pitfill_nir)
        dev = t_sm.generate_potential_shadow_mask(T(x["nir"]), T(cloud), T(x["scl"]), device_output=True)
        assert isinstance(dev.mask, torch.Tensor) and np.array_equal(dev.mask.numpy(), want.mask)

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_big_scene_routes(self, jax_stages, native_route, monkeypatch):
        """With the big-scene gate forced down, a host raster takes the
        host-native route where the library is, else the device route that
        keeps its f32 rasters as tensors; both equal the small-scene route."""
        monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
        x, want = jax_stages["x"], jax_stages["psm"]
        cloud = jax_stages["gen"].cloud_mask_no_processing
        got = t_sm.generate_potential_shadow_mask(x["nir"], cloud, x["scl"], device="cpu")
        host_route = native_route == "native" and shutil.which("g++") is not None
        assert isinstance(got.pitfill_result, np.ndarray) == host_route
        assert isinstance(got.mask, np.ndarray)
        assert np.array_equal(got.mask, want.mask)
        assert np.array_equal(np.asarray(got.pitfill_result), want.pitfill_result)
        assert np.array_equal(np.asarray(got.difference_of_pitfill_nir), want.difference_of_pitfill_nir)


def assert_same_match(got, want):
    assert np.array_equal(got.shadow_mask, want.shadow_mask)
    a, b = got.trimmed_mean_height, want.trimmed_mean_height
    assert (np.isnan(a) and np.isnan(b)) or a == b
    assert got.solutions.keys() == want.solutions.keys()
    for k, w in want.solutions.items():
        g = got.solutions[k]
        assert (g.height, g.similarity, g.id) == (w.height, w.similarity, w.id)
        assert np.array_equal(g.M, w.M)
        gs, ws = got.shadows[k], want.shadows[k]
        assert (gs.bounds, gs.area, gs.anchor) == (ws.bounds, ws.area, ws.anchor)
        if ws.window is not None:
            # the native scan's windows are exact, the sweep's padded to the bucket
            h, w_ = min(gs.window.shape[0], ws.window.shape[0]), min(gs.window.shape[1], ws.window.shape[1])
            assert np.array_equal(gs.window[:h, :w_], ws.window[:h, :w_])
            assert gs.window.sum() == ws.window.sum()


class TestMatching:
    def test_height_sweep_and_buckets(self):
        assert np.array_equal(t_match.height_sweep(t_config.MatchingConfig()),
                              j_match.height_sweep(j_config.MatchingConfig()))
        assert t_match._BUCKETS == j_match._BUCKETS
        assert [t_match._bucket_size(n) for n in (1, 8, 9, 700, 4096)] == [
            j_match._bucket_size(n) for n in (1, 8, 9, 700, 4096)]
        # past the largest the JAX package stops (and scans such windows on
        # its native backend); the port's sweeps take the next power of two
        assert j_match._bucket_size(5000) == 4096
        assert [t_match._bucket_size(n) for n in (4097, 5000, 8192, 10980)] == [
            8192, 8192, 8192, 16384]

    def test_cast_transforms(self, jax_stages):
        heights = np.array([0.5, 2.0, 7.5])
        args = (heights, (N, N), DIAG, jax_stages["sun"], jax_stages["view"])
        got = t_match._cast_transforms(clouds_to_port(jax_stages["clouds"]), *args)
        want = j_match._cast_transforms(jax_stages["clouds"], *args)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert all(np.array_equal(g, w) for g, w in zip(got[2], want[2]))
        assert np.array_equal(got[3], want[3])

    @pytest.mark.parametrize("backend", ["native", "torch"])
    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_match_equals_jax(self, jax_stages, backend, native_route):
        """Both backends (the native one falls back to nothing without the
        library: then "auto" must take the sweep)."""
        if backend == "native" and not native.available():
            backend = "auto"
        s = jax_stages
        got = t_match.match_clouds_shadows(
            clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
            s["psm"].mask, DIAG, s["sun"], s["view"], t_config.MatchingConfig(backend=backend),
            device="cpu")
        assert_same_match(got, s["match"])
        accepted = [v for v in got.solutions.values() if v.similarity >= 0.3]
        assert len(accepted) >= 3

    def test_tensor_inputs(self, jax_stages):
        s = jax_stages
        got = t_match.match_clouds_shadows(
            clouds_to_port(s["clouds"]), s["cloud_map"], T(s["gen"].cloud_mask_no_processing),
            T(s["psm"].mask), DIAG, s["sun"], s["view"], t_config.MatchingConfig(backend="torch"))
        assert_same_match(got, s["match"])

    def _sweep_operands(self, s, heights):
        clouds = s["clouds"]
        a2, delta, (mnx, mxx, mny, mxy), _ = j_match._cast_transforms(
            clouds, heights, (N, N), DIAG, s["sun"], s["view"])
        ext = int(max((mxx - mnx + 1).max(), (mxy - mny + 1).max()))
        wb = hb = j_match._bucket_size(ext)
        pf = wb
        pad = ((pf, hb), (pf, wb))
        rasters = (np.pad(np.flipud(s["gen"].cloud_mask_no_processing), pad),
                   np.pad(np.flipud(s["psm"].mask), pad),
                   np.pad(np.flipud(s["cloud_map"]).astype(np.int32), pad, constant_values=-2))
        ids = np.asarray([c.id for c in clouds], np.int32)
        hm = dict(min_x=mnx.T.astype(np.int32), min_y=mny.T.astype(np.int32),
                  max_x=mxx.T.astype(np.int32), max_y=mxy.T.astype(np.int32),
                  a2=np.swapaxes(a2, 0, 1).astype(np.float32),
                  delta=np.swapaxes(delta, 0, 1).astype(np.float32))
        return rasters, ids, hm, dict(wb=wb, hb=hb, width=N, height=N, pf=pf)

    def test_bucket_sweep_and_detail_equal_jax(self, jax_stages):
        """Every (height, cloud) similarity of one pass, from both forms of
        the sweep, and the detail pass at a fixed height."""
        heights = j_match.height_sweep(j_config.MatchingConfig())[::37]
        rasters, ids, hm, static = self._sweep_operands(jax_stages, heights)
        want = np.asarray(j_match._bucket_sweep(
            *map(jnp.asarray, rasters), jnp.asarray(ids), **{k: jnp.asarray(v) for k, v in hm.items()},
            **static, min_support=5))
        tens = [T(r) for r in rasters]
        targs = {k: T(v) for k, v in hm.items()}
        got = t_match._bucket_sweep(*tens, T(ids), **targs, **static, min_support=5)
        sep = t_match._bucket_sweep_sep(*tens, T(ids), **targs, **static, min_support=5)
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(sep.numpy(), want)
        assert (want > 0.3).any()

        at = {k: v[3] for k, v in hm.items()}
        j_det = j_match._bucket_detail(
            *map(jnp.asarray, rasters), jnp.asarray(ids), **{k: jnp.asarray(v) for k, v in at.items()},
            **static)
        t_det = t_match._bucket_detail(*tens, T(ids), **{k: T(v) for k, v in at.items()}, **static)
        jt, jc, jpacked, *jb = (np.asarray(v) for v in j_det)
        tt, tc, thit, *tb = (v.numpy() for v in t_det)
        assert np.array_equal(tt, jt) and np.array_equal(tc, jc)
        assert np.array_equal(thit, np.unpackbits(jpacked, axis=-1).astype(bool))
        hit_any = jc > 0  # bounds of an empty hit set are sentinels of either sign
        for g, w in zip(tb, jb):
            assert np.array_equal(g[hit_any], w[hit_any])

    def test_sep_metadata_equal_jax_and_rejects_shear(self, jax_stages):
        heights = j_match.height_sweep(j_config.MatchingConfig())[::53]
        _, _, hm, static = self._sweep_operands(jax_stages, heights)
        args = (hm["a2"], hm["delta"], hm["min_x"], hm["min_y"])
        size = (static["wb"], static["hb"])

        def both(a2):
            """The port's verdicts (all it keeps of the reference's five
            results) beside the reference's."""
            got = t_match._sep_metadata(T(a2), *map(T, args[1:]), *size)
            assert got.dtype == torch.bool
            return got.numpy(), j_match._sep_metadata(a2, *args[1:], *size, N, N)[0]

        got, want = both(hm["a2"])
        assert got.all() and np.array_equal(got, want)
        for (i, j), shear in (((0, 1), 0.01), ((1, 0), -0.02)):
            sheared = hm["a2"].copy()
            sheared[..., i, j] = shear
            got, want = both(sheared)
            assert not got.any() and np.array_equal(got, want)
        # a shear too small to move any cast position is vouched for all the same
        tiny = hm["a2"].copy()
        tiny[..., 0, 1] = 1e-12
        got, want = both(tiny)
        assert got.all() and np.array_equal(got, want)

    def test_general_sweep_when_not_separable(self, jax_stages, monkeypatch):
        s = jax_stages
        monkeypatch.setattr(t_match, "_sep_metadata", lambda *a: torch.zeros(1, dtype=torch.bool))
        got = t_match.match_clouds_shadows(
            clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
            s["psm"].mask, DIAG, s["sun"], s["view"], t_config.MatchingConfig(backend="torch"),
            device="cpu")
        assert_same_match(got, s["match"])

    def test_passes_and_groups_do_not_change_the_result(self, jax_stages, monkeypatch):
        """Small cell budgets: many cloud groups, one height a pass."""
        s = jax_stages
        monkeypatch.setattr(t_match, "_SWEEP_GROUP_CELLS", 1 << 8)
        monkeypatch.setattr(t_match, "_SWEEP_PASS_CELLS", 1 << 10)
        got = t_match.match_clouds_shadows(
            clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
            s["psm"].mask, DIAG, s["sun"], s["view"],
            t_config.MatchingConfig(backend="torch", height_chunk=3), device="cpu")
        assert_same_match(got, s["match"])

    def test_sweep_fn_hook(self, jax_stages):
        s, calls = jax_stages, []

        def sweep(*args, **kwargs):
            calls.append(kwargs["wb"])
            return t_match._bucket_sweep(*args, **kwargs)

        got = t_match.match_clouds_shadows(
            clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
            s["psm"].mask, DIAG, s["sun"], s["view"], t_config.MatchingConfig(backend="native"),
            sweep_fn=sweep, device="cpu")
        assert calls and got.solutions.keys() == s["match"].solutions.keys()
        assert_same_match(got, s["match"])

    @pytest.mark.parametrize("border", [False, True])
    @pytest.mark.parametrize("backend", ["native", "torch"])
    def test_rectangular_clouds(self, border, backend):
        """Rectangular clouds with a shadow field that the height sweep
        finds, one of them touching the image border."""
        if backend == "native" and not native.available():
            backend = "auto"
        mask, psm, sun, view, diag = match_scene(shift=(-3, -5), border=border, seed=11)
        j_map, j_clouds = j_cm.partition_cloud_mask(mask, diag, 3)
        want = j_match.match_clouds_shadows(j_clouds, j_map, mask, psm, diag, sun, view,
                                            j_config.MatchingConfig(backend="jax"))
        t_map, t_clouds = t_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
        got = t_match.match_clouds_shadows(t_clouds, t_map, mask, psm, diag, sun, view,
                                           t_config.MatchingConfig(backend=backend), device="cpu")
        assert_same_match(got, want)
        assert len(t_clouds) == 3 + border

    def test_no_clouds(self):
        mask = np.zeros((40, 50), bool)
        got = t_match.match_clouds_shadows([], np.full((40, 50), -1, np.int32), mask, mask, 5.0,
                                           np.array([1.0, 1.0, 1e9]), np.array([0.0, 0.0, 785.0]),
                                           device="cpu")
        assert got.solutions == {} and not got.shadow_mask.any()
        assert np.isnan(got.trimmed_mean_height)

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_oversized_window(self, jax_stages, native_route, monkeypatch):
        """A cloud wider than the largest bucket stays in the sweep, in a
        bucket of the next power of two, and is never truncated: the JAX
        package's results (which scans such windows natively), with or
        without the library, and no native scan in the route."""
        s = jax_stages
        monkeypatch.setattr(t_match, "_BUCKETS", (8, 16))
        args = (clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
                s["psm"].mask, DIAG, s["sun"], s["view"], t_config.MatchingConfig(backend="torch"))
        timer = StageTimer()
        got = t_match.match_clouds_shadows(*args, timer=timer, device="cpu")
        assert_same_match(got, s["match"])
        assert timer.routes["matching"] == "device sweep (cpu)"
        names = [name for name, _ in timer.stages]
        assert not any(n.startswith("matching/native scan") for n in names)
        assert any(int(n.split()[1].split("x")[0]) > 16 for n in names
                   if n.startswith("matching/sweep "))


def assert_identical_match(got, want):
    """Two runs of the device sweep: every result equal, the windows (padded
    to the same bucket) too."""
    assert_same_match(got, want)
    for k, w in want.shadows.items():
        g = got.shadows[k]
        assert (g.window is None) == (w.window is None)
        if w.window is not None:
            assert np.array_equal(g.window, w.window)


MATCH_SCENES = ["mini_scene", "match_scene", "match_scene_border", "bucket_scene"]


def _match_inputs(name, s):
    """(clouds, cloud map, cloud mask, potential shadows, diagonal, sun,
    view) of a scene: ``mini_scene(N)``'s stages, or a synthetic matching
    scene partitioned by the port."""
    if name == "mini_scene":
        return (clouds_to_port(s["clouds"]), s["cloud_map"], s["gen"].cloud_mask_no_processing,
                s["psm"].mask, DIAG, s["sun"], s["view"])
    if name == "bucket_scene":
        mask, psm, sun, view, diag = bucket_scene()
    else:
        mask, psm, sun, view, diag = match_scene(shift=(-3, -5), border=name.endswith("border"),
                                                 seed=11)
    cmap, clouds = t_cm.partition_cloud_mask(mask, diag, 3, device="cpu")
    return clouds, cmap, mask, psm, diag, sun, view


def _buckets(inputs, config):
    """{(wb, hb): clouds} of the sweep, from the cast transforms alone."""
    clouds, _, mask, _, diag, sun, view = inputs
    heights = t_match.height_sweep(config)
    _, _, (mnx, mxx, mny, mxy), _ = t_match._cast_transforms(
        clouds, heights, mask.shape, diag, sun, view)
    out: dict = {}
    for k in range(len(clouds)):
        key = (t_match._bucket_size(int((mxx[k] - mnx[k] + 1).max())),
               t_match._bucket_size(int((mxy[k] - mny[k] + 1).max())))
        out[key] = out.get(key, 0) + 1
    return out, int(((mxx - mnx + 1) * (mxy - mny + 1)).sum()), len(heights)


class TestWholeBucketSweep:
    """Where kernel 11 sweeps (a CUDA device), a bucket goes in one pass over
    all its clouds and heights. Forced on the CPU (``_whole_bucket``),
    ``_bucket_sweep`` runs the torch form through the same dispatch point:
    the results must be those of the groups and passes."""

    @pytest.mark.parametrize("budget", ["default", "small"])
    @pytest.mark.parametrize("scene", MATCH_SCENES)
    def test_one_pass_a_bucket_equals_groups_and_passes(self, jax_stages, scene, budget,
                                                         monkeypatch):
        inputs = _match_inputs(scene, jax_stages)
        config = t_config.MatchingConfig(backend="torch")
        if budget == "small":  # a cloud group a cloud, a height a pass
            monkeypatch.setattr(t_match, "_SWEEP_GROUP_CELLS", 1 << 8)
            monkeypatch.setattr(t_match, "_SWEEP_PASS_CELLS", 1 << 10)
        want = t_match.match_clouds_shadows(*inputs, config, device="cpu")
        if scene == "mini_scene":
            assert_same_match(want, jax_stages["match"])

        calls, real = [], t_match._bucket_sweep

        def recording(*args, **kwargs):
            calls.append((kwargs["wb"], kwargs["hb"], tuple(kwargs["min_x"].shape)))
            return real(*args, **kwargs)

        def no_pinch_check(*args):
            raise AssertionError("the one-pass route takes no separability verdict")

        monkeypatch.setattr(t_match, "_whole_bucket", lambda dev: True)
        monkeypatch.setattr(t_match, "_bucket_sweep", recording)
        monkeypatch.setattr(t_match, "_sep_metadata", no_pinch_check)
        got = t_match.match_clouds_shadows(*inputs, config, device="cpu")
        assert_identical_match(got, want)
        buckets, _, nh = _buckets(inputs, config)
        assert sorted(calls) == sorted((wb, hb, (nh, n)) for (wb, hb), n in buckets.items())
        if scene == "bucket_scene":
            assert len(buckets) == 6 and got.shadow_mask.any()

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_oversized_windows_keep_their_route(self, native_route, monkeypatch):
        """Clouds wider than the largest bucket keep the sweep's route on the
        one-pass route (kernel 11's) and on the groups and passes (the torch
        form's), in buckets of the next power of two, with or without the
        library: both identical to the sweep with the default buckets, where
        no window passes the largest."""
        args = (*_match_inputs("bucket_scene", None), t_config.MatchingConfig(backend="torch"))
        want = t_match.match_clouds_shadows(*args, device="cpu")
        monkeypatch.setattr(t_match, "_BUCKETS", (8, 16))
        for whole in (False, True):
            monkeypatch.setattr(t_match, "_whole_bucket", lambda dev, whole=whole: whole)
            timer = StageTimer()
            got = t_match.match_clouds_shadows(*args, timer=timer, device="cpu")
            assert_identical_match(got, want)
            assert timer.routes["matching"] == "device sweep (cpu)"
            names = [name for name, _ in timer.stages]
            assert not any(n.startswith("matching/native scan") for n in names)
            sweeps = sorted(n for n in names if n.startswith("matching/sweep "))
            assert len(sweeps) == 6 and sum(int(n.rsplit("=", 1)[1]) for n in sweeps) == 6
            assert {"matching/sweep 16x8 n=1", "matching/sweep 8x16 n=1",
                    "matching/sweep 8x8 n=1"} < set(sweeps)

    @pytest.mark.parametrize("whole", [False, True], ids=["passes", "one-pass"])
    @pytest.mark.parametrize("scene", ["mini_scene", "bucket_scene"])
    def test_sweep_spans_count_pairs_cells_and_kernel(self, jax_stages, scene, whole,
                                                      monkeypatch):
        """Each bucket's sweep span records the pairs it swept, the cells of
        their true boxes, whether kernel 11 ran (0 for the torch form) and
        the clouds past the largest bucket (none here): summed a call, every
        (height, cloud) pair and every box cell once, on either route."""
        inputs = _match_inputs(scene, jax_stages)
        config = t_config.MatchingConfig(backend="torch")
        monkeypatch.setattr(t_match, "_whole_bucket", lambda dev: whole)
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.call("detect"):
                t_match.match_clouds_shadows(*inputs, config, device="cpu")
        spans = [r for r in profiling.records() if r.name == "detect.matching/sweep"]
        profiling.clear()
        buckets, cells, nh = _buckets(inputs, config)
        assert spans and all(r.counts["kernel"] == 0 for r in spans)
        assert all(r.counts["oversized"] == 0 for r in spans)
        assert sum(r.counts["pairs"] for r in spans) == nh * len(inputs[0])
        assert sum(r.counts["cells"] for r in spans) == cells
        if whole:
            assert len(spans) == len(buckets)


class TestSweepKernelAlgorithm:
    """Kernel 11's algorithm (``csrc/sweep.cu``) written out in numpy
    (``torch_parity.true_box_counts``: each pair over its true box clipped
    to the bucket, the cast rounded op by op) against the torch form: the
    same counts and similarities. The card tests hold the kernel itself to
    the torch form."""

    @pytest.mark.parametrize("kind", SWEEP_KINDS)
    @pytest.mark.parametrize("bucket", SWEEP_BUCKETS[:3], ids=lambda b: f"{b[0]}x{b[1]}")
    def test_true_box_walk_equals_torch_form(self, bucket, kind):
        rasters, ids, pairs, static = sweep_case(*bucket, kind, seed=sum(bucket))
        t, c = true_box_counts(rasters, ids, pairs, **static)
        got = t_match._bucket_sweep(*map(T, rasters), T(ids), **{k: T(v) for k, v in pairs.items()},
                                    **static, min_support=5)
        want = t_match._similarity(T(t), T(c), 5)
        assert np.array_equal(got.numpy(), want.numpy())
        assert t.max() > 0 or kind in ("sparse", "absent")
        if kind == "sparse":
            assert (t < 5).any()
        if kind == "absent":
            assert (t[:, -1] == 0).all()

    def test_kernel_takes_cuda_operands_only(self):
        rasters, ids, pairs, static = sweep_case(8, 8, "separable")
        args = (*map(T, rasters), T(ids), *(T(pairs[k]) for k in
                                            ("min_x", "min_y", "max_x", "max_y", "a2", "delta")))
        with pytest.raises(ValueError, match="CUDA operands"):
            sweep_kernels.pair_counts(*args, **static)
        with pytest.raises(TypeError, match="dtype"):
            sweep_kernels.pair_counts(args[0].to(torch.int32), *args[1:], **static)
        with pytest.raises(ValueError, match="shape"):
            sweep_kernels.pair_counts(*args[:4], args[4][:1], *args[5:], **static)


class TestHostRefinement:
    def test_alpha_beta(self, jax_stages):
        s = jax_stages
        assert np.array_equal(t_ref.alpha_map(s["psm"].difference_of_pitfill_nir), s["alpha"])
        shadows = {k: interop.shadow_object_from_dict(plain(v)) for k, v in s["match"].shadows.items()}
        sols = {k: interop.solution_from_dict(plain(v)) for k, v in s["match"].solutions.items()}
        got = t_ref.beta_map(shadows, sols, s["gen"].blended_cloud_probability, DIAG)
        assert np.array_equal(got, s["beta"]) and got.max() > 0

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    @pytest.mark.parametrize("big", [False, True])
    def test_surface_and_final_mask(self, jax_stages, native_route, big, monkeypatch):
        """The small-scene numpy route and the big-scene route (one-pass
        native histograms and sampling where the library is)."""
        s = jax_stages
        if big:
            monkeypatch.setattr(t_config, "BIG_SCENE_PIXELS", 1)
        surface = t_ref.probability_map(s["match"].shadow_mask, s["alpha"], s["beta"])
        if native_route == "python":
            assert np.array_equal(surface.data, s["surface"].data)
        else:
            np.testing.assert_allclose(surface.data, s["surface"].data, rtol=0, atol=2e-6)
        # the sampling stage, from the reference's surface
        surface.data = s["surface"].data
        final = t_ref.improved_shadow_mask(
            s["match"].shadow_mask, s["gen"].cloud_mask, s["alpha"], s["beta"], surface, 0.15)
        assert np.array_equal(final, s["final"])

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_border_mask_and_hole_fill(self, native_route):
        r = np.random.default_rng(43)
        m = r.random((12, 15)) > 0.4
        assert np.array_equal(t_ref._border_mask(m), j_ref._border_mask(m))
        counts = r.integers(0, 3, (16, 16)) * (r.random((16, 16)) > 0.5)
        sums = np.minimum(counts, r.integers(0, 3, (16, 16))).astype(np.float64)
        got = t_ref.element_from_histogram(counts, sums)
        with jax_package_without_native():
            want = j_ref.element_from_histogram(counts, sums)
        if native_route == "python":
            assert np.array_equal(got.data, want.data)
        else:
            np.testing.assert_allclose(got.data, want.data, rtol=0, atol=2e-6)


class TestDeviceRefinement:
    def test_alpha(self, jax_stages):
        diff = jax_stages["psm"].difference_of_pitfill_nir
        got = t_refdev.alpha_map(diff, device="cpu")
        assert isinstance(got, torch.Tensor)
        assert_within_ulps(got, np.asarray(j_refdev.alpha_map_jax(diff)), 2, scale=1.0)
        assert_within_ulps(got, jax_stages["alpha"], 2, scale=1.0)

    @pytest.mark.parametrize("band", [None, 4, 16])
    def test_edt(self, band):
        r = np.random.default_rng(44)
        seeds = r.random((40, 48)) > 0.97
        got = t_refdev._edt_sq(T(seeds), 36, 45, band=band).numpy()
        want = np.asarray(j_refdev._edt_sq(jnp.asarray(seeds), 36, 45, band=band))
        assert np.array_equal(got, want)
        cut = seeds.copy()
        cut[36:, :] = cut[:, 45:] = False
        exact = ndimage.distance_transform_edt(~cut) ** 2
        near = exact <= (band or 10**6) ** 2
        assert np.array_equal(got[near], np.rint(exact[near]).astype(np.int32))
        both = t_refdev._edt_sq(T(np.stack([seeds, seeds[::-1]])), torch.tensor([36, 40])[:, None, None],
                                torch.tensor([45, 48])[:, None, None], band=band)
        assert np.array_equal(both[0].numpy(), got)

    def test_beta(self, jax_stages, monkeypatch):
        s = jax_stages
        shadows = {k: interop.shadow_object_from_dict(plain(v)) for k, v in s["match"].shadows.items()}
        sols = {k: interop.solution_from_dict(plain(v)) for k, v in s["match"].solutions.items()}
        clp = s["gen"].blended_cloud_probability
        got = t_refdev.beta_map(shadows, sols, clp, DIAG, device="cpu")
        want = j_refdev.beta_map_jax(s["match"].shadows, s["match"].solutions, clp, DIAG)
        assert_within_ulps(got, want, 2, scale=1.0)
        assert_within_ulps(got, s["beta"], 2, scale=1.0)
        assert got.max() > 0
        dev = t_refdev.beta_map(shadows, sols, T(clp), DIAG, device_output=True)
        assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), got)
        monkeypatch.setattr(t_refdev, "_BETA_BATCH_CELLS", 1)  # one shadow a batch
        assert np.array_equal(t_refdev.beta_map(shadows, sols, clp, DIAG, device="cpu"), got)

    def test_beta_without_shadows(self):
        got = t_refdev.beta_map({}, {}, np.zeros((20, 30), np.float32), 3.0, device="cpu")
        assert got.shape == (20, 30) and not got.any()

    @pytest.mark.parametrize("divisions", [(8, 16, 32, 64, 128), (6, 10, 20), (128,)])
    def test_histograms(self, jax_stages, divisions):
        """int32 cells: equal to the JAX package's and to numpy bincounts."""
        s = jax_stages
        shadow = s["match"].shadow_mask
        got = t_refdev._histograms(T(s["alpha"]), T(s["beta"]), T(shadow), divisions)
        want = j_refdev._histograms_jax(jnp.asarray(s["alpha"]), jnp.asarray(s["beta"]),
                                        jnp.asarray(shadow, jnp.float32), divisions)
        for (gc, gs), (wc, ws), d in zip(got, want, divisions):
            assert gc.dtype == torch.int32 and gs.dtype == torch.int32
            assert np.array_equal(gc.numpy(), np.asarray(wc)) and np.array_equal(gs.numpy(), np.asarray(ws))
            assert int(gc.sum()) == shadow.size and int(gs.sum()) == int(shadow.sum())
        valid = np.zeros(shadow.shape, bool)
        valid[: N // 2] = True
        half = t_refdev._histograms(T(s["alpha"]), T(s["beta"]), T(shadow), divisions, valid=T(valid))
        assert int(half[0][0].sum()) == valid.sum()

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_surface_and_final_mask(self, jax_stages, native_route):
        s = jax_stages
        surface = t_refdev.probability_map(s["match"].shadow_mask, s["alpha"], s["beta"], device="cpu")
        with jax_package_without_native():
            want = j_refdev.probability_map_jax(s["match"].shadow_mask, s["alpha"], s["beta"])
        for ref in (want.data, s["surface"].data):
            if native_route == "python":
                assert_within_ulps(surface.data, ref, 2, scale=1.0)
            else:
                np.testing.assert_allclose(surface.data, ref, rtol=0, atol=2e-6)
        surface.data = s["surface"].data  # the sampling stage, from the reference's surface
        final = t_refdev.improved_shadow_mask(
            s["match"].shadow_mask, s["gen"].cloud_mask, s["alpha"], s["beta"], surface, 0.15,
            device="cpu")
        assert final.dtype == np.bool_ and np.array_equal(final, s["final"])
        dev = t_refdev.improved_shadow_mask(
            T(s["match"].shadow_mask), T(s["gen"].cloud_mask), T(s["alpha"]), T(s["beta"]), surface,
            0.15, device_output=True)
        assert isinstance(dev, torch.Tensor) and np.array_equal(dev.numpy(), final)

    def test_sampling_on_random_inputs(self):
        """Alpha and beta over all of [0, 1], the cell-snapping roundf
        included."""
        r = np.random.default_rng(45)
        a = r.random((80, 90)).astype(np.float32)
        b = r.random((80, 90)).astype(np.float32)
        a[0, :5] = (0.0, 1.0, 0.5, 0.001953125, 0.998046875)
        obj = r.random((80, 90)) > 0.9
        cloud = r.random((80, 90)) > 0.8
        with jax_package_without_native():
            surface = j_ref.probability_map(obj, a, b)
        t_surface = t_ref.UniformProbabilitySurface(surface.data)
        t_surface.alpha_min, t_surface.beta_min = surface.alpha_min, surface.beta_min
        got = t_refdev.improved_shadow_mask(obj, cloud, a, b, t_surface, 0.15, device="cpu")
        assert np.array_equal(got, j_ref.improved_shadow_mask(obj, cloud, a, b, surface, 0.15))
        assert np.array_equal(got, np.asarray(j_refdev.improved_shadow_mask_jax(obj, cloud, a, b, surface, 0.15)))


class TestEvaluation:
    @pytest.mark.parametrize("bounds", [(0, 0, N - 1, N - 1), (10, 20, 150, 120), (5, 5, 5, 5)])
    def test_evaluate_equals_jax(self, jax_stages, bounds):
        from satellite_approximation_tpu.models.detection import evaluation as j_eval
        from satellite_approximation_tpu_torch.models.detection import evaluation as t_eval

        s = jax_stages
        args = (s["final"], s["gen"].cloud_mask, s["match"].shadow_mask, bounds)
        got, want = plain(t_eval.evaluate(*args)), plain(j_eval.evaluate(*args))
        assert np.array_equal(got.pop("pixel_classes"), want.pop("pixel_classes"))
        assert got == want
        classes = t_eval.evaluate(*args).pixel_classes
        assert np.array_equal(t_eval.generate_rgba(classes), j_eval.generate_rgba(classes))
        assert t_eval.casted_image_bounds((N, N), DIAG, s["sun"], s["view"], 2.0) == (
            j_eval.casted_image_bounds((N, N), DIAG, s["sun"], s["view"], 2.0))


class TestInterop:
    def test_detection_config(self):
        for refinement, matching in (("jax", "jax"), ("host", "native"), ("auto", "auto")):
            c = j_config.DEFAULT_DETECTION
            c = dataclasses.replace(
                c, refinement=dataclasses.replace(c.refinement, backend=refinement),
                matching=dataclasses.replace(c.matching, backend=matching, jax_height_chunk=64))
            got = interop.detection_config_from_dict(plain(c))
            assert got.refinement.backend == refinement.replace("jax", "torch")
            assert got.matching.backend == matching.replace("jax", "torch")
            assert got.matching.height_chunk == 64
            want = plain(c)
            have = plain(got)
            for d in (want, have):
                d["matching"].pop("backend"), d["refinement"].pop("backend")
            want["matching"]["height_chunk"] = want["matching"].pop("jax_height_chunk")
            assert have == want
        assert plain(interop.detection_config_from_dict(plain(t_config.DEFAULT_DETECTION))) == plain(
            t_config.DEFAULT_DETECTION)

    def test_objects_round_trip(self, jax_stages):
        s = jax_stages
        for cloud in s["clouds"]:
            back = plain(interop.cloud_object_from_dict(plain(cloud)))
            want = plain(cloud)
            assert all(np.array_equal(back["quad"][k], want["quad"][k]) for k in want["quad"])
            back.pop("quad"), want.pop("quad")
            assert back == want
        for k, shadow in s["match"].shadows.items():
            got = interop.shadow_object_from_dict(plain(shadow))
            assert (got.id, got.bounds, got.area, got.anchor) == (
                shadow.id, shadow.bounds, shadow.area, shadow.anchor)
            assert (got.window is None) == (shadow.window is None)
            sol = interop.solution_from_dict(plain(s["match"].solutions[k]))
            assert sol.height == s["match"].solutions[k].height
        assert interop.region_from_dict(plain(s["clouds"][0].region)) == interop.region_from_dict(
            plain(clouds_to_port(s["clouds"])[0].region))
