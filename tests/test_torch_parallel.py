"""The port's multi-device package (``satellite_approximation_tpu_torch/parallel``)
held against the JAX package's ``parallel/`` on the CPU: the JAX side runs
on its 8-device virtual CPU mesh (tests/conftest.py), the port on eight
shards of the CPU in one process (``ShardMesh`` with ``devices="cpu"``).
The same numpy inputs go through both.

Contracts: mesh policies and communication reports equal; halos equal;
solves within 1e-5 per pixel with iterations +-1 (an f32 sum over shards
need not add in XLA's order); the blur, the pit fill, the detection stages,
the histograms and the masks bit-equal. Plus the port's routing of the
public fill, blend and ``detect`` through an explicit mesh, and its dry run.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from satellite_approximation_tpu.config import RefinementConfig as JRefinementConfig
from satellite_approximation_tpu.models.detection import refinement_jax
from satellite_approximation_tpu.parallel import detect as j_detect
from satellite_approximation_tpu.parallel import fill as j_fill
from satellite_approximation_tpu.parallel import halo as j_halo
from satellite_approximation_tpu.parallel import mesh as j_mesh
from satellite_approximation_tpu.parallel import mg as j_mg
from satellite_approximation_tpu.parallel import solver as j_solver
from satellite_approximation_tpu.parallel import stencils as j_stencils
import satellite_approximation_tpu_torch as port
from satellite_approximation_tpu_torch import config as t_config
from satellite_approximation_tpu_torch.config import RefinementConfig, SolverConfig
from satellite_approximation_tpu_torch.models.cg import neighbor_degree
from satellite_approximation_tpu_torch.models.detection import pipeline as t_pipe
from satellite_approximation_tpu_torch.models.detection import refinement_torch
from satellite_approximation_tpu_torch.ops.blur import gaussian_blur
from satellite_approximation_tpu_torch.ops.pitfill import pit_fill
from satellite_approximation_tpu_torch.parallel import detect as t_detect
from satellite_approximation_tpu_torch.parallel import fill as t_fill
from satellite_approximation_tpu_torch.parallel import halo as t_halo
from satellite_approximation_tpu_torch.parallel import mesh as t_mesh
from satellite_approximation_tpu_torch.parallel import mg as t_mg
from satellite_approximation_tpu_torch.parallel import solver as t_solver
from satellite_approximation_tpu_torch.parallel import stencils as t_stencils
from satellite_approximation_tpu_torch.parallel.dryrun import dryrun_multichip
from satellite_approximation_tpu_torch.utils import geotiff as t_geotiff
from torch_parity import (
    assert_within_ulps,
    detection_config,
    jax_package_without_native,
    mini_diagonal,
    mini_scene,
)

CPU = "cpu"


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    return j_mesh.spatial_band_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return t_mesh.spatial_band_mesh(8, devices=CPU)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mg_problem(c, h, w, seed, rows=(10, -6), cols=(8, -12)):
    rng = np.random.default_rng(seed)
    umask = np.zeros((h, w), bool)
    umask[rows[0] : h + rows[1], cols[0] : w + cols[1]] = True
    umask[2, 2:6] = True  # a region at a shard boundary
    b = (rng.random((c, h, w)) * umask).astype(np.float32)
    return b, umask


# ------------------------------------------------------------------ meshes


class TestMeshPolicy:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24])
    def test_split_policies_equal(self, n):
        assert t_mesh.split_band_spatial(n) == j_mesh.split_band_spatial(n)
        assert t_mesh.split_rows_cols(n) == j_mesh.split_rows_cols(n)

    @pytest.mark.parametrize("n", [2, 4, 6, 8])
    def test_mesh_shapes_equal(self, n):
        assert t_mesh.spatial_band_mesh(n, devices=CPU).shape == dict(j_mesh.spatial_band_mesh(n).shape)
        assert t_mesh.spatial_mesh_2d(n, devices=CPU).shape == dict(j_mesh.spatial_mesh_2d(n).shape)

    def test_explicit_shape_override(self):
        for shape in ((1, 8), (2, 4), (8, 1)):
            m = t_mesh.spatial_band_mesh(8, shape=shape, devices=CPU)
            assert m.shape == dict(j_mesh.spatial_band_mesh(8, shape=shape).shape)
            assert m.size == 8 and m.devices.shape == shape
        with pytest.raises(ValueError):
            j_mesh.spatial_band_mesh(8, shape=(2, 3))
        with pytest.raises(ValueError):
            t_mesh.spatial_band_mesh(8, shape=(2, 3), devices=CPU)
        m = t_mesh.spatial_mesh_2d(8, shape=(2, 2, 2), devices=CPU)
        assert m.shape == dict(j_mesh.spatial_mesh_2d(8, shape=(2, 2, 2)).shape)

    def test_make_mesh_never_drops_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            t_mesh.make_mesh((4,), ("d",))
        m = t_mesh.make_mesh((2,), ("d",))
        assert [str(d) for d in m.devices.reshape(-1)] == ["cuda:0", "cuda:1"]
        m = t_mesh.make_mesh((2, 2), ("b", "x"), "cpu")
        assert m.distinct_devices() == [torch.device("cpu")] and m.size == 4
        with pytest.raises(ValueError, match="one type"):
            t_mesh.ShardMesh((2,), ("d",), ["cpu", "cuda:0"])

    @pytest.mark.parametrize("bands", [1, 2, 13])
    def test_auto_fill_mesh_equal(self, bands, monkeypatch):
        """With 8 CUDA devices visible, ``auto_fill_mesh`` builds the mesh the
        JAX package's "auto" picks over its 8 devices; the port's "auto"
        setting stays on one device; on the CPU neither shards."""
        assert t_mesh.auto_fill_mesh(bands, torch.device("cpu")) is None
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        got = t_mesh.auto_fill_mesh(bands, torch.device("cuda"))
        assert got.shape == dict(j_mesh.resolve_fill_mesh("auto", bands).shape)
        assert t_mesh.resolve_mesh(got) is got
        for setting in (None, "off", "auto"):
            assert t_mesh.resolve_mesh(setting) is None
        with pytest.raises(ValueError):
            t_mesh.resolve_mesh("everywhere")

    def test_spread_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert t_mesh.spread_devices(2, "cuda:0") == [torch.device("cuda", i) for i in range(2)]
        assert t_mesh.spread_devices(4, "cuda:1") == [torch.device("cuda:1")] * 4
        assert t_mesh.spread_devices(3, "cpu") == [torch.device("cpu")] * 3


# ------------------------------------------------------------------- halos


@pytest.mark.parametrize("boundary", [0.0, 7.0])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("kind", ["rows", "cols"])
def test_halo_equal(kind, depth, boundary):
    """Each shard's padded block, JAX's shard_map against the port's list."""
    n = 4
    mesh = jax.make_mesh((n,), ("x",))
    a = np.random.default_rng(11).random((2, 16, 24)).astype(np.float32)
    rows = kind == "rows"
    spec = P(None, "x", None) if rows else P(None, None, "x")
    jfn = j_halo.halo_pad_rows if rows else j_halo.halo_pad_cols

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=spec, out_specs=spec)
    def run(x_l):
        return jfn(x_l, "x", depth=depth, boundary_value=boundary)

    want = np.asarray(jax.jit(run)(jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))))
    dim = -2 if rows else -1
    shards = list(torch.from_numpy(a).chunk(n, dim=dim))
    tfn = t_halo.halo_pad_rows if rows else t_halo.halo_pad_cols
    got = torch.cat(tfn(shards, depth=depth, boundary_value=boundary), dim=dim).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- solvers


def test_sharded_cg_matches_jax(jmesh, tmesh):
    c, h, w = 4, 64, 48
    b, umask = _mg_problem(c, h, w, 0, rows=(10, -24), cols=(8, -8))
    b *= np.float32(1 / 32)  # a solution of order 1, where f32 resolves 1e-5
    deg = neighbor_degree((h, w))
    put = lambda x, spec: jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))
    xj, itj, rsj = j_solver.sharded_masked_cg(
        put(b, P("b", "x", None)), put(np.zeros_like(b), P("b", "x", None)),
        put(umask, P("x", None)), put(deg, P("x", None)), jmesh, tolerance=1e-7,
        max_iterations=4000,
    )
    x, it, rs = t_solver.sharded_masked_cg(b, np.zeros_like(b), umask, deg, tmesh,
                                           tolerance=1e-7, max_iterations=4000)
    np.testing.assert_allclose(_np(x), np.asarray(xj), rtol=0, atol=1e-5)
    assert abs(it - int(itj)) <= 1
    bs = (b.astype(np.float64) ** 2).sum(axis=(-2, -1))
    assert np.all(_np(rs) <= 1e-14 * bs + 1e-12)


def test_sharded_training_step_matches_jax(jmesh, tmesh):
    c, h, w = 2 * jmesh.shape["b"], 16 * jmesh.shape["x"], 32
    rng = np.random.default_rng(5)
    inputs = rng.random((c, h, w)).astype(np.float32)
    repl = rng.random((c, h, w)).astype(np.float32)
    umask = np.zeros((h, w), bool)
    umask[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = True
    put = lambda x, spec: jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))
    want, want_rs = jax.jit(j_solver.sharded_training_step(jmesh))(
        put(inputs, P("b", "x", None)), put(repl, P("b", "x", None)), put(umask, P("x", None)))
    got, rs = t_solver.sharded_training_step(tmesh)(inputs, repl, umask)
    got = _np(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, ~umask], inputs[:, ~umask])
    assert np.isfinite(_np(rs)).all()


@pytest.mark.parametrize("case", ["aligned", "row_padding"])
def test_sharded_mg_solve_matches_jax(case, jmesh, tmesh):
    """H = 122 does not divide xdim * 2^depth: the row-padding path."""
    c, h, w, tol = (4, 128, 96, 1e-7) if case == "aligned" else (2, 122, 70, 1e-6)
    b, umask = _mg_problem(c, h, w, 2)
    xj, itj, relj = j_mg.sharded_mg_solve(b, np.zeros_like(b), umask, None, jmesh,
                                          tolerance=tol, max_iterations=200)
    x, it, rel = t_mg.sharded_mg_solve(b, np.zeros_like(b), umask, None, tmesh,
                                       tolerance=tol, max_iterations=200)
    assert tuple(x.shape) == (c, h, w) and x.dtype == torch.float64
    assert np.all(rel <= tol) and np.all(np.asarray(relj) <= tol)
    np.testing.assert_allclose(_np(x), np.asarray(xj), rtol=0, atol=1e-5)
    assert abs(it - int(itj)) <= 1


@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 4, 2)])
def test_sharded_mg_solve_2d_matches_jax(shape):
    n = int(np.prod(shape))
    jm = j_mesh.spatial_mesh_2d(n, shape=shape)
    tm = t_mesh.spatial_mesh_2d(n, shape=shape, devices=CPU)
    c, h, w = 2, 122, 70  # neither dimension aligned: rows and columns pad
    b, umask = _mg_problem(c, h, w, 13, rows=(5, -5), cols=(5, -5))
    xj, itj, relj = j_mg.sharded_mg_solve_2d(b, np.zeros_like(b), umask, None, jm,
                                             tolerance=1e-6, max_iterations=200)
    x, it, rel = t_mg.sharded_mg_solve_2d(b, np.zeros_like(b), umask, None, tm,
                                          tolerance=1e-6, max_iterations=200)
    assert tuple(x.shape) == (c, h, w)
    assert np.all(rel <= 1e-6)
    np.testing.assert_allclose(_np(x), np.asarray(xj), rtol=0, atol=1e-5)
    assert abs(it - int(itj)) <= 1


def test_iteration_parity_2d_vs_rows_only():
    """Where the alignment pads nothing, the (2, 2) and (2, 1) 2-D solves and
    the 1-D row solve run one global operator: equal iterations in the port,
    within one of the JAX package's."""
    c, h, w = 2, 64, 64
    b, umask = _mg_problem(c, h, w, 15, rows=(8, -8), cols=(5, -20))
    runs = {}
    for label, shape in (("2x2", (1, 2, 2)), ("2x1", (1, 2, 1)), ("rows", (1, 2))):
        tm = (t_mesh.spatial_mesh_2d(int(np.prod(shape)), shape=shape, devices=CPU) if len(shape) == 3
              else t_mesh.spatial_band_mesh(2, shape=shape, devices=CPU))
        solve = t_mg.sharded_mg_solve_2d if len(shape) == 3 else t_mg.sharded_mg_solve
        x, it, rel = solve(b, np.zeros_like(b), umask, None, tm, tolerance=1e-6, max_iterations=200)
        runs[label] = (_np(x), it, rel)
    assert len({v[1] for v in runs.values()}) == 1, {k: v[1] for k, v in runs.items()}
    assert np.all(runs["2x2"][2] <= 1e-6)
    np.testing.assert_allclose(runs["2x2"][0], runs["rows"][0], rtol=0, atol=1e-8)
    _, itj, _ = j_mg.sharded_mg_solve_2d(b, np.zeros_like(b), umask, None,
                                         j_mesh.spatial_mesh_2d(4, shape=(1, 2, 2)),
                                         tolerance=1e-6, max_iterations=200)
    assert abs(runs["2x2"][1] - int(itj)) <= 1


@pytest.mark.parametrize("mode", ["laplace", "poisson"])
def test_sharded_fill_matches_jax(mode, jmesh, tmesh):
    """Three bands over a 'b' axis of 2: the zero-band padding path."""
    rng = np.random.default_rng(9)
    c, h, w = 3, 64, 48
    image = rng.random((c, h, w))
    umask = np.zeros((h, w), bool)
    umask[12:52, 10:40] = True
    umask[5:10, 20:44] = True  # crosses a shard boundary
    repl = rng.random((c, h, w)) + 0.5 if mode == "poisson" else None
    want, itj, relj = j_fill.sharded_fill(image, umask, jmesh, replacement=repl, tolerance=1e-7)
    got, it, rel = t_fill.sharded_fill(image, umask, tmesh, replacement=repl, tolerance=1e-7)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    got = _np(got)
    assert got.shape == image.shape and rel <= 1e-7
    np.testing.assert_array_equal(got[:, ~umask], image[:, ~umask])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert abs(it - int(itj)) <= 1


def test_sharded_fill_band_chunks(tmesh):
    """Five bands in chunks of two over a 'b' axis of 2 (the last chunk
    padded) fill as one chunk does; iterations add up over the chunks."""
    rng = np.random.default_rng(19)
    c, h, w = 5, 64, 48
    image = rng.random((c, h, w))
    umask = np.zeros((h, w), bool)
    umask[12:52, 10:40] = True
    assert t_fill.chunk_bands(tmesh, c, h, w) == 6
    assert t_fill.chunk_bands(tmesh, c, h, w, max_chunk_elements=3 * h * w) == 2
    whole, it1, rel1 = t_fill.sharded_fill(image, umask, tmesh, tolerance=1e-8)
    got, it3, rel3 = t_fill.sharded_fill(image, umask, tmesh, tolerance=1e-8,
                                         max_chunk_elements=2 * h * w)
    assert rel1 <= 1e-8 and rel3 <= 1e-8 and it3 >= it1
    np.testing.assert_array_equal(_np(got)[:, ~umask], image[:, ~umask])
    np.testing.assert_allclose(_np(got), _np(whole), rtol=0, atol=1e-6)


def test_chunk_bands_from_free_memory(monkeypatch):
    """Chunks sized from each card's free memory and its share of the
    shards; the first card also holds the composite."""
    free = {}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (free[torch.device(d).index], 80 * 2**30))
    c, h, w = 13, 2048, 2048
    one_card = t_mesh.make_mesh((1, 4), ("b", "x"), "cuda:0")
    free[0] = 80 * 2**30
    assert t_fill.chunk_bands(one_card, c, h, w) == 13
    free[0] = 10 * 2**30
    want = int((0.8 * 10 * 2**30 - 8 * c * h * w) / (t_fill._STATE_BYTES_PER_ELEMENT
                                                    + t_fill._GATHER_BYTES_PER_ELEMENT))
    assert t_fill.chunk_bands(one_card, c, h, w) == want // (h * w) == 8
    free[0] = 0
    assert t_fill.chunk_bands(one_card, c, h, w) == 1  # never below one band group
    four = t_mesh.make_mesh((2, 2), ("b", "x"), [f"cuda:{i}" for i in range(4)])
    free.update({0: 80 * 2**30, 1: 80 * 2**30, 2: 2 * 2**30, 3: 80 * 2**30})
    per = t_fill.chunk_bands(four, c, h, w)
    assert per % 2 == 0 and per == int(0.8 * 2 * 2**30 * 4 / 192) // (h * w) // 2 * 2


@pytest.mark.parametrize("dims", [(1024, 1024, 1, 16, (4, 4)), (512, 256, 13, 4, (2, 2)),
                                  (250, 130, 2, 8, (4, 2))])
def test_comm_volume_reports_equal(dims):
    h, w, c, xdim, (yd, xd) = dims
    umask = np.zeros((h, w), bool)
    umask[h // 16 : 15 * h // 16, w // 16 : 7 * w // 8] = True
    assert t_mg.comm_volume_report(h, w, c, xdim, umask) == j_mg.comm_volume_report(
        h, w, c, xdim, umask)
    assert t_mg.comm_volume_report_2d(h, w, c, yd, xd, umask) == j_mg.comm_volume_report_2d(
        h, w, c, yd, xd, umask)


# --------------------------------------------------------------- stencils


@pytest.mark.parametrize("sigma,shape", [(4.0, (128, 96)), (1.0, (2, 64, 80))])
def test_sharded_blur_bit_equal(sigma, shape, jmesh, tmesh):
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    got = t_stencils.sharded_gaussian_blur(img, sigma, tmesh).numpy()
    np.testing.assert_array_equal(got, gaussian_blur(torch.from_numpy(img), sigma).numpy())
    # the port's blur holds the JAX package's to 2 ulp (XLA contracts its taps)
    assert_within_ulps(got, np.asarray(j_stencils.sharded_gaussian_blur(img, sigma, jmesh)))


def test_sharded_blur_rejects_too_few_rows(tmesh):
    with pytest.raises(ValueError, match="rows"):
        t_stencils.sharded_gaussian_blur(np.zeros((16, 32), np.float32), 4.0, tmesh)


def test_sharded_pit_fill_bit_equal(jmesh, tmesh):
    img = np.random.default_rng(4).random((64, 56)).astype(np.float32)
    img[20:30, 20:30] -= 0.5  # a deep pit across shard boundaries
    got = t_stencils.sharded_pit_fill(img, 0.3, tmesh).numpy()
    np.testing.assert_array_equal(got, pit_fill(torch.from_numpy(img), 0.3).numpy())
    np.testing.assert_array_equal(got, np.asarray(j_stencils.sharded_pit_fill(img, 0.3, jmesh)))


# --------------------------------------------------------- detection stages


@pytest.fixture(scope="module")
def raster_stage_inputs():
    """237 rows: 237 % 8 = 5, so every row-sharded stage pads."""
    rng = np.random.default_rng(17)
    h, w = 237, 190
    return dict(
        diff=rng.standard_normal((h, w)).astype(np.float32) * 0.01,
        alpha=rng.random((h, w)).astype(np.float32),
        beta=rng.random((h, w)).astype(np.float32),
        shadow=rng.random((h, w)) > 0.7,
        cloud=rng.random((h, w)) > 0.8,
    )


def test_sharded_alpha_bit_equal(raster_stage_inputs, jmesh, tmesh):
    """Bit-equal to the port's single-device alpha map; the JAX package's
    within 2 ulp of 1 (a probability), the contract of the unsharded stage."""
    d = raster_stage_inputs["diff"]
    # each 30-row shard is below the CPU intra-op grain and runs inline on
    # one thread; the whole raster is split between threads, and that split
    # has been seen to round exp differently (up to 6e-6, intermittently
    # under load). One thread holds the reference to the shards' path.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = refinement_torch.alpha_map(d, 17.0, 0.007, device=CPU).numpy()
    finally:
        torch.set_num_threads(threads)
    got = _np(t_detect.sharded_alpha_map(d, tmesh, 17.0, 0.007))
    np.testing.assert_array_equal(got, want)
    assert_within_ulps(got, np.asarray(j_detect.sharded_alpha_map(d, jmesh, 17.0, 0.007)), 2,
                       scale=1.0)
    shards, rows = t_detect.sharded_alpha_map(d, tmesh, 17.0, 0.007, padded_output=True)
    assert rows == d.shape[0] and len(shards) == 8
    np.testing.assert_array_equal(torch.cat(shards).numpy()[:rows], want)


def test_sharded_histograms_bit_equal(raster_stage_inputs, jmesh, tmesh):
    i = raster_stage_inputs
    divisions = tuple(RefinementConfig().histogram_divisions)
    want = j_detect.sharded_histograms(i["alpha"], i["beta"], i["shadow"].astype(np.float32),
                                       divisions, jmesh)
    got = t_detect.sharded_histograms(i["alpha"], i["beta"], i["shadow"], divisions, tmesh)
    for (wc, ws), (gc, gs) in zip(want, got):
        np.testing.assert_array_equal(_np(gc), np.asarray(wc))
        np.testing.assert_array_equal(_np(gs), np.asarray(ws))


def test_sharded_probability_and_final_mask_bit_equal(raster_stage_inputs, jmesh, tmesh):
    i = raster_stage_inputs
    want_surface = refinement_jax.probability_map_jax(i["shadow"], i["alpha"], i["beta"],
                                                      JRefinementConfig())
    surface = t_detect.sharded_probability_map(i["shadow"], i["alpha"], i["beta"], tmesh,
                                               RefinementConfig())
    np.testing.assert_array_equal(surface._extended(), want_surface._extended())
    want = j_detect.sharded_improved_shadow_mask(i["shadow"], i["cloud"], i["alpha"], i["beta"],
                                                 surface, 0.15, jmesh)
    got = t_detect.sharded_improved_shadow_mask(i["shadow"], i["cloud"], i["alpha"], i["beta"],
                                                surface, 0.15, tmesh)
    np.testing.assert_array_equal(got, np.asarray(want))
    # alpha as padded row shards, as the pipeline hands it on
    shards, rows = t_detect._pad_rows(i["alpha"], tmesh, torch.float32)
    got = t_detect.sharded_improved_shadow_mask(i["shadow"], i["cloud"], shards, i["beta"],
                                                surface, 0.15, tmesh, rows=rows)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="rows="):
        t_detect.sharded_histograms(shards, i["beta"], i["shadow"], (8,), tmesh)


def test_mini_detect_sharded_matches_jax(jmesh, tmesh):
    """The port's sharded stage chain against its own single-device route
    (inside ``mini_detect_sharded``) and its masks against the JAX
    package's sharded chain."""
    got = t_detect.mini_detect_sharded(tmesh, n=192)
    with jax_package_without_native():
        want = j_detect.mini_detect_sharded(jmesh, n=192)
    assert got["n_matched"] == want["n_matched"] > 0
    for key in ("cloud", "object", "final"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["final"].any()


# ------------------------------------------------------------------ routing


def test_public_fill_and_blend_route_through_mesh(tmesh, monkeypatch):
    rng = np.random.default_rng(31)
    h = w = 96
    img = rng.random((2, h, w))
    invalid = np.zeros((h, w), bool)
    invalid[10:80, 12:70] = True
    repl = rng.random((2, h, w))
    calls = []
    real = t_fill.sharded_fill
    monkeypatch.setattr(t_fill, "sharded_fill", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    sharded = SolverConfig(mg_threshold_pixels=0, mesh=tmesh)
    single = SolverConfig(mg_threshold_pixels=0, mesh=None)
    got = port.fill_missing_portion_smooth_boundary(img, invalid, config=sharded, device=CPU)
    want = port.fill_missing_portion_smooth_boundary(img, invalid, config=single, device=CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = port.blend_images_poisson(img, repl, invalid, tolerance=1e-9, config=sharded, device=CPU)
    want = port.blend_images_poisson(img, repl, invalid, tolerance=1e-9, config=single, device=CPU)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert calls == [tmesh, tmesh]


def test_detect_routes_through_mesh(tmesh, tmp_path):
    scene = mini_scene(128)
    cfg = detection_config(t_config, "torch", "torch")

    def run(name, mesh):
        work = tmp_path / name
        work.mkdir()
        t_geotiff.write_geotiff(scene["B08"], work / "B08.tif")
        params = t_pipe.CloudParams.from_root(work)
        status = t_pipe.detect(params, mini_diagonal(128), use_cache=False, inputs=dict(scene),
                               config=cfg, mesh=mesh, device=CPU)
        masks = [t_geotiff.GeoTIFF.open(p).read() for p in (
            params.cloud_path(), params.shadow_path(), params.object_based_shadow_path())]
        return status, masks

    status, masks = run("sharded", tmesh)
    want_status, want_masks = run("single", None)
    assert status == want_status
    for a, b in zip(masks, want_masks):
        np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_on_cpu_shards():
    out = dryrun_multichip(4, device=CPU, log=lambda _: None)
    assert out["mesh"].startswith("ShardMesh({'b': 2, 'x': 2}")
    assert out["fill_residual"] <= 1e-6 and out["mini_detect_matched"] > 0
    assert out["iterations_2d"]["2x2"] == out["iterations_2d"]["2x1"]

