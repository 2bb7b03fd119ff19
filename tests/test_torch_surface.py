"""The fill's host surface (``models/_surface.py``) on the CPU: the blocked
f32 exactness test and the scatter back, held bit-equal to the whole-array
numpy expressions they replace, on the caller's thread and on the pool;
their counters; and the public Laplace fill and Poisson blend byte-equal to
those expressions end to end."""

from __future__ import annotations

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from satellite_approximation_tpu_torch.config import SolverConfig
from satellite_approximation_tpu_torch.models import _surface, laplace, multigrid, poisson
from satellite_approximation_tpu_torch.utils import profiling


def oracle_cast(stack, policy):
    """The whole-array exactness test the helper replaces."""
    img32 = stack.astype(np.float32)
    exact = policy == "force" or (
        policy == "auto" and np.array_equal(img32.astype(np.float64), stack))
    return img32, exact


def oracle_scatter(stack, umask, vals):
    """The whole-array scatter back the helper replaces."""
    filled = stack.copy()
    ys, xs = np.nonzero(umask)
    filled[..., ys, xs] = vals
    return filled


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(params=["inline", "pooled"])
def route(request, monkeypatch):
    """"inline": the default block, larger than every stack here, so the
    passes run on the caller's thread; "pooled": blocks of 4 KiB, so each
    stack spans many and the passes run on the pool."""
    if request.param == "pooled":
        monkeypatch.setattr(_surface, "BLOCK_BYTES", 4096)
    return request.param


# 2-D and 3-D; 1 x N; N x 1; heights that are not (100) and are (96) a
# multiple of the pooled block's 8 rows of 64
SHAPES = [(40, 56), (1, 3000), (3000, 1), (3, 100, 64), (2, 96, 64)]


def u16_stack(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 10000, size=shape).astype(np.float64)


def n_blocks(shape, block_bytes):
    h, w = shape[-2], shape[-1]
    bands = shape[0] if len(shape) == 3 else 1
    return bands * math.ceil(h / max(1, block_bytes // (8 * w)))


def counts_of(fn):
    """``fn()`` under an active profiler, inside the span the fill opens
    around the test; returns its result and the span's counts."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("fill.exactness_check"):
            out = fn()
    [rec] = [r for r in profiling.records() if r.name == "fill.exactness_check"]
    return out, rec.counts


# ----------------------------------------------------------------- the test


@pytest.mark.parametrize("shape", SHAPES)
def test_exact_stack_casts_like_astype(route, shape):
    stack = u16_stack(shape)
    before = stack.copy()
    img32, exact = _surface.cast_exact_f32(stack, "auto")
    want32, want = oracle_cast(stack, "auto")
    assert exact is want is True
    assert img32.dtype == np.float32 and img32.shape == stack.shape
    assert img32.tobytes() == want32.tobytes()
    assert not np.shares_memory(img32, stack)
    assert stack.tobytes() == before.tobytes()


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("value", [0.1, np.nan, 1e39, 1e-310], ids=str)
@pytest.mark.parametrize("shape", SHAPES)
def test_planted_value_is_not_exact(route, shape, value, where):
    """A value f32 cannot hold, in the first block of the first band or the
    last block of the last band, makes the stack not exact."""
    stack = u16_stack(shape, 1)
    stack[(0,) * stack.ndim if where == "first" else (-1,) * stack.ndim] = value
    with np.errstate(over="ignore"):
        (img32, exact), counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
        assert oracle_cast(stack, "auto")[1] is exact is False
    assert img32 is None
    if where == "first" and route == "inline":
        assert counts["surface_blocks"] == 1


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("value", [np.inf, -np.inf, -0.0], ids=str)
@pytest.mark.parametrize("shape", SHAPES)
def test_infinities_and_negative_zero_stay_exact(route, shape, value, where):
    stack = u16_stack(shape, 2)
    stack[(0,) * stack.ndim if where == "first" else (-1,) * stack.ndim] = value
    img32, exact = _surface.cast_exact_f32(stack, "auto")
    want32, want = oracle_cast(stack, "auto")
    assert exact is want is True
    assert img32.tobytes() == want32.tobytes()  # the sign of zero too


@pytest.mark.parametrize("exact_input", [True, False], ids=["u16", "planted"])
@pytest.mark.parametrize("policy", ["auto", "force", "off", "never"])
def test_policies(route, policy, exact_input):
    """"force" casts without the test, "off" (and any other word) casts
    nothing, and each answers as the whole-array expression did."""
    stack = u16_stack((3, 100, 64), 3)
    if not exact_input:
        stack[1, 50, 30] = 0.1
    (img32, exact), counts = counts_of(lambda: _surface.cast_exact_f32(stack, policy))
    want32, want = oracle_cast(stack, policy)
    assert exact is want
    if exact:
        assert img32.tobytes() == want32.tobytes()
    else:
        assert img32 is None
    if policy == "force":
        assert counts["surface_blocks"] == 0 and counts["surface_threads"] >= 1
    elif policy != "auto":
        assert counts == {"surface_blocks": 0, "surface_threads": 0}


def test_strided_view():
    """A window of a larger stack (the Poisson blend's patch overload)."""
    big = u16_stack((3, 90, 120), 4)
    stack = big[:, 7:80, 11:100]
    img32, exact = _surface.cast_exact_f32(stack, "auto")
    assert exact and img32.tobytes() == oracle_cast(stack, "auto")[0].tobytes()
    umask = np.zeros(stack.shape[-2:], bool)
    umask[5:60, 9:70] = True
    vals = np.random.default_rng(4).random((3, int(umask.sum())))
    out = _surface.scatter_masked(stack, umask, vals)
    assert out.tobytes() == oracle_scatter(stack, umask, vals).tobytes()
    assert not np.shares_memory(out, big)


# ----------------------------------------------------------- the scatter back


def plant_mask(shape, kind):
    h, w = shape[-2], shape[-1]
    m = np.zeros((h, w), bool)
    if kind == "first_last_rows":
        m[0, :: 3] = True
        m[-1, 1:: 2] = True
    elif kind == "single":
        m[h // 2, w // 2] = True
    elif kind == "interior":
        m[1:-1, 1:-1] = True
    elif kind == "random":
        m = np.random.default_rng(5).random((h, w)) < 0.33
    return m


@pytest.mark.parametrize("kind", ["first_last_rows", "single", "interior", "random", "none"])
@pytest.mark.parametrize("shape", SHAPES)
def test_scatter_matches_copy_and_fancy_index(route, shape, kind):
    stack = u16_stack(shape, 6)
    before = stack.copy()
    umask = plant_mask(shape, kind)
    n = int(umask.sum())
    vals = np.random.default_rng(7).random((shape[0], n) if len(shape) == 3 else (n,))
    out = _surface.scatter_masked(stack, umask, vals)
    want = oracle_scatter(stack, umask, vals)
    assert out.dtype == want.dtype and out.shape == want.shape
    assert out.tobytes() == want.tobytes()
    assert stack.tobytes() == before.tobytes()
    assert not np.shares_memory(out, stack)


# ---------------------------------------------------------------- counters


def test_counters_inline():
    stack = u16_stack((3, 100, 64))
    _, counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
    assert counts == {"surface_blocks": 3, "surface_threads": 1}


def test_counters_pooled(monkeypatch):
    monkeypatch.setattr(_surface, "BLOCK_BYTES", 4096)
    stack = u16_stack((3, 100, 64))
    _, counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
    width = _surface._get_pool()[1]
    assert counts == {"surface_blocks": n_blocks(stack.shape, 4096), "surface_threads": width}


def test_pooled_test_stops_early(monkeypatch):
    """Block 0 fails: the blocks not started by then are not run, so far
    fewer than the stack's 4096 are tested."""
    monkeypatch.setattr(_surface, "BLOCK_BYTES", 512)  # one row of 64
    stack = u16_stack((2, 2048, 64), 8)
    stack[0, 0, 0] = np.nan
    (img32, exact), counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
    assert img32 is None and exact is False
    assert 1 <= counts["surface_blocks"] < n_blocks(stack.shape, 512) == 4096
    assert counts["surface_threads"] == _surface._get_pool()[1]


def test_nothing_counted_without_a_profiler():
    _surface.cast_exact_f32(u16_stack((2, 30, 40)), "auto")
    assert profiling.records() == []


@pytest.mark.parametrize("cpus,width", [(1, 1), (3, 3), (40, 16)])
def test_pool_width_from_affinity(monkeypatch, cpus, width):
    """The pool is as wide as the CPUs the process may run on, at most 16;
    with one CPU every pass runs inline."""
    monkeypatch.setattr(_surface, "_pool", None)
    monkeypatch.setattr(_surface, "_width", None)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)),
                        raising=False)
    monkeypatch.setattr(_surface, "BLOCK_BYTES", 4096)
    try:
        stack = u16_stack((2, 64, 64), 9)
        (img32, exact), counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
        assert exact and counts["surface_threads"] == width
        assert (_surface._pool is None) == (width == 1)
    finally:
        if _surface._pool is not None:
            _surface._pool.shutdown()


# ------------------------------------------------------------- end to end


@pytest.fixture
def one_torch_thread():
    """The solves below on one torch thread: the large case's tensors pass
    torch's grain for intra-op threads, and test workers side by side would
    otherwise oversubscribe the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parent_surface(monkeypatch, module):
    monkeypatch.setattr(module, "cast_exact_f32", oracle_cast)
    monkeypatch.setattr(module, "scatter_masked", oracle_scatter)


SIZES = {
    # bands, height, width, block bytes, config
    "inline": ((3, 40, 52), None, dict(mesh="off")),
    "pooled": ((3, 40, 52), 4096, dict(mesh="off")),
    # over the default block (4.9 MB of f64): the pool without a patch
    "large": ((3, 512, 400), None, dict(mesh="off")),
}


def fill_scene(shape, seed, kind):
    h, w = shape[-2:]
    images = u16_stack(shape, seed)
    if kind == "f64":
        images += np.random.default_rng(seed).random(shape) * 0.1
    # a hole and speckles of a few hundred pixels, whatever the stack's size
    invalid = np.zeros((h, w), bool)
    invalid[h // 5: h // 5 + min(20, h // 2), w // 6: w // 6 + min(26, w // 2)] = True
    r, c = min(16, h // 3), min(16, w // 3)
    invalid[:r, :c] |= np.random.default_rng(seed + 1).random((r, c)) < 0.3
    return images, invalid


@pytest.mark.parametrize("kind", ["u16", "f64", "u16_2d"])
@pytest.mark.parametrize("size", list(SIZES))
def test_solve_matrix_byte_equal_to_the_whole_array_expressions(monkeypatch, one_torch_thread,
                                                                 size, kind):
    shape, block, cfg = SIZES[size]
    if block:
        monkeypatch.setattr(_surface, "BLOCK_BYTES", block)
    if kind == "u16_2d":
        shape = shape[1:]
    images, invalid = fill_scene(shape, 11, kind)
    # the large 2-D band is one block, and runs inline
    assert (images.nbytes > _surface.BLOCK_BYTES) == (size == "pooled" or images.ndim == 3
                                                      and size == "large")
    before = images.copy()
    config = SolverConfig(**cfg)
    multigrid._HIERARCHY_CACHE.clear()
    got, res = laplace.solve_matrix(images, invalid, config, device="cpu")
    with monkeypatch.context() as m:
        parent_surface(m, laplace)
        multigrid._HIERARCHY_CACHE.clear()
        want, res_want = laplace.solve_matrix(images, invalid, config, device="cpu")
    multigrid._HIERARCHY_CACHE.clear()
    assert got.dtype == np.float64 and got.shape == images.shape
    assert np.array_equal(got, want) and got.tobytes() == want.tobytes()
    assert res.iterations == res_want.iterations
    assert images.tobytes() == before.tobytes()
    assert not np.shares_memory(got, images)


@pytest.mark.parametrize("overload", ["mask", "patch"])
@pytest.mark.parametrize("size", list(SIZES))
def test_blend_byte_equal_to_the_whole_array_expressions(monkeypatch, one_torch_thread, size,
                                                         overload):
    shape, block, cfg = SIZES[size]
    if block:
        monkeypatch.setattr(_surface, "BLOCK_BYTES", block)
    inputs, invalid = fill_scene(shape, 12, "u16")
    assert (inputs.nbytes > _surface.BLOCK_BYTES) == (size != "inline")
    config = SolverConfig(**cfg)
    if overload == "mask":
        repl = u16_stack(shape, 13)
        args = (inputs, repl, invalid)
    else:
        h, w = shape[-2:]
        repl = u16_stack((shape[0], h // 2, w // 2), 13) + 2
        repl[:, :2, :] = 1.0  # sentinel rows
        args = (inputs, repl, None, h // 5, w // 6)
    multigrid._HIERARCHY_CACHE.clear()
    got = poisson.blend_images_poisson(*args, config=config, device="cpu")
    with monkeypatch.context() as m:
        parent_surface(m, poisson)
        multigrid._HIERARCHY_CACHE.clear()
        want = poisson.blend_images_poisson(*args, config=config, device="cpu")
    multigrid._HIERARCHY_CACHE.clear()
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


def test_concurrent_callers_on_a_wide_pool(monkeypatch):
    """Twelve callers at once on a pool of 16 (more threads than this host
    has cores), switching threads every microsecond: every block is taken
    once, so each caller's answers match the whole-array expressions and
    its test counts all of its blocks."""
    monkeypatch.setattr(_surface, "_pool", None)
    monkeypatch.setattr(_surface, "_width", None)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(64)),
                        raising=False)
    monkeypatch.setattr(_surface, "BLOCK_BYTES", 1024)
    errors, done = [], []

    def caller(seed):
        try:
            stack = u16_stack((3, 70, 64), seed)
            umask = plant_mask(stack.shape, "random")
            vals = np.random.default_rng(seed).random((3, int(umask.sum())))
            for _ in range(5):
                img32, exact = _surface.cast_exact_f32(stack, "auto")
                assert exact and img32.tobytes() == oracle_cast(stack, "auto")[0].tobytes()
                out = _surface.scatter_masked(stack, umask, vals)
                assert out.tobytes() == oracle_scatter(stack, umask, vals).tobytes()
            done.append(seed)
        except Exception as e:  # handed to the test's thread below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(s,)) for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert _surface._width == 16
        # the counters of one pooled test, with the threads switching as often
        stack = u16_stack((3, 70, 64), 99)
        _, counts = counts_of(lambda: _surface.cast_exact_f32(stack, "auto"))
    finally:
        sys.setswitchinterval(interval)
        if _surface._pool is not None:
            _surface._pool.shutdown()
    assert not errors, errors
    assert sorted(done) == list(range(12))
    assert counts == {"surface_blocks": n_blocks(stack.shape, 1024), "surface_threads": 16}
