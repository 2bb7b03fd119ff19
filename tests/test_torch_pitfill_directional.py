"""The pit fill's directional scan cycles in the port (``ops/pitfill.py``,
``ops/pitfill_kernels.py``) against the JAX package's on the CPU: the same
inputs, made from a numpy seed, through both. Only min, max and comparisons
occur, so every surface and every flag must be equal bit for bit. On the
CPU the wrappers of kernel 9 run its plain version; the kernel itself is
held to it on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from satellite_approximation_tpu.ops import pitfill as j_pit
from satellite_approximation_tpu_torch import native
from satellite_approximation_tpu_torch.ops import pitfill as t_pit
from satellite_approximation_tpu_torch.ops import pitfill_kernels as PK
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from torch_parity import NATIVE_ROUTES, native_route, smooth  # noqa: F401 — a fixture

SHAPES = [(1, 1), (1, 37), (37, 1), (37, 53), (128, 300), (257, 131)]
BORDERS = ["float", "tensor"]


def T(a):
    return torch.from_numpy(np.array(a))


def inputs(shape, seed):
    """(orig, f): orig a field in (0, 1) with pits, f between orig and 1 (a
    start from above, as the pyramid gives)."""
    r = np.random.default_rng(seed)
    orig = r.random(shape).astype(np.float32) * np.float32(0.8) + np.float32(0.1)
    f = (orig + (1 - orig) * r.random(shape).astype(np.float32)).astype(np.float32)
    return orig, f


def borders(kind, value=0.45):
    """The border as each package takes it: a float, or a 0-d array/tensor."""
    if kind == "float":
        return value, value
    return jnp.asarray(value, jnp.float32), torch.tensor(value, dtype=torch.float32)


def nir_field(h, w, seed):
    return (0.1 + 0.8 * smooth(h, w, seed)).astype(np.float32)


class TestAgainstJax:
    @pytest.mark.parametrize("border", BORDERS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_pass_down(self, shape, border):
        orig, f = inputs(shape, 1)
        jb, tb = borders(border)
        want = np.asarray(j_pit._pass_down(jnp.asarray(orig), jb, jnp.asarray(f)))
        got = t_pit._pass_down(T(orig), torch.as_tensor(tb, dtype=torch.float32), T(f))
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("border", BORDERS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_directional_cycle(self, shape, border):
        orig, f = inputs(shape, 2)
        jb, tb = borders(border, 0.6)
        want = np.asarray(j_pit._directional_cycle(jnp.asarray(orig), jb, jnp.asarray(f)))
        got = t_pit._directional_cycle(T(orig), torch.as_tensor(tb, dtype=torch.float32), T(f))
        assert np.array_equal(got.numpy(), want)

    @pytest.mark.parametrize("max_cycles", [1, 8])
    @pytest.mark.parametrize("border", BORDERS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_directional_budget(self, shape, border, max_cycles):
        """The surface and the flag, through the wrapper (its plain route on
        the CPU) and through the plain function itself."""
        orig, f = inputs(shape, 3)
        jb, tb = borders(border, 0.3)
        want, want_changed = j_pit._directional_budget(
            jnp.asarray(orig), jb, jnp.asarray(f), max_cycles=max_cycles)
        for fn in (PK.directional_budget, t_pit._directional_budget):
            cycles = []
            got, changed = fn(T(orig), tb, T(f), max_cycles, cycles)
            assert np.array_equal(got.numpy(), np.asarray(want))
            assert changed is bool(want_changed)
            assert 1 <= cycles[0] <= max_cycles
            assert (cycles[0] < max_cycles) <= (not changed)

    @pytest.mark.parametrize("direction", list(PK.DIRECTIONS))
    @pytest.mark.parametrize("shape", [(1, 1), (37, 53), (53, 37)])
    def test_each_direction_is_the_cycles_pass(self, shape, direction):
        """``directional_pass`` in each direction is the matching step of the
        JAX cycle, and its flag says whether the pass changed a cell."""
        orig, f = inputs(shape, 4)
        o, x = jnp.asarray(orig), jnp.asarray(f)
        step = {
            "down": lambda: j_pit._pass_down(o, 0.45, x),
            "up": lambda: j_pit._pass_down(o[::-1], 0.45, x[::-1])[::-1],
            "left": lambda: j_pit._pass_down(o.T, 0.45, x.T).T,
            "right": lambda: j_pit._pass_down(o.T[::-1], 0.45, x.T[::-1])[::-1].T,
        }[direction]
        want = np.asarray(step())
        got, changed = PK.directional_pass(T(orig), T(f), 0.45, direction)
        assert np.array_equal(got.numpy(), want)
        assert got.is_contiguous()
        assert bool(changed) == bool((want != f).any())

    def test_the_cycle_is_its_four_passes(self):
        orig, f = inputs((41, 29), 5)
        x = T(f)
        for d in PK.DIRECTIONS:
            x, _ = PK.directional_pass(T(orig), x, 0.5, d)
        assert torch.equal(x, t_pit._directional_cycle(T(orig), torch.tensor(0.5), T(f)))


class TestPitFillWithCycles:
    @pytest.fixture
    def cycles_on(self, monkeypatch):
        """Cycles on every level of at least 1,000 cells in both packages,
        on the CPU too."""
        monkeypatch.setattr(t_pit, "_DIRECTIONAL_ON_CPU", True)
        monkeypatch.setattr(t_pit, "_DIRECTIONAL_MIN_SIZE", 1000)
        monkeypatch.setattr(j_pit, "_DIRECTIONAL_MIN_SIZE", 1000)

    @pytest.mark.parametrize("shape,border", [((200, 170), 0.45), ((131, 257), 0.3),
                                              ((96, 96), 0.0), ((96, 96), 1.0)])
    def test_equals_pit_fill_host(self, cycles_on, shape, border):
        x = nir_field(*shape, seed=30)
        got = t_pit.pit_fill(T(x), border).numpy()
        assert np.array_equal(got, np.asarray(j_pit.pit_fill_host(x, border)))
        assert np.array_equal(got, np.asarray(j_pit.pit_fill(jnp.asarray(x), border)))

    def test_white_noise_and_tensor_border(self, cycles_on):
        x = np.random.default_rng(31).random((150, 150)).astype(np.float32)
        got = t_pit.pit_fill(T(x), torch.tensor(0.4)).numpy()
        assert np.array_equal(got, np.asarray(j_pit.pit_fill_host(x, 0.4)))

    @pytest.mark.parametrize("native_route", NATIVE_ROUTES, indirect=True)
    def test_equals_priority_flood(self, cycles_on, native_route):
        """The C++ priority flood where there is one; its other case holds
        the plain fixpoint of the sweeps from all ones."""
        x = nir_field(180, 140, seed=32)
        got = t_pit.pit_fill(T(x), 0.45).numpy()
        flood = native.pit_fill_flood(x, 0.45)
        if native_route == "python":
            assert flood is None
            flood = t_pit._fixpoint(T(x), 0.45, torch.ones(x.shape)).numpy()
        assert np.array_equal(got, flood)

    def test_tiled_schedule_after_the_cycles(self, cycles_on, monkeypatch):
        """The active-tile sweeps of large levels, forced onto small ones,
        certify what the cycles left."""
        monkeypatch.setattr(t_pit, "_TILED_MIN_SIZE", 1)
        monkeypatch.setattr(t_pit, "_TILE", 32)
        monkeypatch.setattr(t_pit, "_HALO", 8)
        x = nir_field(200, 170, seed=33)
        assert np.array_equal(t_pit.pit_fill(T(x), 0.45).numpy(),
                              np.asarray(j_pit.pit_fill_host(x, 0.45)))

    def test_levels_report_their_cycles(self, cycles_on):
        """Levels of at least ``_DIRECTIONAL_MIN_SIZE`` cells run cycles and
        then a few sweeps; smaller ones none; the CPU launches no kernel."""
        x = nir_field(200, 170, seed=34)
        levels = []
        before = dict(K.launch_counts)
        got = t_pit.pit_fill(T(x), 0.45, on_level=lambda *a: levels.append(a))
        assert K.launch_counts == before
        assert torch.equal(got, t_pit.pit_fill(T(x), 0.45))
        assert [lvl for lvl, *_ in levels] == [2, 1, 0]
        for _, shape, rounds, cycles in levels:
            assert (cycles > 0) == (shape[0] * shape[1] >= 1000)
            assert rounds and all(cells > 0 and count >= 1 for cells, count in rounds)


def test_cpu_levels_run_no_cycles(monkeypatch):
    """On the CPU the plain cycles lose to the sweeps, so no level runs
    them, however large; the surface is the fixpoint all the same."""
    monkeypatch.setattr(t_pit, "_DIRECTIONAL_MIN_SIZE", 1000)
    x = nir_field(200, 170, seed=35)
    levels = []
    got = t_pit.pit_fill(T(x), 0.45, on_level=lambda *a: levels.append(a))
    assert [cycles for *_, cycles in levels] == [0, 0, 0]
    assert np.array_equal(got.numpy(), np.asarray(j_pit.pit_fill_host(x, 0.45)))


class TestWrapperChecks:
    def test_rejects_bad_operands(self):
        orig, f = T(np.zeros((4, 5), np.float32)), T(np.ones((4, 5), np.float32))
        with pytest.raises(ValueError, match="direction"):
            PK.directional_pass(orig, f, 0.5, "diagonal")
        with pytest.raises(ValueError, match="shape"):
            PK.directional_pass(orig, f[:3], 0.5, "down")
        with pytest.raises(TypeError, match="dtype"):
            PK.directional_pass(orig.double(), f, 0.5, "down")
        with pytest.raises(ValueError, match="max_cycles"):
            PK.directional_budget(orig, 0.5, f, 0)


@st.composite
def start_above_fixpoint(draw):
    h, w = draw(st.integers(1, 12)), draw(st.integers(1, 12))
    seed = draw(st.integers(0, 2**32 - 1))
    border = draw(st.floats(0.0, 1.0, width=32))
    r = np.random.default_rng(seed)
    orig = r.random((h, w)).astype(np.float32)
    return orig, r.random((h, w)).astype(np.float32), np.float32(border)


@settings(max_examples=60, deadline=None)
@given(start_above_fixpoint())
def test_cycle_stays_between_fixpoint_and_start(case):
    """From any f with F* <= f <= 1: F* <= cycle(f) <= f, and F* is left as
    it is (F* the fixpoint of the sweeps from all ones)."""
    orig, u, border = case
    bv = torch.tensor(border)
    fix = t_pit._fixpoint(T(orig), bv, torch.ones(orig.shape))
    f = fix + (1 - fix) * T(u)
    out = t_pit._directional_cycle(T(orig), bv, f)
    assert bool((fix <= out).all()) and bool((out <= f).all())
    assert torch.equal(t_pit._directional_cycle(T(orig), bv, fix), fix)
