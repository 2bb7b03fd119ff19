"""The port's Poisson blend (``models/poisson.py::blend_images_poisson``) on
the CPU, held against the benchmark's plain reference
(``portbench/reference/blend.py``: the Poisson-editing system worked out
again from the raw inputs, its float64 residual, the known pixels changed,
and its own float64 CG solve), on seeded u16-valued stacks, through both
overloads; the faults a blend can have, each planted, come out as not
correct; and the reference imports neither the port nor JAX."""

from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import blend as reference
from portbench.traffic import scenes
from satellite_approximation_tpu_torch.config import DEFAULT_SOLVER
from satellite_approximation_tpu_torch.models import fill, multigrid, poisson

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6  # the public default, the limit of the benchmark's blend cell
TIGHT = 1e-11  # where the answer lies within 1e-5 of the reference's f64 solve
MG = dataclasses.replace(DEFAULT_SOLVER, mg_threshold_pixels=256)  # the multigrid route


@pytest.fixture(autouse=True)
def _no_cached_hierarchies():
    yield
    multigrid._HIERARCHY_CACHE.clear()


def _stack(c, h, w, seed):
    return np.random.default_rng(seed).integers(1, 10001, size=(c, h, w)).astype(np.float64)


def _mask(kind: str, h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    if kind == "border":  # the frame and a blob that runs into it
        m[0, :] = m[-1, :] = True
        m[:, 0] = m[:, -1] = True
        m[: h // 3, w // 2:] = True
    elif kind == "pixel":
        m[h // 2, w // 3] = True
    elif kind == "corner":  # one unknown of two neighbours
        m[-1, 0] = True
    elif kind.startswith("cover"):  # blobs of 8 x 8 at the cover's share
        cover = int(kind[5:]) / 100
        f = np.random.default_rng(3).random((h // 8 + 2, w // 8 + 2))
        f = np.kron(f, np.ones((8, 8)))[:h, :w]
        m = f >= np.quantile(f, 1 - cover)
    return m


def _correct(got: dict, tol: float) -> bool:
    return got["residual"] <= tol and got["known_changed"] == 0


SHAPES = [(3, 96, 80), (13, 64, 72)]
KINDS = ["border", "pixel", "corner", "empty", "cover5", "cover60"]


@pytest.mark.parametrize("config", [DEFAULT_SOLVER, MG], ids=["default", "multigrid"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mask_overload_against_the_reference(shape, kind, config):
    c, h, w = shape
    images, repl, invalid = _stack(c, h, w, 1), _stack(c, h, w, 2), _mask(kind, h, w)
    out = poisson.blend_images_poisson(images, repl, invalid_mask=invalid, config=config,
                                       device="cpu")
    assert out.shape == images.shape and out.dtype == np.float64
    got = reference.judge(images, repl, invalid, out, "cpu")
    assert _correct(got, TOL), got
    out = poisson.blend_images_poisson(images, repl, invalid_mask=invalid, tolerance=TIGHT,
                                       config=config, device="cpu")
    got = reference.judge(images, repl, invalid, out, "cpu")
    assert _correct(got, TIGHT), got
    want = reference.solve(images, repl, invalid, torch.float64, "cpu", 1e-14, 5000)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out[:, ~invalid], images[:, ~invalid])
    if kind == "empty":
        np.testing.assert_array_equal(out, images)


@pytest.mark.parametrize("kind", ["frame", "blob"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_patch_overload_against_the_reference(shape, kind):
    """The patch's non-sentinel pixels are the unknowns of the system of
    its window; every pixel off them, in the window and out of it, stays."""
    c, h, w = shape
    images = _stack(c, h, w, 4)
    r0, c0, rh, rw = 9, 11, 40, 36
    patch = _stack(c, rh, rw, 5)
    sentinel = np.ones((rh, rw), bool)
    if kind == "frame":  # sentinel all round: the unknowns sit inside
        sentinel[3:-3, 4:-4] = False
    else:  # unknowns that reach the window's edge
        sentinel[:25, 10:] = False
    patch[:3, sentinel] = 1.0
    window = (slice(None), slice(r0, r0 + rh), slice(c0, c0 + rw))
    for tol in (TOL, TIGHT):
        out = poisson.blend_images_poisson(images, patch, None, r0, c0, tolerance=tol,
                                           device="cpu")
        got = reference.judge(images[window], patch, ~sentinel, out[window], "cpu")
        assert _correct(got, tol), got
        outside = np.ones((h, w), bool)
        outside[window[1:]] = False
        np.testing.assert_array_equal(out[:, outside], images[:, outside])
    want = reference.solve(images[window], patch, ~sentinel, torch.float64, "cpu", 1e-14, 5000)
    np.testing.assert_allclose(out[window], want, rtol=0, atol=1e-5)


def _planted(fault: str):
    """(readings of a blend with ``fault`` planted, readings of the blend
    itself): random u16 stacks at 60 % cover, or for the float32 control
    the benchmark's smooth scenes, whose float32 floor the 1e-6 limit sits
    under."""
    if fault == "float32 control":
        gen = scenes.generator(2**41 + 3, "cpu")
        images = scenes.smooth_bands(3, 200, 180, gen, "cpu").double().numpy()
        invalid = scenes.fill_scene(200, 180, 0.6, gen, "cpu").numpy()
        repl = scenes.smooth_bands(3, 200, 180, gen, "cpu").double().numpy()
    else:
        images, repl, invalid = _stack(3, 96, 80, 1), _stack(3, 96, 80, 2), _mask("cover60", 96, 80)
    out = poisson.blend_images_poisson(images, repl, invalid_mask=invalid, device="cpu")
    good = reference.judge(images, repl, invalid, out, "cpu")
    bad = out.copy()
    ys, xs = np.nonzero(invalid)
    if fault == "one unknown off by 1":
        bad[1, ys[len(ys) // 2], xs[len(xs) // 2]] += 1.0
    elif fault == "a known pixel changed":
        ky, kx = np.nonzero(~invalid)
        bad[2, ky[0], kx[0]] += 1.0
    elif fault == "float32 control":
        bad = reference.solve(images, repl, invalid, torch.float32, "cpu", TOL, 20000)
    elif fault == "guidance ignored":  # the Laplace fill of the same mask
        bad = fill.laplace_fill(images, invalid, tolerance=1e-9, device_output=False,
                                device="cpu").x.astype(np.float64)
    return reference.judge(images, repl, invalid, bad, "cpu"), good


@pytest.mark.parametrize("fault", ["one unknown off by 1", "a known pixel changed",
                                   "float32 control", "guidance ignored"])
def test_planted_faults_are_not_correct(fault):
    got, good = _planted(fault)
    assert _correct(good, TOL), good
    assert not _correct(got, TOL), got
    if fault == "a known pixel changed":
        assert got["known_changed"] == 1
    else:
        assert got["known_changed"] == 0 and got["residual"] > 2 * TOL


def test_reference_imports_neither_the_port_nor_jax():
    path = ROOT / "portbench" / "reference" / "blend.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops == {"__future__", "contextlib", "numpy", "torch"}
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench.reference import blend; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'satellite_approximation_tpu', "
            "'satellite_approximation_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]"


def test_reference_holds_tf32_off_and_restores_it():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    seen = []
    real = reference.rhs

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*args)

    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        reference.rhs = spy
        images = _stack(2, 20, 24, 7)
        invalid = _mask("pixel", 20, 24)
        reference.judge(images, images, invalid, images, "cpu")
        reference.solve(images, images, invalid, torch.float64, "cpu", TOL, 10)
        assert seen and set(seen) == {(False, False)}
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        reference.rhs = real
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
