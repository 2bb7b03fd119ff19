"""The fill's band-chunk loop (``models/fill.py::laplace_fill``) on the CPU:
``solve_matrix`` with the chunk size forced to 1, 2, 3 and 4 bands of a
4-band u16-valued stack, each answer judged by the benchmark's plain
reference (``portbench/reference/fill.py``: the system worked out again
from the raw inputs, its float64 residual and the known pixels changed),
the spans one traced call records for its chunks, and the sizing rules:
chunks from the memory the allocator could hand out whatever it holds
reserved, one band a chunk for bands of ``cg.BAND_BATCH_PIXELS`` pixels,
and hierarchy cache entries that do not keep the caller's level-0 ``deg``."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import fill as reference
from satellite_approximation_tpu_torch.config import DEFAULT_SOLVER
from satellite_approximation_tpu_torch.models import cg, fill, laplace, multigrid
from satellite_approximation_tpu_torch.utils import profiling

BANDS, H, W = 4, 80, 96
# the multigrid route, whose target is the configurations' 1e-9, at a size
# the CPU solves in a moment
CONFIG = dataclasses.replace(DEFAULT_SOLVER, mg_threshold_pixels=256)


def _stack():
    rng = np.random.default_rng(16)
    return rng.integers(1, 10001, size=(BANDS, H, W)).astype(np.float64)


def _mask(kind: str) -> np.ndarray:
    invalid = np.zeros((H, W), bool)
    if kind == "blobs":
        invalid[8:50, 10:60] = True
        invalid[40:72, 55:90] = True
    elif kind == "border":  # invalid border pixels stay known
        invalid[0, :] = invalid[-1, :] = True
        invalid[:, 0] = invalid[:, -1] = True
        invalid[:30, :40] = True
        invalid[50:, 70:] = True
    return invalid


@pytest.fixture
def chunks_of(monkeypatch):
    """Force ``laplace_fill``'s chunks to ``k`` bands (the free device
    memory sizes them on a card; the CPU solves every band in one)."""

    def force(k: int) -> None:
        monkeypatch.setattr(fill, "chunk_elements", lambda device: k * H * W)

    yield force
    multigrid._HIERARCHY_CACHE.clear()


@pytest.fixture(autouse=True)
def _empty_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("kind", ["blobs", "border"])
@pytest.mark.parametrize("bands_per_chunk", [1, 2, 3, 4])
def test_chunked_fill_against_the_reference(chunks_of, bands_per_chunk, kind):
    chunks_of(bands_per_chunk)
    images, invalid = _stack(), _mask(kind)
    out, result = laplace.solve_matrix(images, invalid, CONFIG, device="cpu")
    assert out.shape == images.shape and result.iterations > 0
    got = reference.judge(images, invalid, out, "cpu")
    assert got["residual"] <= 1e-9, got
    assert got["known_changed"] == 0, got


@pytest.mark.parametrize("bands_per_chunk", [1, 2, 3, 4])
def test_no_unknowns_returns_the_stack(chunks_of, bands_per_chunk):
    """Invalid pixels on the border only: nothing to solve, the stack comes
    back unchanged."""
    chunks_of(bands_per_chunk)
    images, invalid = _stack(), _mask("border")
    invalid[1:-1, 1:-1] = False
    out, result = laplace.solve_matrix(images, invalid, CONFIG, device="cpu")
    np.testing.assert_array_equal(out, images)
    assert result.iterations == 0


@pytest.mark.parametrize("bands_per_chunk, chunks", [(1, [1, 1, 1, 1]), (2, [2, 2]),
                                                     (3, [3, 1]), (4, [4])])
def test_a_traced_call_records_its_chunks(chunks_of, bands_per_chunk, chunks):
    """One ``fill.chunk`` a chunk with its ``bands`` and one ``fill.join``,
    all under the call's id and inside ``fill.laplace_fill``; every pass and
    fetch inside a chunk."""
    chunks_of(bands_per_chunk)
    with profile(activities=[ProfilerActivity.CPU]):
        laplace.solve_matrix(_stack(), _mask("blobs"), CONFIG, device="cpu")
    recs = profiling.records()
    [call] = [r for r in recs if r.name == "fill.call"]
    assert {r.call_id for r in recs} == {call.call_id}
    mine = [r for r in recs if r.name == "fill.chunk"]
    assert [r.counts["bands"] for r in mine] == chunks
    assert {r.parent for r in mine} == {"fill.laplace_fill"}
    [join] = [r for r in recs if r.name == "fill.join"]
    assert join.parent == "fill.laplace_fill"
    for name in ("fill.pass", "fill.fetch"):
        assert {r.parent for r in recs if r.name == name} == {"fill.chunk"}
    assert sum(r.name == "fill.fetch" for r in recs) == len(chunks)


@pytest.mark.parametrize("free, reserved, allocated", [
    (60 * 2**30, 0, 0),  # nothing held back
    (20 * 2**30, 45 * 2**30, 5 * 2**30),  # what an earlier call left reserved
    (59 * 2**30, 2 * 2**30, 1 * 2**30),
])
def test_chunk_elements_count_reserved_blocks_as_free(monkeypatch, free, reserved, allocated):
    """The same 60 GiB the allocator could hand out give the same chunk,
    however much of it the allocator holds reserved."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (free, 80 * 2**30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: allocated)
    dev = torch.device("cuda", 0)
    assert cg.free_device_bytes(dev) == 60 * 2**30
    assert cg.chunk_elements(dev) == int(0.8 * 60 * 2**30) // cg._STATE_BYTES_PER_ELEMENT
    assert cg.chunk_elements(torch.device("cpu")) == sys.maxsize


@pytest.mark.parametrize("h, w, limit, want", [
    (5490, 5490, 10**9, 33),  # a 20 m band batches as far as the memory lets it
    (5490, 5490, 9 * 5490 * 5490, 9),
    (5490, 5490, 5490 * 5490 - 1, 1),  # never below one band
    (1284, 1697, 13 * 1284 * 1697, 13),
    (8192, 8192, 10**12, 1),  # one band of BAND_BATCH_PIXELS fills the card
    (10980, 10980, 10**12, 1),
    (10980, 10980, 1, 1),
])
def test_bands_per_chunk(h, w, limit, want):
    assert cg.bands_per_chunk(h, w, limit) == want


def test_large_bands_solve_one_a_chunk(monkeypatch):
    """Bands at or over ``BAND_BATCH_PIXELS`` pixels solve one a chunk
    although the memory would take them all."""
    monkeypatch.setattr(cg, "BAND_BATCH_PIXELS", H * W)
    monkeypatch.setattr(fill, "chunk_elements", lambda device: 10 * BANDS * H * W)
    images, invalid = _stack(), _mask("blobs")
    with profile(activities=[ProfilerActivity.CPU]):
        out, _ = laplace.solve_matrix(images, invalid, CONFIG, device="cpu")
    assert [r.counts["bands"] for r in profiling.records() if r.name == "fill.chunk"] == [1] * 4
    got = reference.judge(images, invalid, out, "cpu")
    assert got["residual"] <= 1e-9 and got["known_changed"] == 0, got
    multigrid._HIERARCHY_CACHE.clear()


@pytest.mark.parametrize("shape", [(64, 80), (6, 5)])
def test_cache_entry_does_not_keep_the_callers_deg(monkeypatch, shape):
    """A cached hierarchy holds its mask's levels but not the level-0 deg of
    the call that built it; a hit takes the new caller's deg (a one-level
    hierarchy's dense inverse too)."""
    monkeypatch.setattr(multigrid, "_HIERARCHY_CACHE", type(multigrid._HIERARCHY_CACHE)())
    h, w = shape
    umask = torch.zeros(shape, dtype=torch.bool)
    umask[1 : h - 1, 1 : w - 1] = True
    cpu = torch.device("cpu")
    deg1, deg2 = (cg.neighbor_degree_tensor(h, w, cpu) for _ in range(2))
    built = multigrid._device_hierarchy(umask, deg1, cpu)
    assert built.levels[0][1] is deg1
    [entry] = multigrid._HIERARCHY_CACHE.values()
    assert entry.levels[0][0] is umask and entry.levels[0][1] is None
    assert entry.levels[1:] == built.levels[1:]  # the same tensors
    hit = multigrid._device_hierarchy(umask.clone(), deg2, cpu)
    assert hit.levels[0][0] is umask and hit.levels[0][1] is deg2
    assert len(multigrid._HIERARCHY_CACHE) == 1
    if len(built.levels) == 1:
        torch.testing.assert_close(hit.coarse_inv, built.coarse_inv)
