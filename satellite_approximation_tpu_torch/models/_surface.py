"""The fill's host surface: the f32 exactness test of an f64 band stack, and
the scatter of the solved values back into a copy of it.

Both are passes over the whole stack, up to a tile's 9 x 5490^2 f64 (2.2 GB).
They run in blocks of one band x a run of rows of about ``BLOCK_BYTES``, on a
shared thread pool (numpy's casts, comparisons and indexed writes release the
GIL), and write into arrays allocated once: no full-size temporary. A stack
of one block or less runs on the caller's thread.

The counters ``surface_blocks`` (blocks tested) and ``surface_threads`` (the
pool's width, 1 inline) go to the innermost open span, ``fill.exactness_check``
in ``laplace.solve_matrix`` and in ``poisson.blend_images_poisson``, where they
add up over the input and the replacement stacks.
"""

from __future__ import annotations

import itertools
import os
import threading

import numpy as np

from ..utils import profiling

# f64 bytes of a block. Each block costs a few GIL hand-offs: on an 8-core
# H100 host, in turns over a tile's fill calls, the test took 1.4x as long
# with 2 MiB blocks as with 4 MiB, and 8 or 16 MiB were no faster
BLOCK_BYTES = 4 << 20
# host memory bandwidth saturates by then
MAX_THREADS = 16

_pool = None
_width = None
_pool_lock = threading.Lock()


def _get_pool():
    """The module's pool and its width: the CPUs this process may run on,
    at most ``MAX_THREADS``."""
    global _pool, _width
    with _pool_lock:
        if _width is None:
            cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                    else os.cpu_count() or 1)
            _width = min(cpus, MAX_THREADS)
        if _pool is None and _width > 1:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(max_workers=_width, thread_name_prefix="sat-surface")
    return _pool, _width


def _row_edges(shape, itemsize: int) -> list[int]:
    """The first row of each block of a band, then the band's height."""
    h, w = shape[-2], shape[-1]
    rows = max(1, BLOCK_BYTES // (itemsize * max(w, 1)))
    return list(range(0, h, rows)) + [h]


def _run(work, blocks: list, nbytes: int) -> tuple[int, int, bool]:
    """``work(block)`` for each block, in order, until one returns False;
    the blocks not started by then are not run. Pooled when the stack
    (``nbytes``) is more than one block. Returns (blocks run, threads,
    whether every block run returned True)."""
    pool, width = _get_pool() if nbytes > BLOCK_BYTES else (None, 1)
    if pool is None:
        done = 0
        for block in blocks:
            done += 1
            if not work(block):
                return done, 1, False
        return done, 1, True

    taken = itertools.count()  # next() is atomic under the GIL
    failed = threading.Event()

    def worker() -> int:
        done = 0
        while not failed.is_set():
            i = next(taken)
            if i >= len(blocks):
                break
            done += 1
            try:
                ok = work(blocks[i])
            except BaseException:
                failed.set()
                raise
            if not ok:
                failed.set()
        return done

    futures = [pool.submit(worker) for _ in range(min(width, len(blocks)))]
    done = sum(f.result() for f in futures)
    return done, width, not failed.is_set()


def cast_exact_f32(stack: np.ndarray, policy: str) -> tuple[np.ndarray | None, bool]:
    """``stack`` (C, H, W) f64 cast to a fresh f32 array, and whether the
    device path takes it (``SolverConfig.device_assembly``):

    * ``"auto"``: exactly when the cast is exact, the answer of
      ``np.array_equal(stack.astype(np.float32).astype(np.float64), stack)``
      (NaN, f64 subnormals and values beyond the f32 range are not exact;
      +-inf and -0.0 are). The test stops at the first block that fails,
      and the f32 array is then None.
    * ``"force"``: always, cast without the test.
    * anything else: never; nothing is cast.

    An (H, W) stack is one band.
    """
    if stack.ndim == 2:
        img32, exact = cast_exact_f32(stack[None], policy)
        return (None if img32 is None else img32[0]), exact
    if policy not in ("auto", "force"):
        profiling.count("surface_blocks", 0)
        profiling.count("surface_threads", 0)
        return None, False
    test = policy == "auto"
    img32 = np.empty(stack.shape, np.float32)
    edges = _row_edges(stack.shape, stack.itemsize)
    blocks = [(b, edges[j], edges[j + 1])
              for b in range(stack.shape[0]) for j in range(len(edges) - 1)]

    def work(block) -> bool:
        b, r0, r1 = block
        src, dst = stack[b, r0:r1], img32[b, r0:r1]
        np.copyto(dst, src, casting="unsafe")
        return not test or np.array_equal(dst, src)

    done, threads, exact = _run(work, blocks, stack.nbytes)
    profiling.count("surface_blocks", done if test else 0)
    profiling.count("surface_threads", threads)
    return (img32, True) if exact else (None, False)


def scatter_masked(stack: np.ndarray, umask: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """A fresh copy of ``stack`` (C, H, W) with ``vals`` (C, n) written at
    the n true pixels of ``umask`` (H, W), in ``np.nonzero``'s order:
    ``stack.copy(); [..., ys, xs] = vals``. ``stack`` is only read.

    Two passes: the unknowns' positions in each run of rows, then the
    blocks, each a copy of a band's run of rows and the writes into it. An
    (H, W) stack is one band, with ``vals`` (n,)."""
    if stack.ndim == 2:
        return scatter_masked(stack[None], umask, vals)[0]
    c, h, w = stack.shape
    filled = np.empty(stack.shape, stack.dtype)
    vals = np.asarray(vals).reshape(c, -1)
    edges = _row_edges(stack.shape, stack.itemsize)
    runs = len(edges) - 1
    where = [None] * runs

    def find(j: int) -> bool:
        where[j] = np.flatnonzero(umask[edges[j]:edges[j + 1]])
        return True

    _run(find, list(range(runs)), stack.nbytes)
    # the unknowns of run j are vals[:, at[j]:at[j + 1]]
    at = np.cumsum([0] + [len(x) for x in where]).tolist()

    def work(block) -> bool:
        b, j = block
        rows = filled[b, edges[j]:edges[j + 1]]
        np.copyto(rows, stack[b, edges[j]:edges[j + 1]])
        rows.reshape(-1)[where[j]] = vals[b, at[j]:at[j + 1]]
        return True

    _run(work, [(b, j) for b in range(c) for j in range(runs)], stack.nbytes)
    return filled
