"""Tracing of the port (``satellite_approximation_tpu/utils/profiling.py``).

The reference's observability is spdlog stopwatches around solves and
pipeline stages. Here one layer does both:

* ``span(name, **counts)``, ``count(name, n)`` and ``call(kind)`` mark the
  port's layer boundaries. They record only while a ``torch.profiler``
  profile is active in the process; otherwise ``span`` and ``call`` cost one
  check and hand back a shared null context. A recorded span is a
  ``record_function`` range on the profiler's host timeline (the clock of
  its device events) and a host-only :class:`Record` in a bounded in-memory
  list that :func:`records` reads back, timed on ``time.perf_counter_ns``.
  No span or counter synchronises with the device or reads a device value;
  records hold Python numbers and strings only. Span names are fixed
  strings; per-call values go into the counts.
* :class:`StageTimer`: ``detect``'s per-stage wall times, each stage a span
  named ``detect.<stage>``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch

from .log import create_logger

_logger = create_logger("utils.profiling")

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# the innermost open span of this thread (or of the task a worker runs for it)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("profiling_span", default=None)
_CALL_IDS = itertools.count(1)
# a full tile's detect opens some hundred spans, so this holds thousands of
# calls; the oldest records go first
RECORDS_KEPT = 1 << 17
_RECORDS: collections.deque = collections.deque(maxlen=RECORDS_KEPT)


class Record(NamedTuple):
    """One closed span. ``call_id`` is the id of the public call it ran in
    (None outside every call), ``parent`` the name of the span open around
    it, ``thread`` the name of the thread it ran on."""

    call_id: int | None
    name: str
    parent: str | None
    thread: str
    start_ns: int
    end_ns: int
    counts: dict


class _Span:
    __slots__ = ("name", "counts", "call_id", "parent", "_range", "_token", "_start")

    def __init__(self, name: str, counts: dict, call_id: int | None = None):
        self.name = name
        self.counts = counts
        self.call_id = call_id

    def __enter__(self):
        up = _CURRENT.get()
        self.parent = None if up is None else up.name
        if self.call_id is None and up is not None:
            self.call_id = up.call_id
        self._token = _CURRENT.set(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _CURRENT.reset(self._token)
        _RECORDS.append(Record(self.call_id, self.name, self.parent,
                               threading.current_thread().name, self._start, end, self.counts))
        return False


def _recording() -> bool:
    # a worker's task runs under its submitter's open span (``carry``),
    # where the profiler, which is per thread, is off
    return _profiler_enabled() or _CURRENT.get() is not None


def span(name: str, **counts):
    """A span named ``name`` (a fixed string) with starting ``counts``."""
    if not _recording():
        return _NULL
    return _Span(name, counts)


def call(kind: str):
    """The top-level span ``<kind>.call`` of one public call: it and every
    span opened inside it carry a fresh call id."""
    if not _recording():
        return _NULL
    return _Span(f"{kind}.call", {}, next(_CALL_IDS))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    s = _CURRENT.get()
    if s is not None:
        s.counts[name] = s.counts.get(name, 0) + n


def carry(fn):
    """``fn`` to hand to another thread: it runs under the spans open here,
    so its own spans carry this call's id."""
    if _CURRENT.get() is None:
        return fn
    return functools.partial(contextvars.copy_context().run, fn)


def records() -> list[Record]:
    """The closed spans kept, oldest first."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


class StageTimer:
    """Accumulate named stage wall times; ``report()`` renders a summary.

    ``device``: the device the stages run on. CUDA work is asynchronous, so
    with a CUDA device every stage ends with a synchronise; without it a
    stage would read as the time to launch its kernels. Each stage is a
    span ``detect.<stage>`` that closes after the synchronise.

    ``stages``: (name, seconds) in the order the stages ended. Stages may end
    on worker threads (the big-scene schedule writes the mask files
    concurrently with device stages) and inside other stages (the matching's
    sweeps); ``report()`` keeps both out of its total.

    ``routes``: which implementation each routed stage took in the last run
    ("shadow stage" -> "device", ...), filled in by the pipeline.
    """

    def __init__(self, device=None):
        self.routes: dict[str, str] = {}
        self.device = None if device is None else torch.device(device)
        self._owner = threading.get_ident()
        self._open = threading.local()
        # (name, seconds, on a worker thread, inside another stage)
        self._log: list[tuple[str, float, bool, bool]] = []

    @property
    def stages(self) -> list[tuple[str, float]]:
        return [(name, t) for name, t, _, _ in self._log]

    @contextlib.contextmanager
    def stage(self, name: str, fixed: str | None = None, **counts):
        """Time the stage ``name``. ``fixed``: the fixed part of ``name``,
        which names the span where ``name`` carries per-call values; those
        go in ``counts``."""
        depth = getattr(self._open, "depth", 0)
        self._open.depth = depth + 1
        t0 = time.perf_counter()
        try:
            with span(f"detect.{fixed or name}", **counts):
                try:
                    yield
                finally:
                    if self.device is not None and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        finally:
            dt = time.perf_counter() - t0
            self._open.depth = depth
            self._log.append((name, dt, threading.get_ident() != self._owner, depth > 0))
            _logger.debug("%s: %.3fs", name, dt)

    def report(self) -> str:
        """The outermost stages of the thread that made the timer, with
        their total; then the stages inside them and those of worker
        threads, which overlap it."""
        top = [(n, t) for n, t, worker, nested in self._log if not (worker or nested)]
        total = sum(t for _, t in top)
        lines = [f"{n}: {t:.3f}s ({100 * t / total:.1f}%)" if total else f"{n}: {t:.3f}s"
                 for n, t in top]
        lines.append(f"total: {total:.3f}s")
        inner = [(n, t) for n, t, worker, nested in self._log if nested and not worker]
        workers = [(n, t) for n, t, worker, _ in self._log if worker]
        for title, part in (("inside the stages above", inner),
                            ("on worker threads, overlapping the total", workers)):
            if part:
                lines.append(f"{title}:")
                lines += [f"  {n}: {t:.3f}s" for n, t in part]
        return "\n".join(lines)
