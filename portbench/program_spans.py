"""The program's own spans and counters in a traced run's window: the
records of ``satellite_approximation_tpu_torch/utils/profiling.py``, which
the program keeps while a ``torch.profiler`` profile is active. They are
what the ``program_span`` and ``program_counter`` metrics of the fill's and
``detect``'s layers read. A run without a trace, or a program that keeps no
such records, gives None."""

from __future__ import annotations


def in_window(run):
    """The records that start inside the run's window (the warm-up call and
    the check fall outside it), or None where the program keeps none."""
    try:
        from satellite_approximation_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    lo, hi = (round(t * 1e9) for t in run.window)  # perf_counter seconds -> its ns
    return [r for r in records() if lo <= r.start_ns <= hi]


def per_call(run, kind: str, value):
    """``value(record)`` summed over the records of each ``<kind>.call`` in
    the window, as a mean a call; None without such a call."""
    got = in_window(run)
    if not got:
        return None
    ids = {r.call_id for r in got if r.name == f"{kind}.call"}
    if not ids:
        return None
    return sum(value(r) for r in got if r.call_id in ids) / len(ids)


def seconds(*names: str):
    """A record's seconds where its span is one of ``names``, else 0."""
    return lambda r: (r.end_ns - r.start_ns) / 1e9 if r.name in names else 0.0


def counter(name: str, span: str | None = None):
    """A record's counter ``name`` (0 where it has none), of ``span``'s
    records only where given."""
    return lambda r: r.counts.get(name, 0) if span is None or r.name == span else 0
