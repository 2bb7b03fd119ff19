"""Reduction of a ``torch.profiler`` trace to the numbers the metrics read:
device intervals by name, the busy time (their union), and the breakdown
of a traced run (the device operations that took most time, and the idle
gaps of the device by what the host was doing)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def events(prof) -> tuple[list, list]:
    """(device events, host events) of a finished profile, each a list of
    (name, start_us, end_us) sorted by start. Read from the profiler's raw
    results: ``prof.events()`` first builds a tree of every operation,
    which takes some 20 s a call of a tile's ``detect``."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    dev, host = [], []
    for e in results.events():
        if e.is_hidden_event():
            continue
        name = e.name()
        start = (e.start_ns() - t0) / 1e3
        item = (name, start, start + e.duration_ns() / 1e3)
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not (e.is_user_annotation() or name.startswith("portbench:")):
            # a named host span also shows on the device's timeline, over the
            # operations it launched: it is no operation of the device
            dev.append(item)
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (name, start, end) intervals as sorted disjoint spans."""
    spans: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return [(s, e) for s, e in spans]


def union_seconds(intervals) -> float:
    return sum(e - s for s, e in merged(intervals)) / 1e6


def idle_percent(run):
    """1 - the union of the device's operation intervals over the traced
    window, in percent; None in a run without a trace."""
    if not run.device_events:
        return None
    return 100.0 * (1.0 - union_seconds(run.device_events) / run.window_s)


def seconds_by_name(intervals, match) -> tuple[float, int]:
    """(summed seconds, count) of the intervals whose name ``match`` takes."""
    total, n = 0.0, 0
    for name, s, e in intervals:
        if match(name):
            total += e - s
            n += 1
    return total / 1e6, n


def breakdown(device, host, top: int = 10, gaps_read: int = 200) -> dict:
    """The device operations with most time, and the idle time between
    device operations summed by the host operation running at each gap's
    middle (the innermost, i.e. shortest, one that covers it; the harness
    names its own spans); at most ``top`` entries each, over the
    ``gaps_read`` longest gaps; seconds as measured."""
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in device:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = merged(device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:gaps_read]
    starts = np.array([s for _, s, _ in host], dtype=np.float64)
    ends = np.array([e for _, _, e in host], dtype=np.float64)
    idle: dict[str, float] = defaultdict(float)
    for length, mid in gaps:
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = host[cover[np.argmin(ends[cover] - starts[cover])]][0] if cover.size else (
            "host: outside every traced span")
        idle[name] += length / 1e6
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle_top]}
