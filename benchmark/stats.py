"""Arithmetic the metric readers share: percentiles and span sums."""

from __future__ import annotations

import math


def nearest_rank(values, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``pct`` percent of all values at or below it. Missing answers are
    passed as ``math.inf`` and count like any other value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = max(math.ceil(pct / 100.0 * len(xs)) - 1, 0)
    return xs[k]


def window_us(run) -> tuple[float, float]:
    return run.t0 * 1e6, run.t1 * 1e6


def span_seconds(run, name: str, ids=None, parents=None) -> float:
    """Seconds of the spans named ``name`` inside the window, clipped to
    it; only those with an id in ``ids`` or a parent in ``parents`` when
    given."""
    lo, hi = window_us(run)
    total = 0.0
    for n, s, e, args in run.spans:
        if n != name:
            continue
        if ids is not None and args.get("id") not in ids:
            continue
        if parents is not None and args.get("parent") not in parents:
            continue
        total += max(min(e, hi) - max(s, lo), 0.0)
    return total / 1e6


def counter_delta(run, name: str) -> float | None:
    """Growth of a counter (every label set summed) across the window."""
    try:
        before = run.registry["t0"][name][1]
        after = run.registry["t1"][name][1]
    except KeyError:
        return None
    return sum(after.values()) - sum(before.values())


def histogram_delta(run, name: str) -> tuple[float, int] | None:
    """(sum, count) of a histogram's observations made in the window."""
    try:
        before = run.registry["t0"][name][1]["series"]
        after = run.registry["t1"][name][1]["series"]
    except KeyError:
        return None
    s = sum(v[1] for v in after.values()) - sum(v[1] for v in
                                                 before.values())
    c = sum(v[2] for v in after.values()) - sum(v[2] for v in
                                                 before.values())
    return s, c
