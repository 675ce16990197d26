"""The device's side of a traced window, from ``torch.profiler``.

The profiler's clock is not the host's ``time.perf_counter``. A
``record_function`` marker, opened on this thread at a known
``perf_counter`` instant, ties the two together, so device intervals and
the program's spans (``perf_counter`` microseconds) share one timeline.
``busy_us`` and the device intervals follow ``tools/measure.py`` of the
program (``device_intervals``, ``busy_us``), copied here so the yardstick
stays fixed.
"""

from __future__ import annotations

import time

MARK = "bench.clock_mark"


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals
            if e > t0 and s < t1]


class DeviceTrace:
    """A ``torch.profiler`` capture of CPU and CUDA activity. After exit,
    ``events`` holds ``(name, kind, start_us, end_us)`` on the
    ``perf_counter`` clock, kind ``"kernel"`` or ``"memory"`` (copies and
    sets) for device activity."""

    def __init__(self):
        self.events: list[tuple[str, str, float, float]] = []
        self._prof = None
        self._mark_us = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark_us = time.perf_counter_ns() / 1e3
        with record_function(MARK):
            pass
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.events = self._extract()
        return False

    def _extract(self):
        from torch.autograd import DeviceType

        # the raw events, not prof.events(): no operator tree to build
        raw = [(e.name(), e.device_type() == DeviceType.CUDA,
                e.start_ns() / 1e3, e.duration_ns() / 1e3)
               for e in self._prof.profiler.kineto_results.events()]
        marks = [s for name, dev, s, _ in raw if name == MARK and not dev]
        if not marks:
            return []
        offset = marks[0] - self._mark_us
        out = []
        for name, dev, s, d in raw:
            if not dev:
                continue
            low = name.lower()
            kind = ("memory" if low.startswith(("memcpy", "memset"))
                    or "memcpy" in low or "memset" in low else "kernel")
            out.append((name, kind, s - offset, s - offset + d))
        return out

    def intervals(self, kind: str | None = None):
        return [(s, e) for _, k, s, e in self.events
                if kind is None or k == kind]
