"""Component health registry and stall watchdogs (the part of
``spacemesh_tpu/obs/health.py`` the verification farm and verifyd use).

Liveness here is **progress, not heartbeats**: a :class:`Watchdog` wraps a
monotonically advancing counter (the farm's dispatched items, verifyd's
resolved items) with an activity predicate and a deadline: "while there
is work outstanding, the counter must advance within N seconds". Probes
register on the process-global :data:`HEALTH` registry, which verifyd's
``/readyz`` reports. ``unregister`` removes only the exact probe that was
registered, so a closing component never evicts its successor.

Left out against the JAX package, for the instrumentation item of the
port: the SLO definitions, the ``HealthEngine`` tick loop (SLI windows,
burn rates, events, the flight recorder), and the writer/store probes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

# Probe protocol: fn(now: float) -> (healthy: bool, reason: str)
Probe = Callable[[float], tuple[bool, str]]

DEFAULT_STALL_DEADLINE_S = 30.0


class Watchdog:
    """Progress-counter-not-advancing detection.

    ``progress()`` returns any value that changes while the component
    makes progress (usually a monotonically increasing count).
    ``active()`` gates the deadline: an idle component (no outstanding
    work) is healthy by definition. The first check after becoming
    active re-baselines, so a long-idle component is never accused of a
    stall it had no work to progress through.
    """

    def __init__(self, name: str, progress: Callable[[], object],
                 deadline_s: float = DEFAULT_STALL_DEADLINE_S,
                 active: Callable[[], bool] | None = None):
        self.name = name
        self.progress = progress
        self.deadline_s = float(deadline_s)
        self.active = active
        self._last_value: object = object()  # sentinel != any progress
        self._last_advance: float | None = None

    def check(self, now: float) -> tuple[bool, str]:
        try:
            if self.active is not None and not self.active():
                self._last_advance = None  # re-baseline on next activity
                return True, "idle"
            value = self.progress()
        except Exception as exc:  # noqa: BLE001 — a dead probe IS unhealthy
            return False, f"probe raised: {exc!r}"
        if value != self._last_value or self._last_advance is None:
            self._last_value = value
            self._last_advance = now
            return True, f"progress={value}"
        stalled_for = now - self._last_advance
        if stalled_for > self.deadline_s:
            return False, (f"stalled: progress={value} unchanged for "
                           f"{stalled_for:.1f}s (deadline "
                           f"{self.deadline_s:.1f}s)")
        return True, (f"progress={value} "
                      f"(quiet {stalled_for:.1f}s/{self.deadline_s:.1f}s)")


class HealthRegistry:
    """Named liveness probes, reported together (``/readyz``)."""

    def __init__(self) -> None:
        self._probes: dict[str, Probe] = {}
        # pipelines register/unregister from worker threads, readers
        # report from the loop: every access holds this lock
        self._lock = threading.Lock()

    def register(self, name: str, probe: Probe) -> None:
        """Register (or replace) a component probe."""
        with self._lock:
            self._probes[name] = probe

    def unregister(self, name: str, probe: Probe | None = None) -> None:
        """Remove ``name`` — only if it still maps to ``probe`` when one
        is given (a finished pipeline must not evict its successor).
        Equality, not identity: bound methods are rebuilt per access."""
        with self._lock:
            if probe is None or self._probes.get(name) == probe:
                self._probes.pop(name, None)

    def report(self, now: float | None = None) -> dict[str, dict]:
        """{component: {"healthy": bool, "reason": str}} for every
        registered probe. A raising probe reports unhealthy, never
        propagates."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            probes = list(self._probes.items())
        out: dict[str, dict] = {}
        for name, probe in probes:
            try:
                healthy, reason = probe(t)
            except Exception as exc:  # noqa: BLE001
                healthy, reason = False, f"probe raised: {exc!r}"
            out[name] = {"healthy": bool(healthy), "reason": reason}
        return out


HEALTH = HealthRegistry()
