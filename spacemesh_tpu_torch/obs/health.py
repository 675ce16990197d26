"""Component health registry, stall watchdogs, declarative SLOs, and
the HealthEngine tick loop (port of ``spacemesh_tpu/obs/health.py``).

Liveness here is **progress, not heartbeats**: every pipeline already
exposes a monotonically advancing counter (the init fetch frontier, the
LabelWriter durable cursor, the farm's dispatched-item count, verifyd's
resolved items). A :class:`Watchdog` wraps one such counter with an
activity predicate and a deadline ("while there is work outstanding, the
counter must advance within N seconds"), which detects a wedged pipeline
without a single sleep and stays silent while a component is
legitimately idle.

Probes register on the process-global :data:`HEALTH` registry (the same
shape as ``metrics.REGISTRY``): transient pipelines register on entry
and unregister on exit, long-lived components (the verify farm,
verifyd) register for their lifetime. ``unregister`` only removes the
exact probe object that was registered, so a closing component can
never evict its successor under the same name.

The :class:`HealthEngine` ties it together: each ``tick(now)`` samples
the SLI window (obs/sli.py), evaluates every :class:`Slo` with
burn-rate accounting, runs every probe, publishes the verdicts as
metrics, emits ``SloBreach``/``ComponentHealth`` events on the node's
event bus (``node/events.py``) on transitions, logs breaches with the
current trace span id (utils/logging.py JSON mode), and hands transitions
to the flight recorder (obs/flight.py), whose bundles carry the bus's
recent ring. ``tick`` is pure with respect to time (``now`` is
injectable), so the whole engine is testable without one wall-clock
sleep.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional

from ..utils import logging as slog
from ..utils import metrics, sanitize, tracing
from . import sli as sli_mod

_log = slog.get("health")

# Probe protocol: fn(now: float) -> (healthy: bool, reason: str)
Probe = Callable[[float], tuple[bool, str]]

DEFAULT_INTERVAL_S = 5.0
DEFAULT_STALL_DEADLINE_S = 30.0


# --- stall watchdogs ----------------------------------------------------


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


def writer_watchdog(writer, deadline_s: float = DEFAULT_STALL_DEADLINE_S
                    ) -> Watchdog:
    """The LabelWriter liveness contract: while writes are queued or in
    flight, bytes must keep moving — the FLUSHED cursor (contiguous
    bytes handed to the OS) advances per completed write, the DURABLE
    cursor (contiguous bytes *fsynced*) at checkpoint boundaries; either
    advancing counts as progress, so the interval between metadata
    checkpoints never reads as a stall, while a wedged disk shows up
    here before the bounded queue backpressures the whole init pipeline
    to a halt. A writer parked in the ENOSPC retry loop is DEGRADED,
    not stalled — that is ``store_probe``'s verdict, not this one's —
    so the watchdog stays quiet while the pool waits out a full disk.
    (Older writers without ``flushed()`` fall back to the durable
    cursor alone.)"""
    flushed = getattr(writer, "flushed", writer.durable)

    def progress():
        return (flushed(), writer.durable())

    def active():
        if getattr(writer, "degraded", lambda: None)():
            return False  # ENOSPC park: degraded is store_probe's call
        return writer.pending() > 0

    return Watchdog("post.writer", progress=progress,
                    deadline_s=deadline_s, active=active)


def store_probe(writer) -> Probe:
    """The ``post.store`` readiness probe: healthy while the label
    writer is not parked in ENOSPC degradation. Flipping /readyz (and
    never the process) is the whole point — a full disk pauses init,
    the operator frees space, init resumes."""

    def probe(now: float) -> tuple[bool, str]:
        reason = writer.degraded()
        if reason:
            return False, f"degraded: {reason}"
        return True, "ok"

    return probe


# --- the component health registry --------------------------------------


class HealthRegistry:
    """Named liveness probes, reported together (``/readyz``)."""

    def __init__(self) -> None:
        self._probes: dict[str, Probe] = {}
        # probe map declared shared to the lockset sanitizer: pipelines
        # register/unregister from worker threads, the engine ticks
        # from the loop — every access must hold this lock
        self._lock = sanitize.lock("health.registry")
        self._shared = sanitize.SharedField("health.registry.probes")

    def register(self, name: str, probe: Probe) -> None:
        """Register (or replace) a component probe."""
        with self._lock:
            self._shared.touch()
            self._probes[name] = probe

    def unregister(self, name: str, probe: Probe | None = None) -> None:
        """Remove ``name`` — only if it still maps to ``probe`` when one
        is given (a finished pipeline must not evict its successor).
        Equality, not identity: bound methods are rebuilt per access."""
        with self._lock:
            self._shared.touch()
            if probe is None or self._probes.get(name) == probe:
                self._probes.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            self._shared.touch(write=False)
            return sorted(self._probes)

    def report(self, now: float | None = None) -> dict[str, dict]:
        """{component: {"healthy": bool, "reason": str}} for every
        registered probe. A raising probe reports unhealthy, never
        propagates."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._shared.touch(write=False)
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


# --- declarative SLOs ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slo:
    """target + window + burn budget over one SLI.

    The SLO is met while ``sli_value op target`` holds ("<=" for
    latency/lag ceilings, ">=" for throughput floors). Each engine tick
    marks the instant as violating or not; ``burn`` is the violating
    fraction of the trailing ``window_s``. The SLO **breaches** when
    burn exceeds ``budget`` (budget 0.0: the first violating tick
    breaches). An SLI with no data is *unknown*, which neither violates
    nor repairs — the burn window simply doesn't advance on it.
    """

    name: str
    sli: str                      # SliSpec.name this SLO constrains
    target: float
    op: str = "<="                # "<=" or ">="
    window_s: float = 300.0
    budget: float = 0.0           # allowed violating fraction, 0..1

    def violated(self, value: float) -> bool:
        if self.op == "<=":
            return value > self.target
        if self.op == ">=":
            return value < self.target
        raise ValueError(f"unknown SLO op {self.op!r}")


def default_slos() -> list[Slo]:
    return [
        Slo(name="layer_apply_latency", sli="layer_apply_p99",
            target=2.0, window_s=300.0, budget=0.1),
        Slo(name="farm_queue_wait", sli="farm_queue_wait_p99",
            target=0.25, window_s=120.0, budget=0.2),
        Slo(name="farm_dispatch_latency", sli="farm_dispatch_p99",
            target=5.0, window_s=300.0, budget=0.1),
        Slo(name="gossip_handler_latency", sli="gossip_handler_p99",
            target=1.0, window_s=300.0, budget=0.1),
        Slo(name="event_loop_lag", sli="event_loop_lag",
            target=0.5, window_s=120.0, budget=0.2),
    ]


def verifyd_slos() -> list[Slo]:
    """The verification service's SLO set: under overload the service
    SHEDS rather than queueing — so admitted BLOCK-lane work keeps a
    tight latency ceiling, and the aggregate p99 a looser one."""
    return [
        Slo(name="verifyd_block_latency", sli="verifyd_request_block_p99",
            target=0.5, window_s=60.0, budget=0.1),
        Slo(name="verifyd_request_latency", sli="verifyd_request_p99",
            target=2.0, window_s=120.0, budget=0.2),
    ]


def fleet_slos() -> list[Slo]:
    """The verifyd fleet's SLO set (verifyd/fleet.py): what the NODE
    experienced end-to-end, whichever replica (or the local farm)
    served it.  The BLOCK-lane p99 mirrors the failover scenario's
    acceptance bar — a replica kill mid-load must NOT show up here
    (the sim's fleet scenario asserts this SLO green on the virtual
    clock); the aggregate p99 keeps a looser ceiling on the gossip and
    sync lanes' tail."""
    return [
        Slo(name="fleet_block_latency", sli="fleet_block_p99",
            target=0.25, window_s=60.0, budget=0.1),
        Slo(name="fleet_verify_latency", sli="fleet_verify_p99",
            target=2.0, window_s=120.0, budget=0.2),
    ]


class _SloState:
    __slots__ = ("marks", "breached", "burn")

    def __init__(self) -> None:
        self.marks: list[tuple[float, bool]] = []  # (t, violating)
        self.breached = False
        self.burn = 0.0


# --- the engine ---------------------------------------------------------


class HealthEngine:
    """One tick loop: SLIs -> SLOs -> probes -> metrics/events/flight.

    Everything time-dependent takes an explicit ``now`` so tests and
    ``chip_smoke.py`` drive the engine deterministically; the async
    ``run()`` loop is a thin production scheduler around ``tick()`` that
    doubles as the event-loop-lag measurement point.
    """

    def __init__(self, *,
                 registry: metrics.Registry = metrics.REGISTRY,
                 health: HealthRegistry = HEALTH,
                 slis=None,
                 slos=None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 window_s: float = sli_mod.DEFAULT_WINDOW_S,
                 spool_dir=None,
                 bus=None,
                 time_source: Callable[[], float] = time.monotonic):
        from . import flight as flight_mod

        self.health = health
        self.bus = bus
        self.interval_s = float(interval_s)
        self.time_source = time_source
        self.slis = list(slis) if slis is not None \
            else sli_mod.default_slis()
        self.slos = list(slos) if slos is not None else default_slos()
        self.sampler = sli_mod.SliSampler(registry, window_s=window_s)
        sli_mod.register_runtime_collectors(registry)
        self.recorder = (flight_mod.FlightRecorder(
            spool_dir, registry=registry, time_source=time_source)
            if spool_dir is not None else None)
        self._slo_state = {s.name: _SloState() for s in self.slos}
        # an attached RemediationEngine (obs/remediate.py): its snapshot
        # rides into every flight-bundle manifest so the bundle records
        # what the node was already doing about the breach
        self.remediation = None
        self._component_state: dict[str, bool] = {}
        self._last_tick: float | None = None
        self._last_loop_tick: float | None = None
        self._loop_started_at: float | None = None
        self._last_report: dict = {}
        self._pending_dump: tuple | None = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._lock = sanitize.lock("health.engine")
        self._shared_dump = sanitize.SharedField("health.engine.pending_dump")

    # --- one evaluation ------------------------------------------------

    def tick(self, now: float | None = None, *,
             defer_dump: bool = False) -> dict:
        """Sample, evaluate, publish. Returns the readiness report the
        HTTP surface serves (``ready``, ``components``, ``slos``,
        ``slis``).

        A breach/stall transition queues a flight dump; by default it is
        written before returning. Async callers (the run loop, the HTTP
        handlers) pass ``defer_dump=True`` and flush via
        ``asyncio.to_thread(self.flush_dump)`` so serializing a 64k-span
        trace ring never blocks the event loop at exactly the moment the
        node is unhealthy."""
        t = self.time_source() if now is None else float(now)
        with self._lock:
            report = self._tick_locked(t)
        if not defer_dump:
            self.flush_dump()
        return report

    def flush_dump(self) -> None:
        """Write the dump queued by the last tick, if any. Touches only
        the recorder/registry/tracer (all thread-safe) — safe from a
        worker thread. The handoff swap happens under the engine lock:
        a tick queueing a new dump must never race a flusher into
        overwriting it with None unwritten."""
        with self._lock:
            self._shared_dump.touch()
            pending, self._pending_dump = self._pending_dump, None
        if pending is None or self.recorder is None:
            return
        reason, t, report, events = pending
        self.recorder.dump(reason, now=t, health=report, events=events,
                           remediation=self._remediation_doc())

    # guarded by: self._lock — tick() is the only caller and enters with the engine lock held
    def _tick_locked(self, t: float) -> dict:
        with tracing.span("health.tick"):
            self.sampler.sample(t)
            values = self.sampler.values(self.slis)
            new_breaches: list[str] = []
            slo_doc: dict[str, dict] = {}
            for slo in self.slos:
                state = self._slo_state[slo.name]
                value = values.get(slo.sli)
                # an unknown SLI (None) neither violates nor repairs —
                # but it must TERMINATE the previous mark's interval, or
                # one violating tick followed by idleness would keep
                # accruing burn with zero observations
                state.marks.append(
                    (t, slo.violated(value) if value is not None
                     else None))
                state.marks = [(mt, v) for mt, v in state.marks
                               if mt >= t - slo.window_s]
                state.burn = self._burn(state.marks, slo.window_s, t)
                breached = (state.burn > slo.budget
                            or (slo.budget == 0.0 and bool(state.marks)
                                and state.marks[-1][1] is True))
                if breached and not state.breached:
                    new_breaches.append(slo.name)
                    metrics.slo_breaches.inc(slo=slo.name)
                    _log.warning(
                        "SLO breach: %s (%s=%s, target %s %s, burn "
                        "%.3f > budget %.3f)", slo.name, slo.sli, value,
                        slo.op, slo.target, state.burn, slo.budget)
                    if self.bus is not None:
                        from ..node import events as events_mod

                        self.bus.emit(events_mod.SloBreach(
                            slo=slo.name, sli=slo.sli,
                            value=value if value is not None else -1.0,
                            target=slo.target, burn=state.burn))
                elif not breached and state.breached:
                    _log.info("SLO recovered: %s (burn %.3f)", slo.name,
                              state.burn)
                state.breached = breached
                metrics.slo_healthy.set(0.0 if breached else 1.0,
                                        slo=slo.name)
                metrics.slo_burn.set(state.burn, slo=slo.name)
                slo_doc[slo.name] = {
                    "sli": slo.sli, "value": value, "target": slo.target,
                    "op": slo.op, "window_s": slo.window_s,
                    "budget": slo.budget, "burn": round(state.burn, 4),
                    "breached": breached,
                }
            components = self.health.report(t)
            new_stalls: list[str] = []
            for name, ent in components.items():
                was = self._component_state.get(name, True)
                metrics.component_healthy.set(
                    1.0 if ent["healthy"] else 0.0, component=name)
                if was and not ent["healthy"]:
                    new_stalls.append(name)
                    metrics.component_stalls.inc(component=name)
                    _log.warning("component unhealthy: %s — %s", name,
                                 ent["reason"])
                elif ent["healthy"] and not was:
                    _log.info("component recovered: %s", name)
                if ent["healthy"] != was and self.bus is not None:
                    from ..node import events as events_mod

                    self.bus.emit(events_mod.ComponentHealth(
                        component=name, healthy=ent["healthy"],
                        reason=ent["reason"]))
                self._component_state[name] = ent["healthy"]
            # probes that unregistered since the last tick must not pin
            # a stale verdict — in the report OR the /metrics series
            for gone in set(self._component_state) - set(components):
                del self._component_state[gone]
                metrics.component_healthy.remove(component=gone)
            self._last_tick = t
            report = {
                "ready": all(e["healthy"] for e in components.values()),
                "components": components,
                "slos": slo_doc,
                "slis": {k: v for k, v in values.items()
                         if v is not None},
            }
            self._last_report = report
            if self.recorder is not None and (new_breaches or new_stalls):
                reason = ";".join([f"slo:{n}" for n in new_breaches]
                                  + [f"stall:{n}" for n in new_stalls])
                self._shared_dump.touch()
                self._pending_dump = (reason, t, report,
                                      self._recent_events())
            return report

    def _recent_events(self):
        bus = self.bus
        if bus is None or not hasattr(bus, "recent"):
            return []
        return list(bus.recent)

    @staticmethod
    def _burn(marks, window_s: float, now: float) -> float:
        """Violating fraction of the window: each mark owns the interval
        until the next mark (the last one until ``now``). Marks with an
        unknown verdict (None) own their interval without charging it."""
        if not marks:
            return 0.0
        violating = 0.0
        for (t0, v), (t1, _) in zip(marks, marks[1:]):
            if v is True:
                violating += t1 - t0
        if marks[-1][1] is True:
            violating += max(now - marks[-1][0], 0.0)
        return min(violating / window_s, 1.0)

    # --- serving state -------------------------------------------------

    def report(self, now: float | None = None, *,
               defer_dump: bool = False) -> dict:
        """A fresh evaluation."""
        return self.tick(now, defer_dump=defer_dump)

    def current_report(self, now: float | None = None) -> dict:
        """What ``/readyz`` serves: the background loop's latest report
        while the loop is alive and recent — a 1 Hz readiness prober
        must not grow the sampler window by one full-registry snapshot
        per poll. Loop-less embedders (and a stale loop) evaluate fresh
        (dump deferred; the HTTP handler flushes it off-loop)."""
        t = self.time_source() if now is None else float(now)
        if (self._last_loop_tick is not None and self._last_report
                and t - self._last_loop_tick < 2 * self.interval_s):
            return self._last_report
        return self.tick(t, defer_dump=True)

    def live(self, now: float | None = None) -> bool:
        """Liveness: the tick loop is not wedged. Once ``run()`` has
        started, only the LOOP's own ticks count — request-driven
        ``/readyz`` evaluations must not mask a dead background task.
        Embedders that never start the loop fall back to any-tick
        recency (manual-tick test drivers), and True before the first
        tick."""
        t = self.time_source() if now is None else float(now)
        budget = 3 * self.interval_s + 1.0
        if self._loop_started_at is not None:
            if (self._task is not None and self._task.done()
                    and not self._closed):
                return False  # the run() task died
            ref = (self._last_loop_tick
                   if self._last_loop_tick is not None
                   else self._loop_started_at)
            return t - ref < budget
        if self._last_tick is None:
            return True
        return t - self._last_tick < budget

    def dump_flight(self, reason: str = "manual") -> Optional[str]:
        """Write a flight bundle NOW, bypassing the rate limit (the
        ``/debug/flight`` handler). None when no spool dir is set."""
        if self.recorder is None:
            return None
        path = self.recorder.dump(reason, now=self.time_source(),
                                  health=self._last_report or None,
                                  events=self._recent_events(),
                                  remediation=self._remediation_doc(),
                                  force=True)
        return str(path) if path is not None else None

    def _remediation_doc(self) -> dict | None:
        """The attached remediation engine's snapshot (None lets the
        recorder fall back to the global breaker registry alone)."""
        if self.remediation is None:
            return None
        try:
            return self.remediation.snapshot()
        except Exception:  # noqa: BLE001 — a bundle beats a perfect bundle
            return None

    # --- production scheduling ----------------------------------------

    def ensure_running(self) -> None:
        """Start the tick loop on the current running event loop
        (idempotent; a dead task is replaced)."""
        if self._closed:
            return
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self.run())

    async def run(self) -> None:
        """Tick every ``self.interval_s``, measuring asyncio scheduling lag
        as the drift between the requested and actual wake-up — the
        only honest place to observe event-loop health from."""
        interval = self.interval_s
        loop = asyncio.get_running_loop()
        self._loop_started_at = self.time_source()
        try:
            while not self._closed:
                # spacecheck: ok=SC001 measuring the LOOP's own scheduling lag is the point; the loop clock is the only honest reference
                target = loop.time() + interval
                await asyncio.sleep(interval)
                lag = max(loop.time() - target, 0.0)  # spacecheck: ok=SC001 same loop-lag measurement
                metrics.event_loop_lag.set(lag)
                self.tick(defer_dump=True)
                self._last_loop_tick = self.time_source()
                # bundle serialization (64k-span ring + full exposition)
                # happens off the loop
                await asyncio.to_thread(self.flush_dump)
        except asyncio.CancelledError:
            pass

    def close(self) -> None:
        self._closed = True
        if self._task is not None:
            try:
                self._task.cancel()
            except RuntimeError:  # loop already torn down
                pass
            self._task = None
