"""The device-job loop: a bounded dispatch -> retire window (port of
``spacemesh_tpu/runtime/engine.py``).

A host thread enqueues up to ``inflight`` batches of device work
(``dispatch``), then pops the oldest and blocks on its results
(``retire``), so device compute, copies and host work overlap.

``dispatch(item) -> ticket``
    Enqueue device work for one item and return at once. A raised
    exception goes to the ``fallback`` hook when one is configured, and
    to the ``breaker`` as a failure when one is configured.

``retire(ticket) -> result | None``
    Block on the oldest in-flight ticket and consume it. A non-None return
    is an early exit: the pipeline stops pulling items, abandons the
    in-flight tickets and returns that value.

Every run counts its batches in the ``runtime_*`` metrics under its
``kind`` and ``tenant`` labels (``utils/metrics.py``), and with ``span=``
records an ``f"{span}.dispatch"`` span per batch carrying them, so a
multi-tenant process decomposes per identity.

One deliberate difference from the JAX package: no entry point of the
port passes a ``fallback``. The JAX k2pow search hands a failing device
dispatch to a host re-scan (``spacemesh_tpu/ops/pow.py``); on the card
that would hide a failing kernel behind the plain twin, so a failed
launch raises. The hook and the breaker are here for callers that own a
real second path (the ``runtime-degrade`` drill, ``sim/failover.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional

from ..utils import metrics, sanitize, tracing

# per-kind aggregate in-flight depth: concurrent pipelines of one kind (two
# gang prove windows, parallel k2pow searches) each add their own delta,
# so a finishing pipeline removes only its share of the gauge. Declared
# shared to the lockset sanitizer: every pipeline thread passes here.
_inflight_lock = sanitize.lock("runtime.engine.inflight")
_inflight_shared = sanitize.SharedField("runtime.engine.inflight_by_kind")
_inflight_by_kind: dict[str, int] = {}


def _inflight_adjust(kind: str, delta: int) -> int:
    with _inflight_lock:
        _inflight_shared.touch()
        n = _inflight_by_kind.get(kind, 0) + delta
        _inflight_by_kind[kind] = n
        return n


class JobStopped(RuntimeError):
    """The job's stop predicate flipped while work was still queued."""


# What a continuous item stream (the multi-tenant packer) yields when it
# has no new work right now: the engine retires the oldest in-flight ticket
# (if any) instead of dispatching, so results keep draining while the
# stream decides whether to block for more work. A finite stream never
# needs it: exhausting the iterator drains the window.
IDLE = object()


@dataclasses.dataclass
class PipelineStats:
    batches: int = 0
    dispatch_s: float = 0.0   # host time enqueueing device work
    first_dispatch_s: float = 0.0  # the first batch's share of dispatch_s
    retire_s: float = 0.0     # blocked consuming results
    fallbacks: int = 0        # dispatch exceptions absorbed by fallback
    early_exited: bool = False
    stopped: bool = False


class Pipeline:
    """Bounded in-flight dispatch -> retire executor for one device job.

    ``kind``      workload label of the metrics: "init", "prove", "k2pow",
                  "k2pow_verify", "init_pack", ...
    ``tenant``    identity label of the metrics; "-" for single-tenant
                  callers.
    ``inflight``  device batches in flight before the oldest retires.
    ``stop``      checked before each dispatch and each drain step; True
                  discards the in-flight work (stop latency is one retire,
                  not a drain).
    ``fallback``  ``(item, exc) -> ticket``: a dispatch exception goes
                  here once per item; absent, the exception propagates.
    ``breaker``   an ``obs.remediate.CircuitBreaker`` around the dispatch
                  attempt: failures trip it open, and while it is open
                  dispatch goes straight to ``fallback`` (the item sees a
                  typed ``BreakerOpen`` instead of the long-dead error)
                  until a half-open probe finds the device back.
    ``span``      span name prefix: each dispatch records
                  ``f"{span}.dispatch"`` with the kind and tenant; None
                  records none.
    ``attrs``     ``item -> dict`` extra dispatch-span attributes.
    ``on_inflight`` depth hook (pipeline-specific gauges).
    """

    def __init__(self, *, kind: str = "-", tenant: str = "-",
                 inflight: int = 3,
                 stop: Optional[Callable[[], bool]] = None,
                 fallback: Optional[Callable[[Any, Exception], Any]] = None,
                 breaker=None,
                 span: str | None = None,
                 attrs: Optional[Callable[[Any], dict]] = None,
                 on_inflight: Optional[Callable[[int], None]] = None):
        self.kind = kind
        self.tenant = tenant
        self.inflight = max(int(inflight), 1)
        self._stop = stop
        self._fallback = fallback
        self._breaker = breaker
        self._span = span
        self._attrs = attrs
        self._on_inflight = on_inflight
        self.stats = PipelineStats()
        self._pending: deque = deque()
        self._last_depth = 0

    @property
    def pending_count(self) -> int:
        """Tickets in flight now (a continuous stream reads this to choose
        between blocking for work and yielding :data:`IDLE`)."""
        return len(self._pending)

    def _set_inflight(self, n: int) -> None:
        total = _inflight_adjust(self.kind, n - self._last_depth)
        self._last_depth = n
        metrics.runtime_inflight.set(total, kind=self.kind)
        if self._on_inflight is not None:
            self._on_inflight(n)

    def _attempt(self, dispatch, item):
        """One dispatch through the breaker and the fallback hook."""
        br = self._breaker
        if br is not None and not br.allow():
            # open breaker: the device path is known-dead, go straight to
            # the fallback without paying the failing attempt again
            from ..obs.remediate import BreakerOpen

            exc = BreakerOpen(br.component, br.retry_in())
            if self._fallback is None:
                raise exc
            return self._fall_back(item, exc)
        try:
            ticket = dispatch(item)
        except Exception as exc:  # noqa: BLE001 — routed to fallback
            if br is not None:
                br.record_failure()
            if self._fallback is None:
                raise
            return self._fall_back(item, exc)
        if br is not None:
            br.record_success()
        return ticket

    def _fall_back(self, item, exc):
        ticket = self._fallback(item, exc)
        self.stats.fallbacks += 1
        metrics.runtime_fallbacks.inc(kind=self.kind)
        return ticket

    def _dispatch(self, dispatch, item):
        stats = self.stats
        t0 = time.perf_counter()
        if self._span is None:
            ticket = self._attempt(dispatch, item)
        else:
            attrs = None
            if tracing.is_enabled():
                attrs = {"kind": self.kind, "tenant": self.tenant}
                if self._attrs is not None:
                    attrs.update(self._attrs(item))
            with tracing.span(f"{self._span}.dispatch", attrs):
                ticket = self._attempt(dispatch, item)
        dt = time.perf_counter() - t0
        stats.dispatch_s += dt
        if not stats.batches:
            stats.first_dispatch_s = dt
        stats.batches += 1
        metrics.runtime_dispatched.inc(kind=self.kind, tenant=self.tenant)
        self._pending.append(ticket)
        self._set_inflight(len(self._pending))

    def _retire(self, retire):
        t0 = time.perf_counter()
        try:
            return retire(self._pending.popleft())
        finally:
            self.stats.retire_s += time.perf_counter() - t0
            metrics.runtime_retired.inc(kind=self.kind, tenant=self.tenant)
            self._set_inflight(len(self._pending))

    def _stopped(self) -> bool:
        if self._stop is not None and self._stop():
            self.stats.stopped = True
            self._pending.clear()
            return True
        return False

    def run(self, items: Iterable[Any], dispatch, retire):
        """Drive ``items`` through the window. Returns the first non-None
        retire result, or None when every item retired or the stop
        predicate ended the run (``stats.stopped`` tells them apart)."""
        stats = self.stats
        pending = self._pending
        try:
            for item in items:
                if self._stopped():
                    return None
                if item is IDLE:
                    if not pending:
                        continue
                else:
                    self._dispatch(dispatch, item)
                    if len(pending) < self.inflight:
                        continue
                result = self._retire(retire)
                if result is not None:
                    stats.early_exited = True
                    pending.clear()  # abandon: the result is final
                    return result
            while pending:
                if self._stopped():
                    return None
                result = self._retire(retire)
                if result is not None:
                    stats.early_exited = True
                    pending.clear()
                    return result
            return None
        finally:
            self._set_inflight(0)
            for stage, secs in (("dispatch", stats.dispatch_s),
                                ("retire", stats.retire_s)):
                metrics.runtime_stage_seconds.inc(secs, kind=self.kind,
                                                  stage=stage)
