"""Remediation primitives (the part of ``spacemesh_tpu/obs/remediate.py``
the verification farm, verifyd and its client use).

* :class:`CircuitBreaker`: the closed -> open -> half-open -> closed state
  machine around the farm's per-kind backends, on an injectable clock
  with zero sleeps.
* :func:`backoff_delay`: ONE capped, seeded-jitter backoff shared by the
  breaker's half-open probe timing and the verifyd client's
  ``retry_after_s`` honoring.
* :data:`BREAKERS` / :data:`ACTIONS`: process-global registries of every
  live breaker and of the components' recovery hooks (the farm and
  verifyd register ``reset_farm_lanes``). Unregistering a breaker removes
  its metric series.

The breaker has the JAX package's semantics for everything the verifyd
fleet and failover client call (``fleet.py``, ``failover.py``): the
seeded reopen jitter, the transition callback, the ``retry_after_s``
floor on the reopen delay, probe abort, ``retry_in`` and the state
documents, and the registries' readers (``get``, ``names``, ``states``,
``snapshot``).

Left out against the JAX package, for the instrumentation item of the
port, together with the ``RemediationEngine`` and declarative recovery
policy that would use them: the QUARANTINED state and its escalation
(``quarantine_after``, ``quarantine()``), manual ``reset()``, and the
other recovery action kinds.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils import metrics

_log = logging.getLogger("spacemesh_tpu_torch.remediate")

# --- breaker states (gauge encoding: remediation_breaker_state) ---------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_CODES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

# the recovery action the farm and verifyd register
RESET_FARM_LANES = "reset_farm_lanes"


class BreakerOpen(RuntimeError):
    """A call was refused because its circuit breaker is open.

    Call sites that have a fallback route there without paying the
    failing attempt; call sites without one surface this typed error
    instead of the underlying (long-dead) failure."""

    def __init__(self, component: str, retry_in_s: float | None = None):
        detail = (f"breaker {component!r} open"
                  + (f", retry in {retry_in_s:.3f}s"
                     if retry_in_s is not None else ""))
        super().__init__(detail)
        self.component = component
        self.retry_in_s = retry_in_s


def backoff_delay(attempt: int, *, base_s: float, cap_s: float,
                  retry_after_s: float | None = None,
                  seed: int = 0) -> float:
    """Capped exponential backoff with deterministic seeded jitter.

    The ONE timing rule shared by the verifyd client's shed retries and
    the breaker's reopen cooldown, so the two cannot drift: attempt
    ``k`` waits ``base * 2^k`` jittered into ``[0.5, 1.0)`` of itself,
    floored at the server's ``retry_after_s`` hint (retrying sooner
    than the server said is a wasted round trip), and capped at
    ``cap_s`` (a hint beyond the caller's patience is the caller's cue
    to give up BEFORE sleeping — see VerifydClient).  Deterministic:
    ``f(attempt, seed)`` — no wall clock, no global RNG.
    """
    raw = min(float(base_s) * (2.0 ** max(int(attempt), 0)), float(cap_s))
    jitter = random.Random((int(seed) << 20) ^ (attempt + 1)).random()
    delay = raw * (0.5 + 0.5 * jitter)
    if retry_after_s is not None:
        delay = max(delay, float(retry_after_s))
    return min(delay, float(cap_s))


class CircuitBreaker:
    """closed → open after ``failure_budget`` typed failures within
    ``window_s`` → half-open single probe after a cooldown → closed on
    probe success (or re-open with an escalated cooldown on failure).

    Zero sleeps: ``time_source`` injects the clock and every transition
    happens inside :meth:`allow` / :meth:`record_failure` /
    :meth:`record_success`.  Thread-safe — the farm's backend threads
    record outcomes while the event loop asks :meth:`allow`.

    The reopen cooldown is :func:`backoff_delay` over the consecutive
    open count, floored at the peer's ``retry_after_s`` when the
    failure carried one (a shedding verifyd's hint drives exactly when
    the half-open probe goes out).
    """

    def __init__(self, component: str, *,
                 failure_budget: int = 5,
                 window_s: float = 30.0,
                 cooldown_s: float = 5.0,
                 cooldown_cap_s: float = 120.0,
                 seed: int = 0,
                 time_source: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.component = str(component)
        self.failure_budget = max(int(failure_budget), 1)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.seed = int(seed)
        self._now = time_source
        self._on_transition = on_transition
        self.state = CLOSED
        self._failures: deque[float] = deque()
        self._retry_at: float | None = None
        self._open_streak = 0        # consecutive opens, reset on close
        self._probing = False
        self.opens = 0               # lifetime transitions into OPEN
        self.probes = 0              # half-open probes granted
        self._registered = False
        self._lock = threading.Lock()

    # -- state machine --------------------------------------------------

    def _transition(self, to: str) -> None:
        # guarded by: self._lock — every caller holds it
        if to == self.state:
            return
        frm, self.state = self.state, to
        if self._registered:
            metrics.remediation_breaker_state.set(
                STATE_CODES[to], component=self.component)
            metrics.remediation_breaker_transitions.inc(
                component=self.component, to=to)
        if self._on_transition is not None:
            self._on_transition(frm, to)

    def allow(self, now: float | None = None) -> bool:
        """May an attempt go out right now?  CLOSED: yes.  OPEN: no
        until the cooldown elapses, then exactly ONE half-open probe.
        HALF_OPEN: no while that probe is unresolved."""
        t = self._now() if now is None else float(now)
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._retry_at is not None and t >= self._retry_at:
                    self._transition(HALF_OPEN)
                    self._probing = True
                    self.probes += 1
                    return True
                return False
            # HALF_OPEN: the single probe is out; a second caller waits
            if not self._probing:
                self._probing = True
                self.probes += 1
                return True
            return False

    def record_success(self, now: float | None = None) -> None:
        with self._lock:
            if self.state in (HALF_OPEN, OPEN):
                _log.info("breaker %s: probe ok, closing", self.component)
            self._probing = False
            self._failures.clear()
            self._open_streak = 0
            self._retry_at = None
            self._transition(CLOSED)

    def record_failure(self, now: float | None = None,
                       retry_after_s: float | None = None) -> None:
        t = self._now() if now is None else float(now)
        with self._lock:
            if self.state in (HALF_OPEN, OPEN):
                # failed probe (or a straggler failing while open):
                # reopen with an ESCALATED cooldown
                self._probing = False
                self._open(t, retry_after_s)
                return
            self._failures.append(t)
            while self._failures and self._failures[0] < t - self.window_s:
                self._failures.popleft()
            if len(self._failures) >= self.failure_budget:
                self._open(t, retry_after_s)

    def _open(self, t: float, retry_after_s: float | None) -> None:
        # guarded by: self._lock — record_failure is the only caller
        self.opens += 1
        self._open_streak += 1
        cooldown = backoff_delay(self._open_streak - 1,
                                 base_s=self.cooldown_s,
                                 cap_s=self.cooldown_cap_s,
                                 retry_after_s=retry_after_s,
                                 seed=self.seed)
        self._retry_at = t + cooldown
        self._failures.clear()
        _log.warning("breaker %s: open (streak %d), half-open probe in "
                     "%.3fs", self.component, self._open_streak, cooldown)
        self._transition(OPEN)

    def abort_probe(self) -> None:
        """Release a granted probe slot WITHOUT a verdict — the attempt
        resolved in a way that says nothing about the peer's health (a
        config-class shed, a cancelled caller).  Every ``allow() ==
        True`` in HALF_OPEN must reach exactly one of
        record_success/record_failure/abort_probe, or the breaker wedges
        with the probe slot held and fast-fails forever."""
        with self._lock:
            self._probing = False

    # -- introspection --------------------------------------------------

    def retry_in(self, now: float | None = None) -> float | None:
        """Seconds until the half-open probe while OPEN, else None."""
        t = self._now() if now is None else float(now)
        with self._lock:
            if self.state != OPEN or self._retry_at is None:
                return None
            return max(self._retry_at - t, 0.0)

    def state_doc(self, now: float | None = None) -> dict:
        t = self._now() if now is None else float(now)
        with self._lock:
            return {
                "component": self.component,
                "state": self.state,
                "failures_in_window": len(self._failures),
                "failure_budget": self.failure_budget,
                "window_s": self.window_s,
                "open_streak": self._open_streak,
                "opens": self.opens,
                "probes": self.probes,
                "retry_in_s": (round(max(self._retry_at - t, 0.0), 6)
                               if self.state == OPEN
                               and self._retry_at is not None else None),
            }


class BreakerRegistry:
    """Every live breaker in the process, by component name (the
    ``HEALTH`` registry shape: last-wins names, unregister only removes
    the exact object, one node per process).  Registration owns the
    per-component ``/metrics`` series: ``unregister`` drops them via
    ``remove``/``remove_matching`` so a churn of short-lived components
    cannot grow the registry without bound."""

    def __init__(self) -> None:
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def register(self, breaker: CircuitBreaker) -> CircuitBreaker:
        with self._lock:
            prev = self._breakers.get(breaker.component)
            if prev is not None and prev is not breaker:
                # last-wins, like HEALTH: the DISPLACED breaker must
                # stop writing the (shared, name-keyed) metric series,
                # or two same-named breakers flap one gauge between
                # two unrelated components' states
                prev._registered = False
            self._breakers[breaker.component] = breaker
        breaker._registered = True
        metrics.remediation_breaker_state.set(
            STATE_CODES[breaker.state], component=breaker.component)
        return breaker

    def unregister(self, breaker: CircuitBreaker) -> None:
        """Stop ``breaker`` writing its series, and — only while its
        name still maps to it (a finished component must not evict its
        successor) — drop the per-component metric series too."""
        breaker._registered = False  # always: a gone breaker is silent
        with self._lock:
            if self._breakers.get(breaker.component) is not breaker:
                return  # displaced earlier: the successor owns the series
            del self._breakers[breaker.component]
        metrics.remediation_breaker_state.remove(
            component=breaker.component)
        metrics.remediation_breaker_transitions.remove_matching(
            component=breaker.component)

    def get(self, component: str) -> CircuitBreaker | None:
        with self._lock:
            return self._breakers.get(component)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._breakers)

    def states(self) -> dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: br.state for name, br in sorted(items)}

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: br.state_doc() for name, br in sorted(items)}


BREAKERS = BreakerRegistry()


class HookRegistry:
    """Per-component recovery hooks, registered beside the component's
    watchdog (the farm, verifyd) for a remediation engine to call when a
    policy rule fires. ``register`` / ``unregister`` pair like health
    probes."""

    def __init__(self) -> None:
        self._hooks: dict[tuple[str, str], Callable[[], object]] = {}
        self._lock = threading.Lock()

    def register(self, component: str, action: str,
                 hook: Callable[[], object]) -> None:
        with self._lock:
            self._hooks[(str(component), str(action))] = hook

    def unregister(self, component: str, action: str,
                   hook: Callable[[], object] | None = None) -> None:
        """Remove the hook — only if it still maps to ``hook`` when one
        is given (equality, not identity: bound methods rebuild)."""
        with self._lock:
            key = (str(component), str(action))
            if hook is None or self._hooks.get(key) == hook:
                self._hooks.pop(key, None)


ACTIONS = HookRegistry()
