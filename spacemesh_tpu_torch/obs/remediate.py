"""Remediation: typed, rate-limited, escalating recovery actions (port of
``spacemesh_tpu/obs/remediate.py``).

The health engine DETECTS (it flips ``/readyz`` and spools flight
bundles); this module is the layer that ACTS:

* :class:`CircuitBreaker`: the generic closed -> open -> half-open ->
  closed (or quarantined) state machine wrapped around the chronic
  retry-forever sites: the runtime engine's dispatch
  (runtime/engine.py ``Pipeline(breaker=...)``), the farm's per-kind
  backends (verify/farm.py), the verifyd failover client
  (verifyd/failover.py) and each fleet replica (verifyd/fleet.py).  Zero
  sleeps: the clock is injectable and every decision is a pure function
  of ``(state, now)``.
* :func:`backoff_delay`: ONE capped, seeded-jitter backoff shared by
  the breaker's half-open probe timing and the verifyd client's
  ``retry_after_s`` honoring, so the two can never drift apart.
* :data:`BREAKERS` / :data:`ACTIONS`: process-global registries (the
  ``obs.health.HEALTH`` shape: one node per process, last-wins names,
  unregister-by-identity).  Breakers register so flight-bundle manifests
  can report every breaker in the process, wherever it was constructed;
  components register their restart hooks beside their watchdogs so a
  policy verdict can reach them.  Unregistering removes every
  per-component metric series (``metrics.remove_matching``).
* :class:`RecoveryRule` policies: declarative ``health verdict -> typed
  action`` mappings (``restart_component``, ``reset_farm_lanes``,
  ``quarantine_tenant``, ``failover_remote``, ``shed_and_alert``) with a
  per-component action budget: a flapping component exhausts its budget
  and ESCALATES to quarantine instead of restart-looping.
* :class:`RemediationEngine`: executes policy on health verdicts.  Every
  decision is recorded three ways: a ``remediate.action`` span, the
  ``remediation_actions_total{component,action,outcome}`` counter, and
  the bounded action history embedded in flight-bundle manifests.

Left out against the JAX package until the event bus is ported
(``node/events.py``, ROADMAP [13]): the engine's ``bus=`` subscription
(``start``/``close``, consuming ``ComponentHealth``/``SloBreach`` events)
and its ``RemediationAction`` events.  Callers drive the deterministic
core, :meth:`RemediationEngine.handle_component` / ``handle_slo``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import time
from collections import deque
from typing import Callable, Optional

from ..utils import logging as slog
from ..utils import metrics, sanitize, tracing

_log = slog.get("remediate")

# --- breaker states (gauge encoding: remediation_breaker_state) ---------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
QUARANTINED = "quarantined"

STATE_CODES = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0, QUARANTINED: 3.0}

# --- the typed action vocabulary ----------------------------------------

RESTART_COMPONENT = "restart_component"
RESET_FARM_LANES = "reset_farm_lanes"
QUARANTINE_TENANT = "quarantine_tenant"
FAILOVER_REMOTE = "failover_remote"
SHED_AND_ALERT = "shed_and_alert"
QUARANTINE_COMPONENT = "quarantine_component"

ACTION_KINDS = (RESTART_COMPONENT, RESET_FARM_LANES, QUARANTINE_TENANT,
                FAILOVER_REMOTE, SHED_AND_ALERT, QUARANTINE_COMPONENT)


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
    probe success (or re-open with an escalated cooldown on failure);
    ``quarantine_after`` consecutive opens without a stable close
    escalate to QUARANTINED, which only :meth:`reset` leaves.

    Zero sleeps: ``time_source`` injects the clock and every transition
    happens inside :meth:`allow` / :meth:`record_failure` /
    :meth:`record_success`.  Thread-safe — the runtime engine consults
    it from pipeline threads while the event loop reads state docs.

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
                 quarantine_after: int = 0,
                 seed: int = 0,
                 time_source: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.component = str(component)
        self.failure_budget = max(int(failure_budget), 1)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_cap_s = float(cooldown_cap_s)
        self.quarantine_after = max(int(quarantine_after), 0)
        self.seed = int(seed)
        self._now = time_source
        self._on_transition = on_transition
        self.state = CLOSED
        self._failures: deque[float] = deque()
        self._opened_at: float | None = None
        self._retry_at: float | None = None
        self._open_streak = 0        # consecutive opens, reset on close
        self._probing = False
        self.opens = 0               # lifetime transitions into OPEN
        self.probes = 0              # half-open probes granted
        self._registered = False
        self._lock = sanitize.lock(f"remediate.breaker.{self.component}")

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
        HALF_OPEN: no while that probe is unresolved.  QUARANTINED:
        never (manual :meth:`reset` only)."""
        t = self._now() if now is None else float(now)
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == QUARANTINED:
                return False
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
            if self.state == QUARANTINED:
                return
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
        if (self.quarantine_after
                and self._open_streak >= self.quarantine_after):
            _log.warning("breaker %s: %d consecutive opens, quarantining",
                         self.component, self._open_streak)
            self._transition(QUARANTINED)
            self._retry_at = None
            return
        cooldown = backoff_delay(self._open_streak - 1,
                                 base_s=self.cooldown_s,
                                 cap_s=self.cooldown_cap_s,
                                 retry_after_s=retry_after_s,
                                 seed=self.seed)
        self._opened_at = t
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

    def quarantine(self) -> None:
        """Force QUARANTINED (the engine's budget-exhausted escalation)."""
        with self._lock:
            self._retry_at = None
            self._probing = False
            self._transition(QUARANTINED)

    def reset(self) -> None:
        """Manual all-clear: back to CLOSED with a clean window."""
        with self._lock:
            self._failures.clear()
            self._open_streak = 0
            self._probing = False
            self._retry_at = None
            self._transition(CLOSED)

    # -- introspection --------------------------------------------------

    def retry_in(self, now: float | None = None) -> float | None:
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
        self._lock = sanitize.lock("remediate.breakers")
        self._shared = sanitize.SharedField("remediate.breakers.map")

    def register(self, breaker: CircuitBreaker) -> CircuitBreaker:
        with self._lock:
            self._shared.touch()
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
            self._shared.touch()
            if self._breakers.get(breaker.component) is not breaker:
                return  # displaced earlier: the successor owns the series
            del self._breakers[breaker.component]
        metrics.remediation_breaker_state.remove(
            component=breaker.component)
        metrics.remediation_breaker_transitions.remove_matching(
            component=breaker.component)

    def get(self, component: str) -> CircuitBreaker | None:
        with self._lock:
            self._shared.touch(write=False)
            return self._breakers.get(component)

    def names(self) -> list[str]:
        with self._lock:
            self._shared.touch(write=False)
            return sorted(self._breakers)

    def states(self) -> dict[str, str]:
        with self._lock:
            self._shared.touch(write=False)
            items = list(self._breakers.items())
        return {name: br.state for name, br in sorted(items)}

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            self._shared.touch(write=False)
            items = list(self._breakers.items())
        return {name: br.state_doc() for name, br in sorted(items)}


BREAKERS = BreakerRegistry()


class HookRegistry:
    """Per-component recovery hooks, registered beside the component's
    watchdog (post pipelines, the farm, verifyd) and consumed by the
    engine when a policy rule fires.  ``register`` / ``unregister`` pair
    like health probes."""

    def __init__(self) -> None:
        self._hooks: dict[tuple[str, str], Callable[[], object]] = {}
        self._lock = sanitize.lock("remediate.actions")
        self._shared = sanitize.SharedField("remediate.actions.map")

    def register(self, component: str, action: str,
                 hook: Callable[[], object]) -> None:
        with self._lock:
            self._shared.touch()
            self._hooks[(str(component), str(action))] = hook

    def unregister(self, component: str, action: str,
                   hook: Callable[[], object] | None = None) -> None:
        """Remove the hook — only if it still maps to ``hook`` when one
        is given (equality, not identity: bound methods rebuild)."""
        with self._lock:
            self._shared.touch()
            key = (str(component), str(action))
            if hook is None or self._hooks.get(key) == hook:
                self._hooks.pop(key, None)

    def get(self, component: str,
            action: str) -> Callable[[], object] | None:
        with self._lock:
            self._shared.touch(write=False)
            return self._hooks.get((str(component), str(action)))

    def names(self) -> list[tuple[str, str]]:
        with self._lock:
            self._shared.touch(write=False)
            return sorted(self._hooks)


ACTIONS = HookRegistry()


# --- declarative policy -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryRule:
    """health verdict → action, with a budget and an escalation.

    ``component`` is an fnmatch pattern over component names (for
    ``trigger="unhealthy"``) or SLO names (``trigger="slo_breach"``).
    ``cooldown_s`` rate-limits the action per component; ``budget``
    bounds actions within ``window_s`` — the budget-exhausting verdict
    executes ``escalation`` instead (once), so a flapping component
    lands in quarantine rather than a restart storm.
    """

    component: str
    action: str
    trigger: str = "unhealthy"           # "unhealthy" | "slo_breach"
    budget: int = 3
    window_s: float = 600.0
    cooldown_s: float = 30.0
    escalation: str = QUARANTINE_COMPONENT

    def matches(self, name: str, trigger: str) -> bool:
        return (self.trigger == trigger
                and fnmatch.fnmatchcase(name, self.component))


def default_policy() -> list[RecoveryRule]:
    """The node's rule set: wedged
    farm lanes reset, verifyd's drain path resets its farm lanes, a
    fleet replica that keeps tripping its breaker restarts then lands
    in quarantine (the router stops routing to it), a stalled syncer
    restarts, stalled POST pipelines restart, and any SLO breach
    sheds-and-alerts (flight bundle + event, no mutation).  Rule order
    matters (first match wins): ``verifyd.replica.*`` must precede the
    ``verifyd.*`` shard rule it would otherwise fall through to."""
    return [
        RecoveryRule(component="verify.farm", action=RESET_FARM_LANES,
                     budget=3, window_s=600.0, cooldown_s=60.0),
        # a fleet replica breaker (verifyd/fleet.py registers one per
        # replica as verifyd.replica.<name>): restart it; a flapper
        # that exhausts the budget gets quarantined, which the fleet
        # router treats as "never route here" until an operator acts
        RecoveryRule(component="verifyd.replica.*",
                     action=RESTART_COMPONENT, budget=3,
                     window_s=600.0, cooldown_s=60.0,
                     escalation=QUARANTINE_COMPONENT),
        RecoveryRule(component="verifyd", action=RESET_FARM_LANES,
                     budget=3, window_s=600.0, cooldown_s=60.0),
        # sharded in-process services (verifyd.<shard> — the fleet sim
        # and multi-replica single-host layouts) heal like verifyd
        RecoveryRule(component="verifyd.*", action=RESET_FARM_LANES,
                     budget=3, window_s=600.0, cooldown_s=60.0),
        RecoveryRule(component="sync", action=RESTART_COMPONENT,
                     budget=3, window_s=900.0, cooldown_s=120.0),
        RecoveryRule(component="post.*", action=RESTART_COMPONENT,
                     budget=2, window_s=600.0, cooldown_s=60.0),
        RecoveryRule(component="*", trigger="slo_breach",
                     action=SHED_AND_ALERT, budget=6, window_s=600.0,
                     cooldown_s=30.0, escalation=SHED_AND_ALERT),
    ]


# --- the engine ---------------------------------------------------------


class RemediationEngine:
    """Consume health verdicts, execute policy, record everything.

    The deterministic core is :meth:`handle_component` /
    :meth:`handle_slo` (and :meth:`note_recovered`), driven with an
    injected ``now``.
    """

    def __init__(self, *,
                 policy: list[RecoveryRule] | None = None,
                 history: int = 256,
                 time_source: Callable[[], float] = time.monotonic):
        self.policy = list(policy) if policy is not None \
            else default_policy()
        self._now = time_source
        self.history: deque[dict] = deque(maxlen=max(int(history), 1))
        # per-component execution record: [(t, action), ...] pruned to
        # the widest rule window; quarantined components stop acting
        self._executed: dict[str, deque] = {}
        self._last_action: dict[str, float] = {}
        self._quarantined: set[str] = set()
        self._lock = sanitize.lock("remediate.engine")

    # -- the deterministic core -----------------------------------------

    def handle_component(self, component: str, reason: str = "",
                         now: float | None = None) -> dict | None:
        """An unhealthy component verdict: find the first matching rule
        and execute (or escalate/ratelimit).  Returns the action record
        (None when no rule matches)."""
        t = self._now() if now is None else float(now)
        for rule in self.policy:
            if rule.matches(component, "unhealthy"):
                return self._execute(component, rule, reason, t)
        return None

    def handle_slo(self, slo: str, reason: str = "",
                   now: float | None = None) -> dict | None:
        t = self._now() if now is None else float(now)
        for rule in self.policy:
            if rule.matches(slo, "slo_breach"):
                return self._execute(slo, rule, reason, t)
        return None

    def note_recovered(self, component: str) -> None:
        """A healthy verdict clears the action cooldown (a component
        that RECOVERED and broke again deserves a fresh action sooner
        than the rate limit), but not the windowed budget — flapping
        must still exhaust it and escalate."""
        with self._lock:
            self._last_action.pop(component, None)

    def _execute(self, component: str, rule: RecoveryRule, reason: str,
                 t: float) -> dict:
        # decide under the lock (budget/cooldown state), act and record
        # OUTSIDE it — a recovery hook may take arbitrarily long (or
        # raise), and must never serialize against snapshot readers
        with self._lock:
            if component in self._quarantined:
                return self._record(component, rule.action, "quarantined",
                                    reason, t, ran=False)
            last = self._last_action.get(component)
            if last is not None and t - last < rule.cooldown_s:
                return self._record(component, rule.action, "rate_limited",
                                    reason, t, ran=False)
            executed = self._executed.setdefault(component, deque())
            while executed and executed[0] < t - rule.window_s:
                executed.popleft()
            if len(executed) >= rule.budget:
                # budget exhausted: escalate ONCE instead of the action
                self._last_action[component] = t
                if rule.escalation == QUARANTINE_COMPONENT:
                    self._quarantined.add(component)
                    escalate = QUARANTINE_COMPONENT
                else:
                    escalate = rule.escalation
            else:
                executed.append(t)
                self._last_action[component] = t
                escalate = None
        if escalate == QUARANTINE_COMPONENT:
            br = BREAKERS.get(component)
            if br is not None:
                br.quarantine()
            _log.warning(
                "remediation: %s exhausted its %s budget (%d/%.0fs), "
                "quarantined", component, rule.action, rule.budget,
                rule.window_s)
            return self._record(component, QUARANTINE_COMPONENT,
                                "escalated", reason, t, ran=True)
        if escalate is not None:
            return self._run_hook(component, escalate, "escalated",
                                  reason, t)
        return self._run_hook(component, rule.action, None, reason, t)

    def _run_hook(self, component: str, action: str,
                  forced_outcome: str | None, reason: str,
                  t: float) -> dict:
        hook = ACTIONS.get(component, action)
        with tracing.span("remediate.action",
                          {"component": component, "action": action}
                          if tracing.is_enabled() else None):
            if hook is None:
                outcome = forced_outcome or "no_hook"
                ran = False
            else:
                try:
                    hook()
                    outcome = forced_outcome or "ok"
                    ran = True
                except Exception as exc:  # noqa: BLE001 — recorded, never propagates
                    _log.error("remediation hook %s/%s raised: %r",
                               component, action, exc)
                    outcome = "error"
                    ran = False
        return self._record(component, action, outcome, reason, t,
                            ran=ran)

    def _record(self, component: str, action: str, outcome: str,
                reason: str, t: float, *, ran: bool) -> dict:
        # lock-free: deque.append is atomic, the instruments carry
        # their own synchronization
        rec = {"t": round(t, 6), "component": component, "action": action,
               "outcome": outcome, "reason": reason, "ran": ran}
        self.history.append(rec)
        metrics.remediation_actions.inc(component=component,
                                        action=action, outcome=outcome)
        if outcome not in ("rate_limited",):
            _log.info("remediation: %s %s -> %s (%s)", component, action,
                      outcome, reason)
        return rec

    # -- introspection (flight manifests) --------------------------------

    def budgets(self, now: float | None = None) -> dict:
        t = self._now() if now is None else float(now)
        out: dict[str, dict] = {}
        with self._lock:
            for component, executed in self._executed.items():
                rule = next((r for r in self.policy
                             if fnmatch.fnmatchcase(component,
                                                    r.component)), None)
                window = rule.window_s if rule is not None else 600.0
                used = sum(1 for ts in executed if ts >= t - window)
                out[component] = {
                    "used": used,
                    "budget": rule.budget if rule is not None else None,
                    "window_s": window,
                    "quarantined": component in self._quarantined,
                }
        return out

    def snapshot(self, now: float | None = None) -> dict:
        with self._lock:
            quarantined = sorted(self._quarantined)
        return {
            "breakers": BREAKERS.snapshot(),
            "hooks": [list(k) for k in ACTIONS.names()],
            "quarantined": quarantined,
            "budgets": self.budgets(now),
            "actions": list(self.history),
            "policy": [dataclasses.asdict(r) for r in self.policy],
        }
