"""The port's circuit breaker, registries and remediation engine
(``spacemesh_tpu_torch/obs/remediate.py``), held to the JAX package's.

Twins of ``tests/test_remediate.py`` on injected clocks (the breaker with
QUARANTINED and ``reset``, the registries, the ``RemediationEngine``'s
policy, budgets, escalation and history, the breaker states in flight
manifests; the event-bus test waits for the bus, ROADMAP [13]), plus a
seeded fuzz of breaker operations (``quarantine_after``, ``quarantine()``
and ``reset()`` among them) through both packages' breakers side by
side: equal ``state``, ``retry_in`` and ``state_doc`` after every step,
and equal transition callbacks; and one verdict script through both
packages' engines with equal action records.
"""

import json
import random

import pytest

from spacemesh_tpu.obs import remediate as jremediate
from spacemesh_tpu_torch.obs import remediate
from spacemesh_tpu_torch.utils import metrics


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


# --- backoff_delay ------------------------------------------------------


def test_backoff_delay_deterministic_capped_and_floored():
    d0 = remediate.backoff_delay(0, base_s=0.1, cap_s=2.0, seed=7)
    assert d0 == remediate.backoff_delay(0, base_s=0.1, cap_s=2.0, seed=7)
    assert 0.05 <= d0 < 0.1           # jitter in [0.5, 1.0) of base
    assert remediate.backoff_delay(0, base_s=0.1, cap_s=2.0, seed=8) != d0
    # exponential growth, capped
    d5 = remediate.backoff_delay(5, base_s=0.1, cap_s=2.0, seed=7)
    assert d5 > d0
    assert remediate.backoff_delay(50, base_s=0.1, cap_s=2.0,
                                   seed=7) <= 2.0
    # the server hint floors the wait (retrying sooner is wasted), but
    # never beyond the cap
    assert remediate.backoff_delay(0, base_s=0.1, cap_s=2.0,
                                   retry_after_s=1.5, seed=7) >= 1.5
    assert remediate.backoff_delay(0, base_s=0.1, cap_s=2.0,
                                   retry_after_s=99.0, seed=7) == 2.0


# --- CircuitBreaker -----------------------------------------------------


def _breaker(clock, **kw):
    kw.setdefault("failure_budget", 3)
    kw.setdefault("window_s", 10.0)
    kw.setdefault("cooldown_s", 2.0)
    kw.setdefault("cooldown_cap_s", 16.0)
    return remediate.CircuitBreaker("dev", time_source=clock.now, **kw)


def test_breaker_opens_after_budget_within_window():
    clock = Clock()
    br = _breaker(clock)
    for _ in range(2):
        br.record_failure()
    assert br.state == remediate.CLOSED and br.allow()
    br.record_failure()
    assert br.state == remediate.OPEN
    assert not br.allow()
    assert br.retry_in() is not None


def test_breaker_window_prunes_stale_failures():
    clock = Clock()
    br = _breaker(clock)
    br.record_failure()
    br.record_failure()
    clock.advance(11.0)  # both age out of the 10s window
    br.record_failure()
    assert br.state == remediate.CLOSED


def test_breaker_half_open_single_probe_then_close():
    clock = Clock()
    br = _breaker(clock)
    for _ in range(3):
        br.record_failure()
    retry_in = br.retry_in()
    clock.advance(retry_in - 1e-6)
    assert not br.allow()
    clock.advance(1.0)
    assert br.allow()                       # THE probe
    assert br.state == remediate.HALF_OPEN
    assert not br.allow()                   # a second caller is refused
    br.record_success()
    assert br.state == remediate.CLOSED and br.allow()
    assert br.probes == 1


def test_breaker_failed_probe_reopens_with_escalated_cooldown():
    clock = Clock()
    br = _breaker(clock)
    for _ in range(3):
        br.record_failure()
    first = br.retry_in()
    clock.advance(first)
    assert br.allow()
    br.record_failure()                     # probe failed
    assert br.state == remediate.OPEN
    second = br.retry_in()
    # the shared backoff rule escalates: attempt 1's base doubles
    assert second > first
    # the timings ARE backoff_delay — the client and breaker share it
    assert first == pytest.approx(remediate.backoff_delay(
        0, base_s=2.0, cap_s=16.0, seed=0))
    assert second == pytest.approx(remediate.backoff_delay(
        1, base_s=2.0, cap_s=16.0, seed=0))


def test_breaker_honors_retry_after_hint_for_probe_timing():
    clock = Clock()
    br = _breaker(clock)
    for i in range(3):
        br.record_failure(retry_after_s=7.5 if i == 2 else None)
    # the shedding peer said 7.5s: the half-open probe waits at least
    # that long, jitter or not
    assert br.retry_in() >= 7.5
    clock.advance(7.4)
    assert not br.allow()
    clock.advance(0.2)
    assert br.allow()


def test_breaker_transition_callback_sequence():
    clock = Clock()
    seen = []
    br = remediate.CircuitBreaker(
        "cb-seq", failure_budget=1, cooldown_s=1.0, cooldown_cap_s=1.0,
        time_source=clock.now,
        on_transition=lambda frm, to: seen.append((frm, to)))
    br.record_failure()
    clock.advance(2.0)
    br.allow()
    br.record_success()
    assert seen == [(remediate.CLOSED, remediate.OPEN),
                    (remediate.OPEN, remediate.HALF_OPEN),
                    (remediate.HALF_OPEN, remediate.CLOSED)]


# --- registries and series lifecycle ------------------------------------


def test_breaker_registry_series_removed_on_unregister():
    clock = Clock()
    br = remediate.CircuitBreaker("reg-test", failure_budget=1,
                                  time_source=clock.now)
    remediate.BREAKERS.register(br)
    try:
        key = (("component", "reg-test"),)
        assert metrics.remediation_breaker_state.sample()[key] == 0.0
        br.record_failure()
        assert metrics.remediation_breaker_state.sample()[key] == 1.0
        assert metrics.remediation_breaker_transitions.sample()[
            (("component", "reg-test"), ("to", "open"))] == 1.0
        assert "reg-test" in remediate.BREAKERS.names()
        assert remediate.BREAKERS.states()["reg-test"] == "open"
    finally:
        remediate.BREAKERS.unregister(br)
    # the cardinality pattern: EVERY per-component series left
    assert key not in metrics.remediation_breaker_state.sample()
    assert not [k for k in
                metrics.remediation_breaker_transitions.sample()
                if ("component", "reg-test") in k]
    assert "reg-test" not in remediate.BREAKERS.names()


def test_breaker_abort_probe_releases_the_slot():
    """A probe that resolves with NO health verdict (config-class shed,
    cancelled caller) must release the slot, or the breaker wedges
    half-open and fast-fails forever (review fix)."""
    clock = Clock()
    br = _breaker(clock, failure_budget=1, cooldown_s=1.0)
    br.record_failure()
    clock.advance(2.0)
    assert br.allow()                       # probe granted
    br.abort_probe()                        # ...resolved verdict-less
    assert br.state == remediate.HALF_OPEN
    assert br.allow()                       # a NEW probe is grantable
    br.record_success()
    assert br.state == remediate.CLOSED
    # no-op outside a probe
    br.abort_probe()
    assert br.state == remediate.CLOSED and br.allow()


def test_breaker_registry_unregister_only_evicts_same_object():
    clock = Clock()
    a = remediate.CircuitBreaker("evict", time_source=clock.now)
    b = remediate.CircuitBreaker("evict", time_source=clock.now)
    remediate.BREAKERS.register(a)
    remediate.BREAKERS.register(b)          # last-wins
    try:
        remediate.BREAKERS.unregister(a)    # stale: must not evict b
        assert remediate.BREAKERS.get("evict") is b
    finally:
        remediate.BREAKERS.unregister(b)


def test_breaker_registry_displacement_silences_the_evicted():
    """Two same-named breakers (two farms in one process): the evicted
    one must stop writing the shared series, and its stale unregister
    must not remove the successor's series (review fix)."""
    clock = Clock()
    key = (("component", "displace"),)
    a = remediate.CircuitBreaker("displace", failure_budget=1,
                                 time_source=clock.now)
    b = remediate.CircuitBreaker("displace", failure_budget=1,
                                 time_source=clock.now)
    remediate.BREAKERS.register(a)
    remediate.BREAKERS.register(b)          # displaces a
    try:
        a.record_failure()                  # a opens — silently
        assert metrics.remediation_breaker_state.sample()[key] == 0.0
        remediate.BREAKERS.unregister(a)    # stale: series stay (b's)
        assert key in metrics.remediation_breaker_state.sample()
        b.record_failure()                  # the live owner writes
        assert metrics.remediation_breaker_state.sample()[key] == 1.0
    finally:
        remediate.BREAKERS.unregister(b)
    assert key not in metrics.remediation_breaker_state.sample()


def test_action_registry_equality_unregister():
    calls = []

    def hook():
        calls.append(1)

    key = ("t-comp", "restart_component")
    remediate.ACTIONS.register("t-comp", "restart_component", hook)
    try:
        assert remediate.ACTIONS._hooks[key] is hook
        remediate.ACTIONS.unregister("t-comp", "restart_component",
                                     lambda: None)   # wrong hook: no-op
        assert remediate.ACTIONS._hooks[key] is hook
    finally:
        remediate.ACTIONS.unregister("t-comp", "restart_component", hook)
    assert key not in remediate.ACTIONS._hooks


# --- the fuzz: step-for-step equal to the JAX breaker ---------------------


def _pair(seed: int, clock: Clock):
    """The same breaker in both packages, each recording its callbacks."""
    rng = random.Random(seed)
    kw = dict(failure_budget=rng.randint(1, 4),
              window_s=rng.choice([5.0, 10.0, 60.0]),
              cooldown_s=rng.choice([0.5, 1.0, 2.0]),
              cooldown_cap_s=rng.choice([4.0, 8.0, 30.0]),
              quarantine_after=rng.choice([0, 2, 3]),
              seed=seed, time_source=clock.now)
    seen = ([], [])
    j = jremediate.CircuitBreaker(
        "fuzz", on_transition=lambda f, t: seen[0].append((f, t)), **kw)
    t = remediate.CircuitBreaker(
        "fuzz", on_transition=lambda f, t: seen[1].append((f, t)), **kw)
    return j, t, seen


@pytest.mark.parametrize("seed", range(8))
def test_breaker_fuzz_equals_the_jax_breaker(seed):
    clock = Clock(100.0)
    j, t, seen = _pair(seed, clock)
    rng = random.Random(1000 + seed)
    for step in range(400):
        op = rng.choice(["allow", "allow", "success", "failure",
                         "failure_hint", "abort", "advance", "advance",
                         "failure", "quarantine", "reset"]
                        if rng.random() < 0.97 else ["quarantine",
                                                      "reset"])
        if op == "allow":
            assert j.allow() == t.allow(), step
        elif op == "success":
            j.record_success()
            t.record_success()
        elif op == "failure":
            j.record_failure()
            t.record_failure()
        elif op == "failure_hint":
            hint = rng.choice([0.1, 1.5, 7.0, 50.0])
            j.record_failure(retry_after_s=hint)
            t.record_failure(retry_after_s=hint)
        elif op == "abort":
            j.abort_probe()
            t.abort_probe()
        elif op == "quarantine":
            j.quarantine()
            t.quarantine()
        elif op == "reset":
            j.reset()
            t.reset()
        else:
            clock.advance(rng.choice([0.05, 0.4, 1.0, 3.0, 12.0]))
        assert t.state == j.state, (step, op)
        assert t.retry_in() == j.retry_in(), (step, op)
        assert t.state_doc() == j.state_doc(), (step, op)
        assert seen[1] == seen[0], (step, op)
    assert seen[0], "the fuzz drove some transitions"
    assert any(to == remediate.QUARANTINED for _, to in seen[0])


# --- QUARANTINED and reset --------------------------------------------------


def test_breaker_quarantine_after_consecutive_opens_and_reset():
    clock = Clock()
    br = _breaker(clock, quarantine_after=2)
    for _ in range(3):
        br.record_failure()
    assert br.state == remediate.OPEN
    clock.advance(br.retry_in())
    assert br.allow()
    br.record_failure()                     # second consecutive open
    assert br.state == remediate.QUARANTINED
    clock.advance(1e9)
    assert not br.allow()                   # only reset() leaves
    br.record_failure()                     # ignored while quarantined
    assert br.state == remediate.QUARANTINED
    br.reset()
    assert br.state == remediate.CLOSED and br.allow()
    assert remediate.STATE_CODES[remediate.QUARANTINED] == 3.0


# --- the engine ---------------------------------------------------------


def _engine(clock, rules, mod=remediate, **kw):
    return mod.RemediationEngine(policy=rules, time_source=clock.now, **kw)


def test_engine_runs_hook_and_records_everything():
    clock = Clock(100.0)
    eng = _engine(clock, [remediate.RecoveryRule(
        component="farm.*", action="reset_farm_lanes", budget=3,
        window_s=60.0, cooldown_s=5.0)])
    ran = []
    remediate.ACTIONS.register("farm.x", "reset_farm_lanes",
                               lambda: ran.append(1))
    key = (("action", "reset_farm_lanes"), ("component", "farm.x"),
           ("outcome", "ok"))
    try:
        before = metrics.remediation_actions.sample().get(key, 0)
        rec = eng.handle_component("farm.x", "stalled 31s")
        assert rec["outcome"] == "ok" and rec["ran"] and ran == [1]
        assert metrics.remediation_actions.sample()[key] == before + 1
        assert eng.history[-1]["component"] == "farm.x"
        assert eng.budgets()["farm.x"]["used"] == 1
    finally:
        remediate.ACTIONS.unregister("farm.x", "reset_farm_lanes")


def test_engine_cooldown_rate_limits_and_recovery_clears_it():
    clock = Clock()
    eng = _engine(clock, [remediate.RecoveryRule(
        component="c", action="restart_component", budget=10,
        window_s=600.0, cooldown_s=30.0)])
    assert eng.handle_component("c")["outcome"] == "no_hook"
    assert eng.handle_component("c")["outcome"] == "rate_limited"
    clock.advance(31.0)
    assert eng.handle_component("c")["outcome"] == "no_hook"
    eng.note_recovered("c")
    assert eng.handle_component("c")["outcome"] == "no_hook"


def test_engine_budget_exhaustion_escalates_to_quarantine():
    clock = Clock()
    eng = _engine(clock, [remediate.RecoveryRule(
        component="flappy", action="restart_component", budget=2,
        window_s=600.0, cooldown_s=0.0)])
    ran = []
    br = remediate.CircuitBreaker("flappy", time_source=clock.now)
    remediate.BREAKERS.register(br)
    remediate.ACTIONS.register("flappy", "restart_component",
                               lambda: ran.append(1))
    try:
        for _ in range(2):
            assert eng.handle_component("flappy")["outcome"] == "ok"
            clock.advance(1.0)
        rec = eng.handle_component("flappy")
        assert rec["action"] == "quarantine_component"
        assert rec["outcome"] == "escalated"
        assert br.state == remediate.QUARANTINED
        clock.advance(1.0)
        assert eng.handle_component("flappy")["outcome"] == "quarantined"
        assert ran == [1, 1]
        assert eng.budgets()["flappy"]["quarantined"] is True
        assert "flappy" in eng.snapshot()["quarantined"]
    finally:
        remediate.ACTIONS.unregister("flappy", "restart_component")
        remediate.BREAKERS.unregister(br)


def test_engine_hook_error_is_recorded_never_propagates():
    clock = Clock()
    eng = _engine(clock, [remediate.RecoveryRule(
        component="bad", action="restart_component", cooldown_s=0.0)])

    def boom():
        raise RuntimeError("hook exploded")

    remediate.ACTIONS.register("bad", "restart_component", boom)
    try:
        assert eng.handle_component("bad")["outcome"] == "error"
    finally:
        remediate.ACTIONS.unregister("bad", "restart_component", boom)


def test_engine_slo_trigger_and_first_match_wins():
    clock = Clock()
    eng = _engine(clock, [
        remediate.RecoveryRule(component="farm_*", trigger="slo_breach",
                               action="shed_and_alert", cooldown_s=0.0),
        remediate.RecoveryRule(component="*", trigger="slo_breach",
                               action="restart_component",
                               cooldown_s=0.0),
    ])
    assert eng.handle_slo("farm_queue_wait", "burn 0.4")["action"] == \
        "shed_and_alert"
    assert eng.handle_slo("layer_apply_latency")["action"] == \
        "restart_component"
    assert eng.handle_component("farm_queue_wait") is None


def test_engine_history_is_bounded():
    clock = Clock()
    eng = _engine(clock, [remediate.RecoveryRule(
        component="*", action="shed_and_alert", budget=10_000,
        window_s=1.0, cooldown_s=0.0)], history=16)
    for i in range(50):
        eng.handle_component(f"c{i % 4}")
        clock.advance(2.0)
    assert len(eng.history) == 16


def test_default_policy_and_action_kinds_equal_the_jax_package():
    import dataclasses

    assert remediate.ACTION_KINDS == jremediate.ACTION_KINDS
    assert [dataclasses.asdict(r) for r in remediate.default_policy()] == \
        [dataclasses.asdict(r) for r in jremediate.default_policy()]


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_records_equal_the_jax_engine(seed):
    """One seeded verdict script (unhealthy verdicts, SLO breaches,
    recoveries, time steps) through both packages' engines under their
    default policies: the same action record after every verdict, and the
    same budgets at the end."""
    rng = random.Random(seed)
    clock = Clock(10.0)
    port = _engine(clock, None)
    jax = _engine(clock, None, mod=jremediate)
    comps = ["verify.farm", "verifyd.replica.r1", "verifyd", "verifyd.r0",
             "post.init", "post.writer", "sync", "unknown.thing"]
    slos = ["farm_queue_wait", "verifyd_block_latency"]
    for step in range(300):
        op = rng.random()
        if op < 0.55:
            c = rng.choice(comps)
            assert port.handle_component(c, "r") == \
                jax.handle_component(c, "r"), step
        elif op < 0.7:
            s = rng.choice(slos)
            assert port.handle_slo(s, "b") == jax.handle_slo(s, "b"), step
        elif op < 0.8:
            c = rng.choice(comps)
            port.note_recovered(c)
            jax.note_recovered(c)
        else:
            clock.advance(rng.choice([1.0, 30.0, 61.0, 300.0]))
    assert port.budgets() == jax.budgets()
    assert list(port.history) == list(jax.history)
    assert any(r["outcome"] == "escalated" for r in port.history)


# --- breaker states in flight manifests -----------------------------------


def test_breaker_state_survives_into_flight_manifest(tmp_path):
    from spacemesh_tpu_torch.obs import health as health_mod

    clock = Clock(50.0)
    br = remediate.CircuitBreaker("manifest-test", failure_budget=1,
                                  time_source=clock.now)
    remediate.BREAKERS.register(br)
    br.record_failure()
    eng = health_mod.HealthEngine(spool_dir=tmp_path,
                                  time_source=clock.now)
    eng.remediation = remediate.RemediationEngine(time_source=clock.now)
    try:
        path = eng.dump_flight("test")
        manifest = json.loads(
            (tmp_path / path.split("/")[-1] / "manifest.json").read_text())
        doc = manifest["remediation"]["breakers"]["manifest-test"]
        assert doc["state"] == "open"
        assert doc["failure_budget"] == 1
        assert manifest["remediation"]["actions"] == []
    finally:
        eng.close()
        remediate.BREAKERS.unregister(br)


def test_flight_manifest_falls_back_to_global_breakers(tmp_path):
    from spacemesh_tpu_torch.obs import flight as flight_mod

    clock = Clock()
    br = remediate.CircuitBreaker("global-fb", time_source=clock.now)
    remediate.BREAKERS.register(br)
    try:
        rec = flight_mod.FlightRecorder(tmp_path, time_source=clock.now)
        path = rec.dump("test")
        manifest = json.loads((path / "manifest.json").read_text())
        assert manifest["remediation"]["breakers"][
            "global-fb"]["state"] == "closed"
    finally:
        remediate.BREAKERS.unregister(br)
