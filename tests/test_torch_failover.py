"""The port's verifyd failover client and the client's shed-retry policy
(``spacemesh_tpu_torch/verifyd/failover.py``, ``client.py``): twins of
``tests/test_failover.py`` on the port.

The FailoverVerifier's routing contract on an injected clock — remote
while healthy, breaker-guarded local fallback on typed sheds/transport
errors/deadline misses, half-open probe honoring ``retry_after_s``,
failback on recovery — and the cookbook client's bounded
``retry_after_s``-honoring backoff (the sleeps asserted against the
shared ``backoff_delay`` rule, zero real sleeping).  Verdict
bit-identity remote-vs-local at workload scale is the verifyd-outage
drill's job (tests/test_torch_sim_fleet.py). Then the runtime engine's
breaker and fallback (twins of ``tests/test_runtime_engine.py``'s), and
the port's deliberate difference: no entry point passes a fallback, and a
failed k2pow window launch on the card raises.
"""

import asyncio

import pytest

from spacemesh_tpu_torch.obs import remediate
from spacemesh_tpu_torch.utils import metrics
from spacemesh_tpu_torch.verify.farm import Lane
from spacemesh_tpu_torch.verifyd.client import RetryPolicy, VerifydClient
from spacemesh_tpu_torch.verifyd.failover import FailoverVerifier
from spacemesh_tpu_torch.verifyd.service import Shed


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class FakeReq:
    kind = "sig"

    def __init__(self, i: int):
        self.i = i


class FakeRemote:
    """Scriptable remote endpoint: verdict = (i % 2 == 0)."""

    def __init__(self):
        self.calls = 0
        self.registers = 0
        self.fail_with = None       # exception instance to raise

    async def register(self):
        self.registers += 1

    async def verify(self, reqs, *, lane="gossip", deadline_s=None):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        return [r.i % 2 == 0 for r in reqs]


class FakeFarm:
    """Local twin computing the SAME verdicts (the farm contract)."""

    def __init__(self):
        self.submits = 0

    async def submit(self, req, lane=Lane.GOSSIP) -> bool:
        self.submits += 1
        return req.i % 2 == 0


def _fv(clock, **br_kw):
    br_kw.setdefault("failure_budget", 2)
    br_kw.setdefault("cooldown_s", 4.0)
    br_kw.setdefault("cooldown_cap_s", 8.0)
    remote, farm = FakeRemote(), FakeFarm()
    breaker = remediate.CircuitBreaker(
        "verifyd.remote", time_source=clock.now, window_s=60.0, **br_kw)
    fv = FailoverVerifier(remote=remote, farm=farm, breaker=breaker,
                          time_source=clock.now)
    return fv, remote, farm


REQS = [FakeReq(i) for i in range(4)]
WANT = [True, False, True, False]


def test_remote_path_serves_and_registers_once():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock)
        assert await fv.verify_batch(REQS, Lane.BLOCK) == WANT
        assert await fv.submit(FakeReq(2)) is True
        assert remote.calls == 2 and remote.registers == 1
        assert farm.submits == 0
        assert fv.stats["remote_ok"] == 2

    asyncio.run(run())


def test_transport_error_falls_back_same_call_then_breaker_opens():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock)
        remote.fail_with = ConnectionError("down")
        # budget 2: both failing calls STILL answer (local), then open
        for _ in range(2):
            assert await fv.verify_batch(REQS) == WANT
        assert fv.breaker.state == remediate.OPEN
        assert remote.calls == 2 and farm.submits == 8
        # open: straight to local, the dead service is not re-paid
        for _ in range(5):
            assert await fv.verify_batch(REQS) == WANT
        assert remote.calls == 2
        assert fv.stats["local_fastfail"] == 5

    asyncio.run(run())


def test_typed_shed_trips_and_retry_after_floors_the_probe():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock, failure_budget=1,
                               cooldown_s=1.0, cooldown_cap_s=60.0)
        remote.fail_with = Shed("overload", "busy", retry_after_s=30.0)
        assert await fv.verify_batch(REQS) == WANT   # local answer
        assert fv.breaker.state == remediate.OPEN
        # the shed's hint drives the half-open probe timing
        assert fv.breaker.retry_in() >= 30.0
        clock.advance(29.0)
        assert await fv.verify_batch(REQS) == WANT
        assert remote.calls == 1                     # still open
        clock.advance(2.0)
        remote.fail_with = None
        assert await fv.verify_batch(REQS) == WANT   # the probe
        assert remote.calls == 2
        assert fv.breaker.state == remediate.CLOSED
        assert fv.stats["failbacks"] == 1
        # failed back: remote serves again
        assert await fv.verify_batch(REQS) == WANT
        assert remote.calls == 3

    asyncio.run(run())


def test_non_tripping_shed_serves_locally_and_reregisters():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock)
        assert await fv.verify_batch(REQS) == WANT
        remote.fail_with = Shed("unregistered", "who?")
        assert await fv.verify_batch(REQS) == WANT   # local, no trip
        assert fv.breaker.state == remediate.CLOSED
        remote.fail_with = None
        assert await fv.verify_batch(REQS) == WANT
        assert remote.registers == 2                 # re-registered

    asyncio.run(run())


def test_non_tripping_shed_during_probe_does_not_wedge_breaker():
    """The review-confirmed leak: a half-open probe answered with a
    config-class shed must RELEASE the probe slot — a verifyd restart
    that wiped its client registry must not strand the node on the
    local farm forever."""

    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock, failure_budget=1, cooldown_s=1.0,
                               cooldown_cap_s=2.0)
        remote.fail_with = ConnectionError("down")
        assert await fv.verify_batch(REQS) == WANT
        assert fv.breaker.state == remediate.OPEN
        clock.advance(2.5)
        # the service is back but restarted: the probe gets a
        # registry-wipe shed, not a verdict
        remote.fail_with = Shed("unregistered", "registry wiped")
        assert await fv.verify_batch(REQS) == WANT   # local answer
        # NOT wedged: the very next call may probe again, re-registers,
        # succeeds, and traffic fails back to remote
        remote.fail_with = None
        before = remote.calls
        assert await fv.verify_batch(REQS) == WANT
        assert remote.calls == before + 1
        assert fv.breaker.state == remediate.CLOSED
        assert await fv.verify_batch(REQS) == WANT
        assert remote.calls == before + 2

    asyncio.run(run())


def test_cancelled_probe_releases_the_slot():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock, failure_budget=1, cooldown_s=1.0,
                               cooldown_cap_s=2.0)
        remote.fail_with = ConnectionError("down")
        await fv.verify_batch(REQS)
        clock.advance(2.5)
        remote.fail_with = None
        hang = asyncio.Event()

        async def hung_verify(reqs, *, lane="gossip", deadline_s=None):
            hang.set()
            await asyncio.sleep(3600)

        remote.verify = hung_verify
        task = asyncio.ensure_future(fv.verify_batch(REQS))
        await hang.wait()                   # the probe is in flight
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        # the slot came back: a later caller can probe
        assert fv.breaker.state == remediate.HALF_OPEN
        assert fv.breaker.allow()

    asyncio.run(run())


def test_deadline_miss_trips_breaker():
    async def run():
        clock = Clock()
        remote, farm = FakeRemote(), FakeFarm()

        async def slow_verify(reqs, *, lane="gossip", deadline_s=None):
            await asyncio.sleep(30)

        remote.verify = slow_verify
        fv = FailoverVerifier(
            remote=remote, farm=farm, deadline_s=0.05,
            breaker=remediate.CircuitBreaker(
                "verifyd.remote", failure_budget=1,
                time_source=clock.now),
            time_source=clock.now)
        assert await fv.verify_batch(REQS) == WANT
        assert fv.breaker.state == remediate.OPEN
        assert fv.stats["remote_failed"] == 1

    asyncio.run(run())


def test_start_aclose_registry_and_metrics_lifecycle():
    async def run():
        clock = Clock()
        fv, remote, farm = _fv(clock)
        fv.start()
        assert "verifyd.remote" in remediate.BREAKERS.names()
        key = (("component", "verifyd.remote"),)
        assert key in metrics.remediation_breaker_state.sample()
        await fv.verify_batch(REQS, Lane.BLOCK)
        assert metrics.failover_requests.sample()[
            (("lane", "block"), ("path", "remote"))] >= 1
        await fv.aclose()
        assert "verifyd.remote" not in remediate.BREAKERS.names()
        assert key not in metrics.remediation_breaker_state.sample()
        assert fv.state_doc()["breaker"]["state"] == "closed"

    asyncio.run(run())


# --- the cookbook client's shed-retry policy ----------------------------


class _ScriptedClient(VerifydClient):
    """verify() driven by a script of outcomes instead of sockets."""

    def __init__(self, outcomes, **kw):
        sleeps = []
        kw.setdefault("sleep", self._fake_sleep)
        super().__init__("http://x", "c", **kw)
        self._outcomes = list(outcomes)
        self.sleeps = sleeps
        self.attempts = 0

    async def _fake_sleep(self, s):
        self.sleeps.append(s)

    async def _verify_once(self, reqs, *, lane, deadline_s):
        self.attempts += 1
        out = self._outcomes.pop(0)
        if isinstance(out, Exception):
            raise out
        return out


def test_client_honors_retry_after_with_shared_backoff():
    async def run():
        policy = RetryPolicy(max_attempts=3, base_s=0.05, cap_s=2.0,
                             seed=11)
        c = _ScriptedClient(
            [Shed("rate", "over budget", retry_after_s=0.3),
             Shed("queue_full", "deep", retry_after_s=0.8),
             [True, False]],
            retry=policy)
        assert await c.verify(["r"]) == [True, False]
        assert c.attempts == 3
        # the waits ARE the shared rule, floored at the server's hint
        assert c.sleeps == [
            remediate.backoff_delay(0, base_s=0.05, cap_s=2.0,
                                    retry_after_s=0.3, seed=11),
            remediate.backoff_delay(1, base_s=0.05, cap_s=2.0,
                                    retry_after_s=0.8, seed=11),
        ]
        assert c.sleeps[0] >= 0.3 and c.sleeps[1] >= 0.8

    asyncio.run(run())


def test_client_attempt_budget_exhausts_and_reraises():
    async def run():
        c = _ScriptedClient(
            [Shed("rate", "x", retry_after_s=0.1)] * 5,
            retry=RetryPolicy(max_attempts=3))
        with pytest.raises(Shed) as ei:
            await c.verify(["r"])
        assert ei.value.reason == "rate"
        assert c.attempts == 3 and len(c.sleeps) == 2

    asyncio.run(run())


def test_client_gives_up_immediately_when_hint_exceeds_patience():
    """A retry_after beyond cap_s means the condition won't clear
    within this client's patience: re-raise NOW, sleep never."""

    async def run():
        c = _ScriptedClient(
            [Shed("rate", "tiny bucket", retry_after_s=3600.0)],
            retry=RetryPolicy(max_attempts=5, cap_s=2.0))
        with pytest.raises(Shed):
            await c.verify(["r"])
        assert c.attempts == 1 and c.sleeps == []

    asyncio.run(run())


def test_client_non_retryable_sheds_and_opt_out():
    async def run():
        # lifecycle sheds never retry, whatever the budget
        c = _ScriptedClient([Shed("shutting_down", "bye",
                                  retry_after_s=0.1)],
                            retry=RetryPolicy(max_attempts=5))
        with pytest.raises(Shed):
            await c.verify(["r"])
        assert c.attempts == 1
        # retry=None is the raw one-shot client
        c2 = _ScriptedClient([Shed("rate", "x", retry_after_s=0.01)],
                             retry=None)
        with pytest.raises(Shed):
            await c2.verify(["r"])
        assert c2.attempts == 1 and c2.sleeps == []

    asyncio.run(run())


# --- the runtime engine's breaker and fallback ------------------------------
#
# Twins of tests/test_runtime_engine.py's fallback and breaker tests on the
# port's Pipeline (the hooks the runtime-degrade drill drives), then the
# deliberate difference: no entry point of the port passes a fallback.


def test_pipeline_fallback_on_dispatch_failure():
    from spacemesh_tpu_torch.runtime import engine

    before = sum(metrics.runtime_fallbacks.sample().values())

    def dispatch(i):
        if i == 1:
            raise RuntimeError("device down")
        return ("dev", i)

    pipe = engine.Pipeline(kind="t", inflight=2,
                           fallback=lambda i, exc: ("host", i))
    out = []
    pipe.run(range(3), dispatch, out.append)
    assert out == [("dev", 0), ("host", 1), ("dev", 2)]
    assert pipe.stats.fallbacks == 1
    assert sum(metrics.runtime_fallbacks.sample().values()) == before + 1
    with pytest.raises(RuntimeError):
        engine.Pipeline(kind="t").run(range(3), dispatch, out.append)


def test_pipeline_sustained_failure_repays_device_without_breaker():
    from spacemesh_tpu_torch.runtime import engine

    attempts = [0]

    def dispatch(i):
        attempts[0] += 1
        raise RuntimeError("device permanently dead")

    pipe = engine.Pipeline(kind="t-nobreak", inflight=2,
                           fallback=lambda i, exc: ("host", i))
    pipe.run(range(50), dispatch, lambda t: None)
    assert attempts[0] == 50
    assert pipe.stats.fallbacks == 50


def test_pipeline_breaker_stops_repaying_dead_device():
    from spacemesh_tpu_torch.runtime import engine

    clock = [0.0]
    br = remediate.CircuitBreaker("t-dev", failure_budget=3,
                                  window_s=60.0, cooldown_s=30.0,
                                  time_source=lambda: clock[0])
    attempts = [0]

    def dispatch(i):
        attempts[0] += 1
        raise RuntimeError("device permanently dead")

    before = sum(metrics.runtime_fallbacks.sample().values())
    out = []
    pipe = engine.Pipeline(kind="t-break", inflight=2, breaker=br,
                           fallback=lambda i, exc: ("host", i, exc))
    pipe.run(range(50), dispatch, out.append)
    assert attempts[0] == 3
    assert len(out) == 50
    assert pipe.stats.fallbacks == 50
    assert sum(metrics.runtime_fallbacks.sample().values()) == before + 50
    assert br.state == remediate.OPEN
    assert isinstance(out[-1][2], remediate.BreakerOpen)
    clock[0] = 100.0
    good = engine.Pipeline(kind="t-break", inflight=2, breaker=br,
                           fallback=lambda i, exc: ("host", i, exc))
    dev_out = []
    good.run(range(5), lambda i: ("dev", i), dev_out.append)
    assert good.stats.fallbacks == 0
    assert dev_out == [("dev", i) for i in range(5)]
    assert br.state == remediate.CLOSED


def test_pipeline_breaker_open_without_fallback_raises_typed():
    from spacemesh_tpu_torch.runtime import engine

    br = remediate.CircuitBreaker("t-nofb", failure_budget=1,
                                  cooldown_s=30.0,
                                  time_source=lambda: 0.0)

    def dispatch(i):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError, match="dead"):
        engine.Pipeline(kind="t", breaker=br).run(range(2), dispatch,
                                                  lambda t: None)
    assert br.state == remediate.OPEN
    with pytest.raises(remediate.BreakerOpen):
        engine.Pipeline(kind="t", breaker=br).run(range(2), dispatch,
                                                  lambda t: None)


def test_pipeline_dispatch_span_carries_kind_tenant_and_attrs():
    from spacemesh_tpu_torch.runtime import engine
    from spacemesh_tpu_torch.utils import tracing

    tracing.start(capacity=64)
    try:
        engine.Pipeline(kind="k", tenant="t1", span="job",
                        attrs=lambda i: {"item": i}).run(
            range(2), lambda i: i, lambda t: None)
        engine.Pipeline(kind="k").run(range(2), lambda i: i,
                                      lambda t: None)  # span=None: none
    finally:
        tracing.stop()
    evs = [e for e in tracing.export()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in evs] == ["job.dispatch", "job.dispatch"]
    assert [e["args"]["item"] for e in evs] == [0, 1]
    assert all(e["args"]["kind"] == "k" and e["args"]["tenant"] == "t1"
               for e in evs)


def test_pow_search_on_the_card_raises_when_a_window_launch_fails(
        monkeypatch):
    """The JAX search hands a failing device dispatch to a host re-scan;
    the port's does not: with the window launch stubbed to fail,
    ``ops.pow.search(device="cuda")`` raises and nothing falls back."""
    import torch

    from spacemesh_tpu_torch.ops import pow as tpow
    from spacemesh_tpu_torch.ops import pow_cuda

    def failing_launch(*args, **kwargs):
        raise RuntimeError("window launch failed")

    hashed = []
    monkeypatch.setattr(pow_cuda, "search_window", failing_launch)
    monkeypatch.setattr(pow_cuda, "pow_hash_batch",
                        lambda *a, **k: hashed.append(1))
    monkeypatch.setattr(pow_cuda, "new_cell",
                        lambda device: torch.full((1,), -1,
                                                  dtype=torch.int64))
    monkeypatch.setattr(tpow, "resolve", torch.device)
    before = sum(metrics.runtime_fallbacks.sample().values())
    with pytest.raises(RuntimeError, match="window launch failed"):
        tpow.search(b"\x01" * 32, b"\x02" * 32, bytes([255]) * 32,
                    device="cuda")
    assert hashed == []
    assert sum(metrics.runtime_fallbacks.sample().values()) == before


def test_no_entry_point_of_the_port_passes_a_fallback():
    """Only the runtime-degrade drill wires ``fallback=``/``breaker=``
    into the engine (its stand-in device); the card's paths never do."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "spacemesh_tpu_torch"
    users = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            func = getattr(node, "func", None)
            name = getattr(func, "attr", getattr(func, "id", None))
            if name == "Pipeline" and any(
                    k.arg in ("fallback", "breaker") for k in node.keywords):
                users.add(str(path.relative_to(root)))
    assert users == {"sim/failover.py"}, users
