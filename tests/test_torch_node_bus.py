"""The port's event bus (``spacemesh_tpu_torch/node/events.py``) through
the modules that emit on it and consume it, against the JAX package's.

``HealthEngine`` emits ``SloBreach`` and ``ComponentHealth``; the
``RemediationEngine`` subscribed to them emits ``RemediationAction``; a
flight bundle's ``events.json`` is the bus's recent ring;
``FailoverVerifier`` and ``FleetVerifier`` emit ``RemediationAction``
when a breaker opens; ``fleet_from_urls`` has the JAX signature. Then
both packages' health and remediation engines run one seeded stall and
latency script on a fake clock, and the events each bus carried must be
equal in type, fields and order. Exact equality is the tolerance.
"""

import asyncio
import importlib
import inspect
import json
import random

import pytest

from torch_twin import export
from spacemesh_tpu_torch.node import events as events_mod
from spacemesh_tpu_torch.obs import flight as flight_mod
from spacemesh_tpu_torch.obs import remediate
from spacemesh_tpu_torch.verify.farm import Lane
from spacemesh_tpu_torch.verifyd import fleet as fleet_mod
from spacemesh_tpu_torch.verifyd.failover import FailoverVerifier

export("test_remediate", globals(), only=("test_engine_consumes_bus_events",))

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _mods(pkg):
    return {m: importlib.import_module(f"{pkg}.{p}") for m, p in (
        ("health", "obs.health"), ("remediate", "obs.remediate"),
        ("events", "node.events"), ("metrics", "utils.metrics"),
        ("sli", "obs.sli"))}


def _stack(pkg, tmp_path, fake, progress):
    """A health engine with one latency SLO and one ``post.init``
    watchdog, and a remediation engine on the same bus with its own hook
    and breaker registries."""
    m = _mods(pkg)
    reg = m["metrics"].Registry()
    lat = reg.histogram("lat", buckets=(0.01, 0.1, 1.0, float("inf")))
    bus = m["events"].EventBus()
    hreg = m["health"].HealthRegistry()
    engine = m["health"].HealthEngine(
        registry=reg, health=hreg,
        slis=[m["sli"].SliSpec("lat_p95", "lat", "quantile", q=0.95)],
        slos=[m["health"].Slo(name="latency", sli="lat_p95", target=0.1,
                              window_s=20.0, budget=0.0)],
        window_s=20.0, spool_dir=tmp_path / "flight", bus=bus,
        time_source=fake)
    hooks = m["remediate"].HookRegistry()
    restarts = []
    hooks.register("post.init", "restart_component",
                   lambda: restarts.append(fake()))
    rem = m["remediate"].RemediationEngine(
        bus=bus, hooks=hooks, breakers=m["remediate"].BreakerRegistry(),
        time_source=fake)
    engine.remediation = rem
    wd = m["health"].Watchdog("post.init", progress=lambda: progress[0],
                              deadline_s=5.0)
    hreg.register("post.init", wd.check)
    return engine, rem, bus, lat, restarts


def _events(bus) -> list:
    return [(etype, _fields(ev)) for _t, etype, ev in bus.recent]


def _fields(ev):
    return {k: (round(v, 9) if isinstance(v, float) else v)
            for k, v in vars(ev).items()}


def test_slo_breach_and_component_events_reach_the_bus_and_bundle(tmp_path):
    async def run():
        fake = FakeClock()
        progress = [0]
        engine, rem, bus, lat, restarts = _stack(
            "spacemesh_tpu_torch", tmp_path, fake, progress)
        rem.start()
        sub = bus.subscribe(events_mod.RemediationAction, size=16)
        try:
            engine.tick()
            for _ in range(20):
                lat.observe(0.5)
            fake.advance(6.0)          # the watchdog's 5 s deadline passes
            engine.tick()
            engine.flush_dump()
            acts = [await asyncio.wait_for(sub.next(), 5) for _ in range(2)]
        finally:
            rem.close()
            sub.close()
        types = [e[0] for e in _events(bus)]
        assert types[:2] == ["SloBreach", "ComponentHealth"]
        assert {(a.component, a.action) for a in acts} == {
            ("post.init", "restart_component"),
            ("latency", "shed_and_alert")}
        assert restarts == [fake()]
        bundle = flight_mod.read_bundle(engine.recorder.bundles()[-1])
        evs = json.loads((engine.recorder.bundles()[-1] / "events.json")
                         .read_text())
        assert bundle["manifest"]["reason"] == "slo:latency;stall:post.init"
        assert [e["type"] for e in evs] == ["SloBreach", "ComponentHealth"]
        assert evs[1]["event"] == {"component": "post.init",
                                   "healthy": False,
                                   "reason": evs[1]["event"]["reason"]}

    asyncio.run(run())


def test_flight_events_serialize_bytes(tmp_path):
    bus = events_mod.EventBus()
    bus.emit(events_mod.AtxEvent(atx_id=b"\xab" * 4, node_id=b"\x01" * 4,
                                 epoch=3))
    rec = flight_mod.FlightRecorder(tmp_path / "spool")
    p = rec.dump("manual", force=True, events=list(bus.recent))
    evs = json.loads((p / "events.json").read_text())
    assert evs[-1]["type"] == "AtxEvent"
    assert evs[-1]["event"]["atx_id"] == "ab" * 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bus_events_equal_the_jax_packages(tmp_path, seed):
    """One seeded script of latency observations, watchdog stalls and
    recoveries through both packages' engines: the buses carry the same
    events in the same order, and the hooks ran at the same times."""

    async def drive(pkg):
        rng = random.Random(seed)
        fake = FakeClock()
        progress = [0]
        engine, rem, bus, lat, restarts = _stack(
            pkg, tmp_path / pkg, fake, progress)
        rem.start()
        try:
            for _ in range(40):
                for _ in range(rng.randint(0, 8)):
                    lat.observe(rng.choice([0.003, 0.05, 0.4, 2.0]))
                if rng.random() < 0.5:
                    progress[0] += 1
                fake.advance(rng.choice([1.0, 2.5, 4.0, 7.0]))
                engine.tick()
                for _ in range(3):
                    await asyncio.sleep(0)
        finally:
            rem.close()
        return _events(bus), restarts, list(rem.history)

    port = asyncio.run(drive("spacemesh_tpu_torch"))
    ref = asyncio.run(drive("spacemesh_tpu"))
    assert {t for t, _ in port[0]} >= {"SloBreach", "ComponentHealth",
                                       "RemediationAction"}
    assert port == ref


def test_failover_breaker_open_emits_remediation_action():
    from test_torch_failover import Clock, FakeFarm, FakeRemote, FakeReq

    async def run():
        clock = Clock()
        bus = events_mod.EventBus()
        remote = FakeRemote()
        remote.fail_with = ConnectionError("down")
        breaker = remediate.CircuitBreaker(
            "verifyd.remote", time_source=clock.now, window_s=60.0,
            failure_budget=2, cooldown_s=4.0, cooldown_cap_s=8.0)
        fv = FailoverVerifier(remote=remote, farm=FakeFarm(),
                              breaker=breaker, bus=bus,
                              time_source=clock.now)
        for _ in range(3):
            await fv.verify_batch([FakeReq(i) for i in range(4)])
        acts = [ev for _t, etype, ev in bus.recent
                if etype == "RemediationAction"]
        assert len(acts) == 1
        assert (acts[0].component, acts[0].action, acts[0].outcome) == (
            "verifyd.remote", "failover_remote", "ok")
        assert "down" in acts[0].detail

    asyncio.run(run())


def test_fleet_replica_breaker_open_emits_remediation_action():
    from test_torch_fleet import Clock, FakeEndpoint, FakeFarm, FakeReq

    async def run():
        clock = Clock()
        bus = events_mod.EventBus()
        router = fleet_mod.FleetRouter(
            seed=3, time_source=clock.now,
            breaker_kw={"failure_budget": 2, "cooldown_s": 4.0,
                        "cooldown_cap_s": 8.0})
        eps = {f"r{i}": FakeEndpoint() for i in range(3)}
        for name, ep in eps.items():
            router.register_replica(name, ep)
        fv = fleet_mod.FleetVerifier(router=router, farm=FakeFarm(),
                                     client_id="node", own_router=True,
                                     bus=bus, time_source=clock.now)
        router.place_client("node")
        primary = router.placement.replica_of("node")
        eps[primary].fail_with = ConnectionError("down")
        for _ in range(3):
            await fv.verify_batch([FakeReq(i) for i in range(4)],
                                  Lane.GOSSIP)
        acts = [ev for _t, etype, ev in bus.recent
                if etype == "RemediationAction"]
        assert [(a.component, a.action) for a in acts] == [
            (f"verifyd.replica.{primary}", "failover_replica")]
        await fv.aclose()

    asyncio.run(run())


def test_fleet_from_urls_has_the_jax_signature():
    from spacemesh_tpu.verifyd import fleet as jfleet

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(fleet_mod.fleet_from_urls) == params(jfleet.fleet_from_urls)
