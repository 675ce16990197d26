"""The port's verifyd fleet control plane
(``spacemesh_tpu_torch/verifyd/fleet.py``): twins of ``tests/test_fleet.py``
on the port (services on ``device="cpu"``), and the two packages' fleets
over each other's replicas through real sockets.

The FleetVerifier's chain contract on an injected clock — primary
replica while healthy, chain-walk under per-replica breakers on
transport failure, typed-shed re-routing (``registry_full`` re-places
the client instead of surfacing), work stealing off hot replicas,
fleet-wide admission bound, the start/aclose breaker+series lifecycle,
the autoscaling signal fold — plus the re-route churn loop proving a
moved client's per-shard metric series do NOT leak, and the cookbook client's ``replica_hint`` hop path.  Whole-
plane choreography under chaos is the ``fleet`` drill's job
(tests/test_torch_sim_fleet.py).

Across the packages over HTTP, both ways: a JAX ``FleetVerifier`` from
``fleet_from_urls`` over three port replicas, and a port one over three
JAX replicas, with one replica's listener stopped mid-run; every verdict
equals inline verification.
"""

import asyncio
import math

import pytest

import torch

from spacemesh_tpu.verify import farm as jfarm
from spacemesh_tpu.verify import workload as jworkload
from spacemesh_tpu.verifyd import VerifydServer as JServer
from spacemesh_tpu.verifyd import VerifydService as JService
from spacemesh_tpu.verifyd import fleet as jfleet
from spacemesh_tpu.verifyd import protocol as jprotocol
from spacemesh_tpu_torch.obs import remediate
from spacemesh_tpu_torch.utils import metrics
from spacemesh_tpu_torch.verify.farm import Lane, SigRequest, VerificationFarm
from spacemesh_tpu_torch.verifyd import VerifydServer, protocol
from spacemesh_tpu_torch.verifyd.client import RetryPolicy, VerifydClient
from spacemesh_tpu_torch.verifyd.fleet import (FleetRouter, FleetVerifier,
                                               fleet_from_urls)
from spacemesh_tpu_torch.verifyd.service import Shed, VerifydService


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in
    parallel workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class FakeReq:
    def __init__(self, i: int, kind: str = "sig"):
        self.i = i
        self.kind = kind


class FakeEndpoint:
    """Scriptable replica endpoint: verdict = (i % 2 == 0)."""

    def __init__(self):
        self.calls = 0
        self.registers: list[str] = []
        self.unregisters: list[str] = []
        self.fail_with = None        # exception, or a list popped per call

    async def register(self, client, **kwargs):
        self.registers.append(str(client))
        return {"client": str(client)}

    async def unregister(self, client):
        self.unregisters.append(str(client))

    async def verify(self, reqs, *, client, lane="gossip",
                     deadline_s=None):
        self.calls += 1
        fail = self.fail_with
        if isinstance(fail, list):
            fail = fail.pop(0) if fail else None
        if fail is not None:
            raise fail
        return [r.i % 2 == 0 for r in reqs]


class FakeFarm:
    """Local twin computing the SAME verdicts (the farm contract)."""

    def __init__(self):
        self.submits = 0

    async def submit(self, req, lane=Lane.GOSSIP) -> bool:
        self.submits += 1
        return req.i % 2 == 0


REQS = [FakeReq(i) for i in range(4)]
WANT = [True, False, True, False]


def _fleet(clock, n=3, max_clients=64, **kw):
    kw.setdefault("breaker_kw", {"failure_budget": 2, "cooldown_s": 4.0,
                                 "cooldown_cap_s": 8.0})
    router = FleetRouter(seed=3, time_source=clock.now, **kw)
    eps = {}
    for i in range(n):
        ep = FakeEndpoint()
        eps[f"r{i}"] = ep
        router.register_replica(f"r{i}", ep, max_clients=max_clients)
    farm = FakeFarm()
    fv = FleetVerifier(router=router, farm=farm, client_id="node",
                       own_router=True, time_source=clock.now)
    return fv, router, eps, farm


def _chain(router, cid="node"):
    router.place_client(cid)
    return [router.placement.replica_of(cid)] + [
        m for m in router.placement.ring.walk(cid)
        if m != router.placement.replica_of(cid)]


# --- the chain ------------------------------------------------------------


def test_primary_serves_and_registers_once():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        assert await fv.verify_batch(REQS, Lane.BLOCK) == WANT
        assert await fv.submit(FakeReq(2)) is True
        primary = router.placement.replica_of("node")
        assert eps[primary].calls == 2
        assert eps[primary].registers == ["node"]
        assert all(ep.calls == 0 for name, ep in eps.items()
                   if name != primary)
        assert farm.submits == 0 and fv.stats["remote_ok"] == 2

    asyncio.run(run())


def test_dead_primary_chain_moves_on_same_call_then_skips_it():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        eps[order[0]].fail_with = ConnectionError("down")
        # budget 2: both failing calls STILL answer — from the next
        # replica on the chain, same call, not the local farm
        for _ in range(2):
            assert await fv.verify_batch(REQS) == WANT
        assert router.replicas[order[0]].breaker.state == remediate.OPEN
        assert eps[order[0]].calls == 2 and eps[order[1]].calls == 2
        assert farm.submits == 0
        # open: the corpse is not re-paid, the chain starts at order[1]
        for _ in range(5):
            assert await fv.verify_batch(REQS) == WANT
        assert eps[order[0]].calls == 2 and eps[order[1]].calls == 7
        assert fv.stats["remote_ok"] == 7

    asyncio.run(run())


def test_whole_fleet_dead_local_then_fastfail():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        for ep in eps.values():
            ep.fail_with = ConnectionError("down")
        # budget 2, every call pays each closed replica once: two calls
        # open all three breakers; every call still answers with the
        # bit-identical local verdicts
        for _ in range(2):
            assert await fv.verify_batch(REQS) == WANT
        assert all(r.breaker.state == remediate.OPEN
                   for r in router.replicas.values())
        assert fv.stats["local"] == 2
        calls_before = sum(ep.calls for ep in eps.values())
        assert await fv.verify_batch(REQS) == WANT
        assert sum(ep.calls for ep in eps.values()) == calls_before
        assert fv.stats["local_fastfail"] == 1

    asyncio.run(run())


# --- typed sheds ----------------------------------------------------------


def test_registry_full_reroutes_without_tripping():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        eps[order[0]].fail_with = Shed("registry_full", "replica full")
        assert await fv.verify_batch(REQS) == WANT
        # config-class: the breaker did NOT trip, the client moved
        assert router.replicas[order[0]].breaker.state \
            == remediate.CLOSED
        assert router.placement.replica_of("node") != order[0]
        assert router.stats["reroutes"] >= 1
        assert metrics.fleet_replica_sheds.sample()[
            (("reason", "registry_full"), ("replica", order[0]))] >= 1
        # next call goes straight to the new home
        eps[order[0]].fail_with = None
        assert await fv.verify_batch(REQS) == WANT
        assert eps[order[0]].calls == 1

    asyncio.run(run())


def test_shutting_down_reroutes_and_trips():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(
            clock, breaker_kw={"failure_budget": 1, "cooldown_s": 4.0,
                               "cooldown_cap_s": 8.0})
        order = _chain(router)
        eps[order[0]].fail_with = Shed("shutting_down", "draining")
        assert await fv.verify_batch(REQS) == WANT
        # a draining replica is both avoided (re-route) and tripped
        assert router.replicas[order[0]].breaker.state == remediate.OPEN
        assert router.placement.replica_of("node") != order[0]
        assert metrics.remediation_actions.sample().get(
            (("action", "failover_replica"),
             ("component", f"verifyd.replica.{order[0]}"),
             ("outcome", "ok")), 0) >= 1

    asyncio.run(run())


def test_unregistered_retries_same_replica_once():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        # replica restarted and lost the registration: shed once, then
        # serve — the SAME replica answers after a re-register
        eps[order[0]].fail_with = [Shed("unregistered", "who?")]
        assert await fv.verify_batch(REQS) == WANT
        assert eps[order[0]].calls == 2
        assert eps[order[0]].registers == ["node", "node"]
        assert eps[order[1]].calls == 0
        assert router.replicas[order[0]].breaker.state \
            == remediate.CLOSED

    asyncio.run(run())


def test_fleet_wide_bound_sheds_typed():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock, n=2, max_clients=1)
        assert router.fleet_max_clients() == 2
        await fv.verify_batch(REQS, client_id="c0")
        await fv.verify_batch(REQS, client_id="c1")
        with pytest.raises(Shed) as ei:
            await fv.verify_batch(REQS, client_id="c2")
        assert ei.value.reason == "registry_full"
        # the bound is about NEW placements: placed clients still serve
        assert await fv.verify_batch(REQS, client_id="c0") == WANT

    asyncio.run(run())


# --- work stealing --------------------------------------------------------


def test_hot_primary_is_stolen_from():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        # fold SLIs: primary's queue p99 4x over its SLO share, the
        # others idle -> primary scores hot, coolest healthy wins
        router.update_signals(
            {f"fleet_replica_{order[0]}_queue_p99": 1.0})
        chain = router.chain("node", ["sig"])
        assert chain[0] != order[0] and order[0] in chain
        assert router.stats["steals"] == 1
        assert await fv.verify_batch(REQS) == WANT
        assert eps[order[0]].calls == 0   # served by the steal target

    asyncio.run(run())


def test_kind_heat_steals_only_hot_kinds_and_decays():
    async def run():
        clock = Clock(t=100.0)
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        for _ in range(3):
            router.note_shed(order[0], "overload", kinds=["pow"])
        assert router.chain("node", ["pow"])[0] != order[0]
        assert router.chain("node", ["sig"])[0] == order[0]
        # heat is an EWMA on the injected clock: it decays away
        clock.advance(300.0)
        assert router.chain("node", ["pow"])[0] == order[0]

    asyncio.run(run())


def test_steal_needs_margin_and_a_healthy_target():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        order = _chain(router)
        # everyone equally hot: stealing would just move the hot spot
        router.update_signals(
            {f"fleet_replica_{n}_queue_p99": 1.0 for n in order})
        assert router.steal_target(order[0]) is None
        # the only cool replica has an OPEN breaker: not a target
        router.update_signals(
            {f"fleet_replica_{n}_queue_p99": 1.0
             for n in order[:2]})
        for _ in range(2):
            router.replicas[order[2]].breaker.record_failure()
        assert router.replicas[order[2]].breaker.state == remediate.OPEN
        assert router.steal_target(order[0]) is None

    asyncio.run(run())


# --- autoscaling signal ---------------------------------------------------


def test_update_signals_scores_and_desired_replicas():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        sig = router.update_signals({
            "fleet_replica_r0_queue_p99": 0.5,   # 2x over SLO share
            "fleet_replica_r1_shed_per_sec": 3.0,
            "fleet_replica_r2_queue_p99": 0.025,
        })
        assert sig["scores"]["r0"] == pytest.approx(2.0)
        assert sig["scores"]["r1"] == pytest.approx(3.0)
        assert sig["scores"]["r2"] == pytest.approx(0.1)
        mean = (2.0 + 3.0 + 0.1) / 3
        assert sig["desired_replicas"] == math.ceil(3 * mean / 0.7)
        assert metrics.fleet_desired_replicas.sample()[()] \
            == sig["desired_replicas"]
        # idle fleet wants the floor, not zero
        assert router.update_signals({})["desired_replicas"] \
            == router.min_replicas

    asyncio.run(run())


# --- lifecycle: breakers + series -----------------------------------------


def test_start_aclose_registers_and_removes_everything():
    async def run():
        clock = Clock()
        fv, router, eps, farm = _fleet(clock)
        fv.start()
        try:
            for name in ("r0", "r1", "r2"):
                assert f"verifyd.replica.{name}" \
                    in remediate.BREAKERS.names()
            router.update_signals({})
            assert (("replica", "r1"),) \
                in metrics.fleet_replica_load.sample()
            # a replica leaving the fleet takes its series and breaker
            moved = router.unregister_replica("r1")
            assert all(old == "r1" for _c, old, _n in moved)
            assert "verifyd.replica.r1" not in remediate.BREAKERS.names()
            assert (("replica", "r1"),) \
                not in metrics.fleet_replica_load.sample()
        finally:
            await fv.aclose()
        assert all(f"verifyd.replica.{n}"
                   not in remediate.BREAKERS.names()
                   for n in ("r0", "r2"))
        assert metrics.fleet_replicas.sample()[()] == 0

    asyncio.run(run())


# --- re-route churn: zero leaked series -----------------------------------


class _SvcEndpoint:
    """In-process endpoint over a real sharded VerifydService (the
    churn loop needs the true per-shard registries and series)."""

    def __init__(self, svc: VerifydService):
        self.svc = svc

    async def register(self, client, **kwargs):
        self.svc.register_client(str(client), **kwargs)
        return {"client": str(client)}

    async def unregister(self, client):
        self.svc.unregister_client(str(client))

    async def verify(self, reqs, *, client, lane="gossip",
                     deadline_s=None):  # pragma: no cover - unused
        raise AssertionError("churn test never verifies")


def test_reroute_churn_leaks_no_per_shard_series():
    """100 re-routes between two real shards: every hop's flush_stale
    unregisters the client from the shard it LEFT, so no
    ``{shard}/{cid}`` series and no tenant state survive the churn."""

    async def run():
        cid = "churnling"
        services = {n: VerifydService(shard=n, workers=1, device="cpu")
                    for n in ("a", "b")}
        router = FleetRouter(seed=5)
        try:
            for n, svc in services.items():
                router.register_replica(n, _SvcEndpoint(svc))
            router.place_client(cid)
            for _ in range(100):
                cur = router.placement.replica_of(cid)
                rep = router.replicas[cur]
                await rep.endpoint.register(cid)
                rep.registered.add(cid)
                assert cid in services[cur].clients
                # the shard sheds registry_full -> the router moves the
                # client and flushes the stale registration
                assert router.reroute(cid, avoid=cur,
                                      reason="registry_full") != cur
                await router.flush_stale()
                assert cid not in services[cur].clients
                assert len(services[cur].clients) == 0
            # the identity left no trace on either shard's books
            last = router.placement.replica_of(cid)
            router.replicas[last].registered.discard(cid)
            router.forget_client(cid)
            assert all(not svc.clients for svc in services.values())
            assert cid not in metrics.REGISTRY.expose()
        finally:
            for n in list(services):
                router.unregister_replica(n)
            await router.aclose()
            for svc in services.values():
                await svc.aclose()

    asyncio.run(run())


# --- the cookbook client's replica_hint hop path --------------------------


class _HopClient(VerifydClient):
    """_post driven by a url-keyed script instead of sockets."""

    def __init__(self, servers, start_url, **kw):
        kw.setdefault("retry", None)
        kw.setdefault("session", object())   # never used: _post is ours
        kw.setdefault("sleep", self._fake_sleep)
        super().__init__(start_url, "c", **kw)
        self.servers = servers   # url -> {path: doc | [docs]}
        self.posts: list[tuple[str, str, dict]] = []
        self.sleeps: list[float] = []

    async def _fake_sleep(self, s):
        self.sleeps.append(s)

    async def _post(self, path, body):
        self.posts.append((self.base_url, path, body))
        doc = self.servers[self.base_url][path]
        if isinstance(doc, list):
            doc = doc.pop(0)
        return 200, doc


_OK_REG = {"status": "OK"}
_OK_VERIFY = {"status": "OK", "verdicts": [True, False]}
_SIG = SigRequest(domain=1, public_key=b"\x01" * 32, msg=b"m",
                  signature=b"\x02" * 64)


def _shed_doc(reason, hint=None):
    doc = {"status": "SHED", "reason": reason, "detail": "x"}
    if hint is not None:
        doc["replica_hint"] = hint
    return doc


def test_client_hops_to_hinted_replica_without_sleeping():
    async def run():
        c = _HopClient({
            "http://a": {"/v1/client/register": _OK_REG,
                         "/v1/verify": _shed_doc("registry_full",
                                                 "http://b")},
            "http://b": {"/v1/client/register": _OK_REG,
                         "/v1/verify": _OK_VERIFY},
        }, "http://a", retry=RetryPolicy(max_attempts=5))
        await c.register(weight=2.0)
        assert await c.verify([_SIG]) == [True, False]
        assert c.base_url == "http://b" and c.sleeps == []
        # the hop re-registered with the ORIGINAL knobs
        reg_b = [b for u, p, b in c.posts
                 if u == "http://b" and p == "/v1/client/register"]
        assert reg_b == [{"client": "c", "weight": 2.0}]

    asyncio.run(run())


def test_client_chases_chained_hints():
    async def run():
        # a is draining and points at b; b is ALSO draining and points
        # at c; c serves — the hop loop chases hints, each url once
        c = _HopClient({
            "http://a": {"/v1/verify": _shed_doc("shutting_down",
                                                 "http://b")},
            "http://b": {"/v1/client/register":
                         _shed_doc("shutting_down", "http://c")},
            "http://c": {"/v1/client/register": _OK_REG,
                         "/v1/verify": _OK_VERIFY},
        }, "http://a")
        assert await c.verify([_SIG]) == [True, False]
        assert c.base_url == "http://c" and c.sleeps == []

    asyncio.run(run())


def test_client_falls_back_to_configured_ring_without_hint():
    async def run():
        c = _HopClient({
            "http://a": {"/v1/verify": _shed_doc("registry_full")},
            "http://b": {"/v1/client/register": _OK_REG,
                         "/v1/verify": _OK_VERIFY},
        }, "http://a", fallback_urls=("http://b",))
        assert await c.verify([_SIG]) == [True, False]
        assert c.base_url == "http://b"

    asyncio.run(run())


def test_client_hop_exhaustion_reraises_typed():
    async def run():
        # the hint points back at an already-tried replica and there
        # are no fallbacks: the lifecycle shed surfaces immediately
        c = _HopClient({
            "http://a": {"/v1/verify": _shed_doc("registry_full",
                                                 "http://a")},
        }, "http://a", retry=RetryPolicy(max_attempts=5))
        with pytest.raises(Shed) as ei:
            await c.verify([_SIG])
        assert ei.value.reason == "registry_full"
        assert c.sleeps == []
        assert [p for _u, p, _b in c.posts] == ["/v1/verify"]

    asyncio.run(run())


# --- across the packages over HTTP ----------------------------------------

WL_ARGS = dict(sigs=12, vrfs=4, posts=4, memberships=4, pows=6,
               post_challenges=2)


@pytest.fixture(scope="module")
def jwl(tmp_path_factory):
    """The JAX package's workload: the reference."""
    return jworkload.build(str(tmp_path_factory.mktemp("jax-fleet-wl")),
                           **WL_ARGS)


def _chunks(reqs, n=5):
    return [reqs[i:i + n] for i in range(0, len(reqs), n)]


async def _drive(fv, chunks, servers, clients=("a", "b", "c", "d")):
    """Every chunk through the fleet under a rotating client id; the
    replica serving the most clients' chains has its listener stopped
    half way (the chain moves on, then the local farm backs it)."""
    out = []
    for k, chunk in enumerate(chunks):
        if k == len(chunks) // 2:
            if hasattr(servers[1], "stop_listening"):
                await servers[1].stop_listening()
            else:
                await servers[1].close()
        out.extend(await fv.verify_batch(chunk, client_id=clients[
            k % len(clients)]))
    return out


def _port_replica(wl_port, name):
    svc = VerifydService(shard=name, workers=2, device="cpu",
                         default_rate=1e9, default_burst=1e9,
                         post_params=wl_port["post_params"],
                         post_seed=wl_port["post_seed"])
    svc.farm.ed_verifier = wl_port["ed"]
    svc.farm.vrf_verifier = wl_port["vrf"]
    return VerifydServer(service=svc)


def test_jax_fleet_over_port_replicas_is_inline_equal(jwl):
    """The JAX node's fleet client (``fleet_from_urls``) over three port
    replicas on real sockets: verdicts equal the JAX inline oracle."""
    from spacemesh_tpu_torch.core.signing import EdVerifier, VrfVerifier
    from spacemesh_tpu_torch.post.prover import ProofParams

    expected = jwl.inline_all()
    p = jwl.post_params
    wl_port = {"post_params": ProofParams(k1=p.k1, k2=p.k2, k3=p.k3,
                                          pow_difficulty=p.pow_difficulty),
               "post_seed": jwl.post_seed, "ed": EdVerifier(),
               "vrf": VrfVerifier()}

    async def go():
        servers = [_port_replica(wl_port, f"r{i}") for i in range(3)]
        local = jfarm.VerificationFarm(
            ed_verifier=jwl.ed, vrf_verifier=jwl.vrf,
            post_params=jwl.post_params, post_seed=jwl.post_seed)
        fv = None
        try:
            ports = [await s.start() for s in servers]
            fv = jfleet.fleet_from_urls(
                [f"http://127.0.0.1:{port}" for port in ports], farm=local)
            fv.start()
            got = await _drive(fv, _chunks(jwl.requests), servers)
            return got, fv.stats, fv.router.state_doc()
        finally:
            if fv is not None:
                await fv.aclose()
            for s in servers:
                await s.close()
            await local.aclose()

    got, stats, doc = asyncio.run(go())
    assert got == expected
    assert stats["remote_ok"] >= 1
    served = {n: r["ok"] for n, r in doc["replicas"].items()}
    assert sum(served.values()) >= 1, served


def test_port_fleet_over_jax_replicas_is_inline_equal(jwl):
    """The port's fleet client over three JAX replicas on real sockets:
    the requests cross as protocol docs, verdicts equal the JAX inline
    oracle."""
    from spacemesh_tpu_torch.core.signing import EdVerifier, VrfVerifier
    from spacemesh_tpu_torch.post.prover import ProofParams

    expected = jwl.inline_all()
    reqs = [protocol.request_from_doc(jprotocol.request_to_doc(r))
            for r in jwl.requests]
    p = jwl.post_params

    async def go():
        servers = []
        for i in range(3):
            svc = JService(shard=f"r{i}", workers=2, default_rate=1e9,
                           default_burst=1e9, post_params=jwl.post_params,
                           post_seed=jwl.post_seed)
            svc.farm.ed_verifier = jwl.ed
            svc.farm.vrf_verifier = jwl.vrf
            servers.append(JServer(service=svc))
        local = VerificationFarm(
            ed_verifier=EdVerifier(), vrf_verifier=VrfVerifier(),
            post_params=ProofParams(k1=p.k1, k2=p.k2, k3=p.k3,
                                    pow_difficulty=p.pow_difficulty),
            post_seed=jwl.post_seed, device="cpu")
        fv = None
        try:
            ports = [await s.start() for s in servers]
            fv = fleet_from_urls(
                [f"http://127.0.0.1:{port}" for port in ports], farm=local)
            fv.start()
            got = await _drive(fv, _chunks(reqs), servers)
            return got, fv.stats
        finally:
            if fv is not None:
                await fv.aclose()
            for s in servers:
                await s.close()
            await local.aclose()

    got, stats = asyncio.run(go())
    assert got == expected
    assert stats["remote_ok"] >= 1


# --- the service's shard= and replica_hint --------------------------------


def test_shard_namespaces_tenants_health_and_client_series():
    """A sharded replica registers ``verifyd.<shard>`` with the health
    registry, its tenants as ``<shard>/<cid>`` on the scheduler, and its
    per-client series as ``<shard>/<cid>``; unregistering and closing
    drop them all, as the JAX service does."""
    from spacemesh_tpu.verifyd import VerifydService as JVerifydService
    from spacemesh_tpu_torch.obs import health

    async def run():
        svc = VerifydService(shard="s1", workers=1, device="cpu",
                             default_rate=1e9, default_burst=1e9)
        jsvc = JVerifydService(shard="s1", workers=1)
        try:
            await svc.start()
            assert "verifyd.s1" in health.HEALTH.report()
            svc.register_client("c")
            jsvc.register_client("c")
            assert svc.scheduler.inner.tenants() == \
                jsvc.scheduler.inner.tenants() == ["s1/c"]
            assert svc.scheduler.tenants() == ["c"]
            got = await svc.verify("c", [_SIG])
            assert got == [False]
            text = metrics.REGISTRY.expose()
            assert 'client="s1/c"' in text
            assert metrics.verifyd_clients.sample()[(("shard", "s1"),)] == 1
            svc.unregister_client("c")
            assert 'client="s1/c"' not in metrics.REGISTRY.expose()
        finally:
            await svc.aclose()
            await jsvc.aclose()
        assert "verifyd.s1" not in health.HEALTH.report()
        assert (("shard", "s1"),) not in metrics.verifyd_clients.sample()
        assert svc.stats_doc()["shard"] == "s1"

    asyncio.run(run())


def test_replica_hint_rides_registry_full_and_shutting_down_sheds():
    """``replica_hint`` names a peer in the lifecycle sheds only, in the
    service's exceptions and in the server's shed docs over HTTP."""
    import aiohttp

    async def run():
        svc = VerifydService(shard="a", replica_hint="http://b:1",
                             max_clients=1, workers=1, device="cpu",
                             default_rate=1.0, default_burst=1.0)
        server = VerifydServer(service=svc)
        try:
            port = await server.start()
            svc.register_client("c0")
            with pytest.raises(Shed) as ei:
                svc.register_client("c1")
            assert ei.value.reason == "registry_full"
            assert ei.value.replica_hint == "http://b:1"
            # a rate shed is about time, not space: no hint
            with pytest.raises(Shed) as ei:
                await svc.verify("c0", [_SIG] * 8)
            assert ei.value.reason == "rate"
            assert ei.value.replica_hint is None
            url = f"http://127.0.0.1:{port}"
            async with aiohttp.ClientSession() as sess:
                async with sess.post(url + "/v1/client/register",
                                     json={"client": "c1"}) as resp:
                    doc = await resp.json()
                assert resp.status == 429
                assert doc["reason"] == "registry_full"
                assert doc["replica_hint"] == "http://b:1"
                await svc.aclose()
                async with sess.post(url + "/v1/verify", json={
                        "client": "c0", "items": []}) as resp:
                    doc = await resp.json()
                assert resp.status == 503
                assert doc["reason"] == "shutting_down"
                assert doc["replica_hint"] == "http://b:1"
        finally:
            await server.close()

    asyncio.run(run())
