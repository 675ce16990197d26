"""The port's verification service (``spacemesh_tpu_torch/verifyd/``) on
the CPU, held to the JAX package's.

* Parity: one seeded workload of the JAX ``workload.build`` geometry
  (scrypt N=2, 512 labels per unit, every kind, malformed items
  included) crosses into the port through the protocol docs; the JAX
  farm and service and the port's farm and service (``device="cpu"``)
  give equal verdicts, equal to ``inline_all()``. The port's own
  ``workload.build`` gives the same docs for the same seeds, and docs
  decode across the packages both ways with equal ``key()``s.
* Wire compatibility over real sockets: the JAX client against the
  port's server and the port's client against the JAX server, over HTTP
  and gRPC, and the port's CLI in a subprocess.
* Twins of ``tests/test_verifyd.py``: typed admission (unregistered,
  registry_full, rate, deadline, quota, overload heavy-first), graceful
  drain, client churn, batchtune's race/persist/policy, the protocol,
  the HTTP and gRPC surfaces, shutdown sheds. Where the JAX tests read
  windowed SLIs (``obs/sli.py``, not ported) these read the port's own
  stats and ``verifyd_request_seconds`` histogram.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from spacemesh_tpu.verify import farm as jfarm
from spacemesh_tpu.verify import workload as jworkload
from spacemesh_tpu.verifyd import VerifydClient as JClient
from spacemesh_tpu.verifyd import VerifydServer as JServer
from spacemesh_tpu.verifyd import VerifydService as JService
from spacemesh_tpu.verifyd import protocol as jprotocol
from spacemesh_tpu_torch.core.signing import EdVerifier, VrfVerifier
from spacemesh_tpu_torch.utils import metrics
from spacemesh_tpu_torch.verify import workload as tworkload
from spacemesh_tpu_torch.verify.farm import (
    Lane, PowRequest, SigRequest, VerificationFarm)
from spacemesh_tpu_torch.verifyd import (
    Shed,
    VerifydClient,
    VerifydServer,
    VerifydService,
    batchtune,
    protocol,
)

REPO = Path(__file__).resolve().parent.parent
WL_ARGS = dict(sigs=16, vrfs=4, posts=6, memberships=4, pows=8,
               post_challenges=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in
    parallel workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jwl(tmp_path_factory):
    """The JAX package's workload: the reference."""
    return jworkload.build(str(tmp_path_factory.mktemp("jax-wl")),
                           **WL_ARGS)


@pytest.fixture(scope="module")
def wl(tmp_path_factory, one_torch_thread):
    """The port's workload, same seeds (its own init and prover)."""
    return tworkload.build(str(tmp_path_factory.mktemp("torch-wl")),
                           device="cpu", **WL_ARGS)


@pytest.fixture(scope="module")
def expected(jwl):
    return jwl.inline_all()


def _service(wl, **kw):
    kw.setdefault("workers", 3)
    kw.setdefault("device", "cpu")
    svc = VerifydService(post_params=wl.post_params,
                         post_seed=wl.post_seed, **kw)
    svc.farm.ed_verifier = wl.ed
    svc.farm.vrf_verifier = wl.vrf
    return svc


class _Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _run(coro):
    return asyncio.run(coro)


# --- parity across the packages -------------------------------------------


def test_workload_docs_equal_the_jax_package(jwl, wl):
    """Same seeds, same requests: the port's init, prover and signers
    give byte-identical docs, in the same shuffled order."""
    jdocs = [jprotocol.request_to_doc(r) for r in jwl.requests]
    assert [protocol.request_to_doc(r) for r in wl.requests] == jdocs
    assert {d["kind"] for d in jdocs} == {"sig", "vrf", "post",
                                          "membership", "pow"}


def test_docs_cross_both_ways_with_equal_keys(jwl, wl):
    for jr, tr in zip(jwl.requests, wl.requests):
        doc = json.loads(json.dumps(jprotocol.request_to_doc(jr)))
        into_port = protocol.request_from_doc(doc)
        assert into_port.key() == jr.key() == tr.key()
        back = jprotocol.request_from_doc(json.loads(json.dumps(
            protocol.request_to_doc(tr))))
        assert back.key() == tr.key()
        assert type(back).__name__ == type(tr).__name__


def test_farms_and_services_of_both_packages_agree(jwl, expected):
    """The JAX workload through the docs into the port's farm and
    service, and the JAX farm and service on the originals: equal
    verdicts, equal to both packages' inline verification."""
    docs = [jprotocol.request_to_doc(r) for r in jwl.requests]
    treqs = [protocol.request_from_doc(d) for d in docs]
    ported = tworkload.Workload(
        requests=treqs, ed=EdVerifier(), vrf=VrfVerifier(),
        post_params=jwl.post_params, post_seed=jwl.post_seed, device="cpu")
    assert 0 < sum(expected) < len(expected)
    assert ported.inline_all() == expected

    async def go():
        out = {}
        tf = VerificationFarm(post_params=jwl.post_params,
                              post_seed=jwl.post_seed, device="cpu")
        jf = jfarm.VerificationFarm(post_params=jwl.post_params,
                                    post_seed=jwl.post_seed)
        try:
            out["torch farm"] = list(await asyncio.gather(
                *(tf.submit(r) for r in treqs)))
            out["jax farm"] = list(await asyncio.gather(
                *(jf.submit(r) for r in jwl.requests)))
        finally:
            await tf.aclose()
            await jf.aclose()
        for name, svc, reqs in (
                ("torch service", VerifydService(
                    post_params=jwl.post_params, post_seed=jwl.post_seed,
                    workers=3, device="cpu"), treqs),
                ("jax service", JService(
                    post_params=jwl.post_params, post_seed=jwl.post_seed,
                    workers=3), jwl.requests)):
            try:
                await svc.start()
                svc.register_client("parity")
                out[name] = list(await svc.verify("parity", reqs))
            finally:
                await svc.aclose()
        return out

    out = _run(go())
    for name, got in out.items():
        assert got == expected, name


def test_service_parity_with_inline(wl, expected):
    async def go():
        svc = _service(wl)
        try:
            await svc.start()
            svc.register_client("alice")
            got = await svc.verify("alice", wl.requests)
            stats = svc.stats_doc()
        finally:
            await svc.aclose()
        return got, stats

    got, stats = _run(go())
    assert got == expected == wl.inline_all()
    assert stats["resolved_items"] == len(wl.requests)
    assert stats["farm"]["items"] > 0 and stats["pending_items"] == 0


def test_entry_points_default_to_the_card(monkeypatch, capsys):
    from spacemesh_tpu_torch.verifyd import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (VerifydService, VerifydServer, VerificationFarm):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    capsys.readouterr()
    assert cli.main(["--listen", "127.0.0.1:0"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "cuda" in out.err


# --- typed admission -------------------------------------------------------


def test_empty_and_unregistered(wl):
    async def go():
        svc = _service(wl)
        try:
            await svc.start()
            svc.register_client("a")
            assert await svc.verify("a", []) == []
            with pytest.raises(Shed) as ei:
                await svc.verify("ghost", wl.requests[:1])
            assert ei.value.reason == protocol.SHED_UNREGISTERED
        finally:
            await svc.aclose()

    _run(go())


def test_genesis_id_prefixes_the_service_verifier():
    from spacemesh_tpu_torch.core.signing import Domain, EdSigner

    gid = b"e2e-genesis-id"
    signer = EdSigner(seed=b"\x07" * 32, prefix=gid)
    msg = b"prefixed"
    req = SigRequest(int(Domain.HARE), signer.public_key, msg,
                     signer.sign(Domain.HARE, msg))

    async def go(svc):
        try:
            await svc.start()
            svc.register_client("a")
            return (await svc.verify("a", [req]))[0]
        finally:
            await svc.aclose()

    assert _run(go(VerifydService(workers=1, genesis_id=gid,
                                  device="cpu"))) is True
    assert _run(go(VerifydService(workers=1, device="cpu"))) is False
    with pytest.raises(ValueError):
        VerifydService(farm=VerificationFarm(device="cpu"),
                       genesis_id=gid, device="cpu")


def test_registry_full_typed_and_bounded(wl):
    async def go():
        svc = _service(wl, max_clients=2)
        try:
            await svc.start()
            svc.register_client("a")
            svc.register_client("b")
            with pytest.raises(Shed) as ei:
                svc.register_client("c")
            assert ei.value.reason == protocol.SHED_REGISTRY_FULL
            svc.register_client("a", weight=2.0)
            assert len(svc.clients) == 2
            svc.register_client("a", rate=9000.0)
            assert svc.clients["a"].weight == 2.0
            assert svc.clients["a"].bucket.rate == 9000.0
            assert svc.scheduler._tenants["a"].weight == 2.0
        finally:
            await svc.aclose()

    _run(go())


def test_rate_shed_typed_with_injected_refill(wl):
    clock = _Clock()

    async def go():
        svc = _service(wl, time_source=clock.now)
        try:
            await svc.start()
            svc.register_client("a", rate=0.5, burst=2.0)
            reqs = [r for r in wl.requests
                    if isinstance(r, SigRequest)][:2]
            want = [wl.inline_verify(r) for r in reqs]
            assert await svc.verify("a", reqs) == want
            with pytest.raises(Shed) as ei:
                await svc.verify("a", reqs)
            assert ei.value.reason == protocol.SHED_RATE
            assert ei.value.retry_after_s > 0
            assert ei.value.to_doc()["status"] == "SHED"
            clock.advance(ei.value.retry_after_s + 0.1)
            assert await svc.verify("a", reqs) == want
        finally:
            await svc.aclose()

    _run(go())


def test_deadline_shed_predicts_miss(wl):
    clock = _Clock()

    async def go():
        svc = _service(wl, time_source=clock.now)
        try:
            await svc.start()
            svc.register_client("a")
            svc._pending_items, svc._rate_ewma = 1000, 10.0
            try:
                with pytest.raises(Shed) as ei:
                    await svc.verify("a", wl.requests[:1],
                                     deadline_s=1.0)
            finally:
                svc._pending_items, svc._rate_ewma = 0, 0.0
            assert ei.value.reason == protocol.SHED_DEADLINE
            assert ei.value.retry_after_s == pytest.approx(100.0)
        finally:
            await svc.aclose()

    _run(go())


def _gate_farm(svc):
    """Hold every farm backend dispatch behind a threading.Event so
    pending work accumulates deterministically."""
    gate = threading.Event()
    orig = svc.farm._run_backend

    def gated(kind, reqs):
        gate.wait(timeout=60)
        return orig(kind, reqs)

    svc.farm._run_backend = gated
    return gate


def _block_latency():
    """(count, count at or under the 0.5 s bucket) of the BLOCK lane's
    ``verifyd_request_seconds`` series."""
    hist = metrics.verifyd_request_seconds
    counts, _sum, n = hist.sample().get((("lane", "block"),),
                                        ([0] * len(hist.buckets), 0.0, 0))
    return n, counts[hist.buckets.index(0.5)]


def test_overload_heavy_shed_first_bounded(wl):
    """Offered load far above capacity: the heavy client sheds with typed
    overload/queue_full reasons, the light client's BLOCK-lane work is
    admitted, every admitted verdict is correct, the queue stays bounded,
    and every admitted BLOCK request resolved within the JAX package's
    0.5 s BLOCK-lane latency objective (injected clock, no sleeps)."""
    clock = _Clock()
    sig_pool = [r for r in wl.requests if isinstance(r, SigRequest)]
    before = _block_latency()

    async def go():
        svc = _service(wl, time_source=clock.now, max_pending_items=40,
                       workers=2, default_rate=1e9, default_burst=1e9)
        gate = _gate_farm(svc)
        try:
            await svc.start()
            svc.register_client("heavy")
            svc.register_client("light")

            def req(n):
                return [sig_pool[i % len(sig_pool)] for i in range(n)]

            async def submit(cid, n, lane):
                try:
                    got = await svc.verify(cid, req(n), lane=lane)
                    return ("ok", got, [wl.inline_verify(r)
                                        for r in req(n)])
                except Shed as e:
                    return (e.reason, None, None)

            tasks = []
            for _ in range(8):
                tasks.append(asyncio.ensure_future(
                    submit("heavy", 10, Lane.SYNC)))
                await asyncio.sleep(0)
            light_tasks = []
            for _ in range(3):
                light_tasks.append(asyncio.ensure_future(
                    submit("light", 4, Lane.BLOCK)))
                await asyncio.sleep(0)
            clock.advance(0.01)
            gate.set()
            heavy_out = await asyncio.gather(*tasks)
            light_out = await asyncio.gather(*light_tasks)
            return heavy_out, light_out, dict(svc.stats)
        finally:
            gate.set()
            await svc.aclose()

    heavy_out, light_out, stats = _run(go())
    heavy_shed = [o for o in heavy_out if o[0] != "ok"]
    assert heavy_shed, "heavy client must shed"
    assert all(o[0] in (protocol.SHED_OVERLOAD, protocol.SHED_QUEUE_FULL)
               for o in heavy_shed), heavy_shed
    assert all(o[0] == "ok" for o in light_out)
    for outcome, got, exp in heavy_out + light_out:
        if outcome == "ok":
            assert got == exp, "zero wrong verdicts"
    assert stats["pending_peak"] <= 40, "bounded queue"
    assert stats["shed"].get(protocol.SHED_OVERLOAD, 0) >= 1
    n, fast = _block_latency()
    assert n - before[0] == 3 and fast - before[1] == 3


def test_quota_shed_typed(wl):
    async def go():
        svc = _service(wl, workers=2)
        gate = _gate_farm(svc)
        try:
            await svc.start()
            svc.register_client("a", max_queued=1)
            t = asyncio.ensure_future(svc.verify("a", wl.requests[:2]))
            await asyncio.sleep(0)
            with pytest.raises(Shed) as ei:
                await svc.verify("a", wl.requests[:2])
            assert ei.value.reason == protocol.SHED_QUOTA
            gate.set()
            await t
        finally:
            gate.set()
            await svc.aclose()

    _run(go())


def test_graceful_drain_zero_stranded_futures(wl, expected):
    async def go():
        svc = _service(wl, workers=2)
        gate = _gate_farm(svc)
        try:
            await svc.start()
            svc.register_client("a")
            pending = [asyncio.ensure_future(
                svc.verify("a", wl.requests[i:i + 4]))
                for i in range(0, 12, 4)]
            await asyncio.sleep(0)
            closer = asyncio.ensure_future(svc.aclose())
            await asyncio.sleep(0)
            gate.set()
            results = await asyncio.gather(*pending,
                                           return_exceptions=True)
            await closer
            for i, r in enumerate(results):
                assert not isinstance(r, BaseException), r
                assert r == expected[4 * i:4 * i + 4]
            with pytest.raises(Shed) as ei:
                await svc.verify("a", wl.requests[:1])
            assert ei.value.reason == protocol.SHED_SHUTTING_DOWN
        finally:
            gate.set()
            await svc.aclose()

    _run(go())


def test_client_churn_bounds_metric_cardinality(wl):
    poisoned = [f'churn-{i}-"quote"\\back\nline' for i in range(24)]

    async def go():
        svc = _service(wl, max_clients=8)
        try:
            await svc.start()
            req = [r for r in wl.requests if isinstance(r, SigRequest)][:2]
            for cid in poisoned:
                svc.register_client(cid)
                await svc.verify(cid, req)
                with pytest.raises(Shed):
                    await svc.verify("nobody", req)
                svc.unregister_client(cid)
            assert len(svc.clients) == 0
        finally:
            await svc.aclose()

    _run(go())
    churned = set(poisoned)
    for inst in (metrics.verifyd_client_pending, metrics.verifyd_items,
                 metrics.verifyd_requests, metrics.verifyd_shed,
                 metrics.runtime_tenant_queued,
                 metrics.runtime_tenant_jobs,
                 metrics.runtime_quantum_seconds):
        leaked = [k for k in inst.sample()
                  if dict(k).get("client", dict(k).get("tenant"))
                  in churned]
        assert not leaked, (inst.name, leaked)
    assert "verifyd_clients" in metrics.REGISTRY.expose()


def test_farm_pow_kind_parity(wl, expected):
    pow_reqs = [(i, r) for i, r in enumerate(wl.requests)
                if isinstance(r, PowRequest)]
    assert pow_reqs

    async def go():
        svc = _service(wl)
        try:
            await svc.start()
            svc.register_client("a")
            return await svc.verify("a", [r for _i, r in pow_reqs])
        finally:
            await svc.aclose()

    assert _run(go()) == [expected[i] for i, _r in pow_reqs]


# --- batchtune -------------------------------------------------------------


def test_batchtune_race_persists_and_reloads(tmp_path, monkeypatch):
    monkeypatch.setenv(batchtune.ENV_CACHE, str(tmp_path / "tune.json"))
    monkeypatch.delenv(batchtune.ENV_TUNE, raising=False)
    calls = []

    def backend(kind, reqs):
        calls.append((kind, len(reqs)))
        return [True] * len(reqs)

    t1 = batchtune.BatchTuner(backend=backend, platform="cpu")
    raced = t1.ensure_raced(kinds=["membership"])
    assert "membership" in raced and calls
    doc = json.loads((tmp_path / "tune.json").read_text())
    assert list(doc) == ["torch-v1:cpu:membership"]
    calls.clear()
    t2 = batchtune.BatchTuner(backend=backend, platform="cpu")
    assert t2.ensure_raced(kinds=["membership"]) == {}
    assert not calls
    assert t2.rates("membership")
    (tmp_path / "tune.json").write_text("{broken")
    t3 = batchtune.BatchTuner(backend=backend, platform="cpu")
    assert "membership" in t3.ensure_raced(kinds=["membership"])
    assert calls


def test_batchtune_never_reads_rows_measured_for_the_jax_package(
        tmp_path, monkeypatch):
    """Rows the JAX package persisted (its ``v1:<backend>:<kind>`` keys,
    a TPU's included) are invisible to the port even in the same file,
    and the port's default file is its own, inside the checkout."""
    path = tmp_path / "shared.json"
    path.write_text(json.dumps({
        f"v1:{p}:{k}": {"raced": {"8": 123.0}}
        for p in ("cpu", "tpu") for k in batchtune.CANDIDATES}))
    monkeypatch.setenv(batchtune.ENV_CACHE, str(path))
    monkeypatch.setenv(batchtune.ENV_TUNE, "off")
    for platform in ("cpu", "tpu"):
        t = batchtune.BatchTuner(platform=platform)
        for kind in batchtune.CANDIDATES:
            assert t.rates(kind) == {}
            assert t.target_batch(kind) == min(
                batchtune.STATIC_TARGETS[kind], t.max_batch)
    monkeypatch.delenv(batchtune.ENV_CACHE)
    assert Path(batchtune.cache_path()) == (
        REPO / "spacemesh_tpu_torch" / "build" / "verifyd_batchtune.json")
    assert batchtune.device_platform("cpu") == "cpu"
    svc = VerifydService(workers=1, device="cpu")
    try:
        assert svc.tuner.platform() == "cpu"
    finally:
        svc.scheduler.close()
        svc.farm.shutdown()


def test_batchtune_race_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv(batchtune.ENV_CACHE, str(tmp_path / "t.json"))
    monkeypatch.setenv(batchtune.ENV_TUNE, "off")
    calls = []
    t = batchtune.BatchTuner(
        backend=lambda k, r: calls.append(k), platform="cpu")
    assert t.ensure_raced() == {}
    assert not calls
    assert t.target_batch("sig") == batchtune.STATIC_TARGETS["sig"]


def test_batchtune_model_and_policy(tmp_path, monkeypatch):
    monkeypatch.setenv(batchtune.ENV_CACHE, str(tmp_path / "t.json"))
    monkeypatch.setenv(batchtune.ENV_TUNE, "off")
    clock = _Clock()
    t = batchtune.BatchTuner(platform="cpu", max_batch=256,
                             time_source=clock.now)
    t.observe("sig", 32, 10.0)
    assert not t.rates("sig")
    t.observe("sig", 32, 0.001)
    t.observe("sig", 1, 1.0)
    t.observe("sig", 1, 0.01)
    rows = t.rates("sig")
    assert rows[32] == pytest.approx(32000.0)
    assert rows[1] == pytest.approx(100.0)
    assert t.target_batch("sig") == 32
    assert t.service_s("sig", 32) == pytest.approx(0.001)
    assert t.service_s("sig", 64) == pytest.approx(0.002)
    assert t.dispatch_now("sig", 4, 0.0)
    for i in range(6):
        t.note_arrival("sig", 1000.0 + i * 0.0001)
    assert t.arrival_rate("sig") > 1000
    assert not t.dispatch_now("sig", 4, 0.0)
    assert t.dispatch_now("sig", 32, 0.0)
    t2 = batchtune.BatchTuner(platform="cpu", max_batch=256)
    t2.observe("sig", 32, 10.0)
    t2.observe("sig", 32, 0.001)
    t2.observe("sig", 1, 1.0)
    t2.observe("sig", 1, 0.01)
    t2.note_arrival("sig", 0.0)
    t2.note_arrival("sig", 100.0)
    assert t2.dispatch_now("sig", 4, 0.0)


def test_farm_consumes_tuner_targets(wl, expected, tmp_path, monkeypatch):
    monkeypatch.setenv(batchtune.ENV_CACHE, str(tmp_path / "t.json"))
    t = batchtune.BatchTuner(platform="cpu", max_batch=64)

    async def go():
        svc = _service(wl, tuner=t, max_batch=64)
        try:
            await svc.start()
            svc.register_client("a")
            return await svc.verify("a", wl.requests)
        finally:
            await svc.aclose()

    assert _run(go()) == expected
    assert t.stats["observations"] + t.stats["discarded_cold"] > 0


# --- protocol ---------------------------------------------------------------


def test_protocol_roundtrip_every_kind(wl):
    for req in wl.requests:
        doc = protocol.request_to_doc(req)
        back = protocol.request_from_doc(json.loads(json.dumps(doc)))
        assert protocol.request_to_doc(back) == doc
        assert back.kind == req.kind and back.key() == req.key()


def test_protocol_malformed_docs():
    with pytest.raises(protocol.ProtocolError, match="kind"):
        protocol.request_from_doc({"kind": "nope"})
    with pytest.raises(protocol.ProtocolError, match="public_key"):
        protocol.request_from_doc({"kind": "sig", "domain": 1,
                                   "public_key": "zz", "msg": "",
                                   "signature": ""})
    with pytest.raises(protocol.ProtocolError, match="challenge"):
        protocol.request_from_doc({"kind": "pow", "challenge": "ab",
                                   "node_id": "00" * 32,
                                   "difficulty": "00" * 32, "nonce": 1})
    with pytest.raises(protocol.ProtocolError, match="nonce"):
        protocol.request_from_doc({"kind": "pow",
                                   "challenge": "00" * 32,
                                   "node_id": "00" * 32,
                                   "difficulty": "00" * 32,
                                   "nonce": "7"})
    for bad in (1 << 64, -1):
        with pytest.raises(protocol.ProtocolError, match="64-bit"):
            protocol.request_from_doc({"kind": "pow",
                                       "challenge": "00" * 32,
                                       "node_id": "00" * 32,
                                       "difficulty": "00" * 32,
                                       "nonce": bad})
        with pytest.raises(protocol.ProtocolError, match="64-bit"):
            protocol.request_from_doc({
                "kind": "post", "challenge": "00" * 32,
                "node_id": "00" * 32, "commitment": "00" * 32,
                "scrypt_n": 2, "total_labels": 64,
                "proof": {"nonce": 0, "indices": [1, 2],
                          "pow_nonce": bad, "k2": 2}})
    with pytest.raises(protocol.ProtocolError, match="lane"):
        protocol.parse_lane("express")
    assert protocol.SHED_REASONS == jprotocol.SHED_REASONS
    assert {k: int(v) for k, v in protocol.LANES.items()} == {
        k: int(v) for k, v in jprotocol.LANES.items()}


# --- the network surface (real sockets) ------------------------------------


def _server(wl, **kw):
    kw.setdefault("workers", 3)
    server = VerifydServer(listen="127.0.0.1:0", post_params=wl.post_params,
                           post_seed=wl.post_seed, device="cpu", **kw)
    server.service.farm.ed_verifier = wl.ed
    server.service.farm.vrf_verifier = wl.vrf
    return server


def test_server_http_e2e(wl, expected):
    async def go():
        server = _server(wl)
        try:
            port = await server.start()
            base = f"http://127.0.0.1:{port}"
            c = VerifydClient(base, "alice")
            await c.register()
            assert await c.verify(wl.requests) == expected
            sess = await c._sess()
            tiny = VerifydClient(base, "tiny", session=sess,
                                 unregister_on_close=False)
            await tiny.register(rate=0.001, burst=1)
            with pytest.raises(Shed) as ei:
                await tiny.verify(wl.requests)
            assert ei.value.reason == protocol.SHED_RATE
            async with sess.post(base + "/v1/verify", json={
                    "client": "tiny",
                    "items": [protocol.request_to_doc(r)
                              for r in wl.requests]}) as resp:
                assert resp.status == 429
                doc = await resp.json()
                assert doc["status"] == "SHED"
                assert doc["reason"] == protocol.SHED_RATE
                assert doc["retry_after_s"] > 0
            async with sess.post(base + "/v1/verify", json={
                    "client": "alice",
                    "items": [{"kind": "martian"}]}) as resp:
                assert resp.status == 400
                assert "kind" in await resp.text()
            async with sess.post(base + "/v1/verify", json={
                    "client": "ghost", "items": []}) as resp:
                assert resp.status == 403
                assert (await resp.json())["reason"] == \
                    protocol.SHED_UNREGISTERED
            async with sess.get(base + "/readyz") as resp:
                assert resp.status == 200
                rep = await resp.json()
                assert rep["ready"] and "verify.farm" in rep["components"]
            async with sess.get(base + "/healthz") as resp:
                assert (await resp.json())["status"] == "ok"
            async with sess.get(base + "/metrics") as resp:
                assert "verifyd_items_total" in await resp.text()
            async with sess.get(base + "/v1/stats") as resp:
                assert (await resp.json())["clients"] == 2
            async with sess.get(base + "/v1/tune") as resp:
                assert "targets" in await resp.json()
            async with sess.post(base + "/v1/client/unregister",
                                 json={"client": "tiny"}) as resp:
                assert (await resp.json())["unregistered"] is True
            await c.aclose()
        finally:
            await server.close()

    _run(go())


def test_jax_client_against_the_port_server(wl, expected):
    async def go():
        server = _server(wl)
        try:
            port = await server.start()
            c = JClient(f"http://127.0.0.1:{port}", "jax-node")
            try:
                await c.register(weight=2.0)
                jreqs = [jprotocol.request_from_doc(
                    protocol.request_to_doc(r)) for r in wl.requests]
                got = await c.verify(jreqs, lane="block")
                assert server.service.clients["jax-node"].weight == 2.0
                return got, await c.stats()
            finally:
                await c.aclose()
        finally:
            await server.close()

    got, stats = _run(go())
    assert got == expected
    assert stats["admitted_items"] == len(expected)


def test_port_client_against_the_jax_server(jwl, expected):
    async def go():
        server = JServer(listen="127.0.0.1:0",
                         post_params=jwl.post_params,
                         post_seed=jwl.post_seed, workers=3)
        try:
            port = await server.start()
            c = VerifydClient(f"http://127.0.0.1:{port}", "torch-node")
            try:
                await c.register()
                treqs = [protocol.request_from_doc(
                    jprotocol.request_to_doc(r)) for r in jwl.requests]
                got = await c.verify(treqs)
                server.service.clients["torch-node"].bucket.rate = 1e-3
                server.service.clients["torch-node"].bucket.tokens = 0.0
                with pytest.raises(Shed) as ei:
                    await VerifydClient(
                        f"http://127.0.0.1:{port}", "torch-node",
                        session=await c._sess(), retry=None).verify(treqs)
                return got, ei.value.reason
            finally:
                await c.aclose()
        finally:
            await server.close()

    got, reason = _run(go())
    assert got == expected and reason == protocol.SHED_RATE


def test_grpc_same_docs_both_ways(wl, jwl, expected):
    pytest.importorskip("grpc")
    from spacemesh_tpu.verifyd.client import grpc_verify as jgrpc_verify
    from spacemesh_tpu_torch.verifyd.client import grpc_verify

    async def go():
        out = {}
        tserver = _server(wl, grpc_listen="127.0.0.1:0")
        jserver = JServer(listen="127.0.0.1:0", grpc_listen="127.0.0.1:0",
                          post_params=jwl.post_params,
                          post_seed=jwl.post_seed, workers=3)
        try:
            await tserver.start()
            await jserver.start()
            assert tserver.grpc_port and jserver.grpc_port
            tserver.service.register_client("g")
            jserver.service.register_client("g")
            out["jax client, port server"] = await jgrpc_verify(
                f"127.0.0.1:{tserver.grpc_port}", "g", jwl.requests[:8])
            out["port client, jax server"] = await grpc_verify(
                f"127.0.0.1:{jserver.grpc_port}", "g", wl.requests[:8])
            out["port client, port server"] = await grpc_verify(
                f"127.0.0.1:{tserver.grpc_port}", "g", wl.requests[:8])
            with pytest.raises(Shed) as ei:
                await grpc_verify(f"127.0.0.1:{tserver.grpc_port}",
                                  "ghost", wl.requests[:1])
            assert ei.value.reason == protocol.SHED_UNREGISTERED
            tserver.service.unregister_client("g")
            jserver.service.unregister_client("g")
        finally:
            await tserver.close()
            await jserver.close()
        return out

    for name, got in _run(go()).items():
        assert got == expected[:8], name


def test_server_sheds_during_shutdown(wl):
    async def go():
        server = _server(wl, workers=2)
        port = await server.start()
        base = f"http://127.0.0.1:{port}"
        c = VerifydClient(base, "a", unregister_on_close=False)
        await c.register()
        await server.service.aclose()
        with pytest.raises(Shed) as ei:
            await c.verify(wl.requests[:1])
        assert ei.value.reason == protocol.SHED_SHUTTING_DOWN
        await c.aclose()
        await server.close()
        await server.close()  # idempotent

    _run(go())


def test_cli_serves_on_cpu_and_drains_on_sigterm(wl, expected):
    """``python -m spacemesh_tpu_torch.verifyd --device cpu`` in a
    subprocess: it prints its ports, the JAX client verifies a
    signature batch through it, and SIGTERM exits 0."""
    import signal

    sigs = [(i, r) for i, r in enumerate(wl.requests)
            if isinstance(r, SigRequest)]
    env = dict(os.environ, SPACEMESH_VERIFYD_TUNE="off")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacemesh_tpu_torch.verifyd",
         "--device", "cpu", "--listen", "127.0.0.1:0", "--workers", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = json.loads(proc.stdout.readline())
        host_port = line["listening"]
        assert line["grpc"] is None

        async def go():
            c = JClient(f"http://{host_port}", "cli")
            try:
                await c.register()
                return await c.verify([jprotocol.request_from_doc(
                    protocol.request_to_doc(r)) for _i, r in sigs])
            finally:
                await c.aclose()

        assert _run(go()) == [expected[i] for i, _r in sigs]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
