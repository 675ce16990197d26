"""The port's federation plane (``spacemesh_tpu_torch/obs/federate.py``,
``utils/tracing.py:merge_captures``), held to the JAX package's.

Twins of ``tests/test_federate.py``: the strict escape-aware parser,
sample/exposition agreement, the proc lifecycle and its gauge, then the
capture half (``merge_captures`` resolving link tokens with per-process
provenance, the span-multiset digest, ``Federation.merged_capture``,
flight bundles' ``procs/``) and the end-to-end fleet trace plane: verifyd
replicas in their own processes, captures started and pulled over
``/debug/trace``, one merged timeline. Plus parity: the same exposition
text and the same samples federate to equal exposition in both packages,
either package's parser reads the other's ``/metrics`` text alike, and
the same captures merge to the same document in both.
"""

import asyncio
import json
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from spacemesh_tpu.obs import federate as jfederate
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.obs.federate import (FEDERATION, Federation,
                                              flatten_samples,
                                              parse_exposition)
from spacemesh_tpu_torch.utils import metrics, tracing

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_slate():
    """Every test starts with no federated procs, no live capture and the
    default process identity."""
    FEDERATION.clear()
    tracing.stop()
    yield
    FEDERATION.clear()
    tracing.stop()
    tracing.set_process_identity(f"pid-{os.getpid()}")


# --- the strict exposition parser --------------------------------------


def test_parser_roundtrips_escaped_label_values():
    reg = metrics.Registry()
    g = reg.gauge("nasty_gauge", "hostile label values")
    hostile = 'quote " backslash \\ newline \n done'
    g.set(2.5, peer=hostile, plain="ok")
    series = parse_exposition(reg.expose())
    match = [(lb, v) for name, lb, v in series if name == "nasty_gauge"]
    assert match == [({"peer": hostile, "plain": "ok"}, 2.5)]


def test_parser_rejects_garbage_lines():
    for bad in ("not a metric", 'x{a="1} 2', 'x{a="1"} ',
                'x{=""} 1', "x 1 2 3"):
        with pytest.raises(ValueError):
            parse_exposition(bad)
    # comments and blanks are fine
    assert parse_exposition("# HELP x y\n\n") == []


def test_flatten_samples_matches_expose_histograms_included():
    """Pipe-shipped (sample) and HTTP-shipped (exposition) snapshots of
    the same registry must federate to the SAME triples — or a shard
    worker and a verifyd replica would disagree about one metric."""
    reg = metrics.Registry()
    reg.counter("c_total", "c").inc(3, kind="a")
    reg.gauge("g", "g").set(1.5)
    h = reg.histogram("h_seconds", "h", buckets=(0.1, 1.0))
    h.observe(0.05, lane="x")
    h.observe(5.0, lane="x")

    def key(triples):
        return sorted((n, tuple(sorted(lb.items())), v)
                      for n, lb, v in triples)

    assert key(flatten_samples(reg.sample())) == \
        key(parse_exposition(reg.expose()))


# --- the Federation container ------------------------------------------


def test_federation_proc_lifecycle_and_cardinality_hygiene():
    fed = Federation()
    fed.update("w1", [("up", {"x": "1"}, 1.0)], trace={"traceEvents": []})
    fed.update("w2", [("up", {}, 1.0)])
    text = fed.expose()
    series = parse_exposition(text)
    assert {lb.get("proc") for _, lb, _ in series} == {"w1", "w2"}
    # clean exit: drop removes EVERY series for that proc
    assert fed.drop("w1") is True
    assert all(lb.get("proc") != "w1"
               for _, lb, _ in parse_exposition(fed.expose()))
    assert fed.trace("w1") is None
    # crash: snapshot retained AND flagged for forensics
    fed.mark_crashed("w2")
    series = parse_exposition(fed.expose())
    assert ("federated_proc_crashed", {"proc": "w2"}, 1.0) in series
    assert any(n == "up" and lb.get("proc") == "w2"
               for n, lb, _ in series)
    # a re-update means the process is evidently alive again
    fed.update("w2", [("up", {}, 2.0)])
    assert not fed.procs()["w2"]["crashed"]
    fed.clear()
    assert fed.expose() == "" and fed.procs() == {}


def test_federation_gauges_track_live_and_crashed():
    fed = Federation()  # private instance still drives the global gauge
    fed.update("a", [])
    fed.update("b", [])
    fed.mark_crashed("b")
    sample = metrics.REGISTRY.sample()["federated_procs"][1]
    assert sample[(("state", "live"),)] == 1.0
    assert sample[(("state", "crashed"),)] == 1.0
    fed.clear()


# --- parity with the JAX package ------------------------------------------


def _fill(mod, seed: int):
    rng = random.Random(seed)
    reg = mod.Registry()
    c = reg.counter("c_total", "c")
    g = reg.gauge("g", "g")
    h = reg.histogram("h_seconds", "h", buckets=(0.01, 0.1, 1.0,
                                                 float("inf")))
    for _ in range(60):
        label = rng.choice(['plain', 'q"uote', 'back\\slash', 'new\nline'])
        c.inc(rng.randint(1, 5), peer=label, kind=rng.choice("ab"))
        g.set(rng.random(), peer=label)
        h.observe(rng.expovariate(5.0), lane=rng.choice(["x", "y"]))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_federated_exposition_equals_the_jax_package(seed):
    reg, jreg = _fill(metrics, seed), _fill(jmetrics, seed)
    assert parse_exposition(reg.expose()) == \
        jfederate.parse_exposition(jreg.expose())
    assert parse_exposition(jreg.expose()) == \
        jfederate.parse_exposition(reg.expose())
    assert flatten_samples(reg.sample()) == \
        jfederate.flatten_samples(jreg.sample())
    fed, jfed = Federation(), jfederate.Federation()
    for f, r, mod in ((fed, reg, None), (jfed, jreg, None)):
        f.parse_and_update("replica-r0", r.expose())
        f.update_from_samples("replica-r1", r.sample())
        f.update("w", [("up", {"x": "1"}, 1.0)])
        f.mark_crashed("w")
    assert fed.expose() == jfed.expose()
    assert fed.procs() == jfed.procs()
    assert fed.series("replica-r1") == jfed.series("replica-r1")
    fed.drop("replica-r0")
    jfed.drop("replica-r0")
    assert fed.expose() == jfed.expose()


# --- the capture half ---------------------------------------------------


def _two_process_captures():
    """Two real captures taken one after the other from the in-process
    tracer under different process identities: the child's span links to
    the parent's through the parent's link token."""
    tracing.set_process_identity("parent")
    tracing.start(capacity=256, torch_bridge=False)
    with tracing.span("request", {"n": 1}, cat="test"):
        token = tracing.link_token()
    parent_doc = tracing.export()
    tracing.stop()
    tracing.set_process_identity("child", clock_domain="wall")
    tracing.start(capacity=256, torch_bridge=False)
    with tracing.span("handle", {"link": token}, cat="test"):
        pass
    with tracing.span("orphan", {"link": "ghost/12345"}, cat="test"):
        pass
    child_doc = tracing.export()
    tracing.stop()
    return parent_doc, child_doc


def test_merge_captures_resolves_links_and_stamps_provenance():
    parent_doc, child_doc = _two_process_captures()
    merged = tracing.merge_captures([parent_doc, child_doc])
    assert tracing.validate(merged) == []
    od = merged["otherData"]
    assert [p["role"] for p in od["procs"]] == ["parent", "child"]
    assert od["links"] == {"resolved": 1, "unresolved": 1}
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    handle = next(e for e in spans if e["name"] == "handle")
    request = next(e for e in spans if e["name"] == "request")
    assert handle["args"]["parent"] == request["args"]["id"]
    assert handle["pid"] != request["pid"]
    summary = tracing.summarize(merged)
    assert summary["cross_proc_links"]["pairs"] == {"request->handle": 1}
    assert "cross-process parent links: 1" in tracing.render_summary(
        summary)


def test_merged_documents_equal_the_jax_merge():
    from spacemesh_tpu.utils import tracing as jtracing

    parent_doc, child_doc = _two_process_captures()
    docs = [parent_doc, child_doc]
    ours = tracing.merge_captures(json.loads(json.dumps(docs)))
    theirs = jtracing.merge_captures(json.loads(json.dumps(docs)))
    ours["otherData"].pop("tool")
    theirs["otherData"].pop("tool")
    assert ours == theirs
    assert tracing.span_multiset_digest(ours) == \
        jtracing.span_multiset_digest(theirs)


def test_merged_digest_is_a_span_multiset_not_a_timestamp_hash():
    parent_doc, child_doc = _two_process_captures()
    d1 = tracing.span_multiset_digest(
        tracing.merge_captures([parent_doc, child_doc]))
    d2 = tracing.span_multiset_digest(
        tracing.merge_captures([parent_doc, child_doc]))
    assert d1 == d2
    assert d1 != tracing.span_multiset_digest(
        tracing.merge_captures([parent_doc]))


def test_federation_merged_capture_orders_procs_deterministically():
    parent_doc, child_doc = _two_process_captures()
    fed = Federation()
    fed.update("child", [], trace=child_doc)
    merged = fed.merged_capture(parent=parent_doc)
    assert [p["role"] for p in merged["otherData"]["procs"]] == \
        ["parent", "child"]
    assert fed.merged_capture() is not None
    assert Federation().merged_capture() is None
    assert set(fed.captures()) == {"child"}


def test_flight_bundle_federates_procs_and_digests_merged(tmp_path):
    from spacemesh_tpu_torch.obs import flight as flight_mod

    parent_doc, child_doc = _two_process_captures()
    FEDERATION.update("replica-r1", [("up", {}, 1.0)], trace=child_doc)
    FEDERATION.update("replica-r2", [("up", {}, 1.0)])
    FEDERATION.mark_crashed("replica-r2")
    rec = flight_mod.FlightRecorder(tmp_path / "spool", min_interval_s=0)
    path = rec.dump("test:procs", force=True)
    assert path is not None
    bundle = flight_mod.read_bundle(path)
    assert set(bundle["procs"]) == {"replica-r1", "replica-r2"}
    assert bundle["procs"]["replica-r1"]["trace"] is not None
    assert not bundle["procs"]["replica-r1"]["crashed"]
    assert bundle["procs"]["replica-r2"]["crashed"]
    assert 'proc="replica-r1"' in bundle["procs"]["replica-r1"]["metrics"]
    doc = flight_mod.digest(bundle)
    assert doc["procs"]["replica-r2"]["crashed"] is True
    assert "child" in {p["proc"] for p in doc["proc_self_time"]}


def test_span_drops_surface_in_validate_warnings():
    tracing.set_process_identity("droppy")
    tracing.start(capacity=4, torch_bridge=False)
    for i in range(32):
        with tracing.span(f"s{i}", cat="test"):
            pass
    doc = tracing.export()
    tracing.stop()
    assert doc["otherData"]["dropped_spans"] > 0
    warnings = tracing.validate(doc)
    assert warnings and any("dropped" in w for w in warnings)
    assert "SPACEMESH_TRACE" in warnings[0]
    merged = tracing.merge_captures([doc])
    assert tracing.drop_warnings(merged)[0].startswith("proc droppy")


# --- end-to-end: verifyd replicas federate over HTTP --------------------


def _boot_replica():
    p = subprocess.Popen(
        [sys.executable, "-m", "spacemesh_tpu_torch.verifyd",
         "--listen", "127.0.0.1:0", "--workers", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO)
    doc = {}

    def read():
        line = p.stdout.readline()
        if line:
            doc.update(json.loads(line))

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(90)
    if not doc:
        p.kill()
        raise RuntimeError("verifyd replica did not boot in 90s")
    return p, "http://" + doc["listening"]


def test_fleet_router_pulls_and_merges_replica_captures():
    """Two port verifyd replicas in their own processes, captures started
    over /debug/trace, verify traffic carrying trace_parent link tokens
    from the router's fleet.remote spans, the router pulling trace +
    /metrics into the federation, and one validate-clean merged timeline
    with replica provenance and resolved cross-process links.
    Unregistering a replica drops its proc= series."""
    pytest.importorskip("aiohttp")
    from spacemesh_tpu_torch.verify.farm import PowRequest
    from spacemesh_tpu_torch.verifyd.fleet import (FleetRouter,
                                                   HttpReplicaEndpoint)

    replicas = [_boot_replica() for _ in range(2)]

    async def go():
        tracing.set_process_identity("fleet-parent")
        tracing.start(capacity=8192, torch_bridge=False)
        router = FleetRouter()
        endpoints = []
        try:
            for i, (_, url) in enumerate(replicas):
                ep = HttpReplicaEndpoint(url)
                endpoints.append(ep)
                router.register_replica(f"r{i}", ep, own_endpoint=True)
            started = await router.start_captures(capacity=4096)
            assert started == {
                "r0": {"enabled": True, "capacity": 4096,
                       "role": "replica-r0"},
                "r1": {"enabled": True, "capacity": 4096,
                       "role": "replica-r1"}}
            req = PowRequest(challenge=b"\x01" * 32, node_id=b"\x02" * 32,
                             difficulty=b"\xff" * 32, nonce=1)
            for name, rep in sorted(router.replicas.items()):
                await rep.endpoint.register(f"cli-{name}")
                with tracing.span("fleet.remote", {"replica": name}):
                    got = await rep.endpoint.verify([req],
                                                    client=f"cli-{name}")
                assert got == [True]
            pulled = await router.pull_captures()
            assert set(pulled) == {"replica-r0", "replica-r1"}
            for proc, doc in pulled.items():
                assert doc["otherData"]["proc"]["role"] == proc
            merged = router.merged_capture(parent=tracing.export())
            assert tracing.validate(merged) == []
            od = merged["otherData"]
            assert [p["role"] for p in od["procs"]] == \
                ["fleet-parent", "replica-r0", "replica-r1"]
            assert od["links"]["unresolved"] == 0
            assert od["links"]["resolved"] >= 2
            pairs = tracing.summarize(merged)["cross_proc_links"]["pairs"]
            assert pairs.get("fleet.remote->verifyd.request", 0) >= 2
            series = parse_exposition(FEDERATION.expose())
            for proc in ("replica-r0", "replica-r1"):
                assert any(lb.get("proc") == proc for _, lb, _ in series)
            router.unregister_replica("r0")
            assert "replica-r0" not in FEDERATION.procs()
            assert all(lb.get("proc") != "replica-r0" for _, lb, _ in
                       parse_exposition(FEDERATION.expose()))
        finally:
            tracing.stop()
            for ep in endpoints:
                await ep.aclose()
            await router.aclose()

    try:
        asyncio.run(go())
    finally:
        for p, _ in replicas:
            p.terminate()
        for p, _ in replicas:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
