"""The port's health engine, SLOs and flight recorder
(``spacemesh_tpu_torch/obs/{health,flight}.py``), held to the JAX
package's.

Twins of ``tests/test_health_engine.py`` without the event bus (not
ported: ROADMAP [13]): watchdogs, SLO burn accounting and transitions,
the flight recorder's rate limit, prune, corruption checks and failed
dumps, the tick loop's liveness, and the acceptance capture (init +
prove + farm with the engine on, a stalled writer flipping verifyd's
``/readyz`` with its reason, the stall's flight bundle validating). Plus
the SLO engine driven through both packages on the same observations
(equal reports), and a flight bundle from each package with the same
file set and manifest keys.
"""

import asyncio
import json
import threading

import pytest
import torch

from spacemesh_tpu_torch.obs import flight as flight_mod
from spacemesh_tpu_torch.obs import health as health_mod
from spacemesh_tpu_torch.obs import sli as sli_mod
from spacemesh_tpu_torch.utils import metrics as metrics_mod
from spacemesh_tpu_torch.utils import tracing


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- watchdogs ----------------------------------------------------------


def test_watchdog_progress_stall_idle_rebaseline():
    v = {"n": 0, "active": True}
    wd = health_mod.Watchdog("x", progress=lambda: v["n"],
                             deadline_s=5.0, active=lambda: v["active"])
    assert wd.check(0.0)[0]
    assert wd.check(4.0)[0]
    ok, reason = wd.check(6.0)
    assert not ok and "stalled" in reason and "6.0s" in reason
    v["n"] = 1
    assert wd.check(7.0)[0]
    v["active"] = False
    ok, reason = wd.check(100.0)
    assert ok and reason == "idle"
    v["active"] = True
    assert wd.check(200.0)[0]
    assert not wd.check(206.0)[0]


def test_watchdog_raising_probe_is_unhealthy():
    def boom():
        raise RuntimeError("dead counter")

    wd = health_mod.Watchdog("x", progress=boom, deadline_s=1.0)
    ok, reason = wd.check(0.0)
    assert not ok and "probe raised" in reason


def test_registry_register_replace_unregister():
    reg = health_mod.HealthRegistry()
    probe_a = lambda now: (True, "a")  # noqa: E731
    probe_b = lambda now: (False, "b")  # noqa: E731
    reg.register("c", probe_a)
    reg.register("c", probe_b)
    assert reg.report(0.0)["c"] == {"healthy": False, "reason": "b"}
    reg.unregister("c", probe_a)
    assert reg.names() == ["c"]
    reg.unregister("c", probe_b)
    assert reg.names() == []

    def raising(now):
        raise ValueError("probe bug")

    reg.register("r", raising)
    assert not reg.report(0.0)["r"]["healthy"]


# --- SLO burn + engine transitions --------------------------------------


def _engine(tmp_path, fake, budget=0.0, window_s=30.0, mods=None):
    m = mods or (health_mod, sli_mod, metrics_mod)
    hmod, smod, mmod = m
    reg = mmod.Registry()
    lat = reg.histogram("lat", buckets=(0.01, 0.1, 1.0, float("inf")))
    spec = smod.SliSpec("lat_p95", "lat", "quantile", q=0.95)
    slo = hmod.Slo(name="latency", sli="lat_p95", target=0.1,
                   window_s=window_s, budget=budget)
    engine = hmod.HealthEngine(
        registry=reg, health=hmod.HealthRegistry(),
        slis=[spec], slos=[slo], window_s=window_s,
        spool_dir=tmp_path / "flight", time_source=fake)
    return engine, lat


def test_slo_breach_transition_metric_flight(tmp_path):
    fake = FakeClock()
    engine, lat = _engine(tmp_path, fake)
    engine.tick()
    for _ in range(20):
        lat.observe(0.005)
    fake.advance(5.0)
    rep = engine.tick()
    assert rep["slos"]["latency"]["breached"] is False
    assert rep["slos"]["latency"]["value"] <= 0.1
    before = metrics_mod.slo_breaches.sample().get((("slo", "latency"),), 0)
    for _ in range(20):
        lat.observe(0.5)
    fake.advance(5.0)
    rep = engine.tick()
    assert rep["slos"]["latency"]["breached"] is True
    assert rep["slos"]["latency"]["value"] > 0.1
    after = metrics_mod.slo_breaches.sample().get((("slo", "latency"),), 0)
    assert after - before == 1
    assert metrics_mod.slo_healthy.sample()[(("slo", "latency"),)] == 0.0
    bundles = engine.recorder.bundles()
    assert len(bundles) == 1
    manifest = json.loads((bundles[0] / "manifest.json").read_text())
    assert manifest["reason"] == "slo:latency"
    fake.advance(1.0)
    engine.tick()
    assert metrics_mod.slo_breaches.sample().get(
        (("slo", "latency"),), 0) == after
    fake.advance(40.0)
    rep = engine.tick()
    assert rep["slos"]["latency"]["breached"] is False


def test_slo_budget_tolerates_brief_violation(tmp_path):
    fake = FakeClock()
    engine, lat = _engine(tmp_path, fake, budget=0.5, window_s=30.0)
    engine.tick()
    for _ in range(5):
        lat.observe(0.5)
    fake.advance(5.0)
    rep = engine.tick()
    assert rep["slos"]["latency"]["breached"] is False
    for _ in range(4):
        for _ in range(5):
            lat.observe(0.5)
        fake.advance(5.0)
        rep = engine.tick()
    assert rep["slos"]["latency"]["burn"] > 0.5
    assert rep["slos"]["latency"]["breached"] is True


def test_burn_freezes_when_sli_goes_unknown():
    fake = FakeClock()
    reg = metrics_mod.Registry()
    lat = reg.histogram("lat", buckets=(0.01, 0.1, 1.0, float("inf")))
    spec = sli_mod.SliSpec("lat_p95", "lat", "quantile", q=0.95)
    slo = health_mod.Slo(name="latency", sli="lat_p95", target=0.1,
                         window_s=60.0, budget=0.3)
    engine = health_mod.HealthEngine(
        registry=reg, health=health_mod.HealthRegistry(),
        slis=[spec], slos=[slo], window_s=10.0, time_source=fake)
    engine.tick()
    for _ in range(5):
        lat.observe(0.5)
    burns = []
    for _ in range(10):
        fake.advance(5.0)
        rep = engine.tick()
        burns.append(rep["slos"]["latency"]["burn"])
    assert max(burns) < 0.3, burns
    assert rep["slos"]["latency"]["breached"] is False
    assert burns[-1] <= burns[2]


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_engine_reports_equal_the_jax_engine(tmp_path, seed):
    """The same observation schedule through both packages' engines (no
    bus, no probes): equal readiness reports tick for tick."""
    import random

    from spacemesh_tpu.obs import health as jhealth
    from spacemesh_tpu.obs import sli as jsli
    from spacemesh_tpu.utils import metrics as jmetrics

    rng = random.Random(seed)
    fp, fj = FakeClock(), FakeClock()
    port, plat = _engine(tmp_path / "p", fp, budget=0.2, window_s=20.0)
    jax, jlat = _engine(tmp_path / "j", fj, budget=0.2, window_s=20.0,
                        mods=(jhealth, jsli, jmetrics))
    for _ in range(30):
        for _ in range(rng.randint(0, 12)):
            v = rng.choice([0.003, 0.05, 0.4, 2.0])
            plat.observe(v)
            jlat.observe(v)
        dt = rng.choice([1.0, 2.5, 5.0])
        fp.advance(dt)
        fj.advance(dt)
        assert port.tick() == jax.tick()
    assert len(port.recorder.bundles()) == len(jax.recorder.bundles())


def test_flight_failed_dump_does_not_arm_rate_limit(tmp_path):
    fake = FakeClock()
    spool = tmp_path / "spool"
    spool.write_text("a file where the spool dir should be")
    rec = flight_mod.FlightRecorder(spool, min_interval_s=60,
                                    time_source=fake)
    assert rec.dump("slo:x", now=fake()) is None
    spool.unlink()
    fake.advance(1.0)
    assert rec.dump("slo:x", now=fake()) is not None


def test_live_tracks_loop_not_request_ticks():
    fake = FakeClock()
    engine = health_mod.HealthEngine(
        registry=metrics_mod.Registry(), health=health_mod.HealthRegistry(),
        slis=[], slos=[], interval_s=5.0, time_source=fake)

    async def drive():
        engine.ensure_running()
        await asyncio.sleep(0)
        assert engine.live()
        fake.advance(60.0)
        engine.tick()
        assert not engine.live()
        engine.close()

    asyncio.run(drive())


def test_component_transition_metric_and_gauge_removal(tmp_path):
    fake = FakeClock()
    engine, _ = _engine(tmp_path, fake)
    state = {"ok": True}
    engine.health.register("widget", lambda now: (state["ok"], "because"))
    engine.tick()
    before = metrics_mod.component_stalls.sample().get(
        (("component", "widget"),), 0)
    state["ok"] = False
    fake.advance(1.0)
    rep = engine.tick()
    assert rep["ready"] is False
    assert metrics_mod.component_stalls.sample()[
        (("component", "widget"),)] == before + 1
    state["ok"] = True
    fake.advance(1.0)
    assert engine.tick()["ready"] is True
    state["ok"] = False
    fake.advance(1.0)
    engine.tick()
    engine.health.unregister("widget")
    fake.advance(1.0)
    assert "widget" not in engine.tick()["components"]
    assert (("component", "widget"),) not in \
        metrics_mod.component_healthy.sample()


# --- flight recorder ----------------------------------------------------


def test_flight_recorder_rate_limit_force_prune(tmp_path):
    fake = FakeClock()
    rec = flight_mod.FlightRecorder(tmp_path / "spool", min_interval_s=60,
                                    keep=2, time_source=fake)
    p1 = rec.dump("slo:first", now=fake())
    assert p1 is not None and p1.is_dir()
    assert rec.dump("slo:second", now=fake.advance(10)) is None
    p3 = rec.dump("manual", now=fake(), force=True)
    assert p3 is not None
    p4 = rec.dump("stall:late", now=fake.advance(120))
    assert p4 is not None
    assert len(rec.bundles()) == 2
    bundle = flight_mod.read_bundle(p4)
    assert bundle["manifest"]["reason"] == "stall:late"
    tracing.validate(bundle["trace"])
    assert bundle["metrics_samples"] > 0
    assert bundle["events"] == []  # no event bus in the port yet
    assert flight_mod.digest(bundle)["reason"] == "stall:late"


def test_flight_read_bundle_rejects_corruption(tmp_path):
    rec = flight_mod.FlightRecorder(tmp_path / "spool")
    p = rec.dump("manual", force=True)
    (p / "trace.json").write_text('{"traceEvents": [{"bad": 1}]}')
    with pytest.raises(ValueError):
        flight_mod.read_bundle(p)
    with pytest.raises(FileNotFoundError):
        flight_mod.read_bundle(tmp_path / "nope")


def _tree(path) -> set:
    return {str(p.relative_to(path)) for p in path.rglob("*")}


def test_flight_bundle_matches_the_jax_layout(tmp_path):
    """A bundle from each package: the same file set (procs/ included)
    and the same manifest keys; each validates through the other
    package's reader."""
    from spacemesh_tpu.obs import flight as jflight
    from spacemesh_tpu.obs.federate import FEDERATION as JFED
    from spacemesh_tpu.utils import tracing as jtracing
    from spacemesh_tpu_torch.obs.federate import FEDERATION

    tracing.start(capacity=64)
    jtracing.start(capacity=64, jax_bridge=False)
    with tracing.span("p.work"):
        pass
    with jtracing.span("p.work"):
        pass
    child = tracing.export()
    jchild = jtracing.export()
    tracing.stop()
    jtracing.stop()
    FEDERATION.update("replica-r0", [("up", {}, 1.0)], trace=child)
    JFED.update("replica-r0", [("up", {}, 1.0)], trace=jchild)
    try:
        health = {"ready": False, "components": {
            "post.prove": {"healthy": False, "reason": "stalled"}},
            "slos": {}, "slis": {}}
        p = flight_mod.FlightRecorder(tmp_path / "p").dump(
            "stall:post.prove", health=health, force=True)
        j = jflight.FlightRecorder(tmp_path / "j").dump(
            "stall:post.prove", health=health, force=True)
    finally:
        FEDERATION.drop("replica-r0")
        JFED.drop("replica-r0")
    assert _tree(p) == _tree(j)
    pm = json.loads((p / "manifest.json").read_text())
    jm = json.loads((j / "manifest.json").read_text())
    assert set(pm) == set(jm)
    assert pm["reason"] == jm["reason"] and pm["health"] == jm["health"]
    # each package's reader takes the other's bundle
    assert jflight.read_bundle(p)["manifest"]["reason"] == pm["reason"]
    assert flight_mod.read_bundle(j)["manifest"]["reason"] == jm["reason"]
    assert flight_mod.digest(flight_mod.read_bundle(p))[
        "unhealthy_components"] == {"post.prove": "stalled"}


# --- /readyz through verifyd's server -------------------------------------


def _with_server(server, fn):
    from aiohttp import ClientSession

    async def go():
        await server.start()
        try:
            async with ClientSession() as s:
                return await fn(s, f"http://127.0.0.1:{server.actual_port}")
        finally:
            await server.close()

    return asyncio.run(go())


def test_verifyd_readyz_serves_the_health_engine():
    """verifyd's /readyz is its health engine's report (SLOs included)
    and flips with a component probe; /healthz stays alive."""
    pytest.importorskip("aiohttp")
    from spacemesh_tpu_torch.verifyd.server import VerifydServer

    server = VerifydServer(device="cpu")
    assert server.health_engine is not None
    state = {"ok": True}
    probe = lambda now: (state["ok"], "widget reason")  # noqa: E731
    health_mod.HEALTH.register("widget", probe)

    async def go(s, base):
        h = await s.get(f"{base}/healthz")
        good = await s.get(f"{base}/readyz")
        gdoc = await good.json()
        state["ok"] = False
        server.health_engine._last_loop_tick = None  # evaluate fresh
        bad = await s.get(f"{base}/readyz")
        return h.status, (good.status, gdoc), (bad.status, await bad.json())

    try:
        hs, (gs, gdoc), (bs, bdoc) = _with_server(server, go)
    finally:
        health_mod.HEALTH.unregister("widget", probe)
    assert hs == 200
    assert gs == 200 and gdoc["ready"] is True
    assert {"verifyd_block_latency", "verifyd_request_latency"} <= set(
        gdoc["slos"])
    assert bs == 503
    assert bdoc["components"]["widget"] == {"healthy": False,
                                            "reason": "widget reason"}


# --- the acceptance capture ------------------------------------------------


def test_acceptance_init_prove_farm_stall_flight(tmp_path):
    """One init+prove+farm run with the engine on and every timing on an
    injected clock: windowed p99s for the prove window and the farm, the
    init rate, a stalled LabelWriter tripping its watchdog within its
    deadline, verifyd's /readyz reporting it with the reason, and the
    stall's flight bundle validating with the real workload's trace."""
    pytest.importorskip("aiohttp")
    from spacemesh_tpu_torch.core.signing import Domain, EdSigner
    from spacemesh_tpu_torch.post import workload
    from spacemesh_tpu_torch.post.data import LabelStore, PostMetadata
    from spacemesh_tpu_torch.verify.farm import SigRequest, VerificationFarm
    from spacemesh_tpu_torch.verifyd.server import VerifydServer

    tracing.stop()
    tracing.start(capacity=65536)
    fake = FakeClock(1000.0)
    engine = health_mod.HealthEngine(
        spool_dir=tmp_path / "flight", window_s=300.0, time_source=fake)
    registered = None
    writer = None
    gate = threading.Event()
    try:
        engine.tick()
        prover = workload.build(str(tmp_path / "post"), labels=2048,
                                batch=512, device="cpu")
        proof = prover.prove(workload.CHALLENGE)
        assert workload.verify_proof(proof, 2048, device="cpu")
        for name in ("post.init", "post.prove", "post.writer"):
            assert name not in health_mod.HEALTH.names()

        signer = EdSigner(seed=bytes(31) + b"\x01")

        async def farm_run():
            farm = VerificationFarm(device="cpu")
            try:
                reqs = [SigRequest(int(Domain.HARE), signer.public_key,
                                   b"m%d" % i,
                                   signer.sign(Domain.HARE, b"m%d" % i))
                        for i in range(24)]
                assert all(await asyncio.gather(
                    *(farm.submit(r) for r in reqs)))
            finally:
                await farm.aclose()

        asyncio.run(farm_run())
        fake.advance(30.0)
        report = engine.tick()
        p99 = {k: v for k, v in report["slis"].items()
               if k.endswith("_p99")}
        assert {"prove_window_p99", "farm_queue_wait_p99",
                "farm_dispatch_p99"} <= set(p99), report["slis"]
        assert all(v > 0 for v in p99.values())
        assert report["slis"]["init_labels_per_sec"] > 0

        meta = PostMetadata(
            node_id="00" * 32, commitment="11" * 32, scrypt_n=2,
            num_units=1, labels_per_unit=256, max_file_size=1 << 20)
        store = LabelStore(tmp_path / "stall", meta)
        store.write_labels = lambda start, labels: gate.wait(60)
        writer = store.start_writer(threads=1, queue_depth=4)
        writer.submit(0, b"\x00" * 16 * 8)
        wd = health_mod.writer_watchdog(writer, deadline_s=5.0)
        registered = wd.check
        health_mod.HEALTH.register("post.writer", registered)
        assert engine.tick()["components"]["post.writer"]["healthy"]
        fake.advance(4.0)
        assert engine.tick()["components"]["post.writer"]["healthy"]
        fake.advance(2.0)
        report = engine.tick()
        ent = report["components"]["post.writer"]
        assert ent["healthy"] is False
        assert "stalled" in ent["reason"] and "deadline" in ent["reason"]
        assert report["ready"] is False

        # the server's engine judges the stall on the clock that stamped it
        server = VerifydServer(device="cpu", time_source=fake)

        async def go(s, base):
            r = await s.get(f"{base}/readyz")
            return r.status, await r.json()

        status, doc = _with_server(server, go)
        assert status == 503
        assert doc["components"]["post.writer"]["healthy"] is False
        assert "stalled" in doc["components"]["post.writer"]["reason"]

        bundles = engine.recorder.bundles()
        assert bundles, "stall transition did not spool a bundle"
        bundle = flight_mod.read_bundle(bundles[-1])
        assert "stall:post.writer" in bundle["manifest"]["reason"]
        from spacemesh_tpu_torch.obs.federate import parse_exposition

        names = {n for n, _, _ in parse_exposition(
            (bundles[-1] / "metrics.prom").read_text())}
        assert {"post_prove_window_seconds_bucket",
                "component_healthy"} <= names
        span_names = {e["name"] for e in bundle["trace"]["traceEvents"]}
        assert {"init.run", "prove.run", "farm.batch"} <= span_names
        assert flight_mod.digest(bundle)["unhealthy_components"][
            "post.writer"].startswith("stalled")
    finally:
        gate.set()
        if writer is not None:
            writer.close(drain=False)
        if registered is not None:
            health_mod.HEALTH.unregister("post.writer", registered)
        tracing.stop()
