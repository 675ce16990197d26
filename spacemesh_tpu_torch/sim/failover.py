"""Deterministic self-healing scenarios (port of
``spacemesh_tpu/sim/failover.py``).

Chaos drills for the remediation layer (obs/remediate.py,
verifyd/failover.py): seeded, scripted, on a virtual clock advanced only
between steps, with a replay-stable event digest (two runs give
byte-identical digests, and the event stream equals the JAX package's
for the same script).  ``mode`` selects the drill; the services, farms
and workload run on ``device`` (default ``"cuda"``).

**verifyd-outage** — a node's :class:`~..verifyd.failover.
FailoverVerifier` drives mixed verification waves against an in-process
:class:`~..verifyd.service.VerifydService` through a killable
transport.  Mid-load the transport dies (every call raises —
the socket's-eye view of a killed verifyd).  The node must: keep
answering every request with verdicts bit-identical to inline
verification (the local farm carries the load), trip the breaker after
its failure budget so the dead service stops being re-paid per
request, keep the BLOCK-lane latency SLO green straight through the
outage (asserted from windowed SLIs on the virtual clock — zero
sleeps), and, once the transport returns, half-open-probe its way back
to remote serving (failback).

**runtime-degrade** — the runtime engine's device-dispatch path
(runtime/engine.py ``Pipeline(breaker=...)``) under a seeded
device-fault plan: dispatch fails for a scripted span of batches.  The
breaker must open after exactly the configured failure budget (N device
attempts for an M>>N-batch outage, not M), the host fallback must carry
every batch bit-identically, and device recovery must re-close the
breaker through a half-open probe.  The drill's "device" is a stand-in
callback (no card is touched), so it runs the same on any ``device``; no
entry point of the port wires a fallback (``runtime/engine.py``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import random

from ..obs import remediate as remediate_mod
from ..obs import sli as sli_mod
from ..utils import metrics
from ..verify.farm import Lane
from .verifyd_load import _VClock, _build_pools, _pick_items


@dataclasses.dataclass
class FailoverResult:
    """The drill's result: digest, ok, asserts, SLIs, stats and the
    event stream."""

    name: str
    seed: int
    digest: str
    ok: bool
    asserts: list
    slis: dict
    stats: dict
    events: list

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "seed": self.seed, "digest": self.digest,
            "ok": self.ok, "asserts": self.asserts, "slis": self.slis,
            "stats": self.stats, "events": self.events,
        }, indent=1, sort_keys=True, default=str)


def _digest_of(script: dict, events: list, asserts: list) -> str:
    doc = {
        "name": script.get("name"), "seed": script.get("seed"),
        "engine": "failover", "mode": script.get("mode"),
        "events": events,
        "asserts": [{k: v for k, v in a.items() if k != "detail"}
                    for a in asserts],
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


# --- verifyd-outage -----------------------------------------------------


class _KillableTransport:
    """The failover verifier's remote endpoint: an in-process verifyd
    service behind a kill switch.  ``down=True`` is the wire's view of
    a killed verifyd — every call raises ConnectionError."""

    def __init__(self, service, client_id: str):
        self.service = service
        self.client_id = client_id
        self.down = False
        self.calls = 0

    async def verify(self, reqs: list, *, lane: str = "gossip",
                     deadline_s: float | None = None) -> list[bool]:
        self.calls += 1
        if self.down:
            raise ConnectionError("verifyd is down")
        from ..verifyd import protocol

        return await self.service.verify(self.client_id, reqs,
                                         lane=protocol.parse_lane(lane),
                                         deadline_s=deadline_s)


async def _run_outage(script: dict, pools: dict, clock: _VClock,
                      events: list, stats_out: dict,
                      slis_out: dict, device) -> None:
    from ..verify.farm import VerificationFarm
    from ..verifyd.failover import FailoverVerifier
    from ..verifyd.service import VerifydService

    w = pools["workload"]
    svc_cfg = dict(script.get("service") or {})
    svc_cfg.setdefault("workers", 2)
    service = VerifydService(time_source=clock.now, device=device,
                             **svc_cfg)
    service.farm.ed_verifier = w.ed
    service.farm.vrf_verifier = w.vrf
    service.farm.post_params = w.post_params
    service.farm.post_seed = w.post_seed
    local_farm = VerificationFarm(ed_verifier=w.ed, vrf_verifier=w.vrf,
                                  post_params=w.post_params,
                                  post_seed=w.post_seed, device=device)
    sampler = sli_mod.SliSampler(metrics.REGISTRY, window_s=3600.0)
    rng = random.Random(int(script.get("seed", 7)))
    waves = int(script.get("waves", 16))
    interval = float(script.get("wave_interval_s", 0.5))
    outage = dict(script.get("outage") or {})
    kill_wave = int(outage.get("kill_wave", waves // 3))
    restore_wave = int(outage.get("restore_wave", (2 * waves) // 3))
    br_cfg = dict(script.get("breaker") or {})
    transport = _KillableTransport(service, "node")

    def on_transition(frm: str, to: str) -> None:
        events.append({"breaker": to, "from": frm,
                       "t": round(clock.now(), 6)})

    breaker = remediate_mod.CircuitBreaker(
        "verifyd.remote",
        failure_budget=int(br_cfg.get("failure_budget", 2)),
        window_s=float(br_cfg.get("window_s", 60.0)),
        cooldown_s=float(br_cfg.get("cooldown_s", 2.0)),
        cooldown_cap_s=float(br_cfg.get("cooldown_cap_s", 8.0)),
        seed=int(script.get("seed", 7)),
        time_source=clock.now, on_transition=on_transition)
    fv = FailoverVerifier(remote=transport, farm=local_farm,
                          breaker=breaker, time_source=clock.now)
    try:
        await service.start()
        fv.start()
        service.register_client("node", rate=1e9, burst=1e9,
                                max_queued=4096)
        sampler.sample(clock.now())
        per_wave = int(script.get("requests_per_wave", 2))
        lo, hi = (script.get("items") or [3, 6])[:2]
        mix = script.get("mix") or {"sig": 6, "vrf": 1, "pow": 2}
        for wave in range(waves):
            if wave == kill_wave:
                transport.down = True
                events.append({"fault": "kill_verifyd", "wave": wave})
            if wave == restore_wave:
                transport.down = False
                events.append({"fault": "restore_verifyd", "wave": wave})
            for r in range(per_wave):
                picked = _pick_items(rng, pools["pools"], mix,
                                     rng.randint(int(lo), int(hi)))
                reqs = [p[0] for p in picked]
                exp = [bool(p[1]) for p in picked]
                lane = Lane.BLOCK if r % 2 == 0 else Lane.GOSSIP
                before = dict(fv.stats)
                verdicts = await fv.verify_batch(reqs, lane)
                after = fv.stats
                if after["remote_ok"] > before["remote_ok"]:
                    path = "remote"
                elif after["local"] > before["local"]:
                    path = "local"
                else:
                    path = "local_fastfail"
                events.append({
                    "wave": wave, "req": r,
                    "lane": lane.name.lower(),
                    "kinds": [q.kind for q in reqs],
                    "path": path,
                    "verdicts": list(verdicts), "expected": exp,
                })
            clock.advance(interval)
            sampler.sample(clock.now())
        stats_out.update({"failover": dict(fv.stats),
                          "transport_calls": transport.calls,
                          "breaker": breaker.state_doc()})
        for spec in sli_mod.failover_slis():
            v = sampler.compute(spec)
            if v is not None:
                slis_out[spec.name] = v
    finally:
        service.unregister_client("node")
        await fv.aclose()
        await service.aclose()
        await local_farm.aclose()


def _eval_outage(script: dict, events: list, stats: dict,
                 slis: dict) -> list:
    served = [e for e in events if "path" in e]
    wrong = [e for e in served if e["verdicts"] != e["expected"]]
    transitions = [e["breaker"] for e in events if "breaker" in e]
    outage = dict(script.get("outage") or {})
    kill_wave = int(outage.get("kill_wave", 0))
    restore_wave = int(outage.get("restore_wave", 1 << 30))
    in_outage = [e for e in served
                 if kill_wave <= e["wave"] < restore_wave]
    asserts = []
    for spec in script.get("asserts") or [{"kind": "no_wrong_verdicts"}]:
        kind = spec.get("kind")
        ent = dict(spec)
        if kind == "no_wrong_verdicts":
            ent["ok"] = not wrong
            ent["detail"] = f"{len(wrong)} diverging of {len(served)}"
        elif kind == "path_served":
            n = sum(1 for e in served if e["path"] == spec["path"]
                    or (spec["path"] == "local"
                        and e["path"] == "local_fastfail"))
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} requests via {spec['path']}"
        elif kind == "outage_local":
            # every request issued while verifyd was dead still got its
            # verdicts — from the farm
            bad = [e for e in in_outage if e["path"] == "remote"]
            ent["ok"] = bool(in_outage) and not bad
            ent["detail"] = (f"{len(in_outage)} outage requests, "
                             f"{len(bad)} claimed remote")
        elif kind == "remote_attempts_bounded":
            # the breaker's whole point: the dead service is paid for
            # at most budget + half-open-probe attempts, NOT once per
            # request
            n = stats["failover"]["remote_failed"]
            ent["ok"] = n <= int(spec["max"])
            ent["detail"] = (f"{n} failed remote attempts over "
                             f"{len(in_outage)} outage requests")
        elif kind == "failback":
            last_wave = max((e["wave"] for e in served), default=-1)
            tail = [e for e in served if e["wave"] == last_wave]
            ent["ok"] = bool(tail) and all(e["path"] == "remote"
                                           for e in tail)
            ent["detail"] = (f"wave {last_wave}: "
                             f"{[e['path'] for e in tail]}")
        elif kind == "breaker_sequence":
            want = ["open", "half_open", "closed"]
            it = iter(transitions)
            ent["ok"] = all(any(t == step for t in it) for step in want)
            ent["detail"] = f"transitions: {transitions}"
        elif kind == "slo_green":
            name = spec.get("name", "failover_block_p99")
            value = slis.get(name)
            target = float(spec.get("target", 0.25))
            ent["ok"] = value is not None and value <= target
            ent["detail"] = f"{name}={value} target<={target}"
        elif kind == "sli_present":
            ent["ok"] = spec.get("name") in slis
            ent["detail"] = f"slis: {sorted(slis)}"
        else:
            ent["ok"] = False
            ent["detail"] = f"unknown assert kind {kind!r}"
        asserts.append(ent)
    return asserts


def _run_verifyd_outage(script: dict, device) -> FailoverResult:
    import tempfile

    events: list = []
    stats: dict = {}
    slis: dict = {}
    clock = _VClock()
    with tempfile.TemporaryDirectory() as d:
        pools = _build_pools(script, d, device)
        asyncio.run(_run_outage(script, pools, clock, events, stats,
                                slis, device))
    asserts = _eval_outage(script, events, stats, slis)
    served = [e for e in events if "path" in e]
    hub = {
        "requests": len(served),
        "remote": sum(1 for e in served if e["path"] == "remote"),
        "local": sum(1 for e in served
                     if e["path"].startswith("local")),
        "remote_failures": stats["failover"]["remote_failed"],
        "failbacks": stats["failover"]["failbacks"],
    }
    return FailoverResult(
        name=str(script.get("name", "verifyd-outage")),
        seed=int(script.get("seed", 7)),
        digest=_digest_of(script, events, asserts),
        ok=all(a["ok"] for a in asserts), asserts=asserts, slis=slis,
        stats={"hub": hub, "failover": stats}, events=events)


# --- runtime-degrade ----------------------------------------------------


def _label(seed: int, i: int) -> str:
    """The batch's 'result': one deterministic digest the device and
    host paths both compute — bit-identity is equality."""
    return hashlib.sha256(b"rt-degrade:%d:%d" % (seed, i)).hexdigest()[:16]


def _run_runtime_degrade(script: dict) -> FailoverResult:
    from ..runtime import engine

    seed = int(script.get("seed", 3))
    batches = int(script.get("batches", 60))
    step = float(script.get("step_s", 0.5))
    fault = dict(script.get("fault") or {})
    f_start = int(fault.get("start", batches // 4))
    f_end = int(fault.get("end", (3 * batches) // 4))
    br_cfg = dict(script.get("breaker") or {})
    clock = _VClock()
    events: list = []
    attempts = {"device": 0, "device_in_fault": 0}

    def on_transition(frm: str, to: str) -> None:
        events.append({"breaker": to, "from": frm,
                       "t": round(clock.now(), 6)})

    breaker = remediate_mod.CircuitBreaker(
        "runtime.device",
        failure_budget=int(br_cfg.get("failure_budget", 3)),
        window_s=float(br_cfg.get("window_s", 120.0)),
        cooldown_s=float(br_cfg.get("cooldown_s", 5.0)),
        cooldown_cap_s=float(br_cfg.get("cooldown_cap_s", 20.0)),
        seed=seed, time_source=clock.now, on_transition=on_transition)
    remediate_mod.BREAKERS.register(breaker)
    try:
        def items():
            for i in range(batches):
                yield i
                clock.advance(step)

        def dispatch(i: int):
            attempts["device"] += 1
            if f_start <= i < f_end:
                attempts["device_in_fault"] += 1
                raise RuntimeError("injected device fault")
            return ("device", i, _label(seed, i))

        def fallback(i: int, exc: Exception):
            return ("host", i, _label(seed, i))

        results: list = []

        def retire(ticket):
            path, i, digest = ticket
            results.append(ticket)
            events.append({"batch": i, "path": path, "digest": digest,
                           "t": round(clock.now(), 6)})
            return None

        pipe = engine.Pipeline(kind="simdev",
                               inflight=int(script.get("inflight", 3)),
                               fallback=fallback, breaker=breaker)
        pipe.run(items(), dispatch, retire)
        final_state = breaker.state
        stats = {
            "device_attempts": attempts["device"],
            "device_attempts_in_fault": attempts["device_in_fault"],
            "fallbacks": pipe.stats.fallbacks,
            "batches": pipe.stats.batches,
            "breaker": breaker.state_doc(),
        }
    finally:
        remediate_mod.BREAKERS.unregister(breaker)

    reference = {i: _label(seed, i) for i in range(batches)}
    wrong = [e for e in events if "batch" in e
             and e["digest"] != reference[e["batch"]]]
    tail = [e for e in events if "batch" in e
            and e["batch"] >= f_end + max(
                int(br_cfg.get("recover_slack", 12)), 1)]
    asserts = []
    for spec in script.get("asserts") or [{"kind": "bit_identical"}]:
        kind = spec.get("kind")
        ent = dict(spec)
        if kind == "bit_identical":
            n = sum(1 for e in events if "batch" in e)
            ent["ok"] = n == batches and not wrong
            ent["detail"] = f"{n}/{batches} batches, {len(wrong)} wrong"
        elif kind == "device_attempts_bounded":
            # the regression the breaker fixes: a dead device is paid
            # budget + probe attempts across the WHOLE fault span, not
            # once per batch
            n = stats["device_attempts_in_fault"]
            ent["ok"] = n <= int(spec["max"])
            ent["detail"] = (f"{n} device attempts across a "
                             f"{f_end - f_start}-batch fault span")
        elif kind == "fallbacks":
            ent["ok"] = stats["fallbacks"] >= int(spec.get("min", 1))
            ent["detail"] = f"{stats['fallbacks']} fallbacks"
        elif kind == "breaker_recloses":
            ent["ok"] = (final_state == remediate_mod.CLOSED
                         and bool(tail)
                         and all(e["path"] == "device" for e in tail))
            ent["detail"] = (f"final={final_state}, "
                             f"{len(tail)} post-recovery device batches")
        elif kind == "breaker_sequence":
            transitions = [e["breaker"] for e in events if "breaker" in e]
            want = ["open", "half_open", "closed"]
            it = iter(transitions)
            ent["ok"] = all(any(t == step for t in it) for step in want)
            ent["detail"] = f"transitions: {transitions}"
        else:
            ent["ok"] = False
            ent["detail"] = f"unknown assert kind {kind!r}"
        asserts.append(ent)
    hub = {
        "batches": batches,
        "device": sum(1 for e in events
                      if e.get("path") == "device"),
        "host": sum(1 for e in events if e.get("path") == "host"),
        "device_attempts": stats["device_attempts"],
    }
    return FailoverResult(
        name=str(script.get("name", "runtime-degrade")), seed=seed,
        digest=_digest_of(script, events, asserts),
        ok=all(a["ok"] for a in asserts), asserts=asserts, slis={},
        stats={"hub": hub, "runtime": stats}, events=events)


def run_scenario(script: dict, device="cuda") -> FailoverResult:
    """Run one failover script on ``device`` (mode selects the drill;
    like every entry point, it raises without a card unless ``device``
    says ``"cpu"``, even for the runtime-degrade drill, which touches no
    device)."""
    from ..device import resolve

    dev = resolve(device)
    mode = script.get("mode", "verifyd-outage")
    if mode == "verifyd-outage":
        return _run_verifyd_outage(script, dev)
    if mode == "runtime-degrade":
        return _run_runtime_degrade(script)
    raise ValueError(f"unknown failover mode {mode!r}")
