"""Deterministic verifyd FLEET scenario: the whole control plane under
chaos (port of ``spacemesh_tpu/sim/fleet.py``; the ``fleet`` and
``byzantine-verifyd`` drills).

One :class:`~..verifyd.fleet.FleetVerifier` drives thousands of placed
client identities across three in-process sharded
:class:`~..verifyd.service.VerifydService` replicas (``shard=`` keeps
their registries, tenant namespaces and metric series disjoint inside
one process) through killable transports: seeded, scripted, on a virtual
clock advanced only between waves, with a replay-stable event digest
(two runs give byte-identical digests, and the event stream equals the
JAX package's for the same script). The replicas' farms, the local farm
and the workload run on ``device`` (default ``"cuda"``).

What the drill must prove, all from one script:

* **Sharded admission** — client placement fills the FLEET-wide bound
  (the sum of the replicas' router-side ``max_clients``); the client
  past it hears a typed ``registry_full``, never a silent serve.
* **Re-route, don't surface** — a replica whose own registry is full
  sheds typed; the router re-places the client on its next ring choice
  and the caller never sees the shed.
* **Work stealing** — a replica made hot (shed pressure on its kinds)
  is stolen from: chains for its clients try the coolest healthy
  replica first, visibly (``fleet_steals_total``).
* **Replica kill mid-load** — the killed replica's breaker opens after
  its failure budget (attempts against the corpse stay bounded), its
  clients' requests keep being answered by the survivors with verdicts
  bit-identical to inline verification, and the BLOCK-lane p99 SLO
  stays green from windowed SLIs on the virtual clock.
* **Full blackout → local farm** — with every replica dead the local
  farm serves every request (the bit-identical last resort), and after
  restore the fleet half-open-probes its way back to remote serving.
* **Autoscaling signal** — the router folds the windowed per-replica
  SLIs into load scores and the ``fleet_desired_replicas`` gauge; the
  script asserts the signal reacts to the hot span.

The whole drill runs under a span capture (an already-running capture
is used as-is), merged into one timeline that the ``merged_capture``
assert judges: it validates, carries spans and resolves every link.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import random

from ..obs import remediate as remediate_mod
from ..obs import sli as sli_mod
from ..utils import metrics, tracing
from ..verify.farm import Lane
from ..verifyd import protocol
from ..verifyd.fleet import FleetRouter, FleetVerifier
from ..verifyd.service import Shed, VerifydService
from .verifyd_load import _VClock, _build_pools, _pick_items

_LANES = (Lane.BLOCK, Lane.GOSSIP, Lane.SYNC)


@dataclasses.dataclass
class FleetSimResult:
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
        "engine": "fleet", "waves": script.get("waves"),
        "events": events,
        "asserts": [{k: v for k, v in a.items() if k != "detail"}
                    for a in asserts],
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


class _ReplicaTransport:
    """One replica's endpoint: an in-process sharded verifyd service
    behind a kill switch.  ``down=True`` is the wire's view of a killed
    replica — every call raises ConnectionError (and is counted, so the
    script can assert the breaker bounded attempts against the corpse).
    """

    def __init__(self, service: VerifydService):
        self.service = service
        self.down = False
        self.byzantine = False   # answer with flipped (wrong) verdicts
        self.calls = 0
        self.calls_down = 0

    def _gate(self) -> None:
        self.calls += 1
        if self.down:
            self.calls_down += 1
            raise ConnectionError(
                f"replica {self.service.shard} is down")

    async def register(self, client: str, **kwargs) -> dict:
        self._gate()
        kwargs.setdefault("rate", 1e9)
        kwargs.setdefault("burst", 1e9)
        kwargs.setdefault("max_queued", 4096)
        self.service.register_client(str(client), **kwargs)
        return {"client": str(client)}

    async def unregister(self, client: str) -> None:
        self._gate()
        self.service.unregister_client(str(client))

    async def verify(self, reqs: list, *, client: str,
                     lane: str = "gossip",
                     deadline_s: float | None = None) -> list[bool]:
        self._gate()
        verdicts = await self.service.verify(
            str(client), reqs, lane=protocol.parse_lane(lane),
            deadline_s=deadline_s)
        if self.byzantine:
            # a stale/hostile replica: transport healthy, admission
            # healthy, every verdict wrong — only a verdict-level audit
            # can catch this failure mode
            return [not v for v in verdicts]
        return verdicts

    async def aclose(self) -> None:
        return None


async def _run(script: dict, pools: dict, clock: _VClock, events: list,
               stats_out: dict, slis_out: dict, device) -> None:
    from ..verify.farm import VerificationFarm

    w = pools["workload"]
    seed = int(script.get("seed", 7))
    rng = random.Random(seed)
    waves = int(script.get("waves", 18))
    interval = float(script.get("wave_interval_s", 0.5))
    br_cfg = dict(script.get("breaker") or {})
    faults = dict(script.get("faults") or {})
    kill = dict(faults.get("kill") or {})
    blackout = dict(faults.get("blackout") or {})
    byzantine = dict(faults.get("byzantine") or {})
    ccfg = dict(script.get("clients") or {})

    services: dict[str, VerifydService] = {}
    transports: dict[str, _ReplicaTransport] = {}
    router = FleetRouter(seed=seed, time_source=clock.now)
    local_farm = VerificationFarm(ed_verifier=w.ed, vrf_verifier=w.vrf,
                                  post_params=w.post_params,
                                  post_seed=w.post_seed, device=device)

    def on_transition(name: str):
        def cb(frm: str, to: str) -> None:
            events.append({"breaker": to, "from": frm, "replica": name,
                           "t": round(clock.now(), 6)})
        return cb

    replica_specs = list(script.get("replicas") or ())
    for spec in replica_specs:
        name = str(spec["name"])
        svc_cfg = dict(spec.get("service") or {})
        svc_cfg.setdefault("workers", 2)
        service = VerifydService(time_source=clock.now, shard=name,
                                 device=device, **svc_cfg)
        service.farm.ed_verifier = w.ed
        service.farm.vrf_verifier = w.vrf
        service.farm.post_params = w.post_params
        service.farm.post_seed = w.post_seed
        services[name] = service
        transports[name] = _ReplicaTransport(service)
        breaker = remediate_mod.CircuitBreaker(
            f"verifyd.replica.{name}",
            failure_budget=int(br_cfg.get("failure_budget", 2)),
            window_s=float(br_cfg.get("window_s", 60.0)),
            cooldown_s=float(br_cfg.get("cooldown_s", 1.0)),
            cooldown_cap_s=float(br_cfg.get("cooldown_cap_s", 2.0)),
            seed=seed, time_source=clock.now,
            on_transition=on_transition(name))
        router.register_replica(
            name, transports[name], breaker=breaker,
            max_clients=int(spec.get("router_max_clients", 64)))

    holder: dict = {}

    def observer(kind: str, **kw) -> None:
        if kind == "served":
            holder.update(kw)
        elif kind == "audit_divergence":
            events.append({"audit_divergence": str(kw.get("replica")),
                           "index": int(kw.get("index", 0)),
                           "t": round(clock.now(), 6)})

    audit = dict(script.get("audit") or {})
    fv = FleetVerifier(router=router, farm=local_farm,
                       own_router=True, observer=observer,
                       time_source=clock.now,
                       audit_k=int(audit.get("items", 0)))
    sampler = sli_mod.SliSampler(metrics.REGISTRY, window_s=3600.0)
    replica_names = sorted(services)
    sli_specs = sli_mod.fleet_slis(replica_names)

    try:
        for service in services.values():
            await service.start()
        fv.start()

        # fill placement to the FLEET bound: per-shard registries make
        # admission capacity the SUM of the replicas' bounds
        total = int(ccfg.get("placed") or router.fleet_max_clients())
        placed = [f"c{i:04d}" for i in range(total)]
        for cid in placed:
            router.place_client(cid)
        overflow = [f"over-{i}" for i in
                    range(int(ccfg.get("overflow", 2)))]
        hot_replica = str(ccfg.get("hot_replica", replica_specs[0]["name"]))
        pinned = sorted(
            c for c, r in router.placement.assign.items()
            if r == hot_replica)[:int(ccfg.get("pinned_hot", 3))]
        active_n = int(ccfg.get("active_per_wave", 16))
        lo, hi = (ccfg.get("items") or [2, 4])[:2]
        mix = ccfg.get("mix") or {"sig": 6, "vrf": 1, "pow": 2}

        sampler.sample(clock.now())
        for wave in range(waves):
            if wave == int(kill.get("wave", -1)):
                transports[str(kill["replica"])].down = True
                events.append({"fault": "kill_replica",
                               "replica": str(kill["replica"]),
                               "wave": wave})
            if wave == int(kill.get("restore_wave", -1)):
                transports[str(kill["replica"])].down = False
                events.append({"fault": "restore_replica",
                               "replica": str(kill["replica"]),
                               "wave": wave})
            if wave == int(blackout.get("wave", -1)):
                for name, t in transports.items():
                    t.down = True
                events.append({"fault": "blackout", "wave": wave})
            if wave == int(blackout.get("restore_wave", -1)):
                for name, t in transports.items():
                    t.down = False
                events.append({"fault": "restore_all", "wave": wave})
            if wave == int(byzantine.get("wave", -1)):
                transports[str(byzantine["replica"])].byzantine = True
                events.append({"fault": "byzantine_replica",
                               "replica": str(byzantine["replica"]),
                               "wave": wave})
            if wave == int(byzantine.get("restore_wave", -1)):
                transports[str(byzantine["replica"])].byzantine = False
                events.append({"fault": "restore_byzantine",
                               "replica": str(byzantine["replica"]),
                               "wave": wave})

            active = list(pinned)
            for cid in rng.sample(placed, active_n):
                if cid not in active:
                    active.append(cid)
            for idx, cid in enumerate(active + overflow):
                picked = _pick_items(rng, pools["pools"], mix,
                                     rng.randint(int(lo), int(hi)))
                reqs = [p[0] for p in picked]
                exp = [bool(p[1]) for p in picked]
                lane = _LANES[idx % len(_LANES)]
                ent = {"client": cid, "wave": wave,
                       "lane": lane.name.lower(),
                       "kinds": [q.kind for q in reqs],
                       "expected": exp}
                try:
                    verdicts = await fv.verify_batch(reqs, lane,
                                                     client_id=cid)
                except Shed as e:
                    ent.update({"outcome": f"shed:{e.reason}",
                                "verdicts": None, "served_by": None,
                                "path": None})
                else:
                    ent.update({"outcome": "ok",
                                "verdicts": list(verdicts),
                                "served_by": holder.get("served_by"),
                                "path": holder.get("path")})
                holder.clear()
                events.append(ent)

            clock.advance(interval)
            sampler.sample(clock.now())
            values = {}
            for spec in sli_specs:
                v = sampler.compute(spec)
                if v is not None:
                    values[spec.name] = v
            sig = router.update_signals(values)
            events.append({
                "wave": wave,
                "signals": {k: round(v, 4)
                            for k, v in sorted(sig["scores"].items())},
                "desired": int(sig["desired_replicas"])})

        slis_out.update({k: v for k, v in values.items()})
        stats_out.update({
            "router": router.state_doc(),
            "verifier": dict(fv.stats),
            "transports": {
                name: {"calls": t.calls, "calls_down": t.calls_down}
                for name, t in sorted(transports.items())},
            "services": {name: s.stats_doc()
                         for name, s in sorted(services.items())},
        })
    finally:
        for name in sorted(services):
            router.unregister_replica(name)
        await fv.aclose()
        for service in services.values():
            await service.aclose()
        await local_farm.aclose()


def _evaluate(script: dict, events: list, stats: dict,
              slis: dict, merged: dict | None = None) -> list:
    served = [e for e in events if e.get("outcome") == "ok"]
    shed = [e for e in events
            if str(e.get("outcome", "")).startswith("shed:")]
    wrong = [e for e in served if e["verdicts"] != e["expected"]]
    faults = dict(script.get("faults") or {})
    kill = dict(faults.get("kill") or {})
    blackout = dict(faults.get("blackout") or {})
    transitions = [(e["replica"], e["breaker"]) for e in events
                   if "breaker" in e]
    rstats = (stats.get("router") or {}).get("stats") or {}
    asserts = []
    for spec in script.get("asserts") or [{"kind": "no_wrong_verdicts"}]:
        kind = spec.get("kind")
        ent = dict(spec)
        if kind == "no_wrong_verdicts":
            ent["ok"] = not wrong
            ent["detail"] = f"{len(wrong)} diverging of {len(served)}"
        elif kind == "typed_sheds_only":
            # every non-served outcome is a TYPED shed, and only of the
            # reasons the script declares survivable
            allowed = set(spec.get("reasons") or ())
            reasons = {e["outcome"].split(":", 1)[1] for e in shed}
            answered = all("outcome" in e
                           for e in events if "client" in e)
            ent["ok"] = answered and reasons <= allowed
            ent["detail"] = f"shed reasons seen: {sorted(reasons)}"
        elif kind == "shed":
            reason = spec.get("reason")
            n = sum(1 for e in shed
                    if (spec.get("client") is None
                        or e["client"].startswith(spec["client"]))
                    and (reason is None
                         or e["outcome"] == f"shed:{reason}"))
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} sheds"
        elif kind == "path_served":
            if "replica" in spec:
                n = sum(1 for e in served
                        if e["served_by"] == spec["replica"])
                what = f"replica {spec['replica']}"
            else:
                n = sum(1 for e in served
                        if e["path"] == spec["path"]
                        or (spec["path"] == "local"
                            and e["path"] == "local_fastfail"))
                what = f"path {spec['path']}"
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} requests via {what}"
        elif kind == "blackout_local":
            span = [e for e in served
                    if int(blackout.get("wave", 1 << 30)) <= e["wave"]
                    < int(blackout.get("restore_wave", -1))]
            bad = [e for e in span if not e["path"].startswith("local")]
            ent["ok"] = bool(span) and not bad
            ent["detail"] = (f"{len(span)} blackout requests, "
                             f"{len(bad)} claimed remote")
        elif kind == "dead_replica_attempts_bounded":
            # the per-replica breaker's whole point: the corpse is paid
            # budget + half-open probes, NOT once per request
            name = str(spec.get("replica", kill.get("replica")))
            n = stats["transports"][name]["calls_down"]
            ent["ok"] = n <= int(spec["max"])
            ent["detail"] = f"{n} calls against dead {name}"
        elif kind == "failback":
            last_wave = max((e["wave"] for e in served), default=-1)
            tail = [e for e in served if e["wave"] == last_wave
                    and e["outcome"] == "ok"]
            ent["ok"] = bool(tail) and all(e["path"] == "remote"
                                           for e in tail)
            ent["detail"] = (f"wave {last_wave}: "
                             f"{sorted({e['path'] for e in tail})}")
        elif kind == "byzantine_detected":
            byz = dict(faults.get("byzantine") or {})
            name = str(spec.get("replica", byz.get("replica")))
            n = sum(1 for e in events
                    if e.get("audit_divergence") == name)
            stray = sum(1 for e in events
                        if "audit_divergence" in e
                        and e["audit_divergence"] != name)
            ent["ok"] = n >= int(spec.get("min", 1)) and stray == 0
            ent["detail"] = (f"{n} divergences on {name}, "
                             f"{stray} on honest replicas")
        elif kind == "breaker_sequence":
            name = str(spec.get("replica", kill.get("replica")))
            seq = [t for r, t in transitions if r == name]
            want = ["open", "half_open", "closed"]
            it = iter(seq)
            ent["ok"] = all(any(t == step for t in it) for step in want)
            ent["detail"] = f"{name} transitions: {seq}"
        elif kind == "reroutes":
            n = int(rstats.get("reroutes", 0))
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} reroutes"
        elif kind == "steals":
            n = int(rstats.get("steals", 0))
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} steals"
        elif kind == "fleet_bound":
            placed = ((stats.get("router") or {}).get("placement")
                      or {}).get("clients", 0)
            bound = (stats.get("router") or {}).get("fleet_max_clients", 0)
            ent["ok"] = placed == bound == int(spec["clients"])
            ent["detail"] = f"{placed} placed of bound {bound}"
        elif kind == "autoscale":
            peaks = [e["desired"] for e in events if "desired" in e]
            peak = max(peaks, default=0)
            ent["ok"] = peak >= int(spec.get("min_desired", 1))
            ent["detail"] = f"desired_replicas peak {peak}"
        elif kind == "slo_green":
            name = spec.get("name", "fleet_block_p99")
            value = slis.get(name)
            target = float(spec.get("target", 0.25))
            ent["ok"] = value is not None and value <= target
            ent["detail"] = f"{name}={value} target<={target}"
        elif kind == "sli_present":
            ent["ok"] = spec.get("name") in slis
            ent["detail"] = f"slis: {sorted(slis)}"
        elif kind == "merged_capture":
            # digest-stable merged-timeline facts: the run's capture
            # validates clean, carries spans, and resolves every
            # cross-process link token it saw ("detail", excluded from
            # the digest, carries the raw numbers)
            od = (merged or {}).get("otherData") or {}
            links = dict(od.get("links") or {})
            clean = merged is not None
            if clean:
                try:
                    tracing.validate(merged)
                except Exception:  # noqa: BLE001 — judged, not raised
                    clean = False
            spans = int(od.get("captured_spans") or 0)
            ent["ok"] = (clean and spans >= int(spec.get("min_spans", 1))
                         and int(links.get("unresolved", 0)) == 0)
            ent["detail"] = (f"{spans} spans over "
                             f"{len(od.get('procs') or [])} procs, "
                             f"unresolved={links.get('unresolved', 0)}")
        else:
            ent["ok"] = False
            ent["detail"] = f"unknown assert kind {kind!r}"
        asserts.append(ent)
    return asserts


def run_scenario(script: dict, device="cuda") -> FleetSimResult:
    """Run one fleet script (fresh services, fresh loop) on ``device``;
    returns the result with the replay-stable event digest."""
    import tempfile

    from ..device import resolve

    device = resolve(device)
    events: list = []
    stats: dict = {}
    slis: dict = {}
    clock = _VClock()
    # capture the whole drill so merged_capture asserts can judge the
    # timeline; an already-running outer capture is used as-is
    own_trace = not tracing.is_enabled()
    if own_trace:
        tracing.set_process_identity("fleet-sim")
        tracing.start(capacity=1 << 16)
    try:
        with tempfile.TemporaryDirectory() as d:
            pools = _build_pools(script, d, device)
            asyncio.run(_run(script, pools, clock, events, stats, slis,
                             device))
        merged = tracing.merge_captures([tracing.export()])
    finally:
        if own_trace:
            tracing.stop()
    asserts = _evaluate(script, events, stats, slis, merged=merged)
    served = [e for e in events if e.get("outcome") == "ok"]
    hub = {
        "requests": sum(1 for e in events if "client" in e),
        "served": len(served),
        "remote": sum(1 for e in served if e["path"] == "remote"),
        "local": sum(1 for e in served
                     if str(e["path"]).startswith("local")),
        "shed": sum(1 for e in events
                    if str(e.get("outcome", "")).startswith("shed:")),
        "placed_clients": ((stats.get("router") or {}).get("placement")
                           or {}).get("clients", 0),
        "steals": ((stats.get("router") or {}).get("stats")
                   or {}).get("steals", 0),
        "reroutes": ((stats.get("router") or {}).get("stats")
                     or {}).get("reroutes", 0),
    }
    return FleetSimResult(
        name=str(script.get("name", "fleet")),
        seed=int(script.get("seed", 7)),
        digest=_digest_of(script, events, asserts),
        ok=all(a["ok"] for a in asserts), asserts=asserts, slis=slis,
        stats={"hub": hub, **stats}, events=events)
