"""Deterministic open-loop multi-client verifyd load scenario (port of
``spacemesh_tpu/sim/verifyd_load.py``).

This module exercises the verification SERVICE scripted, seeded and
replayable: same seed, byte-identical digest across processes, and the
same event stream as the JAX package's for the same script. The service,
its farm and the workload's POST unit run on ``device`` (default
``"cuda"``; the tests pass ``"cpu"``).

Determinism contract: the service runs on a VIRTUAL clock advanced only
between waves, so every admission decision (token buckets, deadline
estimates) is a pure function of the script.  Each wave issues every
client's requests open-loop (tasks created without awaiting — the farm
coalesces across clients), then the wave gathers before the clock
advances, so queue state at each admission instant is reproducible.
Verdicts are deterministic (fixed workload seeds + pinned K3 post
seed), so the event digest — per request: client, wave, kinds, typed
outcome, verdicts — replays byte-identically.

Script schema (all numbers deterministic functions of the seed)::

    {"name": ..., "engine": "verifyd", "seed": 7,
     "waves": 12, "wave_interval_s": 0.05,
     "service": {"max_clients": 8, "max_pending_items": 4096, ...},
     "workload": {"sigs": 64, "vrfs": 8, "posts": 4,
                  "memberships": 8, "pows": 12},
     "clients": [
        {"id": "light-0", "rate": 4000, "burst": 2000,
         "requests_per_wave": 2, "items": [4, 8],
         "mix": {"sig": 6, "vrf": 1, "membership": 1, "pow": 2},
         "lane": "gossip"},
        {"id": "heavy", "rate": 60, "burst": 80, ...}],
     "asserts": [
        {"kind": "no_wrong_verdicts"},
        {"kind": "shed", "client": "heavy", "reason": "rate", "min": 1},
        {"kind": "ok_requests", "client": "light-0", "min": 10},
        {"kind": "bounded_pending", "max": 4096},
        {"kind": "sli_present", "name": "verifyd_request_p99"}]}
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import random

from ..obs import sli as sli_mod
from ..utils import metrics
from ..verifyd.service import Shed, VerifydService


class _VClock:
    """The scenario's virtual time source (advanced between waves)."""

    def __init__(self, start: float = 1000.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += float(dt)


@dataclasses.dataclass
class VerifydLoadResult:
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
        }, indent=1, sort_keys=True)


def _build_pools(script: dict, post_dir: str, device) -> dict:
    """Per-kind pools of (request, expected verdict) from the shared
    deterministic workload (its POST unit made on ``device``)."""
    from ..verify import workload

    wl_cfg = dict(script.get("workload") or {})
    w = workload.build(post_dir,
                       sigs=int(wl_cfg.get("sigs", 64)),
                       vrfs=int(wl_cfg.get("vrfs", 8)),
                       posts=int(wl_cfg.get("posts", 4)),
                       memberships=int(wl_cfg.get("memberships", 8)),
                       pows=int(wl_cfg.get("pows", 12)),
                       post_challenges=int(wl_cfg.get("post_challenges",
                                                      2)),
                       rng_seed=int(script.get("seed", 7)),
                       device=device)
    expected = w.inline_all()
    pools: dict[str, list] = {}
    for req, verdict in zip(w.requests, expected):
        pools.setdefault(req.kind, []).append((req, verdict))
    return {"pools": pools, "workload": w}


def _pick_items(rng: random.Random, pools: dict, mix: dict,
                count: int) -> list:
    kinds = sorted(k for k in mix if pools.get(k))
    if not kinds:
        raise ValueError(f"client mix {mix} matches no workload pool")
    weights = [float(mix[k]) for k in kinds]
    out = []
    for _ in range(count):
        kind = rng.choices(kinds, weights=weights)[0]
        pool = pools[kind]
        out.append(pool[rng.randrange(len(pool))])
    return out


async def _run(script: dict, pools: dict, clock: _VClock,
               events: list, service_stats: dict,
               slis_out: dict, device) -> None:
    from ..verifyd import protocol

    svc_cfg = dict(script.get("service") or {})
    svc_cfg.setdefault("workers", 3)
    service = VerifydService(time_source=clock.now, device=device,
                             **svc_cfg)
    w = pools["workload"]
    service.farm.ed_verifier = w.ed
    service.farm.vrf_verifier = w.vrf
    service.farm.post_params = w.post_params
    service.farm.post_seed = w.post_seed
    sampler = sli_mod.SliSampler(metrics.REGISTRY, window_s=3600.0)
    rng = random.Random(int(script.get("seed", 7)))
    waves = int(script.get("waves", 8))
    interval = float(script.get("wave_interval_s", 0.05))
    try:
        await service.start()
        for c in script.get("clients") or ():
            service.register_client(
                str(c["id"]), weight=float(c.get("weight", 1.0)),
                rate=c.get("rate"), burst=c.get("burst"),
                max_queued=c.get("max_queued"))
        sampler.sample(clock.now())

        async def one_request(cid: str, picked: list, lane, deadline):
            reqs = [r for r, _v in picked]
            exp = [bool(v) for _r, v in picked]
            try:
                got = await service.verify(cid, reqs, lane=lane,
                                           deadline_s=deadline)
                return ("ok", [bool(v) for v in got], exp)
            except Shed as e:
                return (f"shed:{e.reason}", None, exp)

        for wave in range(waves):
            tasks = []
            for c in script.get("clients") or ():
                cid = str(c["id"])
                lane = protocol.parse_lane(c.get("lane"))
                lo, hi = (c.get("items") or [4, 8])[:2]
                for r in range(int(c.get("requests_per_wave", 1))):
                    picked = _pick_items(rng, pools["pools"],
                                         c.get("mix") or {"sig": 1},
                                         rng.randint(int(lo), int(hi)))
                    tasks.append((cid, wave, r,
                                  [p[0].kind for p in picked],
                                  asyncio.ensure_future(one_request(
                                      cid, picked, lane,
                                      c.get("deadline_s")))))
            for cid, wv, r, kinds, task in tasks:
                outcome, got, exp = await task
                events.append({"client": cid, "wave": wv, "req": r,
                               "kinds": kinds, "outcome": outcome,
                               "verdicts": got, "expected": exp})
            clock.advance(interval)
            sampler.sample(clock.now())
        service_stats.update(service.stats_doc())
        for spec in sli_mod.verifyd_slis():
            v = sampler.compute(spec)
            if v is not None:
                slis_out[spec.name] = v
        for spec in sli_mod.verifyd_client_slis(
                [str(c["id"]) for c in script.get("clients") or ()]):
            v = sampler.compute(spec)
            if v is not None:
                slis_out[spec.name] = v
    finally:
        # explicit client lifecycle: every registered id unregisters
        # (per-client series leave the registry) before the drain
        for c in script.get("clients") or ():
            service.unregister_client(str(c["id"]))
        await service.aclose()


def _evaluate(script: dict, events: list, service_stats: dict,
              slis: dict) -> list:
    asserts = []
    wrong = [e for e in events
             if e["outcome"] == "ok" and e["verdicts"] != e["expected"]]
    for spec in script.get("asserts") or (
            [{"kind": "no_wrong_verdicts"}]):
        kind = spec.get("kind")
        ent = dict(spec)
        if kind == "no_wrong_verdicts":
            ent["ok"] = not wrong
            ent["detail"] = f"{len(wrong)} diverging requests"
        elif kind == "shed":
            reason = spec.get("reason")
            n = sum(1 for e in events
                    if (spec.get("client") is None
                        or e["client"] == spec["client"])
                    and e["outcome"].startswith("shed:")
                    and (reason is None
                         or e["outcome"] == f"shed:{reason}"))
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} sheds"
        elif kind == "ok_requests":
            n = sum(1 for e in events
                    if (spec.get("client") is None
                        or e["client"] == spec["client"])
                    and e["outcome"] == "ok")
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} admitted requests"
        elif kind == "no_shed":
            n = sum(1 for e in events
                    if (spec.get("client") is None
                        or e["client"] == spec["client"])
                    and e["outcome"].startswith("shed:"))
            ent["ok"] = n == 0
            ent["detail"] = f"{n} sheds"
        elif kind == "bounded_pending":
            peak = service_stats.get("pending_peak", 0)
            ent["ok"] = peak <= int(spec["max"])
            ent["detail"] = f"pending peak {peak}"
        elif kind == "sli_present":
            ent["ok"] = spec.get("name") in slis
            ent["detail"] = f"slis: {sorted(slis)}"
        else:
            ent["ok"] = False
            ent["detail"] = f"unknown assert kind {kind!r}"
        asserts.append(ent)
    return asserts


def run_scenario(script: dict, device="cuda") -> VerifydLoadResult:
    """Run one verifyd load script (fresh service, fresh loop) on
    ``device``; returns the result with the replay-stable event digest."""
    import tempfile

    from ..device import resolve

    device = resolve(device)
    events: list = []
    service_stats: dict = {}
    slis: dict = {}
    clock = _VClock()
    with tempfile.TemporaryDirectory() as d:
        pools = _build_pools(script, d, device)
        asyncio.run(_run(script, pools, clock, events, service_stats,
                         slis, device))
    asserts = _evaluate(script, events, service_stats, slis)
    # digest covers ONLY replay-stable facts: the script identity and
    # the per-request outcome log (wall-derived values — rates, SLI
    # magnitudes — stay out)
    digest_doc = {
        "name": script.get("name"), "seed": script.get("seed"),
        "engine": "verifyd", "waves": script.get("waves"),
        "events": events,
        "asserts": [{k: v for k, v in a.items() if k != "detail"}
                    for a in asserts],
    }
    digest = hashlib.sha256(
        json.dumps(digest_doc, sort_keys=True).encode()).hexdigest()[:16]
    hub = {
        "requests": len(events),
        "admitted": sum(1 for e in events if e["outcome"] == "ok"),
        "shed": sum(1 for e in events
                    if e["outcome"].startswith("shed:")),
        "clients": len(script.get("clients") or ()),
    }
    return VerifydLoadResult(
        name=str(script.get("name", "verifyd-load")),
        seed=int(script.get("seed", 7)), digest=digest,
        ok=all(a["ok"] for a in asserts), asserts=asserts, slis=slis,
        stats={"hub": hub, "service": service_stats}, events=events)
