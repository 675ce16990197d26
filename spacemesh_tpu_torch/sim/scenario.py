"""The declarative scenario engine (port of ``spacemesh_tpu/sim/scenario.py``;
the full nodes run on ``device``, default ``"cuda"``).

A scenario is a plain dict (or YAML loaded into one — sim/__main__.py):

    {
      "name": "partition-heal",
      "seed": 7,
      "nodes": {"full": 4, "light": 60, "identities": [2, 1, 1, 1]},
      "layer_sec": 2.0, "lpe": 8, "until_layer": 14,
      "topology": {"degree": 6, "gossip_degree": 4},
      "phases": [
        {"name": "warmup", "until_layer": 10},
        {"name": "partition", "until_layer": 13,
         "faults": [{"kind": "partition", "islands": [[0, 1], [2], [3]]}],
         "traffic": {"storm": {"publishers": 6, "messages": 24,
                               "interval": 0.25}}},
        {"name": "heal",
         "faults": [{"kind": "heal"}],
         "converge": {"frontier": 12, "deadline": 240.0},
         "asserts": [{"kind": "converged", "frontier": 12},
                     {"kind": "slo_green"},
                     {"kind": "span", "name": "mesh.process_layer",
                      "min": 1}]},
      ],
    }

Everything runs on ONE VirtualClockLoop: phase boundaries are layer
starts on a virtual LayerClock, faults land at exact virtual instants,
and assertions read windowed SLIs (obs/sli.py) + span traces
(utils/tracing.py) + consensus state — never a wall-clock sleep.

**Event digest.** The digest covers replay-stable content only: the
scenario header, every booted identity, the fault script as applied,
and the CONSENSUS RECORD — each full node's applied block per layer up
to the scripted ``digest_frontier`` plus its state root, and the
outcomes of the consensus assertions. Wall-time-derived values (SLI
quantiles measure real compute seconds; hub counters shift with
scheduler micro-ordering) stay in the report but OUT of the digest, so
``same seed => byte-identical digest`` holds on a loaded CI box while
any consensus/replay divergence still changes it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import tempfile
from pathlib import Path
from typing import Optional

from ..device import resolve
from ..node import clock as clock_mod
from ..obs import sli as sli_mod
from ..obs.health import Slo
from ..utils import metrics, tracing
from ..utils.vclock import ChaosClockLoop, VirtualClockLoop, cancel_all_tasks
from . import faults as faults_mod
from .net import MeshHub, SimNet, SimNetwork
from .node import STORM_TOPIC, FullNode, LightNode, storm_payload
from .shard import ShardWorkerCrash, resolve_shards

# generous-by-design CI targets: the quantiles measure REAL compute
# seconds while hundreds of coroutines share one GIL, so these catch
# pathologies (a wedged pipeline, a minutes-long stall), not latency
# regressions — the production targets live in obs/health.default_slos
def scenario_slos() -> list[Slo]:
    return [
        Slo(name="layer_apply_latency", sli="layer_apply_p99", target=15.0),
        Slo(name="gossip_handler_latency", sli="gossip_handler_p99",
            target=15.0),
        Slo(name="farm_queue_wait", sli="farm_queue_wait_p99", target=10.0),
    ]


@dataclasses.dataclass
class ScenarioResult:
    name: str
    seed: int
    digest: str
    ok: bool
    asserts: list
    events: list
    slis: dict
    stats: dict

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


class ScenarioEngine:
    def __init__(self, script: dict, *, tmp: Path | None = None,
                 vtimeout: float = 30_000.0, device="cuda"):
        self.device = resolve(device)
        self.script = dict(script)
        self.seed = int(script.get("seed", 0))
        self.name = script.get("name", "scenario")
        self.vtimeout = vtimeout
        self._own_tmp: Optional[tempfile.TemporaryDirectory] = None
        if tmp is None:
            self._own_tmp = tempfile.TemporaryDirectory(prefix="simrun-")
            tmp = Path(self._own_tmp.name)
        self.tmp = Path(tmp)
        self.events: list = []          # (vtime, line) — human report
        self._digest_lines: list = []   # replay-stable content only
        self.asserts: list = []
        self.fulls: list[FullNode] = []
        self.lights: list[LightNode] = []
        self._aux_tasks: list = []
        self._run_tasks: list = []

    # --- recording ------------------------------------------------------

    def _now(self) -> float:
        # the engine OWNS this loop and it is always a VirtualClockLoop:
        # its clock IS the scenario's virtual time source
        return self.loop.time()  # spacecheck: ok=SC001 engine-owned VirtualClockLoop

    def record(self, line: str, digest: bool = True) -> None:
        self.events.append((round(self._now(), 6), line))
        if digest:
            self._digest_lines.append(line)

    # --- lifecycle ------------------------------------------------------

    def run(self) -> ScenarioResult:
        chaos = self.script.get("chaos_schedule")
        self.loop = (ChaosClockLoop(int(chaos)) if chaos is not None
                     else VirtualClockLoop())
        try:
            self.loop.run_until_complete(
                asyncio.wait_for(self._go(), self.vtimeout))
        except ShardWorkerCrash as e:
            # typed scenario failure, never a hang: detach the governor
            # so teardown below runs clean, record, and judge failed
            self.loop.time_governor = None
            self.record("fault shard-worker-crash shard=%d" % e.shard,
                        digest=False)
            self.asserts.append({"phase": "fabric", "kind": "shard_worker",
                                 "ok": False, "detail": str(e),
                                 "last_metrics": e.last_metrics is not None,
                                 "last_spans": e.last_spans is not None})
            self._crash_result()
        finally:
            self.loop.time_governor = None
            try:
                self.loop.run_until_complete(cancel_all_tasks())
            finally:
                hub = getattr(self, "hub", None)
                if hub is not None and hasattr(hub, "close"):
                    hub.close()
                for fn in self.fulls:
                    fn.close()
                if tracing.is_enabled():
                    tracing.stop()
                try:
                    self.loop.run_until_complete(
                        self.loop.shutdown_asyncgens())
                    self.loop.run_until_complete(
                        self.loop.shutdown_default_executor())
                finally:
                    asyncio.set_event_loop(None)
                    self.loop.close()
                if self._own_tmp is not None:
                    self._own_tmp.cleanup()
        return self.result

    def _crash_result(self) -> None:
        digest = hashlib.sha256(
            "\n".join(self._digest_lines).encode()).hexdigest()
        self.result = ScenarioResult(
            name=self.name, seed=self.seed, digest=digest, ok=False,
            asserts=self.asserts,
            events=[f"{t:.3f} {line}" for t, line in self.events],
            slis={}, stats={})

    async def _go(self) -> None:
        s = self.script
        nodes = s.get("nodes", {})
        n_full = int(nodes.get("full", 2))
        n_light = int(nodes.get("light", 16))
        identities = nodes.get("identities") or [1] * n_full
        topo = s.get("topology", {})
        self.layer_sec = float(s.get("layer_sec", 2.0))
        self.lpe = int(s.get("lpe", 8))
        self.until_layer = int(s.get("until_layer", 14))

        if s.get("trace", True):
            # the parent of the (possibly sharded) fabric: worker
            # captures federate into this process under shard-<k> roles
            tracing.set_process_identity("parent")
            tracing.start(capacity=int(s.get("trace_capacity", 65536)))
        self.network = SimNetwork(self.seed,
                                  degree=int(topo.get("degree", 6)))
        shards = resolve_shards(s.get("shards"), n_light)
        self.hub = MeshHub(self.network,
                           gossip_degree=int(topo.get("gossip_degree", 4)),
                           shards=shards)
        self.shard_count = getattr(self.hub, "shards", 1)
        if self.shard_count > 1:
            # conservative-window barriers ride the clock's idle jumps;
            # the shard count must NOT enter the digest (assertions are
            # W-invariant, the byte-identical contract is per (seed, W))
            self.loop.time_governor = self.hub.governor
        self.record("fabric shards=%d" % self.shard_count, digest=False)
        self.simnet = SimNet(self.network)
        self.sampler = sli_mod.SliSampler(
            metrics.REGISTRY, window_s=float(s.get("sli_window", 300.0)))
        self._sli_specs = {spec.name: spec
                           for spec in sli_mod.default_slis()}

        self.record("scenario name=%s seed=%d full=%d light=%d until=%d"
                    % (self.name, self.seed, n_full, n_light,
                       self.until_layer))
        # full nodes first so their topology slots are stable, then the
        # light fabric; topology is a pure function of (seed, order)
        for i in range(n_full):
            self.fulls.append(FullNode(
                self.seed, i, tmp=self.tmp, hub=self.hub,
                simnet=self.simnet, loop_time=self.loop.time,
                layer_sec=self.layer_sec, lpe=self.lpe,
                num_identities=int(identities[i]),
                smeshing=bool(nodes.get("smeshing", True)),
                device=self.device))
        for i in range(n_light):
            self.lights.append(LightNode(self.seed, i, self.hub))
        self.network.build_topology()
        for i, fn in enumerate(self.fulls):
            self.record("boot full=%d id=%s ids=%d"
                        % (i, fn.name.hex()[:16], identities[i]))
        light_digest = hashlib.sha256(
            b"".join(ln.name for ln in self.lights)).hexdigest()[:16]
        self.record("boot light n=%d digest=%s" % (n_light, light_digest))

        # POST init sequentially: concurrent worker threads are the one
        # wall-clock-ordered thing in the process, and boot order must
        # not depend on them
        for fn in self.fulls:
            await fn.prepare()

        # spacecheck: ok=SC001 genesis anchors to the engine's own virtual clock
        genesis = self.loop.time() + 1.0
        self.clock = clock_mod.LayerClock(genesis, self.layer_sec,
                                          time_source=self.loop.time)
        for fn in self.fulls:
            fn.rebase_clock(genesis)
        self._run_tasks = [fn.start(self.until_layer) for fn in self.fulls]
        self._aux_tasks.append(asyncio.ensure_future(self._heartbeats(
            float(s.get("heartbeat", 1.0)))))
        self._aux_tasks.append(asyncio.ensure_future(self._sampling(
            float(s.get("sample_interval", 2.0)))))

        phases = s.get("phases", [])
        for pi, phase in enumerate(phases):
            await self._run_phase(pi, phase, last=(pi == len(phases) - 1))

        await self._finish()

    async def _run_phase(self, pi: int, phase: dict, *, last: bool) -> None:
        pname = phase.get("name", f"phase{pi}")
        self.record("phase name=%s" % pname)
        for fault in phase.get("faults", ()):
            if fault.get("kind") == "adversary":
                line = self._start_adversary(fault)
            elif fault.get("kind") == "restart":
                line = await self._restart_full(fault)
            else:
                line = faults_mod.apply_fault(self, fault)
            self.record("fault phase=%s %s" % (pname, line))
        traffic_tasks = self._start_traffic(phase.get("traffic", {}))
        if "until_layer" in phase:
            await self.clock.await_layer(int(phase["until_layer"]))
        elif "duration" in phase:
            await asyncio.sleep(float(phase["duration"]))
        if last:
            # the apps' run loops end at the scripted until_layer; wait
            # for their final hare drains before judging convergence
            await asyncio.gather(*self._run_tasks, return_exceptions=True)
        for t in traffic_tasks:
            if not t.done():
                t.cancel()
        if "converge" in phase:
            await self._wait_converged(**phase["converge"])
        self.sampler.sample(self._now())
        for spec in phase.get("asserts", ()):
            self._evaluate(pname, dict(spec))

    async def _finish(self) -> None:
        for t in self._aux_tasks:
            t.cancel()
        for fn in self.fulls:
            fn.app.syncer.stop()
        frontier = int(self.script.get(
            "digest_frontier", self.until_layer - 2))
        for fn in self.fulls:
            if not fn.alive:
                self.record("record full=%d killed" % fn.index)
                continue
            rec = fn.applied_record(self.lpe, frontier)
            root = fn.state_root(frontier)
            self.record("record full=%d applied=%s root=%s" % (
                fn.index,
                ";".join("%d:%s" % (lyr, b.hex()[:16]) for lyr, b in rec),
                (root or b"").hex()[:16]))
        # merged light event record: per-shard delivery counts merged in
        # deterministic (name-sorted) order — shard-structure invariant,
        # so W=1 and W=k agree on loss-free links.  A sharded fabric must
        # quiesce first: the tail of a flood can still be bouncing
        # light -> full -> light between the parent wheel and the worker
        # wheels, and those hops only progress while the loop runs.
        # Events-only (digest=False): the digest must stay FABRIC
        # invariant — event and legacy fabrics relay along different
        # edges, so raw delivery counts differ even though consensus
        # (the digested content) is identical, and the bench's
        # event-vs-legacy digest gate depends on that equality.
        # Cross-W delivery equivalence is still enforced through the
        # storm_coverage assertion, which reads these merged counts.
        if self.shard_count > 1 and hasattr(self.hub, "drain"):
            await self.hub.drain()
        if hasattr(self.hub, "finalize"):
            self.hub.finalize()
        merged = sorted((ln.name.hex()[:16], c)
                        for ln, c in self._light_storm_counts())
        self.record("record lights storm=%s n=%d" % (
            hashlib.sha256(repr(merged).encode()).hexdigest()[:16],
            len(merged)), digest=False)
        doc = None
        if tracing.is_enabled():
            doc = tracing.export()
            tracing.stop()
            self._judge_merged_trace(doc)
        slis = {k: self.sampler.compute(spec)
                for k, spec in self._sli_specs.items()}
        stats = {"hub": dict(self.hub.stats),
                 "net": dict(self.network.stats)}
        if getattr(self, "_merged_trace", None) is not None:
            stats["merged_trace"] = self._merged_trace
        ok = all(a["ok"] for a in self.asserts)
        digest = hashlib.sha256(
            "\n".join(self._digest_lines).encode()).hexdigest()
        self.result = ScenarioResult(
            name=self.name, seed=self.seed, digest=digest, ok=ok,
            asserts=self.asserts,
            events=[f"{t:.3f} {line}" for t, line in self.events],
            slis={k: v for k, v in slis.items() if v is not None},
            stats=stats)

    def _judge_merged_trace(self, doc: dict) -> None:
        """Merge the parent capture with every federated shard-worker
        capture into ONE timeline and judge the fleet-observability
        contract. Every assert kind below is emitted for every W —
        W=1 degenerates to the parent's own capture and passes
        trivially — so assertion OUTCOMES stay W-invariant."""
        caps = dict(getattr(self.hub, "worker_captures", {}))
        merged = tracing.merge_captures(
            [doc] + [caps[k] for k in sorted(caps)])
        try:
            warnings = tracing.validate(merged)
            trace_ok = True
        except Exception:  # noqa: BLE001 — recorded, judged below
            warnings, trace_ok = [], False
        self.asserts.append({"phase": "final", "kind": "trace_valid",
                             "ok": trace_ok,
                             "value": doc["otherData"].get(
                                 "captured_spans")})
        od = merged["otherData"]
        procs = od.get("procs", [])
        contributed = sum(1 for p in procs
                          if p.get("captured_spans", 0) > 0)
        self.asserts.append({"phase": "final", "kind": "merged_procs",
                             "ok": contributed == self.shard_count,
                             "value": contributed})
        links = dict(od.get("links") or {})
        # scripts may demand resolved cross-process parent edges, but
        # only when the fabric actually sharded (shards "auto" resolves
        # to W=1 on small hosts, where no process boundary exists)
        need_links = (int(self.script.get("require_cross_proc_links", 0))
                      if self.shard_count > 1 else 0)
        self.asserts.append({
            "phase": "final", "kind": "cross_proc_links",
            "ok": (links.get("unresolved", 0) == 0
                   and links.get("resolved", 0) >= need_links),
            "value": links.get("resolved", 0)})
        # federation cardinality: every live worker's proc= series are
        # present NOW (they are dropped at hub.close — the leak test's
        # other half). Range is empty for W=1: trivially ok.
        from ..obs.federate import FEDERATION
        live = FEDERATION.procs()
        missing = [f"shard-{s}" for s in range(1, self.shard_count)
                   if not live.get(f"shard-{s}", {}).get("series")]
        self.asserts.append({"phase": "final", "kind": "proc_series_live",
                             "ok": not missing,
                             "value": self.shard_count - 1 - len(missing)})
        self._merged_trace = {
            "digest": tracing.span_multiset_digest(merged),
            "procs": len(procs),
            "links": links,
            "captured_spans": od.get("captured_spans"),
            "dropped_spans": od.get("dropped_spans"),
            "warnings": list(warnings),
        }
        self.record(
            "trace merged procs=%d resolved=%d unresolved=%d digest=%s"
            % (len(procs), links.get("resolved", 0),
               links.get("unresolved", 0),
               self._merged_trace["digest"][:16]), digest=False)
        # the merged timeline itself lands next to the run's artifacts
        # so `profiler --timeline <tmp>/merged_trace.json` (and the CI
        # obs-fleet-smoke job) can digest exactly what was judged
        try:
            (self.tmp / "merged_trace.json").write_text(
                json.dumps(merged))
        except OSError:
            pass  # diagnostics only; the digest above is the contract

    def _light_storm_counts(self) -> list:
        """(light, distinct storm messages seen) — from the node object
        in-process, from the owning shard's merged counts otherwise."""
        counts = (self.hub.light_counts(STORM_TOPIC)
                  if hasattr(self.hub, "light_counts") else {})
        return [(ln, counts.get(ln.name, ln.storm_seen))
                for ln in self.lights]

    # --- background cadences -------------------------------------------

    async def _heartbeats(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.hub.heartbeat()

    async def _sampling(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.sampler.sample(self._now())

    # --- traffic --------------------------------------------------------

    def _start_traffic(self, traffic: dict) -> list:
        tasks = []
        if "storm" in traffic:
            tasks.append(asyncio.ensure_future(
                self._storm(**traffic["storm"])))
        if "tx_spawn" in traffic:
            tasks.append(asyncio.ensure_future(self._tx_spawn()))
        self._aux_tasks.extend(tasks)
        return tasks

    async def _storm(self, publishers: int = 4, messages: int = 16,
                     interval: float = 0.25, size: int = 200) -> None:
        """Gossip storm from rotating light publishers."""
        if not self.lights:
            return
        for m in range(int(messages)):
            ln = self.lights[(m * 7) % min(publishers, len(self.lights))]
            if self.network.alive(ln.name):
                await ln.pubsub.publish(
                    STORM_TOPIC, storm_payload(self.seed, m, size))
            await asyncio.sleep(interval)

    async def _tx_spawn(self) -> None:
        """Each full node publishes its signer's wallet-spawn tx (valid
        once layer rewards funded the coinbase; duplicates dedup)."""
        from ..p2p.pubsub import TOPIC_TX
        from ..vm import sdk

        for fn in self.fulls:
            if not fn.alive:
                continue
            tx = sdk.spawn_wallet(fn.signer)
            await fn.pubsub.publish(TOPIC_TX, tx.raw)
            # spacecheck: ok=SC001 virtual pacing: 0.1 VIRTUAL seconds between publishes, zero wall cost
            await asyncio.sleep(0.1)

    async def _restart_full(self, spec: dict) -> str:
        """Crash recovery fault: bring a killed full node back over its
        surviving on-disk stores (needs an await for prepare(), so it
        lives here rather than in the sync fault vocabulary)."""
        fn = self.fulls[int(spec["full"])]
        if fn.alive:
            raise faults_mod.FaultError(
                f"restart full={fn.index}: node is alive (kill it first)")
        await fn.restart(self.until_layer)
        # the final phase gathers _run_tasks before judging convergence;
        # the reborn node's run loop must be part of that barrier
        self._run_tasks.append(fn.run_task)
        return "restart full=%d id=%s" % (fn.index, fn.name.hex()[:16])

    def _start_adversary(self, spec: dict) -> str:
        what = spec["what"]
        count = int(spec.get("count", 8))
        via = int(spec.get("via", 0))
        interval = float(spec.get("interval", 0.2))

        async def attack() -> None:
            from ..p2p.pubsub import TOPIC_ATX, TOPIC_HARE

            ln = self.lights[via]
            if what == "malformed_atx":
                for blob in faults_mod.malformed_atx_blobs(self.seed,
                                                           count):
                    await ln.pubsub.publish(TOPIC_ATX, blob)
                    await asyncio.sleep(interval)
            elif what == "torsion_sig":
                for i in range(count):
                    layer = int(self.clock.current_layer())
                    await ln.pubsub.publish(
                        TOPIC_HARE, faults_mod.torsion_hare_message(
                            layer, self.seed + i))
                    await asyncio.sleep(interval)
            elif what == "dup_flood":
                payload = storm_payload(self.seed, 0xD0D0)
                for _ in range(count):
                    await ln.pubsub.publish(STORM_TOPIC, payload)
                    await asyncio.sleep(interval)
            else:
                raise faults_mod.FaultError(
                    f"unknown adversary {what!r}")

        self._aux_tasks.append(asyncio.ensure_future(attack()))
        return "adversary what=%s count=%d via=%d" % (what, count, via)

    # --- condition waits (no sleep-and-hope) ----------------------------

    def _live_fulls(self) -> list[FullNode]:
        return [fn for fn in self.fulls if fn.alive]

    def _convergence(self, frontier: int, from_layer: int | None = None):
        """(ok, detail): every live full node applied the SAME block per
        layer and the SAME state root at the frontier."""
        lo = self.lpe if from_layer is None else from_layer
        live = self._live_fulls()
        if not live:
            return False, "no live full nodes"
        for fn in live:
            if fn.last_applied() < frontier:
                return False, ("full=%d applied=%d < frontier %d"
                               % (fn.index, fn.last_applied(), frontier))
        records = {fn.index: tuple(fn.applied_record(lo, frontier))
                   for fn in live}
        if len(set(records.values())) != 1:
            return False, "applied blocks diverge: %s" % {
                i: [f"{lyr}:{b.hex()[:8]}" for lyr, b in rec]
                for i, rec in records.items()}
        roots = {fn.state_root(frontier) for fn in live}
        if len(roots) != 1 or None in roots:
            return False, "state roots diverge at %d" % frontier
        return True, "converged at %d across %d nodes" % (frontier,
                                                          len(live))

    async def _wait_converged(self, frontier: int,
                              deadline: float = 240.0,
                              from_layer: int | None = None) -> None:
        """Drive until convergence or the VIRTUAL deadline. Syncers are
        driven DIRECTLY (back-to-back passes at a near-frozen virtual
        instant) rather than waiting on their background cadence: every
        idle wait advances the virtual clock, so the tip would otherwise
        outrun a healing node pass for pass. This is a condition wait —
        it returns the moment the predicate holds."""
        t0 = self._now()
        while self._now() - t0 < deadline:
            ok, _ = self._convergence(frontier, from_layer)
            if ok:
                return
            for fn in self._live_fulls():
                try:
                    await fn.app.syncer.synchronize()
                except Exception:  # noqa: BLE001 — next pass retries
                    pass
            # spacecheck: ok=SC001 condition-wait poll cadence in VIRTUAL seconds (the predicate, not the sleep, terminates the wait)
            await asyncio.sleep(0.5)

    # --- assertions -----------------------------------------------------

    def _evaluate(self, pname: str, spec: dict) -> None:
        kind = spec.pop("kind")
        entry = {"phase": pname, "kind": kind, **spec}
        digestable = False
        if kind == "converged":
            ok, detail = self._convergence(
                int(spec["frontier"]), spec.get("from_layer"))
            entry.update(ok=ok, detail=detail)
            digestable = True
        elif kind == "progress":
            live = self._live_fulls()
            applied = {fn.index: fn.last_applied() for fn in live}
            ok = bool(live) and min(applied.values()) >= int(
                spec["min_layer"])
            entry.update(ok=ok, value=applied)
            digestable = True
        elif kind == "sli":
            sspec = self._sli_specs.get(spec["name"])
            value = self.sampler.compute(sspec) if sspec else None
            if value is None:
                ok = not spec.get("required", True)
            else:
                op, target = spec.get("op", "<="), float(spec["target"])
                ok = value <= target if op == "<=" else value >= target
            entry.update(ok=ok, value=value)
        elif kind == "sli_present":
            sspec = self._sli_specs.get(spec["name"])
            value = self.sampler.compute(sspec) if sspec else None
            entry.update(ok=value is not None, value=value)
        elif kind == "slo_green":
            slos = scenario_slos()
            violated = {}
            for slo in slos:
                value = self.sampler.compute(self._sli_specs[slo.sli])
                if value is not None and slo.violated(value):
                    violated[slo.name] = value
            entry.update(ok=not violated, violated=violated)
        elif kind == "span":
            doc = tracing.export() if tracing.is_enabled() else {
                "traceEvents": []}
            n = sum(1 for e in doc["traceEvents"]
                    if e.get("name") == spec["name"]
                    and e.get("ph") in ("X", "B", "i"))
            entry.update(ok=n >= int(spec.get("min", 1)), value=n)
        elif kind == "storm_coverage":
            seen = {ln.name: c for ln, c in self._light_storm_counts()}
            live = [ln for ln in self.lights
                    if self.network.alive(ln.name)]
            got = sum(1 for ln in live if seen.get(ln.name, 0) > 0)
            frac = got / len(live) if live else 0.0
            entry.update(ok=frac >= float(spec.get("min_fraction", 0.9)),
                         value=round(frac, 4))
        elif kind == "hub_stat":
            value = self.hub.stats.get(spec["name"], 0)
            ok = value >= int(spec.get("min", 1))
            if "max" in spec:
                ok = ok and value <= int(spec["max"])
            entry.update(ok=ok, value=value)
        elif kind == "epoch_roots":
            # state-root equality across live fulls at EVERY epoch
            # boundary up to the frontier (the multi-epoch soak gate)
            upto = int(spec.get("upto_layer", self.until_layer - 2))
            live = self._live_fulls()
            boundaries, diverged = [], []
            for lyr in range(self.lpe, upto + 1, self.lpe):
                roots = {fn.state_root(lyr) for fn in live}
                boundaries.append(lyr)
                if len(roots) != 1 or None in roots:
                    diverged.append(lyr)
            ok = bool(live) and bool(boundaries) and not diverged
            entry.update(ok=ok, value={"epoch_layers": boundaries,
                                       "diverged": diverged})
            digestable = True
        else:
            entry.update(ok=False, detail=f"unknown assert kind {kind!r}")
        self.asserts.append(entry)
        if digestable:
            self.record("assert phase=%s kind=%s name=%s ok=%s"
                        % (pname, kind, spec.get("name", ""), entry["ok"]))
        else:
            self.record("assert phase=%s kind=%s ok=%s value=%s"
                        % (pname, kind, entry["ok"],
                           entry.get("value")), digest=False)


def run_scenario(script: dict, *, tmp: Path | None = None,
                 vtimeout: float = 30_000.0, device="cuda") -> ScenarioResult:
    """Build + run one scenario on a fresh VirtualClockLoop, its full
    nodes on ``device``."""
    return ScenarioEngine(script, tmp=tmp, vtimeout=vtimeout,
                          device=device).run()
