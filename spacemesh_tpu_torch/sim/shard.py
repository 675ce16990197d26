"""Multi-process scenario fabric: the event wheel sharded over host
cores with conservative virtual-time windows (port of
``spacemesh_tpu/sim/shard.py``; a worker is ``python -m
spacemesh_tpu_torch.sim.shard`` and imports no torch).

The event fabric (sim/net.py) is event-driven, but one asyncio loop still
serializes every light-relay hop. This module partitions the LIGHT
relays over W-1 worker subprocesses (shard 0 — the parent — keeps the
full nodes, the SimNet, and the engine); each worker runs a synchronous
event wheel like sim/net.py's over its subset, and shards advance together
under the classic conservative PDES contract (Chandy–Misra/Bryant,
barrier-synchronized YAWNS windows): no speculation, no rollback.

**Safe horizon.** Let N be the earliest pending event instant across
all shards and L the per-link delay floor (`SimNetwork.min_delay_floor`
— jitter and reorder only ever ADD delay). Any frame generated at an
instant >= N arrives at >= N + L, so every shard may process the window
[N, N+L) without hearing from anyone. When L == 0 the window degenerates
to the single instant N and same-instant exchange rounds run until the
flood quiesces — correct (zero-lookahead) but chattier, which is why
hostile worlds with a delay floor parallelize best.

**Determinism.** Cross-shard frames carry (instant, seq) tags: each
side assigns sequence numbers from its own deterministic counter, the
parent sorts every incoming batch by (instant, src shard, src seq)
before insertion, and each worker draws link-policy randomness from its
own `random.Random(("simshard", seed, W, shard))` stream in execution
order. Replay with the same (seed, W) is therefore byte-identical;
scenario ASSERTIONS are identical across any W (on loss-free links even
the merged per-light delivery record is W-invariant, because flood
coverage under relay-set forwarding does not depend on arrival order).
W=1 never constructs this class at all — `MeshHub` returns the plain
in-process `EventMeshHub`.

**Transport.** Length-prefixed pickle over the worker's stdin/stdout
pipes. The parent's side runs synchronously inside the
`VirtualClockLoop.time_governor` hook (utils/vclock.py), i.e. while the
loop is idle at a window edge — barrier waits are exactly the wall time
workers spend computing. A worker that dies mid-window surfaces as
:class:`ShardWorkerCrash`, which the scenario engine converts into a
typed failed assertion (never a hang).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import itertools
import os
import pickle
import random
import struct
import subprocess
import sys
from pathlib import Path

from ..core.hashing import sum256
from ..p2p.gossipmesh import SEEN_CAP, mark_seen, relay_sample
from ..utils import metrics, tracing
from .net import EventMeshHub, LinkPolicy, SimNetwork

# obs.federate is imported lazily inside PARENT-side methods only: the
# worker subprocess must stay importable without torch (the obs package
# drags in the health/SLI stack), and workers never touch FEDERATION.

_LEN = struct.Struct("<I")
_INF = float("inf")
_EPS = 1e-9          # instant-comparison tolerance (grid spacing is 1e-6)
_MAX_ROUNDS = 100_000  # runaway-exchange backstop, not a tuning knob


class ShardWorkerCrash(RuntimeError):
    """A shard worker process died mid-run (typed scenario failure).

    Carries the dead worker's last federated snapshot — the metrics
    sample and trace capture it shipped most recently — so the typed
    failure itself holds the forensics (docs/OBSERVABILITY.md § Fleet
    observability). ``None`` when the worker died before its first
    snapshot."""

    def __init__(self, shard: int, detail: str = "",
                 last_metrics=None, last_spans=None):
        self.shard = shard
        self.last_metrics = last_metrics
        self.last_spans = last_spans
        msg = f"sim shard worker {shard} crashed"
        super().__init__(msg + (f": {detail}" if detail else ""))


def resolve_shards(spec, n_light: int) -> int:
    """Resolve a scenario's ``shards`` spec to a worker-process count W.

    ``SPACEMESH_SIM_SHARDS`` overrides the script. ``"auto"`` picks
    ``min(host cores, n_light // 64)``; an explicit integer is honored
    (tests force W=4 on small hosts). W is clamped so every worker owns
    at least one light — with too few lights W collapses to 1 (the
    plain in-process fabric)."""
    env = os.environ.get("SPACEMESH_SIM_SHARDS", "").strip()
    if env:
        spec = env
    if spec in (None, "", 0, "0", 1, "1"):
        return 1
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover — non-linux
        cores = os.cpu_count() or 1
    if isinstance(spec, str) and spec.strip().lower() == "auto":
        w = min(cores, n_light // 64)
    else:
        w = int(spec)
    if w > 1:
        w = min(w, n_light + 1)   # >= 1 light per worker shard
    return max(1, w)


# --- pipe framing ------------------------------------------------------


def _write_msg(fp, obj) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    fp.write(_LEN.pack(len(blob)))
    fp.write(blob)
    fp.flush()


def _read_msg(fp):
    hdr = fp.read(4)
    if len(hdr) < 4:
        raise EOFError("shard pipe closed")
    n = _LEN.unpack(hdr)[0]
    blob = fp.read(n)
    if len(blob) < n:
        raise EOFError("shard pipe truncated")
    return pickle.loads(blob)


# --- the worker (subprocess side) --------------------------------------


_STATS_KEYS = ("published", "delivered", "dup", "rejected", "relayed",
               "dropped", "events_scheduled", "events_fired")


class ShardWorker:
    """Synchronous event-wheel processor over one shard's light relays.

    Owns a deterministic replica of the parent's SimNetwork (topology
    snapshot at spawn + replayed fault ops), per-node seen caches, and
    its own link-policy RNG stream. Only ever advances when granted a
    horizon by the parent, so it can never observe the future."""

    def __init__(self, snap: dict):
        self.shard = int(snap["shard"])
        self.shards = int(snap["shards"])
        self.gossip_degree = int(snap["gossip_degree"])
        net = SimNetwork(snap["seed"], degree=snap["degree"])
        for name in snap["names"]:
            net.add_node(name)
        for name, peers in snap["adj"].items():
            net.adj[name] = set(peers)
        net.group.update(snap["group"])
        net.down = set(snap["down"])
        net.eclipsed = {k: frozenset(v)
                        for k, v in snap["eclipsed"].items()}
        net.blocked = {frozenset(pair) for pair in snap["blocked"]}
        net.default_policy = LinkPolicy(**snap["default_policy"])
        net.link_policy = {frozenset(pair): LinkPolicy(**pol)
                           for pair, pol in snap["link_policy"]}
        net._bump_epoch()
        self.net = net
        self.shard_of: dict[bytes, int] = snap["shard_of"]
        self.rng = random.Random(
            ("simshard", snap["seed"], self.shards, self.shard).__repr__())
        self.seen = {name: {} for name in snap["owned"]}
        self.gen = {name: 1 for name in snap["owned"]}
        self.counts: dict[tuple, int] = collections.defaultdict(int)
        self.wheel: list[tuple] = []   # (instant, seq, dst, gen, item)
        self._seq = itertools.count()
        self._out_seq = itertools.count()
        self.out: list[tuple] = []     # (arrival, seq, dst, item)
        self.now = 0.0
        self._relay_cache: dict[tuple, tuple] = {}
        self.stats = dict.fromkeys(_STATS_KEYS, 0)
        self.runs = 0
        self.fed_every = int(snap.get("fed_every", 128))
        if snap.get("trace"):
            # worker-side capture: virtual-time spans in this worker's
            # own ring, shipped to the parent's federation plane.
            # Identity is set ONLY here — an in-process ShardWorker
            # (unit tests) must not rename the host process.
            tracing.set_process_identity(f"shard-{self.shard}",
                                         clock_domain="virtual")
            tracing.TRACER.start(capacity=snap.get("trace_capacity"),
                                 torch_bridge=False)

    # -- fault-op replay (parent order == apply order) --

    def apply_op(self, op: tuple) -> None:
        kind = op[0]
        if kind == "publish":
            instant, name, topic, data = op[1:5]
            token = op[5] if len(op) > 5 else None
            heapq.heappush(self.wheel, (instant, next(self._seq), name,
                                        self.gen.get(name, 0),
                                        ("pub", topic, data, token)))
            self.stats["events_scheduled"] += 1
        elif kind == "churn":
            name = op[1]
            if name in self.gen:
                self.gen[name] += 1
        elif kind == "set_link_policy":
            _, pol, a, b = op
            self.net.set_link_policy(LinkPolicy(**pol), a, b)
        elif kind == "partition":
            self.net.partition(op[1])
        elif kind == "heal":
            self.net.heal()
        elif kind == "eclipse":
            self.net.eclipse(op[1], op[2])
        elif kind == "clear_eclipse":
            self.net.clear_eclipse(op[1])
        elif kind == "block_link":
            self.net.block_link(op[1], op[2])
        elif kind == "unblock_link":
            self.net.unblock_link(op[1], op[2])
        elif kind == "set_down":
            self.net.set_down(op[1], op[2])
        else:
            raise ValueError(f"unknown shard op {kind!r}")

    # -- the granted-horizon run --

    def run(self, upto: float, inclusive: bool, ops: list,
            frames: list) -> tuple:
        for op in ops:
            self.apply_op(op)
        for instant, dst, item in frames:
            heapq.heappush(self.wheel, (instant, next(self._seq), dst,
                                        self.gen.get(dst, 0), item))
            self.stats["events_scheduled"] += 1
        lim = upto + _EPS if inclusive else upto - _EPS
        wheel = self.wheel
        fired0 = self.stats["events_fired"]
        wstart = None
        while wheel and wheel[0][0] <= lim:
            instant, _, dst, gen, item = heapq.heappop(wheel)
            self.stats["events_fired"] += 1
            if wstart is None:
                wstart = instant
            self.now = instant
            if self.gen.get(dst) != gen:
                self.stats["dropped"] += 1   # churned while in flight
                continue
            kind = item[0]
            if kind == "pub":
                self._publish(dst, item[1], item[2],
                              item[3] if len(item) > 3 else None)
            elif kind == "msg":
                self._on_msg(dst, item[1], item[2])
            # "ctrl": light relays run no control plane — dropped, same
            # as EventMeshHub._on_ctrl's light short-circuit
        fired = self.stats["events_fired"] - fired0
        if fired and tracing.TRACER.enabled:
            # one span per non-empty granted window, stamped in VIRTUAL
            # microseconds — all wheels share one virtual clock, so the
            # merged timeline aligns exactly across shards
            ts0 = int(wstart * 1e6)
            tracing.TRACER._record(
                "shard.window", "sim", ts0,
                max(int(self.now * 1e6) - ts0, 0),
                next(tracing.TRACER._ids), None, {"fired": fired}, "X")
        out, self.out = self.out, []
        nxt = wheel[0][0] if wheel else _INF
        return nxt, out

    # -- light-relay semantics (mirror of EventMeshHub's light path) --

    def _publish(self, name: bytes, topic: str, data: bytes,
                 token: str | None = None) -> None:
        msg_id = sum256(topic.encode(), data)
        mark_seen(self.seen[name], msg_id, SEEN_CAP)
        self.stats["published"] += 1
        if tracing.TRACER.enabled:
            attrs: dict = {"topic": topic}
            if token:
                # the parent's fabric.publish link token — resolved to a
                # cross-process parent edge by merge_captures()
                attrs["link"] = token
            tracing.TRACER._record(
                "shard.publish", "sim", int(self.now * 1e6), 0,
                next(tracing.TRACER._ids), None, attrs, "X")
        frame = (topic, msg_id, data)
        for dst in self._relay_targets(name, topic):
            self._send(name, dst, ("msg", name, frame))

    def _on_msg(self, name: bytes, src: bytes, frame: tuple) -> None:
        topic, msg_id, data = frame
        if not mark_seen(self.seen[name], msg_id, SEEN_CAP):
            self.stats["dup"] += 1
            return
        # a light relay's handler set accepts every topic (PubSub
        # returns True with no handlers) — count and relay
        self.counts[(name, topic)] += 1
        self.stats["delivered"] += 1
        for dst in self._relay_targets(name, topic, exclude=src):
            self.stats["relayed"] += 1
            self._send(name, dst, ("msg", name, frame))

    def _relay_targets(self, name: bytes, topic: str,
                       exclude: bytes | None = None):
        key = (name, topic)
        ent = self._relay_cache.get(key)
        if ent is None or ent[0] != self.net.epoch:
            ent = (self.net.epoch,
                   relay_sample(topic, name, self.net.neighbors(name),
                                self.gossip_degree))
            self._relay_cache[key] = ent
        if exclude is None:
            return ent[1]
        return [p for p in ent[1] if p != exclude]

    def _send(self, src: bytes, dst: bytes, item: tuple) -> None:
        net = self.net
        if not net.reachable(src, dst):
            self.stats["dropped"] += 1
            net.stats["blocked"] += 1
            return
        pol = net.policy(src, dst)
        rng = self.rng
        copies = 1
        if pol.loss and rng.random() < pol.loss:
            net.stats["loss"] += 1
            return
        if pol.dup and rng.random() < pol.dup:
            net.stats["dup"] += 1
            copies = 2
        for _ in range(copies):
            delay = pol.delay
            if pol.jitter:
                delay += rng.random() * pol.jitter
            if pol.reorder and rng.random() < pol.reorder:
                net.stats["reorder"] += 1
                delay += pol.reorder_delay
            arrival = self.now + delay
            if self.shard_of.get(dst, 0) == self.shard:
                heapq.heappush(self.wheel,
                               (arrival, next(self._seq), dst,
                                self.gen.get(dst, 0), item))
                self.stats["events_scheduled"] += 1
            else:
                self.out.append((arrival, next(self._out_seq), dst, item))

    # -- federation snapshots (docs/OBSERVABILITY.md § Fleet obs) --

    def fed_snapshot(self) -> dict:
        """This worker's full registry sample + trace capture, shipped
        over the pipe for the parent's ``obs.federate`` plane."""
        for k, v in self.stats.items():
            metrics.sim_shard_worker_stats.set(
                float(v), shard=str(self.shard), stat=k)
        return {
            "metrics": metrics.REGISTRY.sample(),
            "trace": tracing.export() if tracing.TRACER.enabled else None,
        }

    def maybe_fed(self) -> dict | None:
        """Periodic snapshot piggybacked on run replies — the FIRST
        window always ships one, so a worker that crashes early still
        leaves last-known forensics behind, then every ``fed_every``
        windows after that."""
        self.runs += 1
        if self.runs == 1 or self.runs % self.fed_every == 0:
            return self.fed_snapshot()
        return None


def worker_main() -> int:   # pragma: no cover — exercised via subprocess
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    try:
        tag, snap = _read_msg(stdin)
        if tag != "init":
            return 2
        w = ShardWorker(snap)
        _write_msg(stdout, ("ready", w.shard))
        while True:
            msg = _read_msg(stdin)
            kind = msg[0]
            if kind == "run":
                _, upto, inclusive, ops, frames = msg
                nxt, out = w.run(upto, inclusive, ops, frames)
                _write_msg(stdout, ("done", nxt, out, w.maybe_fed()))
            elif kind == "counts":
                topic = msg[1]
                _write_msg(stdout, ("counts", {
                    name: c for (name, t), c in w.counts.items()
                    if t == topic}))
            elif kind == "finalize":
                _write_msg(stdout, ("final", dict(w.stats),
                                    dict(w.counts), dict(w.net.stats),
                                    w.fed_snapshot()))
            elif kind == "exit":
                return 0
            else:
                return 2
    except EOFError:
        return 0


# --- the parent hub ----------------------------------------------------


class _Worker:
    __slots__ = ("shard", "proc", "next", "ops_cursor", "pending",
                 "last_fed")

    def __init__(self, shard: int, proc):
        self.shard = shard
        self.proc = proc
        self.next = _INF          # earliest pending instant, as reported
        self.ops_cursor = 0       # index into the hub's fault-op log
        self.pending: list = []   # frames awaiting flush (arrival, seq, dst, item)
        self.last_fed = None      # last federated snapshot (crash forensics)


class ShardedMeshHub(EventMeshHub):
    """Shard-0 hub: the parent's EventMeshHub over the full nodes, plus
    the conservative-window exchange plane for W-1 light-relay workers.

    The engine attaches :meth:`governor` as the VirtualClockLoop's
    ``time_governor``; every idle clock jump first settles the current
    instant across shards, then advances to the next safe horizon."""

    def __init__(self, network: SimNetwork, *, gossip_degree: int = 4,
                 shards: int = 2):
        super().__init__(network, gossip_degree=gossip_degree)
        self.shards = max(2, int(shards))
        self._shard_of: dict[bytes, int] = {}
        self._owned: dict[int, list[bytes]] = {
            s: [] for s in range(1, self.shards)}
        self._light_join_idx = 0
        self._workers: list[_Worker] = []
        self._ops_log: list[tuple] = []
        self._out_seq = itertools.count()
        self._spawned = False
        self._crashed: ShardWorkerCrash | None = None
        self._counts: dict[tuple, int] = {}
        self._final: list | None = None
        self.barrier_rounds = 0
        self.fed_every = 128      # worker snapshot cadence (windows)
        self.worker_captures: dict[str, dict] = {}
        network.listener = self._on_net_mutation

    # -- membership: lights round-robin onto workers by join index --

    def join(self, ps, *, light: bool = False) -> None:
        if not light:
            return super().join(ps)
        name = ps.name
        shard = 1 + self._light_join_idx % (self.shards - 1)
        self._light_join_idx += 1
        ps._hub = self
        self.network.add_node(name)
        self._shard_of[name] = shard
        self._owned[shard].append(name)

    def suspend(self, name: bytes) -> None:
        shard = self._shard_of.get(name, 0)
        if shard == 0:
            return super().suspend(name)
        self._ops_log.append(("churn", name))
        self.network.set_down(name, True)   # listener logs the set_down

    def resume(self, name: bytes) -> None:
        if self._shard_of.get(name, 0) == 0:
            return super().resume(name)
        self.network.set_down(name, False)

    # -- fault mirror --

    def _on_net_mutation(self, method: str, args: tuple) -> None:
        self._ops_log.append((method, *args))

    # -- data plane: remote publishers and cross-shard sends --

    async def broadcast(self, sender, topic: str, data: bytes) -> None:
        name = sender.name
        if self._shard_of.get(name, 0) == 0:
            return await super().broadcast(sender, topic, data)
        if not self.network.alive(name):
            return
        loop = asyncio.get_running_loop()
        # the publish op carries a link token so the worker's
        # shard.publish span can parent to this fabric.publish span
        # across the process boundary (merge_captures resolves it)
        with tracing.span("fabric.publish", {"topic": topic}, cat="sim"):
            token = tracing.link_token()
        # spacecheck: ok=SC001 virtual publish instant from the engine's VirtualClockLoop
        self._ops_log.append(("publish", loop.time(), name, topic, data,
                              token))

    def _send(self, src: bytes, dst: bytes, item: tuple) -> None:
        shard = self._shard_of.get(dst, 0)
        if shard == 0:
            return super()._send(src, dst, item)
        net = self.network
        if not net.reachable(src, dst):
            self.stats["dropped"] += 1
            net.stats["blocked"] += 1
            return
        # same draw order as the in-process path: the parent draws for
        # frames its OWN nodes originate; workers draw for theirs
        pol = net.policy(src, dst)
        rng = net.rng
        copies = 1
        if pol.loss and rng.random() < pol.loss:
            net.stats["loss"] += 1
            return
        if pol.dup and rng.random() < pol.dup:
            net.stats["dup"] += 1
            copies = 2
        # spacecheck: ok=SC001 frame instants share the engine's virtual-clock timebase
        now = asyncio.get_running_loop().time()
        w = self._workers[shard - 1] if self._spawned else None
        for _ in range(copies):
            delay = pol.delay
            if pol.jitter:
                delay += rng.random() * pol.jitter
            if pol.reorder and rng.random() < pol.reorder:
                net.stats["reorder"] += 1
                delay += pol.reorder_delay
            entry = (now + delay, next(self._out_seq), dst, item)
            if w is not None:
                w.pending.append(entry)
            else:
                self._prespawn_pending(shard, entry)

    def _prespawn_pending(self, shard: int, entry: tuple) -> None:
        # sends before the first window (none in practice — the first
        # publish happens well after boot) are held per shard
        buf = getattr(self, "_prespawn", None)
        if buf is None:
            buf = self._prespawn = {}
        buf.setdefault(shard, []).append(entry)

    # -- worker lifecycle --

    def _spawn(self) -> None:
        self._spawned = True
        net = self.network
        common = dict(
            seed=net.seed, degree=net.degree, shards=self.shards,
            gossip_degree=self.gossip_degree,
            names=list(net.names),
            adj={n: sorted(ps) for n, ps in net.adj.items()},
            group=dict(net.group),
            down=sorted(net.down),
            eclipsed={k: sorted(v) for k, v in net.eclipsed.items()},
            blocked=[sorted(pair) for pair in net.blocked],
            default_policy=dataclasses.asdict(net.default_policy),
            link_policy=[(sorted(pair), dataclasses.asdict(pol))
                         for pair, pol in net.link_policy.items()],
            shard_of=dict(self._shard_of),
            trace=tracing.TRACER.enabled,
            trace_capacity=tracing.TRACER.capacity,
            fed_every=self.fed_every,
        )
        # the snapshot covers every NETWORK mutation so far, so those ops
        # must not be applied twice — but publish ops are data, not
        # topology: a publish logged before the first idle point (and
        # hence before the lazy spawn) still has to reach its worker
        self._ops_log = [op for op in self._ops_log if op[0] == "publish"]
        root = Path(__file__).resolve().parents[2]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + ([env["PYTHONPATH"]]
                           if env.get("PYTHONPATH") else []))
        for s in range(1, self.shards):
            proc = subprocess.Popen(
                [sys.executable, "-m", "spacemesh_tpu_torch.sim.shard"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
            w = _Worker(s, proc)
            self._workers.append(w)
            self._ssend(w, ("init", dict(common, shard=s,
                                         owned=list(self._owned[s]))))
        for w in self._workers:
            tag, shard = self._recv(w)
            if tag != "ready" or shard != w.shard:
                raise ShardWorkerCrash(w.shard, "bad init handshake")
        pre = getattr(self, "_prespawn", None)
        if pre:
            for s, entries in pre.items():
                self._workers[s - 1].pending.extend(entries)
            self._prespawn = {}

    def close(self) -> None:
        """Terminate every worker (engine teardown; idempotent). Clean
        workers' federated ``proc=`` series are dropped here — the
        cardinality-hygiene half of the federation contract — while a
        CRASHED worker's snapshot stays retained and flagged."""
        self.network.listener = None
        workers, self._workers = self._workers, []
        if workers:
            from ..obs.federate import FEDERATION
            crashed = (self._crashed.shard
                       if self._crashed is not None else None)
            for w in workers:
                if w.shard != crashed:
                    FEDERATION.drop(f"shard-{w.shard}")
        for w in workers:
            try:
                _write_msg(w.proc.stdin, ("exit",))
                w.proc.stdin.close()
            except OSError:
                pass
        for w in workers:
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:   # pragma: no cover
                w.proc.kill()
                w.proc.wait()

    # -- pipe helpers with typed crash translation --

    def _crash(self, w: _Worker, detail: str) -> ShardWorkerCrash:
        """Build the typed crash carrying the dead worker's last
        federated snapshot, and flag (not drop) its federation entry."""
        fed = w.last_fed or {}
        from ..obs.federate import FEDERATION
        FEDERATION.mark_crashed(f"shard-{w.shard}")
        self._crashed = ShardWorkerCrash(
            w.shard, detail,
            last_metrics=fed.get("metrics"),
            last_spans=fed.get("trace"))
        return self._crashed

    def _federate(self, w: _Worker, fed: dict | None) -> None:
        if fed is None:
            return
        w.last_fed = fed
        from ..obs.federate import FEDERATION
        FEDERATION.update_from_samples(
            f"shard-{w.shard}", fed["metrics"], trace=fed.get("trace"))

    def _ssend(self, w: _Worker, msg: tuple) -> None:
        try:
            _write_msg(w.proc.stdin, msg)
        except (OSError, ValueError) as e:
            raise self._crash(w, repr(e)) from None

    def _recv(self, w: _Worker):
        try:
            return _read_msg(w.proc.stdout)
        except (EOFError, OSError) as e:
            raise self._crash(w, repr(e)) from None

    # -- the conservative-window exchange plane --

    def _wnext(self, w: _Worker) -> float:
        nxt = w.next
        if w.pending:
            nxt = min(nxt, min(p[0] for p in w.pending))
        return nxt

    def _flush_and_run(self, need: list, upto: float,
                       inclusive: bool) -> bool:
        """One exchange round: grant ``need`` the horizon, route what
        comes back. Returns True if a frame landed on the PARENT wheel
        at or before ``upto`` (same-instant work to process)."""
        self.barrier_rounds += 1
        metrics.sim_shard_barrier_waits.inc()
        for w in need:
            ops = self._ops_log[w.ops_cursor:]
            w.ops_cursor = len(self._ops_log)
            frames = [(a, dst, item)
                      for a, _, dst, item in sorted(w.pending)]
            w.pending = []
            self._ssend(w, ("run", upto, inclusive, ops, frames))
        local_new = False
        for w in need:
            tag, nxt, out, fed = self._recv(w)
            if tag != "done":
                raise ShardWorkerCrash(w.shard, f"bad reply {tag!r}")
            self._federate(w, fed)
            w.next = nxt
            for arrival, _, dst, item in sorted(out):
                dshard = self._shard_of.get(dst, 0)
                if dshard == 0:
                    self._schedule_at(arrival, dst, item)
                    if arrival <= upto + _EPS and inclusive:
                        local_new = True
                else:
                    self._workers[dshard - 1].pending.append(
                        (arrival, next(self._out_seq), dst, item))
        return local_new

    def _settle(self, now: float) -> bool:
        """Drive every shard through the current instant: flush pending
        ops/frames and run same-instant exchange rounds until no frame
        at <= now remains anywhere. Returns True if the PARENT received
        same-instant work (the caller must let the loop run it before
        advancing time)."""
        local_new = False
        for _ in range(_MAX_ROUNDS):
            need = [w for w in self._workers
                    if w.pending or w.ops_cursor < len(self._ops_log)
                    or w.next <= now + _EPS]
            if not need:
                return local_new
            local_new |= self._flush_and_run(need, now, True)
        raise RuntimeError("sim shard settlement did not quiesce")

    def _run_window(self, horizon: float) -> None:
        """Grant every lagging worker the safe window [*, horizon):
        lookahead guarantees everything generated inside arrives at or
        after the horizon, so one round suffices unless ops trickle."""
        for _ in range(_MAX_ROUNDS):
            need = [w for w in self._workers
                    if w.ops_cursor < len(self._ops_log)
                    or self._wnext(w) < horizon - _EPS]
            if not need:
                return
            self._flush_and_run(need, horizon, False)
        raise RuntimeError("sim shard window did not quiesce")

    def governor(self, now: float, proposed: float | None):
        """VirtualClockLoop.time_governor hook — returns the next
        virtual instant the parent may advance to."""
        if self._crashed is not None:
            raise self._crashed
        if not self._spawned:
            self._spawn()
        if self._settle(now):
            return now    # same-instant frames landed: process first
        cap = _INF if proposed is None else proposed
        nxt = min((self._wnext(w) for w in self._workers), default=_INF)
        if nxt < cap:
            lookahead = self.network.min_delay_floor()
            if lookahead > 0.0:
                self._run_window(nxt + lookahead)
                nxt = min((self._wnext(w) for w in self._workers),
                          default=_INF)
            # lookahead 0: advance to nxt; settle() there runs the
            # zero-delay exchange rounds at that single instant
        target = min(cap, nxt, self._timer_due)
        return None if target == _INF else target

    async def drain(self) -> None:
        """Quiesce the WHOLE fabric at the current instant: parent
        drainers, worker wheels, and the same-instant relay chains that
        bounce between them (light -> full -> light needs the parent
        loop to run between exchange rounds)."""
        loop = asyncio.get_running_loop()
        for _ in range(_MAX_ROUNDS):
            await super().drain()
            # spacecheck: ok=SC001 exchange rounds settle AT the engine's current virtual instant
            if self._spawned and self._settle(loop.time()):
                await asyncio.sleep(0)   # fire the just-landed frames
                continue
            # spacecheck: ok=SC001 due-frame check against the same virtual clock the wheel is keyed on
            if self._wheel and self._wheel[0][0] <= loop.time() + _EPS:
                await asyncio.sleep(0)   # due parent frames not yet fired
                continue
            return
        raise RuntimeError("sim shard drain did not quiesce")

    # -- merge plane: counts, stats, metrics --

    def light_counts(self, topic: str) -> dict:
        """Merged per-light delivery counts for one topic (distinct
        messages seen — arrival-order invariant)."""
        if self._final is not None or not self._spawned:
            return {name: c for (name, t), c in self._counts.items()
                    if t == topic}
        # spacecheck: ok=SC001 engine-owned VirtualClockLoop instant
        self._settle(asyncio.get_running_loop().time())
        out: dict = {}
        for w in self._workers:
            self._ssend(w, ("counts", topic))
        for w in self._workers:
            tag, d = self._recv(w)
            if tag != "counts":
                raise ShardWorkerCrash(w.shard, f"bad reply {tag!r}")
            out.update(d)
        return out

    def finalize(self) -> None:
        """Drain every shard through the current instant, then merge
        worker stats/counts into the parent's (idempotent; the engine
        calls this before recording the merged event record)."""
        if self._final is not None or not self._spawned:
            self._final = self._final or []
            return
        # spacecheck: ok=SC001 engine-owned VirtualClockLoop instant
        self._settle(asyncio.get_running_loop().time())
        self._final = []
        fired = [self.stats["events_fired"]]
        for w in self._workers:
            self._ssend(w, ("finalize",))
        for w in self._workers:
            tag, stats, counts, netstats, fed = self._recv(w)
            if tag != "final":
                raise ShardWorkerCrash(w.shard, f"bad reply {tag!r}")
            self._federate(w, fed)
            if fed and fed.get("trace") is not None:
                self.worker_captures[f"shard-{w.shard}"] = fed["trace"]
            self._final.append((w.shard, stats))
            fired.append(stats["events_fired"])
            for k, v in stats.items():
                self.stats[k] = self.stats.get(k, 0) + v
            for k, v in netstats.items():
                self.network.stats[k] = self.network.stats.get(k, 0) + v
            for key, c in counts.items():
                self._counts[key] = self._counts.get(key, 0) + c
            metrics.sim_shard_events.inc(stats["events_fired"],
                                         shard=str(w.shard), kind="fired")
        metrics.sim_shard_events.inc(fired[0], shard="0", kind="fired")
        top = max(fired)
        metrics.sim_shard_imbalance.set(
            (top - min(fired)) / top if top else 0.0)


if __name__ == "__main__":   # pragma: no cover — the worker entry point
    sys.exit(worker_main())
