"""Simulated network: topology, fault state, gossip hub, req/resp (port
of ``spacemesh_tpu/sim/net.py``, whole; it imports no torch).

One :class:`SimNetwork` owns the ground truth the fault-injection layer
mutates — the scenario engine's scripted faults are all method calls
here, the in-proc analogue of the reference's systest chaos tooling
(iptables partitions, systest/chaos/partition.go) and of the transport's
own ``Host.chaos_block`` hooks:

* **topology**: a seeded ring+chords graph of degree ~k — gossip frames
  only travel along edges, so a partition really separates islands;
* **partition groups / eclipse / blocked links / downed nodes** decide
  :meth:`SimNetwork.reachable`;
* **link policies** (loss, delay, jitter, duplication, reorder) apply
  per send with the network's seeded RNG — deterministic on the virtual
  clock, every delayed delivery lands at an exact virtual instant.

Reachability, neighbor sets, and link policies are memoized behind a
**fault epoch**: every fault mutator bumps :attr:`SimNetwork.epoch` and
clears the caches, so the per-frame path between faults is dict lookups
(storm-256 resolved ``reachable`` 2.3M times; almost all of them hit).

Two hub fabrics implement the pubsub surface (``PubSub._hub``), both
running the gossipsub-lite control plane of p2p/gossipmesh.py for mesh
nodes:

* :class:`EventMeshHub` (default) — a single virtual-time **event
  wheel** (calendar queue keyed on delivery instants, ties broken by
  (instant, seq)) plus per-node inbox deques drained by on-demand
  tasks: a node with an empty inbox costs zero. Light relays skip the
  control plane entirely — they forward along deterministic sparse
  per-topic relay sets — and ``heartbeat()`` only visits the dirty set
  of mesh nodes with pending GRAFT/PRUNE/IHAVE work. Cost scales with
  edges that matter, not population.
* :class:`LegacyMeshHub` — the original one-consumer-task-per-node hub,
  kept behind ``SPACEMESH_SIM_FABRIC=legacy`` as the bench baseline for
  the ``sim_fabric_events_per_sec`` vs_legacy ratio.

:class:`SimNet` is the req/resp surface (``Server._net``); requests may
reach any live peer in the same partition group (the real transport
dials any learned address, so adjacency does not constrain req/resp).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import itertools
import os
import random
from typing import Iterable, Optional

from ..p2p.gossipmesh import (
    IHAVE,
    SEEN_CAP,
    GossipMesh,
    encode_ctrl,
    mark_seen,
    relay_sample,
)
from ..p2p.server import RequestError, Server
from ..utils import metrics


@dataclasses.dataclass
class LinkPolicy:
    """Per-link degradation; probabilities in [0,1], delays in virtual
    seconds. ``reorder`` is the probability a frame takes an extra
    ``reorder_delay`` detour — later frames overtake it."""

    loss: float = 0.0
    delay: float = 0.0
    jitter: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    reorder_delay: float = 0.5


class SimNetwork:
    """Topology + fault ground truth shared by MeshHub and SimNet.

    All read paths (:meth:`reachable`, :meth:`neighbors`,
    :meth:`policy`) memoize per fault epoch: any mutator bumps
    :attr:`epoch` and clears the memos, so between faults every lookup
    is O(1) no matter how hostile the world is."""

    def __init__(self, seed: int, *, degree: int = 6):
        self.seed = int(seed)
        self.degree = int(degree)
        self.rng = random.Random(("simnet", self.seed).__repr__())
        self.names: list[bytes] = []        # join order (deterministic)
        self.adj: dict[bytes, set[bytes]] = {}
        self.group: dict[bytes, int] = {}
        self.eclipsed: dict[bytes, frozenset] = {}
        self.blocked: set[frozenset] = set()
        self.down: set[bytes] = set()
        self.default_policy = LinkPolicy()
        self.link_policy: dict[frozenset, LinkPolicy] = {}
        self.stats = {"loss": 0, "dup": 0, "reorder": 0, "blocked": 0}
        self.epoch = 0
        self.cache_stats = {"hit": 0, "miss": 0}
        self._reach_cache: dict[tuple[bytes, bytes], bool] = {}
        self._nbr_cache: dict[bytes, frozenset] = {}
        self._pol_cache: dict[tuple[bytes, bytes], LinkPolicy] = {}
        # Optional fault-mutation listener (sim/shard.py): called as
        # listener(method_name, args_tuple) AFTER each mutator applies,
        # so shard workers can replay the mutation on their replica
        # SimNetwork at the same virtual instant.
        self.listener = None

    def _bump_epoch(self) -> None:
        self.epoch += 1
        self._reach_cache.clear()
        self._nbr_cache.clear()
        self._pol_cache.clear()

    def _notify(self, method: str, args: tuple) -> None:
        if self.listener is not None:
            self.listener(method, args)

    def min_delay_floor(self) -> float:
        """Conservative cross-shard lookahead: the smallest delay any
        link policy currently in force could apply to a frame. Jitter
        and reorder only ADD delay, so ``delay`` itself is the floor."""
        floor = self.default_policy.delay
        for pol in self.link_policy.values():
            floor = min(floor, pol.delay)
        return max(0.0, floor)

    # --- membership / topology ---------------------------------------

    def add_node(self, name: bytes) -> None:
        if name in self.adj:
            return
        self.names.append(name)
        self.adj[name] = set()
        self.group.setdefault(name, 0)
        self._bump_epoch()

    def build_topology(self, degree: int | None = None) -> None:
        """Ring (connectivity guarantee) + seeded random chords up to
        ~``degree`` per node. Deterministic for a given (seed, join
        order)."""
        k = degree if degree is not None else self.degree
        n = len(self.names)
        for s in self.adj.values():
            s.clear()
        self._bump_epoch()
        if n <= 1:
            return
        for i, a in enumerate(self.names):
            b = self.names[(i + 1) % n]
            self._connect(a, b)
        rng = random.Random(("topology", self.seed).__repr__())
        for a in self.names:
            tries = 0
            while len(self.adj[a]) < k and tries < 8 * k:
                tries += 1
                b = self.names[rng.randrange(n)]
                if b == a or b in self.adj[a] or len(self.adj[b]) >= k + 2:
                    continue
                self._connect(a, b)

    def _connect(self, a: bytes, b: bytes) -> None:
        self.adj[a].add(b)
        self.adj[b].add(a)

    # --- reachability -------------------------------------------------

    def alive(self, name: bytes) -> bool:
        return name in self.adj and name not in self.down

    def reachable(self, a: bytes, b: bytes) -> bool:
        """May a and b exchange ANY traffic right now (req/resp or a
        gossip edge, if one exists)? Memoized per fault epoch —
        reachability is symmetric, so one resolve fills both
        directions."""
        r = self._reach_cache.get((a, b))
        if r is not None:
            self.cache_stats["hit"] += 1
            return r
        self.cache_stats["miss"] += 1
        r = self._reachable(a, b)
        self._reach_cache[(a, b)] = r
        self._reach_cache[(b, a)] = r
        return r

    def _reachable(self, a: bytes, b: bytes) -> bool:
        if a == b:
            return False
        if not self.alive(a) or not self.alive(b):
            return False
        if frozenset((a, b)) in self.blocked:
            return False
        if self.group.get(a, 0) != self.group.get(b, 0):
            return False
        ea, eb = self.eclipsed.get(a), self.eclipsed.get(b)
        if ea is not None and b not in ea:
            return False
        if eb is not None and a not in eb:
            return False
        return True

    def neighbors(self, name: bytes) -> frozenset:
        """Gossip-edge peers usable right now (memoized per epoch)."""
        nbrs = self._nbr_cache.get(name)
        if nbrs is not None:
            self.cache_stats["hit"] += 1
            return nbrs
        self.cache_stats["miss"] += 1
        if not self.alive(name):
            nbrs = frozenset()
        else:
            nbrs = frozenset(p for p in self.adj.get(name, ())
                             if self.reachable(name, p))
        self._nbr_cache[name] = nbrs
        return nbrs

    def policy(self, a: bytes, b: bytes) -> LinkPolicy:
        pol = self._pol_cache.get((a, b))
        if pol is None:
            pol = self.link_policy.get(frozenset((a, b)),
                                       self.default_policy)
            self._pol_cache[(a, b)] = pol
            self._pol_cache[(b, a)] = pol
        return pol

    # --- the fault vocabulary ----------------------------------------

    def partition(self, groups: Iterable[Iterable[bytes]]) -> None:
        """Split the net: listed groups get ids 1..n, everyone else
        stays in group 0 (so an unlisted bulk forms its own island
        exactly when some nodes ARE listed)."""
        groups = [list(members) for members in groups]
        for name in self.group:
            self.group[name] = 0
        for gid, members in enumerate(groups, start=1):
            for name in members:
                self.group[name] = gid
        self._bump_epoch()
        self._notify("partition", (groups,))

    def heal(self) -> None:
        """Clear partitions, eclipses, and blocked links (downed nodes
        stay down — churn is a separate fault)."""
        for name in self.group:
            self.group[name] = 0
        self.eclipsed.clear()
        self.blocked.clear()
        self._bump_epoch()
        self._notify("heal", ())

    def eclipse(self, victim: bytes, allowed: Iterable[bytes]) -> None:
        """The victim may only talk to ``allowed`` (its attackers)."""
        self.eclipsed[victim] = frozenset(allowed)
        self._bump_epoch()
        self._notify("eclipse", (victim, sorted(self.eclipsed[victim])))

    def clear_eclipse(self, victim: bytes) -> None:
        self.eclipsed.pop(victim, None)
        self._bump_epoch()
        self._notify("clear_eclipse", (victim,))

    def block_link(self, a: bytes, b: bytes) -> None:
        self.blocked.add(frozenset((a, b)))
        self._bump_epoch()
        self._notify("block_link", (a, b))

    def unblock_link(self, a: bytes, b: bytes) -> None:
        self.blocked.discard(frozenset((a, b)))
        self._bump_epoch()
        self._notify("unblock_link", (a, b))

    def set_down(self, name: bytes, is_down: bool = True) -> None:
        if is_down:
            self.down.add(name)
        else:
            self.down.discard(name)
        self._bump_epoch()
        self._notify("set_down", (name, is_down))

    def set_link_policy(self, policy: LinkPolicy,
                        a: bytes | None = None,
                        b: bytes | None = None) -> None:
        """Set one link's policy, or the network default (a=b=None)."""
        if a is None and b is None:
            self.default_policy = policy
        else:
            self.link_policy[frozenset((a, b))] = policy
        self._bump_epoch()
        self._notify("set_link_policy", (dataclasses.asdict(policy), a, b))


class EventMeshHub:
    """Event-driven gossip fabric: one virtual-time wheel, zero cost
    for idle nodes.

    * **Delivery** goes straight onto the destination's inbox deque
      (delay 0) or into the calendar queue ``_wheel`` keyed on
      ``(delivery instant, seq)`` — the seq tie-break makes pop order
      deterministic. A per-node drainer task exists only while that
      node's inbox is non-empty.
    * **Churn** bumps the node's incarnation counter; wheel frames
      scheduled for an earlier incarnation are dropped on pop, so a
      resumed node never sees pre-crash traffic (same semantics as the
      legacy hub replacing the inbox queue).
    * **Light relays** (``join(..., light=True)``) run no gossipsub
      control plane at all: they dedup, deliver, and forward along a
      deterministic sparse relay set (p2p/gossipmesh.relay_sample) of
      their current neighbors, recomputed only when the fault epoch
      moves.
    * **heartbeat()** visits only the dirty set: mesh nodes with
      pending control-plane work (new traffic, received control
      frames, or a fault-epoch change). A quiet node costs nothing.
    """

    light_control_plane = False

    def __init__(self, network: SimNetwork, *, gossip_degree: int = 4):
        self.network = network
        self.gossip_degree = gossip_degree
        self._nodes: dict[bytes, object] = {}      # name -> PubSub
        self._gossip: dict[bytes, GossipMesh] = {}  # mesh (non-light) only
        self._light: set[bytes] = set()
        self._seen: dict[bytes, dict[bytes, None]] = {}
        self._inbox: dict[bytes, collections.deque] = {}
        self._gen: dict[bytes, int] = {}           # incarnation per name
        self._drainers: dict[bytes, asyncio.Task] = {}
        self._wheel: list[tuple] = []              # (instant, seq, dst, gen, item)
        self._seq = itertools.count()
        self._timer: asyncio.TimerHandle | None = None
        self._timer_due = float("inf")
        self._light_ready: collections.deque = collections.deque()
        self._light_task: asyncio.Task | None = None
        self._dirty: set[bytes] = set()
        self._hb_epoch = -1
        self._relay_cache: dict[tuple[bytes, str], tuple[int, tuple]] = {}
        self.stats = {"published": 0, "delivered": 0, "dup": 0,
                      "rejected": 0, "relayed": 0, "ihave": 0,
                      "iwant_served": 0, "dropped": 0,
                      "events_scheduled": 0, "events_fired": 0,
                      "hb_visits": 0}
        self._flushed: dict[str, int] = {}

    # --- membership ----------------------------------------------------

    def join(self, ps, *, light: bool = False) -> None:
        name = ps.name
        ps._hub = self
        self.network.add_node(name)
        self._nodes[name] = ps
        self._seen[name] = {}
        self._inbox[name] = collections.deque()
        self._gen[name] = self._gen.get(name, 0) + 1
        if light:
            self._light.add(name)
            self._gossip.pop(name, None)
            return
        self._light.discard(name)
        d = self.gossip_degree
        self._gossip[name] = GossipMesh(
            degree=d, d_lo=max(2, d - 1), d_hi=d + 2,
            rng=random.Random(("gossip", self.network.seed, name)
                              .__repr__()))
        self._dirty.add(name)

    def leave(self, ps) -> None:
        self.suspend(ps.name)
        self._nodes.pop(ps.name, None)
        self._gossip.pop(ps.name, None)
        self._light.discard(ps.name)
        self._seen.pop(ps.name, None)
        self._inbox.pop(ps.name, None)

    def suspend(self, name: bytes) -> None:
        """Churn: queued and in-flight frames are lost (identity and
        stores survive for a later :meth:`resume`)."""
        task = self._drainers.pop(name, None)
        if task is not None:
            task.cancel()
        inbox = self._inbox.get(name)
        if inbox:
            self.stats["dropped"] += len(inbox)
            inbox.clear()
        self._gen[name] = self._gen.get(name, 0) + 1
        self._dirty.discard(name)
        self.network.set_down(name, True)

    def resume(self, name: bytes) -> None:
        self.network.set_down(name, False)
        if name in self._gossip:
            self._dirty.add(name)

    # --- data plane ----------------------------------------------------

    async def broadcast(self, sender, topic: str, data: bytes) -> None:
        """PubSub._hub surface: the publisher floods its topic mesh (or,
        for a light relay, its sparse relay set)."""
        from ..core.hashing import sum256

        name = sender.name
        if name not in self._nodes or not self.network.alive(name):
            return
        msg_id = sum256(topic.encode(), data)
        self._mark_seen(name, msg_id)
        self.stats["published"] += 1
        frame = (topic, msg_id, data)
        if name in self._light:
            targets = self._relay_targets(name, topic)
        else:
            mesh = self._gossip[name]
            mesh.on_message(msg_id, topic, frame)
            self._dirty.add(name)
            targets = mesh.eager_targets(topic,
                                         self.network.neighbors(name))
        for dst in targets:
            self._send(name, dst, ("msg", name, frame))

    def _mark_seen(self, name: bytes, msg_id: bytes) -> bool:
        # the transport's exact dedup policy (shared helper), per node
        return mark_seen(self._seen[name], msg_id, SEEN_CAP)

    def _relay_targets(self, name: bytes, topic: str,
                       exclude: bytes | None = None):
        """Light relay's per-topic forward set — deterministic
        (sha256-ranked, cross-process stable) and cached until the
        fault epoch moves."""
        key = (name, topic)
        ent = self._relay_cache.get(key)
        if ent is None or ent[0] != self.network.epoch:
            ent = (self.network.epoch,
                   relay_sample(topic, name, self.network.neighbors(name),
                                self.gossip_degree))
            self._relay_cache[key] = ent
        if exclude is None:
            return ent[1]
        return [p for p in ent[1] if p != exclude]

    def _send(self, src: bytes, dst: bytes, item: tuple) -> None:
        """One frame over one link, with the link's fault policy. The
        RNG draw order matches LegacyMeshHub exactly so both fabrics
        replay the same world from the same seed."""
        net = self.network
        if not net.reachable(src, dst):
            self.stats["dropped"] += 1
            net.stats["blocked"] += 1
            return
        inbox = self._inbox.get(dst)
        if inbox is None:
            self.stats["dropped"] += 1
            return
        pol = net.policy(src, dst)
        rng = net.rng
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
            if delay > 0:
                self._schedule(delay, dst, item)
            else:
                self._deliver_now(dst, item)

    def _deliver_now(self, dst: bytes, item: tuple) -> None:
        """Hand a frame to its consumer. Light relays — the node-count
        majority — share ONE long-lived drainer fed by a global FIFO
        (their handlers never truly suspend, so head-of-line cost is
        nil); that kills the task-per-burst churn a per-node drainer
        pays. Mesh nodes keep per-node drainers so one node's slow
        validator never delays another's."""
        if dst in self._light:
            self._light_ready.append((dst, self._gen.get(dst, 0), item))
            t = self._light_task
            if t is None or t.done():
                self._light_task = asyncio.ensure_future(
                    self._drain_lights())
        else:
            self._inbox[dst].append(item)
            self._ensure_drainer(dst)

    # --- the event wheel ------------------------------------------------

    def _schedule(self, delay: float, dst: bytes, item: tuple) -> None:
        loop = asyncio.get_running_loop()
        # spacecheck: ok=SC001 wheel instants must share call_at's timebase; under the sim that loop IS the engine's VirtualClockLoop
        due = loop.time() + delay
        heapq.heappush(self._wheel, (due, next(self._seq), dst,
                                     self._gen.get(dst, 0), item))
        self.stats["events_scheduled"] += 1
        # ONE loop timer serves the whole wheel, re-armed only when a new
        # head undercuts it (delays are near-constant per policy, so this
        # is rare). A consumer-task design wakes and re-arms a wait_for
        # on EVERY schedule — measured 4.5 loop iterations per frame at
        # 1024 nodes, dwarfing the actual delivery work.
        if self._timer is None or due < self._timer_due:
            self._arm(loop, due)

    def _schedule_at(self, instant: float, dst: bytes, item: tuple) -> None:
        """Wheel insert at an ABSOLUTE virtual instant (cross-shard
        frames arrive tagged with their delivery instant; re-deriving a
        relative delay would lose determinism to float round-trips)."""
        loop = asyncio.get_running_loop()
        heapq.heappush(self._wheel, (instant, next(self._seq), dst,
                                     self._gen.get(dst, 0), item))
        self.stats["events_scheduled"] += 1
        if self._timer is None or instant < self._timer_due:
            self._arm(loop, instant)

    def _arm(self, loop, due: float) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer_due = due
        self._timer = loop.call_at(due, self._fire)

    def _fire(self) -> None:
        """Wheel timer callback: move every due frame onto its
        destination inbox in (instant, seq) order, then re-arm for the
        next delivery instant (a virtual-clock jump, zero wall cost)."""
        loop = asyncio.get_running_loop()
        self._timer = None
        now = loop.time()  # spacecheck: ok=SC001 same wheel timebase as _schedule
        wheel = self._wheel
        while wheel and wheel[0][0] <= now:
            _, _, dst, gen, item = heapq.heappop(wheel)
            self.stats["events_fired"] += 1
            if self._gen.get(dst) != gen:
                self.stats["dropped"] += 1  # churned while in flight
                continue
            if dst not in self._nodes:
                self.stats["dropped"] += 1
                continue
            self._deliver_now(dst, item)
        if wheel:
            self._arm(loop, wheel[0][0])
        else:
            self._timer_due = float("inf")

    def _ensure_drainer(self, name: bytes) -> None:
        if name in self._drainers:
            return
        self._drainers[name] = asyncio.ensure_future(
            self._drain_node(name))

    async def _drain_lights(self) -> None:
        """The shared light-relay consumer: global FIFO, frames from a
        since-churned incarnation dropped by generation check."""
        q = self._light_ready
        try:
            while q:
                name, gen, (kind, src, payload) = q.popleft()
                if self._gen.get(name) != gen:
                    self.stats["dropped"] += 1  # churned while queued
                    continue
                try:
                    if kind == "msg":
                        await self._on_msg(name, src, payload)
                    else:
                        self._on_ctrl(name, src, payload)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — bad frame must not kill the fabric
                    pass
        finally:
            if self._light_task is asyncio.current_task():
                self._light_task = None

    async def _drain_node(self, name: bytes) -> None:
        inbox = self._inbox.get(name)
        try:
            while inbox:
                kind, src, payload = inbox.popleft()
                try:
                    if kind == "msg":
                        await self._on_msg(name, src, payload)
                    else:
                        self._on_ctrl(name, src, payload)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — bad frame must not kill the node
                    pass
        finally:
            # no await between the emptiness check and this unlink, so a
            # frame can't slip in unobserved; a replacement drainer
            # (post-churn) must not be unlinked by the cancelled one
            if self._drainers.get(name) is asyncio.current_task():
                del self._drainers[name]

    async def _on_msg(self, name: bytes, src: bytes, frame: tuple) -> None:
        topic, msg_id, data = frame
        if not self._mark_seen(name, msg_id):
            self.stats["dup"] += 1
            return
        light = name in self._light
        if not light:
            mesh = self._gossip[name]
            mesh.on_message(msg_id, topic, frame)
            self._dirty.add(name)
        ps = self._nodes.get(name)
        if ps is None:
            return
        ok = await ps.deliver(topic, src, data)
        self.stats["delivered"] += 1
        if ok is True:
            if light:
                targets = self._relay_targets(name, topic, exclude=src)
            else:
                targets = mesh.eager_targets(
                    topic, self.network.neighbors(name), exclude=src)
            for dst in targets:
                self.stats["relayed"] += 1
                self._send(name, dst, ("msg", name, frame))
        elif ok is False:
            self.stats["rejected"] += 1

    # --- control plane -------------------------------------------------

    def _on_ctrl(self, name: bytes, src: bytes, payload: bytes) -> None:
        if name in self._light:
            return  # light relays run no control plane
        mesh = self._gossip[name]
        self._dirty.add(name)
        seen = self._seen[name]
        replies = mesh.on_control(src, payload,
                                  seen=lambda mid: mid in seen)
        for subtype, topic, ids in replies:
            if subtype == -1:  # answer IWANT with the full frames
                for mid in ids:
                    frame = mesh.cache.get(mid)
                    if frame is not None:
                        self.stats["iwant_served"] += 1
                        self._send(name, src, ("msg", name, frame))
            else:
                self._send(name, src,
                           ("ctrl", name, encode_ctrl(subtype, topic, ids)))

    def heartbeat(self) -> None:
        """One gossip heartbeat over the DIRTY mesh nodes only. A fault
        epoch change re-dirties every live mesh node (neighbor sets
        moved); a node leaves the set when a beat produced no control
        sends and its message cache has fully aged out."""
        net = self.network
        if self._hb_epoch != net.epoch:
            self._hb_epoch = net.epoch
            self._dirty.update(n for n in self._gossip if net.alive(n))
        if not self._dirty:
            self._flush_metrics()
            return
        dirty = self._dirty
        for name in [n for n in self._gossip if n in dirty]:
            if not net.alive(name):
                dirty.discard(name)
                continue
            mesh = self._gossip[name]
            self.stats["hb_visits"] += 1
            sends = mesh.heartbeat(net.neighbors(name))
            for peer, subtype, topic, ids in sends:
                if subtype == IHAVE:
                    self.stats["ihave"] += 1
                self._send(name, peer,
                           ("ctrl", name, encode_ctrl(subtype, topic, ids)))
            if not sends and mesh.cache.empty():
                dirty.discard(name)
        metrics.sim_fabric_dirty.set(len(dirty))
        self._flush_metrics()

    def _flush_metrics(self) -> None:
        """Publish fabric counter deltas to the shared registry (hot
        paths bump plain ints; the registry sees them once per beat)."""
        for kind, key in (("scheduled", "events_scheduled"),
                          ("fired", "events_fired")):
            delta = self.stats[key] - self._flushed.get(key, 0)
            if delta:
                metrics.sim_fabric_events.inc(delta, kind=kind)
                self._flushed[key] = self.stats[key]
        cs = self.network.cache_stats
        for result in ("hit", "miss"):
            delta = cs[result] - self._flushed.get(result, 0)
            if delta:
                metrics.sim_fabric_cache.inc(delta, result=result)
                self._flushed[result] = cs[result]

    async def drain(self) -> None:
        """Wait until every queued frame is fully processed (in-wheel
        frames wait for their delivery instant, exactly like the legacy
        hub's call_later frames)."""
        while self._drainers or self._light_task is not None:
            tasks = list(self._drainers.values())
            if self._light_task is not None:
                tasks.append(self._light_task)
            await asyncio.gather(*tasks, return_exceptions=True)


class LegacyMeshHub:
    """The original fabric: gossip over SimNetwork edges with one
    always-on consumer task and one queue per node. O(nodes) per beat
    and per hop — kept as the ``SPACEMESH_SIM_FABRIC=legacy`` baseline
    the event fabric's speedup is measured against.
    """

    light_control_plane = True

    def __init__(self, network: SimNetwork, *, gossip_degree: int = 4):
        self.network = network
        self.gossip_degree = gossip_degree
        self._nodes: dict[bytes, object] = {}      # name -> PubSub
        self._gossip: dict[bytes, GossipMesh] = {}
        self._seen: dict[bytes, dict[bytes, None]] = {}
        self._inboxes: dict[bytes, asyncio.Queue] = {}
        self._consumers: dict[bytes, asyncio.Task] = {}
        self.stats = {"published": 0, "delivered": 0, "dup": 0,
                      "rejected": 0, "relayed": 0, "ihave": 0,
                      "iwant_served": 0, "dropped": 0}

    # --- membership ----------------------------------------------------

    def join(self, ps, *, light: bool = False) -> None:
        # ``light`` is accepted for surface parity and ignored: the
        # legacy fabric runs the full control plane on every node
        name = ps.name
        ps._hub = self
        self.network.add_node(name)
        self._nodes[name] = ps
        d = self.gossip_degree
        self._gossip[name] = GossipMesh(
            degree=d, d_lo=max(2, d - 1), d_hi=d + 2,
            rng=random.Random(("gossip", self.network.seed, name)
                              .__repr__()))
        self._seen[name] = {}
        self._ensure_consumer(name)

    def leave(self, ps) -> None:
        self.suspend(ps.name)
        self._nodes.pop(ps.name, None)

    def suspend(self, name: bytes) -> None:
        """Churn: the node's consumer dies and queued frames are lost
        (its identity and stores survive for a later :meth:`resume`)."""
        task = self._consumers.pop(name, None)
        if task is not None:
            task.cancel()
        self._inboxes.pop(name, None)
        self.network.set_down(name, True)

    def resume(self, name: bytes) -> None:
        self.network.set_down(name, False)
        if name in self._nodes:
            self._ensure_consumer(name)

    def _ensure_consumer(self, name: bytes) -> None:
        if name in self._consumers and not self._consumers[name].done():
            return
        q = self._inboxes.get(name)
        if q is None:
            q = self._inboxes[name] = asyncio.Queue()
        self._consumers[name] = asyncio.ensure_future(
            self._consume(name, q))

    # --- data plane ----------------------------------------------------

    async def broadcast(self, sender, topic: str, data: bytes) -> None:
        """PubSub._hub surface: the publisher floods its topic mesh."""
        from ..core.hashing import sum256

        name = sender.name
        if not self.network.alive(name):
            return
        msg_id = sum256(topic.encode(), data)
        self._mark_seen(name, msg_id)
        mesh = self._gossip.get(name)
        if mesh is None:
            return
        mesh.on_message(msg_id, topic, (topic, msg_id, data))
        self.stats["published"] += 1
        targets = mesh.eager_targets(topic, self.network.neighbors(name))
        for dst in targets:
            self._send(name, dst, ("msg", name, (topic, msg_id, data)))

    def _mark_seen(self, name: bytes, msg_id: bytes) -> bool:
        # the transport's exact dedup policy (shared helper), per node
        return mark_seen(self._seen[name], msg_id, SEEN_CAP)

    def _send(self, src: bytes, dst: bytes, item: tuple) -> None:
        """One frame over one link, with the link's fault policy."""
        net = self.network
        if not net.reachable(src, dst):
            self.stats["dropped"] += 1
            net.stats["blocked"] += 1
            return
        q = self._inboxes.get(dst)
        if q is None:
            self.stats["dropped"] += 1
            return
        pol = net.policy(src, dst)
        rng = net.rng
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
            if delay > 0:
                asyncio.get_running_loop().call_later(
                    delay, self._deliver_later, dst, q, item)
            else:
                q.put_nowait(item)

    def _deliver_later(self, dst: bytes, q: asyncio.Queue,
                       item: tuple) -> None:
        # the node may have churned (and its queue been replaced) while
        # the frame was in flight — deliver only to the live queue
        if self._inboxes.get(dst) is q:
            q.put_nowait(item)

    async def _consume(self, name: bytes, q: asyncio.Queue) -> None:
        while True:
            kind, src, payload = await q.get()
            try:
                if kind == "msg":
                    await self._on_msg(name, src, payload)
                else:
                    self._on_ctrl(name, src, payload)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — bad frame must not kill the node
                pass
            finally:
                q.task_done()

    async def _on_msg(self, name: bytes, src: bytes, frame: tuple) -> None:
        topic, msg_id, data = frame
        if not self._mark_seen(name, msg_id):
            self.stats["dup"] += 1
            return
        mesh = self._gossip[name]
        mesh.on_message(msg_id, topic, frame)
        ps = self._nodes.get(name)
        if ps is None:
            return
        ok = await ps.deliver(topic, src, data)
        self.stats["delivered"] += 1
        if ok is True:
            targets = mesh.eager_targets(
                topic, self.network.neighbors(name), exclude=src)
            for dst in targets:
                self.stats["relayed"] += 1
                self._send(name, dst, ("msg", name, frame))
        elif ok is False:
            self.stats["rejected"] += 1

    # --- control plane -------------------------------------------------

    def _on_ctrl(self, name: bytes, src: bytes, payload: bytes) -> None:
        mesh = self._gossip[name]
        seen = self._seen[name]
        replies = mesh.on_control(src, payload,
                                  seen=lambda mid: mid in seen)
        for subtype, topic, ids in replies:
            if subtype == -1:  # answer IWANT with the full frames
                for mid in ids:
                    frame = mesh.cache.get(mid)
                    if frame is not None:
                        self.stats["iwant_served"] += 1
                        self._send(name, src, ("msg", name, frame))
            else:
                self._send(name, src,
                           ("ctrl", name, encode_ctrl(subtype, topic, ids)))

    def heartbeat(self) -> None:
        """One gossip heartbeat for every live node: mesh maintenance
        (GRAFT/PRUNE) + lazy IHAVE. The scenario engine calls this on a
        virtual-time cadence."""
        for name in list(self._nodes):
            if not self.network.alive(name):
                continue
            mesh = self._gossip[name]
            sends = mesh.heartbeat(self.network.neighbors(name))
            for peer, subtype, topic, ids in sends:
                if subtype == IHAVE:
                    self.stats["ihave"] += 1
                self._send(name, peer,
                           ("ctrl", name, encode_ctrl(subtype, topic, ids)))

    async def drain(self) -> None:
        """Wait until every queued frame is fully processed."""
        await asyncio.gather(*(q.join() for q in self._inboxes.values()))


def MeshHub(network: SimNetwork, *, gossip_degree: int = 4,
            shards: int = 1):
    """Fabric selector: the event wheel by default, the legacy
    task-per-node hub under ``SPACEMESH_SIM_FABRIC=legacy`` (the bench
    baseline), or the multi-process sharded wheel when ``shards > 1``
    (sim/shard.py; forced back to 1 under the legacy fabric)."""
    fabric = os.environ.get("SPACEMESH_SIM_FABRIC", "").strip().lower()
    if fabric == "legacy":
        return LegacyMeshHub(network, gossip_degree=gossip_degree)
    if shards and int(shards) > 1:
        from .shard import ShardedMeshHub

        return ShardedMeshHub(network, gossip_degree=gossip_degree,
                              shards=int(shards))
    return EventMeshHub(network, gossip_degree=gossip_degree)


class _NetView:
    """One server's view of the SimNet: ``nodes`` lists only peers it
    can currently reach (partition/eclipse/down honored), so
    ``Server.peers()`` and everything built on it (fetch peer
    selection, peersync quorums) see the faulted world."""

    def __init__(self, simnet: "SimNet", me: bytes):
        self._simnet = simnet
        self._me = me

    @property
    def nodes(self) -> dict[bytes, Server]:
        net = self._simnet.network
        return {n: s for n, s in self._simnet.servers.items()
                if n == self._me or net.reachable(self._me, n)}

    async def route(self, src: bytes, dst: bytes, protocol: str,
                    data: bytes) -> bytes:
        return await self._simnet.route(src, dst, protocol, data)


class SimNet:
    """Req/resp transport over the SimNetwork (``Server._net``)."""

    def __init__(self, network: SimNetwork):
        self.network = network
        self.servers: dict[bytes, Server] = {}

    def join(self, server: Server) -> None:
        self.network.add_node(server.node_id)
        self.servers[server.node_id] = server
        server._net = _NetView(self, server.node_id)

    def leave(self, server: Server) -> None:
        self.servers.pop(server.node_id, None)
        server._net = None

    async def route(self, src: bytes, dst: bytes, protocol: str,
                    data: bytes) -> bytes:
        net = self.network
        target = self.servers.get(dst)
        if target is None or not net.reachable(src, dst):
            raise RequestError(f"peer {dst.hex()[:8]} not reachable")
        pol = net.policy(src, dst)
        if pol.loss and net.rng.random() < pol.loss:
            net.stats["loss"] += 1
            raise RequestError(f"request to {dst.hex()[:8]} lost (chaos)")
        delay = pol.delay + (net.rng.random() * pol.jitter
                             if pol.jitter else 0.0)
        if delay > 0:
            await asyncio.sleep(delay)  # virtual under VirtualClockLoop
        return await target.handle(protocol, src, data)
