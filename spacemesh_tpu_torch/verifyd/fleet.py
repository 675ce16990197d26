"""verifyd fleet: sharded replicas behind one verification surface
(port of ``spacemesh_tpu/verifyd/fleet.py``).

One verifyd process with one farm is a service ceiling.  This module is
the fleet control plane that lifts it:

* :class:`FleetRouter` — places client identities on N replicas with
  the seeded consistent-hash bounded-load table (routing.py), holds one
  :class:`~..obs.remediate.CircuitBreaker` per replica, turns the
  windowed SLIs (per-replica queue-wait p99 + shed rate, obs/sli.py
  ``fleet_slis``) into load scores, a work-steal set for hot kinds, and
  the autoscaling gauges ``fleet_desired_replicas`` /
  ``fleet_replica_load_score``.
* :class:`FleetVerifier` — :class:`~.failover.FailoverVerifier`
  generalized from remote→local to remote→remote→…→local.  It exposes
  the same farm-compatible surface (``await submit(req, lane)`` plus
  ``verify_batch``), walks the client's ring chain replica by replica
  under each replica's breaker, re-routes typed sheds instead of
  surfacing them (a ``registry_full`` replica re-places the client on
  its next ring choice; a draining replica trips and the chain moves
  on), and always has the node's local farm as the bit-identical last
  resort — admission is scheduling, never semantics, so a verdict from
  any replica or from the farm is the same verdict.

Per-shard admission state: every replica runs its own client registry,
token buckets and fair-share tenant weights (service.py ``shard=``), so
fleet capacity is the SUM of the replicas' ``max_clients`` — the router
sheds ``registry_full`` only past that fleet-wide bound.

A node wires a fleet behind ``SPACEMESH_VERIFYD_URLS`` (comma-separated
endpoints) via :func:`fleet_from_urls`; the ``fleet`` drill
(``sim/fleet.py``) drives the whole plane deterministically. aiohttp is
imported only inside :meth:`HttpReplicaEndpoint._sess`, so this module
imports without it.

The trace plane: the router starts a capture on every replica that
serves ``/debug/trace`` (``start_captures``, each replica stamped
``replica-<name>``), pulls each capture and ``/metrics`` into the
federation (``pull_captures``) and merges them with the caller's own
capture into one timeline (``merged_capture``). Each remote attempt is a
``fleet.remote`` span whose link token rides in the verify body as
``trace_parent``, so the replica's ``verifyd.request`` parents to it in
the merged timeline; the local fallback is ``fleet.local``.

Left out against the JAX package: the event bus (``node/events.py``, not
ported): ``bus=`` stays in the signatures and is ignored.
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Callable, Optional

import logging

from ..obs import remediate as remediate_mod
from ..utils import metrics, tracing
from ..verify.farm import Lane
from . import protocol
from .routing import Placement
from .service import Shed, VerifydClosed

_log = logging.getLogger("spacemesh_tpu_torch.fleet")

# mirrors failover.py: these shed reasons say "this client is
# misconfigured ON THIS REPLICA", not "the replica is unhealthy" — they
# never trip the replica's breaker, they re-route
_NON_TRIPPING_SHEDS = frozenset({protocol.SHED_UNREGISTERED,
                                 protocol.SHED_REGISTRY_FULL})

PATH_LOCAL = "local"
PATH_LOCAL_FASTFAIL = "local_fastfail"  # every breaker open: no attempt

# the JAX FleetRouter's defaults, fixed here: no caller of the port sets
# them (ring shape, stealing, and the autoscaling signal's targets)
VNODES = 64
LOAD_FACTOR = 1.0
HOT_SCORE = 1.0            # load score that marks a replica stealable-from
STEAL_MARGIN = 0.25        # a steal target must be this much cooler
KIND_HEAT_TAU_S = 30.0     # decay of per-kind shed pressure
KIND_HEAT_THRESHOLD = 3.0  # decayed sheds of one kind that make it hot
TARGET_UTILIZATION = 0.7
MIN_REPLICAS = 1
MAX_REPLICAS = 64
QUEUE_WAIT_SLO_S = 0.25    # queue-wait p99 at a load score of 1.0
SHED_SLO_PER_SEC = 1.0     # shed rate at a load score of 1.0


class _Replica:
    """One fleet member: endpoint + breaker + registration cache."""

    __slots__ = ("name", "endpoint", "breaker", "own_endpoint",
                 "registered", "max_clients", "ok", "failed")

    def __init__(self, name: str, endpoint, breaker, *,
                 own_endpoint: bool, max_clients: int):
        self.name = name
        self.endpoint = endpoint
        self.breaker = breaker
        self.own_endpoint = own_endpoint
        self.registered: set[str] = set()   # client ids registered here
        self.max_clients = max_clients
        self.ok = 0
        self.failed = 0


class FleetRouter:
    """Fleet membership, placement, breakers, and load signals.

    Lifecycle: construct → :meth:`start` (registers every replica
    breaker on the global registry) → ``register_replica`` /
    ``unregister_replica`` → :meth:`close` or ``await aclose()`` in a
    ``finally``.
    """

    def __init__(self, *, seed: int = 0,
                 breaker_kw: dict | None = None,
                 time_source: Callable[[], float] = time.monotonic):
        self.placement = Placement(seed=seed, vnodes=VNODES,
                                   load_factor=LOAD_FACTOR)
        self.replicas: dict[str, _Replica] = {}
        self._breaker_kw = dict(breaker_kw or {})
        self._now = time_source
        self._started = False
        self._scores: dict[str, float] = {}
        # (replica, kind) -> (heat, t_last): decayed shed pressure that
        # drives per-kind stealing between SLI windows
        self._kind_heat: dict[tuple[str, str], tuple[float, float]] = {}
        # (replica, client) pairs whose registration went stale when the
        # client moved shards; drained best-effort by flush_stale so the
        # OLD replica's unregister_client drops its per-client series
        self._stale: list[tuple[str, str]] = []
        self.stats = {"steals": 0, "reroutes": 0, "replicas_added": 0,
                      "replicas_removed": 0}

    @property
    def min_replicas(self) -> int:
        """The floor of ``fleet_desired_replicas``."""
        return MIN_REPLICAS

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Register every replica breaker (idempotent)."""
        if not self._started:
            self._started = True
            for rep in self.replicas.values():
                remediate_mod.BREAKERS.register(rep.breaker)

    def close(self) -> None:
        """Synchronous teardown: unregister breakers and drop every
        fleet/per-replica metric series this router created."""
        if self._started:
            for rep in self.replicas.values():
                remediate_mod.BREAKERS.unregister(rep.breaker)
            self._started = False
        for name in list(self.replicas):
            metrics.fleet_replica_load.remove(replica=name)
        metrics.fleet_replicas.set(0)
        metrics.fleet_clients.set(0)

    async def aclose(self) -> None:
        self.close()
        for rep in self.replicas.values():
            if rep.own_endpoint:
                aclose = getattr(rep.endpoint, "aclose", None)
                if aclose is not None:
                    await aclose()

    # -- membership ------------------------------------------------------

    def register_replica(self, name: str, endpoint, *,
                         breaker: remediate_mod.CircuitBreaker | None
                         = None,
                         own_endpoint: bool = False,
                         max_clients: int = 64) -> list:
        """Add a replica; pair with :meth:`unregister_replica` when it
        leaves the fleet.  Returns the ``(client, old, new)`` moves the bounded-load
        rebalance made (≤ ceil(K/N); routing.py)."""
        name = str(name)
        if name in self.replicas:
            return []
        if breaker is None:
            kw = dict(failure_budget=3, window_s=60.0, cooldown_s=5.0,
                      cooldown_cap_s=120.0)
            kw.update(self._breaker_kw)
            breaker = remediate_mod.CircuitBreaker(
                f"verifyd.replica.{name}", time_source=self._now, **kw)
        rep = _Replica(name, endpoint, breaker,
                       own_endpoint=own_endpoint,
                       max_clients=max(int(max_clients), 1))
        self.replicas[name] = rep
        if self._started:
            remediate_mod.BREAKERS.register(breaker)
        moved = self.placement.add_replica(name)
        self._record_moves(moved, reason="replica_added")
        self.stats["replicas_added"] += 1
        metrics.fleet_replicas.set(len(self.replicas))
        return moved

    def unregister_replica(self, name: str) -> list:
        """Drop a replica: its breaker and per-replica series go away,
        and its clients spill to the survivors (≤ one replica's
        capacity moves)."""
        name = str(name)
        rep = self.replicas.pop(name, None)
        if rep is None:
            return []
        if self._started:
            remediate_mod.BREAKERS.unregister(rep.breaker)
        moved = self.placement.remove_replica(name)
        # the moved clients' old registrations died with the replica —
        # nothing to flush; drop any stale pairs pointing at it
        self._stale = [(r, c) for r, c in self._stale if r != name]
        self._record_moves(
            [m for m in moved if m[2]], reason="replica_removed",
            flush=False)
        self._scores.pop(name, None)
        self._kind_heat = {k: v for k, v in self._kind_heat.items()
                           if k[0] != name}
        metrics.fleet_replica_load.remove(replica=name)
        metrics.fleet_replica_verify_seconds.remove_matching(replica=name)
        metrics.fleet_replica_sheds.remove_matching(replica=name)
        # federation cardinality hygiene: a replica that LEAVES takes
        # its proc= series with it (crashed replicas are never
        # unregistered here — their snapshots stay flagged)
        from ..obs.federate import FEDERATION
        FEDERATION.drop(f"replica-{name}")
        self.stats["replicas_removed"] += 1
        metrics.fleet_replicas.set(len(self.replicas))
        return moved

    def _record_moves(self, moved, *, reason: str,
                      flush: bool = True) -> None:
        for cid, old, _new in moved:
            self.stats["reroutes"] += 1
            metrics.fleet_reroutes.inc(reason=reason)
            if flush and old in self.replicas:
                self._stale.append((old, cid))

    # -- placement / admission -------------------------------------------

    def fleet_max_clients(self) -> int:
        return sum(r.max_clients for r in self.replicas.values())

    def place_client(self, cid: str) -> str:
        """The client's replica, assigning it on first sight; raises a
        typed ``registry_full`` Shed past the FLEET-WIDE client bound
        (the per-shard registries scale admission past any single
        ``max_clients``)."""
        cid = str(cid)
        got = self.placement.replica_of(cid)
        if got is not None:
            return got
        if not self.replicas:
            raise LookupError("fleet has no replicas")
        bound = self.fleet_max_clients()
        if len(self.placement.assign) >= bound:
            raise Shed(protocol.SHED_REGISTRY_FULL,
                       f"{len(self.placement.assign)} clients placed "
                       f">= fleet capacity {bound}")
        placed = self.placement.place(cid)
        metrics.fleet_clients.set(len(self.placement.assign))
        return placed

    def forget_client(self, cid: str) -> None:
        old = self.placement.forget(cid)
        if old is not None:
            rep = self.replicas.get(old)
            if rep is not None:
                rep.registered.discard(str(cid))
        metrics.fleet_clients.set(len(self.placement.assign))

    def reroute(self, cid: str, *, avoid: str, reason: str) -> str | None:
        """Move a client off a replica that typed-shed it; the old
        registration is flushed so its per-client series drop."""
        cid = str(cid)
        target = self.placement.reroute(cid, avoid)
        if target is None or target == avoid:
            return None
        self.stats["reroutes"] += 1
        metrics.fleet_reroutes.inc(reason=reason)
        rep = self.replicas.get(avoid)
        if rep is not None and cid in rep.registered:
            self._stale.append((avoid, cid))
        metrics.fleet_clients.set(len(self.placement.assign))
        return target

    async def flush_stale(self) -> None:
        """Best-effort unregister of moved clients from their OLD
        replicas, so a re-routed identity's per-client metric series
        and tenant state do not linger on a shard it left."""
        while self._stale:
            name, cid = self._stale.pop()
            rep = self.replicas.get(name)
            if rep is None or cid not in rep.registered:
                continue
            rep.registered.discard(cid)
            if rep.breaker.state == remediate_mod.OPEN:
                continue       # dead replica: its registry dies with it
            try:
                await rep.endpoint.unregister(cid)
            except Exception:  # noqa: BLE001 — best-effort: the old
                # replica may be mid-outage; its own max_clients bound
                # and restart are the backstop
                pass

    # -- routing chain + work stealing -----------------------------------

    def chain(self, cid: str, kinds=()) -> list[str]:
        """Replica names to try in order: the client's sticky placement
        first (or a steal target when the placement is hot for these
        kinds), then the rest of its ring preference chain."""
        cid = str(cid)
        primary = self.placement.replica_of(cid)
        order: list[str] = []
        if primary is not None:
            order.append(primary)
        for member in self.placement.ring.walk(cid):
            if member != primary:
                order.append(member)
        if primary is None or len(order) < 2:
            return order
        if self._is_hot(primary, kinds):
            target = self.steal_target(primary)
            if target is not None:
                order.remove(target)
                order.insert(0, target)
                self.stats["steals"] += 1
                metrics.fleet_steals.inc(src=primary, dst=target)
        return order

    def _is_hot(self, name: str, kinds) -> bool:
        if self._scores.get(name, 0.0) >= HOT_SCORE:
            return True
        now = self._now()
        for kind in kinds:
            heat, t = self._kind_heat.get((name, kind), (0.0, now))
            if heat * math.exp(-(now - t) / KIND_HEAT_TAU_S) \
                    >= KIND_HEAT_THRESHOLD:
                return True
        return False

    def steal_target(self, src: str) -> str | None:
        """The coolest healthy replica, when it is meaningfully cooler
        than ``src`` — otherwise stealing just moves the hot spot."""
        best, best_score = None, None
        for name, rep in self.replicas.items():
            if name == src \
                    or rep.breaker.state == remediate_mod.OPEN:
                continue
            score = self._scores.get(name, 0.0)
            if best_score is None or score < best_score \
                    or (score == best_score and name < best):
                best, best_score = name, score
        if best is None:
            return None
        src_score = self._scores.get(src, HOT_SCORE)
        if best_score + STEAL_MARGIN > src_score:
            return None
        return best

    def note_shed(self, name: str, reason: str, kinds=()) -> None:
        """A typed shed from a replica: pressure signal for stealing."""
        metrics.fleet_replica_sheds.inc(replica=name, reason=reason)
        now = self._now()
        for kind in set(kinds):
            heat, t = self._kind_heat.get((name, kind), (0.0, now))
            heat = heat * math.exp(-(now - t) / KIND_HEAT_TAU_S)
            self._kind_heat[(name, kind)] = (heat + 1.0, now)

    # -- autoscaling signals ---------------------------------------------

    def update_signals(self, sli_values: dict) -> dict:
        """Fold the windowed SLIs (obs/sli.py ``fleet_slis``) into
        per-replica load scores and the ``fleet_desired_replicas``
        autoscaling gauge.  A score of 1.0 means "at target": the
        replica's queue-wait p99 sits at its SLO share or its shed rate
        at the tolerated rate; ≥ ``HOT_SCORE`` marks it stealable-from.
        """
        scores: dict[str, float] = {}
        for name in self.replicas:
            qwait = sli_values.get(f"fleet_replica_{name}_queue_p99")
            sheds = sli_values.get(f"fleet_replica_{name}_shed_per_sec")
            score = 0.0
            if qwait is not None:
                score = max(score, float(qwait) / QUEUE_WAIT_SLO_S)
            if sheds is not None:
                score = max(score, float(sheds) / SHED_SLO_PER_SEC)
            scores[name] = score
            metrics.fleet_replica_load.set(score, replica=name)
        self._scores = scores
        n = len(self.replicas)
        if n == 0:
            desired = 0
        else:
            # utilization autoscaling: enough replicas that the mean
            # score lands back at the target utilization
            mean = sum(scores.values()) / n
            desired = max(MIN_REPLICAS,
                          min(MAX_REPLICAS,
                              math.ceil(n * mean
                                        / TARGET_UTILIZATION)
                              if mean > 0 else MIN_REPLICAS))
        metrics.fleet_desired_replicas.set(desired)
        return {"scores": scores, "desired_replicas": desired}

    # -- fleet observability: the pull-and-merge plane -------------------

    async def start_captures(self, *, capacity: int | None = None) -> dict:
        """Start a span capture on every replica that exposes the
        /debug/trace surface (endpoints without it are skipped). Returns
        {replica: start doc | None}."""
        out: dict = {}
        for name, rep in sorted(self.replicas.items()):
            ep = rep.endpoint
            if not hasattr(ep, "trace_start"):
                continue
            try:
                out[name] = await ep.trace_start(
                    capacity=capacity, role=f"replica-{name}")
            except Exception:  # noqa: BLE001 — a dead replica is not news
                out[name] = None
        return out

    async def pull_captures(self) -> dict:
        """Pull every reachable replica's trace capture AND metrics
        exposition into the federation under ``replica-<name>``; returns
        {proc: capture doc} for the pulled captures. A replica that cannot
        be scraped is skipped (its breaker already tells that story)."""
        from ..obs.federate import FEDERATION

        pulled: dict = {}
        for name, rep in sorted(self.replicas.items()):
            ep = rep.endpoint
            if not hasattr(ep, "trace_export"):
                continue
            proc = f"replica-{name}"
            try:
                doc = await ep.trace_export()
                text = await ep.metrics_text()
            except Exception:  # noqa: BLE001 — unreachable replica
                continue
            FEDERATION.parse_and_update(proc, text, trace=doc)
            pulled[proc] = doc
        return pulled

    def merged_capture(self, parent: dict | None = None) -> dict | None:
        """One validate-clean timeline over the parent capture and every
        federated replica capture (``tracing.merge_captures``)."""
        from ..obs.federate import FEDERATION

        return FEDERATION.merged_capture(parent=parent)

    # -- introspection ---------------------------------------------------

    def state_doc(self) -> dict:
        return {
            "replicas": {
                name: {"breaker": rep.breaker.state_doc(),
                       "registered_clients": len(rep.registered),
                       "max_clients": rep.max_clients,
                       "load_score": round(
                           self._scores.get(name, 0.0), 4),
                       "ok": rep.ok, "failed": rep.failed}
                for name, rep in sorted(self.replicas.items())},
            "placement": self.placement.doc(),
            "fleet_max_clients": self.fleet_max_clients(),
            "stats": dict(self.stats),
        }


class FleetVerifier:
    """Replica-aware failover verifier over a :class:`FleetRouter`.

    The farm-compatible surface (``submit`` / ``verify_batch``) walks
    the client's chain — steal target, sticky placement, ring spills —
    under per-replica breakers, and lands on the local farm when the
    whole fleet is unreachable.  Every routing decision is visible:
    ``fleet_requests_total{path,lane}``, the per-replica latency/shed
    signals the router's autoscaler reads, and an optional observer the
    fleet sim uses for its replay-stable digest.

    Lifecycle: construct → :meth:`start` → :meth:`aclose` in a
    ``finally``, closing an owned router (and its owned endpoints) with
    it.
    """

    def __init__(self, *, router: FleetRouter, farm,
                 client_id: str = "node",
                 deadline_s: float | None = None,
                 own_router: bool = False,
                 bus=None,
                 observer: Optional[Callable[..., None]] = None,
                 time_source: Callable[[], float] = time.monotonic,
                 audit_k: int = 0):
        self.router = router
        self.farm = farm
        self.client_id = str(client_id)
        self.deadline_s = deadline_s
        self._own_router = own_router
        self.bus = bus
        self.observer = observer
        self._now = time_source
        # audit_k > 0: spot-check that many items of every successful
        # remote batch against the local farm (byzantine detection)
        self.audit_k = int(audit_k)
        self.stats = {"remote_ok": 0, "remote_failed": 0,
                      "local": 0, "local_fastfail": 0,
                      "remote_attempts": 0, "failbacks": 0,
                      "audits": 0, "audit_divergence": 0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.router.start()

    async def aclose(self) -> None:
        self.shutdown()
        if self._own_router:
            await self.router.aclose()

    def shutdown(self) -> None:
        """Synchronous teardown half (for an embedder that closes after
        its loop has exited): the router's breakers and series
        unregister; owned endpoints need the loop, so only
        :meth:`aclose` closes them."""
        if self._own_router:
            self.router.close()

    # -- the farm-compatible surface -------------------------------------

    async def submit(self, req, lane: Lane = Lane.GOSSIP) -> bool:
        return (await self.verify_batch([req], lane))[0]

    async def verify_batch(self, reqs: list, lane: Lane = Lane.GOSSIP,
                           *, client_id: str | None = None) -> list[bool]:
        """Verify a batch through the fleet: the client's replica chain
        first (typed sheds re-route, transport errors and draining
        replicas trip that replica's breaker and the chain moves on),
        the local farm as the bit-identical last resort — ALWAYS an
        answer for every failure mode the breakers model."""
        lane = Lane(lane)
        lname = lane.name.lower()
        cid = str(client_id) if client_id is not None else self.client_id
        t0 = self._now()
        await self.router.flush_stale()
        kinds = sorted({getattr(r, "kind", "?") for r in reqs})
        chain: list[str] = []
        if self.router.replicas:
            # a fleet-wide registry_full surfaces TYPED: placement is
            # admission, and a client past the fleet bound must hear a
            # shed, not be silently served off the books
            self.router.place_client(cid)
            chain = self.router.chain(cid, kinds)
        attempted = False
        for name in chain:
            rep = self.router.replicas.get(name)
            if rep is None or not rep.breaker.allow():
                continue
            attempted = True
            verdicts = await self._try_replica(rep, cid, reqs, lane)
            if verdicts is not None:
                dt = max(self._now() - t0, 0.0)
                metrics.fleet_replica_verify_seconds.observe(
                    dt, replica=name, lane=lname)
                return self._done(name, "remote", lname, t0, len(reqs),
                                  verdicts)
        path = PATH_LOCAL if attempted else PATH_LOCAL_FASTFAIL
        self.stats["local" if attempted else "local_fastfail"] += 1
        async with tracing.span("fleet.local",
                                {"lane": lname, "n": len(reqs),
                                 "fastfail": not attempted}
                                if tracing.is_enabled() else None):
            verdicts = list(await asyncio.gather(
                *(self.farm.submit(r, lane) for r in reqs)))
        return self._done(path, path, lname, t0, len(reqs), verdicts)

    # -- internals -------------------------------------------------------

    async def _try_replica(self, rep: _Replica, cid: str, reqs: list,
                           lane: Lane) -> list[bool] | None:
        """One replica's turn on the chain: verdicts on success, None
        when the chain should move on (breaker bookkeeping done)."""
        was_probe = rep.breaker.state == remediate_mod.HALF_OPEN
        self.stats["remote_attempts"] += 1
        kinds = [getattr(r, "kind", "?") for r in reqs]
        for retry in (False, True):
            try:
                async with tracing.span(
                        "fleet.remote",
                        {"replica": rep.name, "n": len(reqs)}
                        if tracing.is_enabled() else None):
                    verdicts = await self._remote_verify(rep, cid, reqs,
                                                         lane)
            except Shed as e:
                if e.reason == protocol.SHED_UNREGISTERED and not retry:
                    # replica restarted and lost the registration:
                    # re-register and retry THIS replica once before
                    # moving down the chain
                    rep.registered.discard(cid)
                    continue
                self._on_shed(rep, cid, e, kinds)
                return None
            except (asyncio.TimeoutError, TimeoutError) as e:
                self._trip(rep, f"deadline:{e!r}")
                return None
            except VerifydClosed as e:
                self._trip(rep, f"closed:{e!r}")
                return None
            except Exception as e:  # noqa: BLE001 — any transport/protocol failure moves down the chain
                self._trip(rep, f"transport:{e!r}")
                return None
            except BaseException:
                # cancelled mid-attempt: no verdict either way — the
                # probe slot must not stay held
                rep.breaker.abort_probe()
                raise
            else:
                if self.audit_k and reqs and \
                        not await self._audit(rep, reqs, lane, verdicts):
                    return None  # byzantine: tripped, chain moves on
                rep.ok += 1
                self.stats["remote_ok"] += 1
                if was_probe:
                    self.stats["failbacks"] += 1
                    _log.info("replica %s probe ok: failing back",
                              rep.name)
                rep.breaker.record_success()
                return verdicts
        return None

    async def _audit(self, rep: _Replica, reqs: list, lane: Lane,
                     verdicts: list[bool]) -> bool:
        """Spot-check a deterministic sample (first/last items) of a
        successful remote batch against the local farm — verdicts are
        bit-identical by construction, so ANY divergence means the
        replica is answering from a stale or hostile state.  The
        replica is tripped as byzantine and its whole batch discarded:
        a wrong verdict must never reach the caller even when the
        transport and the admission plane look perfectly healthy."""
        idxs = sorted({0, len(reqs) - 1})[:max(self.audit_k, 1)]
        self.stats["audits"] += 1
        for i in idxs:
            local = await self.farm.submit(reqs[i], lane)
            if bool(local) != bool(verdicts[i]):
                self.stats["audit_divergence"] += 1
                metrics.fleet_audit_divergence.inc(replica=rep.name)
                _log.warning("replica %s verdict diverges from local "
                             "farm on item %d: tripping as byzantine",
                             rep.name, i)
                if self.observer is not None:
                    self.observer("audit_divergence", replica=rep.name,
                                  index=i)
                self._trip(rep, "byzantine:audit_divergence")
                return False
        return True

    def _on_shed(self, rep: _Replica, cid: str, e: Shed,
                 kinds: list) -> None:
        self.router.note_shed(rep.name, e.reason, kinds)
        if e.reason in _NON_TRIPPING_SHEDS:
            # config-class: release a held probe slot (this outcome says
            # nothing about the replica's health) and re-place the
            # client when the REPLICA is full — its next ring choice has
            # per-shard headroom this registry does not
            rep.breaker.abort_probe()
            rep.registered.discard(cid)
            if e.reason == protocol.SHED_REGISTRY_FULL:
                self.router.reroute(cid, avoid=rep.name,
                                    reason=e.reason)
            _log.warning("replica %s shed %s (%s): re-routing",
                         rep.name, e.reason, e.detail)
        else:
            if e.reason == protocol.SHED_SHUTTING_DOWN:
                # a draining replica will keep shedding until it is
                # gone: move the client now instead of re-paying it
                self.router.reroute(cid, avoid=rep.name,
                                    reason=e.reason)
            self._trip(rep, f"shed:{e.reason}",
                       retry_after_s=e.retry_after_s)

    async def _remote_verify(self, rep: _Replica, cid: str, reqs: list,
                             lane: Lane) -> list[bool]:
        if cid not in rep.registered:
            await rep.endpoint.register(cid)
            rep.registered.add(cid)
        lname = lane.name.lower()
        if self.deadline_s is not None:
            return await asyncio.wait_for(
                rep.endpoint.verify(reqs, client=cid, lane=lname,
                                    deadline_s=self.deadline_s),
                timeout=self.deadline_s)
        return await rep.endpoint.verify(reqs, client=cid, lane=lname)

    def _trip(self, rep: _Replica, why: str,
              retry_after_s: float | None = None) -> None:
        rep.failed += 1
        self.stats["remote_failed"] += 1
        before = rep.breaker.state
        rep.breaker.record_failure(retry_after_s=retry_after_s)
        after = rep.breaker.state
        if self.observer is not None:
            self.observer("replica_failure", replica=rep.name, why=why,
                          state=after)
        if after != before and after == remediate_mod.OPEN:
            _log.warning("replica %s unhealthy (%s): breaker open, "
                         "chain continues without it", rep.name, why)
            metrics.remediation_actions.inc(
                component=rep.breaker.component,
                action="failover_replica", outcome="ok")

    def _done(self, served_by: str, path: str, lname: str, t0: float,
              n: int, verdicts: list[bool]) -> list[bool]:
        """``path`` is the serving CLASS (remote/local/local_fastfail —
        the label the fleet SLIs rate over); ``served_by`` names the
        actual server (a replica, or the path itself for the farm)."""
        metrics.fleet_requests.inc(path=path, lane=lname)
        metrics.fleet_verify_seconds.observe(
            max(self._now() - t0, 0.0), path=path, lane=lname)
        if self.observer is not None:
            self.observer("served", served_by=served_by, path=path,
                          lane=lname, n=n)
        return verdicts

    def state_doc(self) -> dict:
        return {"client_id": self.client_id,
                "stats": dict(self.stats),
                "router": self.router.state_doc()}


class HttpReplicaEndpoint:
    """Multi-client HTTP endpoint for one replica (the fleet-side twin
    of client.py's single-identity :class:`VerifydClient`: same wire
    docs, ``client`` chosen per call)."""

    def __init__(self, base_url: str, *, session=None):
        self.base_url = base_url.rstrip("/")
        self._session = session
        self._own_session = session is None

    async def _sess(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def _post(self, path: str, body: dict) -> dict:
        from .client import VerifydClient

        sess = await self._sess()
        async with sess.post(self.base_url + path, json=body) as resp:
            if resp.content_type == "application/json":
                doc = await resp.json()
            else:
                doc = {"status": "ERROR", "error": await resp.text()}
        VerifydClient._raise_typed(doc)
        return doc

    async def register(self, client: str, **kwargs) -> dict:
        doc = await self._post("/v1/client/register",
                               {"client": str(client), **kwargs})
        if doc.get("status") == "ERROR":
            raise protocol.ProtocolError(f"register failed: {doc}")
        return doc

    async def unregister(self, client: str) -> None:
        await self._post("/v1/client/unregister",
                         {"client": str(client)})

    async def verify(self, reqs: list, *, client: str,
                     lane: str = "gossip",
                     deadline_s: float | None = None) -> list[bool]:
        body = {"client": str(client), "lane": lane,
                "items": [protocol.request_to_doc(r) for r in reqs]}
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        # ship this caller's span identity so the replica's
        # verifyd.request span can parent to our fleet.remote span in the
        # merged fleet timeline
        token = tracing.link_token()
        if token:
            body["trace_parent"] = token
        doc = await self._post("/v1/verify", body)
        verdicts = doc.get("verdicts")
        if doc.get("status") != "OK" or not isinstance(verdicts, list):
            raise protocol.ProtocolError(f"verify failed: {doc}")
        return [bool(v) for v in verdicts]

    async def stats(self) -> dict:
        sess = await self._sess()
        async with sess.get(self.base_url + "/v1/stats") as resp:
            return await resp.json()

    async def metrics_text(self) -> str:
        sess = await self._sess()
        async with sess.get(self.base_url + "/metrics") as resp:
            return await resp.text()

    # -- fleet observability pulls (server.py /debug/trace/*) ----------

    async def trace_start(self, *, capacity: int | None = None,
                          role: str | None = None) -> dict:
        """Start (or restart) a capture on the replica, stamping its
        process identity so the merged timeline shows provenance."""
        q = []
        if capacity is not None:
            q.append(f"capacity={int(capacity)}")
        if role:
            q.append(f"role={role}")
        sess = await self._sess()
        url = (self.base_url + "/debug/trace/start"
               + ("?" + "&".join(q) if q else ""))
        async with sess.get(url) as resp:
            return await resp.json()

    async def trace_export(self) -> dict:
        sess = await self._sess()
        async with sess.get(self.base_url + "/debug/trace/export") as resp:
            return await resp.json()

    async def aclose(self) -> None:
        if self._own_session and self._session is not None:
            await self._session.close()
            self._session = None


def fleet_from_urls(urls, *, farm, client_id: str = "node",
                    deadline_s: float | None = None,
                    bus=None) -> FleetVerifier:
    """Build a FleetVerifier over HTTP replicas (a node wires this
    behind ``SPACEMESH_VERIFYD_URLS``; replica names are r0..rN in URL
    order, so a restarted node reproduces the same ring).  The replicas
    may be either package's verifyd: the wire docs are one format."""
    router = FleetRouter()
    for i, url in enumerate(u.strip() for u in urls):
        if not url:
            continue
        # the router escapes into the FleetVerifier (own_router=True),
        # whose aclose tears every replica down
        router.register_replica(
            f"r{i}", HttpReplicaEndpoint(url), own_endpoint=True)
    return FleetVerifier(router=router, farm=farm, client_id=client_id,
                         deadline_s=deadline_s, own_router=True,
                         bus=bus)
