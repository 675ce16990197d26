"""verifyd core: per-client admission over the shared device runtime
(port of ``spacemesh_tpu/verifyd/service.py``).

The in-process farm (verify/farm.py) batches ONE node's verification
work; this service verifies proofs for OTHER nodes (the "proofs
verified/sec" half of BASELINE.json).  Composition, front to back:

1. **Admission** (``verify``): per-client token buckets (weighted by
   item kind — a POST recompute costs more than a signature), a global
   pending-items bound with heaviest-client-first shedding (above a
   half-full high-water mark a client over its fair share sheds
   ``overload`` while lighter clients keep being admitted; the global
   bound sheds ``queue_full``), deadline-aware
   rejection (a request predicted to miss its deadline is shed NOW,
   not verified late), and a bounded client registry (``max_clients``).
   Every rejection is a typed :class:`Shed` — reason, detail,
   retry-after — never a silent drop.
2. **Fair share** (runtime/scheduler.py): each client is a tenant;
   every admitted request is one scheduler job, so stride fair share +
   EDF deadlines decide WHICH client's work reaches the device next,
   and the scheduler's ``max_queued`` quota is the per-client job bound
   (``quota`` sheds).
3. **Continuous batching** (verify/farm.py): released requests from
   all clients coalesce in the farm's per-kind batchers, sized by the
   measured-rate model in batchtune.py (speculative batch sizing: a
   partially-full batch dispatches the moment the marginal wait
   exceeds the predicted throughput gain).

Verdicts are bit-identical to inline verification — admission and
batching are scheduling, never semantics (the farm contract).

The service takes ``device=`` (default ``"cuda"``; it raises without a
card) and hands it to its own farm, scheduler and batch tuner. ``shard=``
makes it one replica of a verifyd fleet in a process shared with others
(``verifyd/fleet.py``): tenant ids, the health component, the recovery
hook and the per-client metric identities are shard-namespaced, and
``replica_hint`` names a peer in the ``registry_full`` and
``shutting_down`` sheds. Each admitted request is a ``verifyd.request``
span (carrying the caller's ``trace_parent`` link token, which
``tracing.merge_captures`` resolves into a cross-process parent edge),
and its drain into the farm a ``verifyd.drain`` span under it, so the
chain ``verifyd.request -> verifyd.drain -> farm.request -> farm.batch``
holds across the scheduler's worker thread.

Shutdown (``aclose``) stops admission (``shutting_down`` sheds), drains
admitted work, then closes the scheduler and farm — zero stranded
client futures: anything undrained resolves with
:class:`VerifydClosed`.
"""

from __future__ import annotations

import asyncio
import time

from ..core.signing import EdVerifier
from ..device import resolve
from ..runtime.scheduler import (
    QuotaExceeded,
    SchedulerClosed,
    TenantScheduler,
)
from ..utils import metrics, tracing
from ..verify import farm as farm_mod
from ..verify.farm import Lane, VerificationFarm
from . import batchtune, protocol

# token-bucket cost per item kind: rough relative backend cost, so one
# client's POST recomputes cannot crowd out another's signatures at the
# same nominal item rate
KIND_WEIGHTS = {"sig": 1.0, "vrf": 1.0, "membership": 1.0, "pow": 1.0,
                "post": 8.0}

DEFAULT_RATE = 5000.0       # items/s replenishment per client
DEFAULT_BURST = 10000.0     # bucket depth
DEFAULT_MAX_PENDING = 1 << 15


class VerifydClosed(RuntimeError):
    """The service shut down while (or before) the request was pending."""


class Shed(Exception):
    """Typed admission rejection (protocol.SHED_* reasons).

    Carries everything a well-behaved client needs to react: the
    ``reason``, a human ``detail``, ``retry_after_s`` when the
    condition is known to clear (token refill), and — for the
    lifecycle sheds a WAIT cannot clear (``registry_full``,
    ``shutting_down``) — an optional ``replica_hint``: the Retry-After
    analog in SPACE instead of time, naming a fleet peer worth trying
    instead of backing off against a full or draining replica.  The
    server surfaces it as a structured response body, the client
    library raises it — a shed is an ANSWER, never a dropped
    connection.
    """

    def __init__(self, reason: str, detail: str = "",
                 retry_after_s: float | None = None,
                 replica_hint: str | None = None):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail
        self.retry_after_s = retry_after_s
        self.replica_hint = replica_hint

    def to_doc(self) -> dict:
        doc = {"status": "SHED", "reason": self.reason,
               "detail": self.detail,
               "retry_after_s": self.retry_after_s}
        if self.replica_hint is not None:
            doc["replica_hint"] = self.replica_hint
        return doc


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "updated")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = max(float(rate), 1e-9)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.updated = now

    def take(self, cost: float, now: float) -> float:
        """0.0 when ``cost`` tokens were taken; else the seconds until
        enough tokens will have refilled (the retry-after hint)."""
        self.tokens = min(self.burst,
                          self.tokens + (now - self.updated) * self.rate)
        self.updated = now
        if self.tokens >= cost:
            self.tokens -= cost
            return 0.0
        return (cost - self.tokens) / self.rate


class _Client:
    __slots__ = ("id", "weight", "bucket", "pending", "admitted",
                 "shed", "registered_at")

    def __init__(self, cid: str, weight: float, bucket: _TokenBucket,
                 now: float):
        self.id = cid
        self.weight = weight
        self.bucket = bucket
        self.pending = 0        # admitted items not yet resolved
        self.admitted = 0       # items admitted, lifetime
        self.shed = 0           # requests shed, lifetime
        self.registered_at = now


class VerifydService:
    """The verification service behind the network front-end
    (module docstring; server.py owns the sockets).

    Lifecycle: construct -> ``await start()`` (binds the loop, registers
    the health watchdog, races+persists the batch model off-loop) ->
    ``register_client`` / ``verify`` -> ``await aclose()`` in a
    ``finally``.  ``time_source`` injects the admission clock (token
    buckets, deadlines, latency SLIs) for deterministic tests and the
    sim scenario.
    """

    def __init__(self, *, farm: VerificationFarm | None = None,
                 scheduler: TenantScheduler | None = None,
                 tuner: batchtune.BatchTuner | None = None,
                 max_clients: int = 64,
                 default_rate: float = DEFAULT_RATE,
                 default_burst: float = DEFAULT_BURST,
                 max_pending_items: int = DEFAULT_MAX_PENDING,
                 workers: int = 4,
                 default_max_queued: int = 64,
                 default_max_inflight: int = 4,
                 max_batch: int = 256,
                 post_params=None, post_seed: bytes | None = None,
                 genesis_id: bytes | None = None,
                 stall_deadline_s: float = 30.0,
                 drain_timeout_s: float = 60.0,
                 shard: str = "",
                 replica_hint: str | None = None,
                 time_source=time.monotonic,
                 device="cuda"):
        self.device = resolve(device)
        self._now = time_source
        # fleet shard name (verifyd/fleet.py): namespaces this
        # replica's tenant ids, per-client metric series, watchdog and
        # remediation hook, so N replicas can share one process — and
        # one registry, and one device scheduler — without colliding
        self.shard = str(shard)
        self._component = f"verifyd.{self.shard}" if self.shard \
            else "verifyd"
        # a fleet peer worth trying when THIS replica is full or
        # draining; rides in registry_full/shutting_down shed docs
        self.replica_hint = replica_hint
        self.max_clients = max(int(max_clients), 1)
        self.max_pending_items = max(int(max_pending_items), 1)
        self._default_rate = float(default_rate)
        self._default_burst = float(default_burst)
        self._drain_timeout_s = float(drain_timeout_s)
        self.tuner = tuner if tuner is not None else batchtune.BatchTuner(
            max_batch=max_batch,
            platform=batchtune.device_platform(self.device))
        self._own_farm = farm is None
        # genesis_id is a CONSENSUS parameter like the POST params: the
        # node signs ``genesis_id || domain || msg``, so a replica that
        # verifies with a different prefix fails every honest signature
        if genesis_id is not None and farm is not None:
            raise ValueError("genesis_id only configures the service's "
                             "own farm; set ed_verifier on the injected "
                             "farm instead")
        self.farm = farm if farm is not None else VerificationFarm(
            ed_verifier=(None if genesis_id is None
                         else EdVerifier(prefix=bytes(genesis_id))),
            post_params=post_params, post_seed=post_seed,
            max_batch=max_batch, stall_deadline_s=stall_deadline_s,
            tuner=self.tuner, device=self.device)
        if tuner is None and self.tuner._backend is None:
            # the tuner races the farm's REAL backends (batchtune.py);
            # wired after construction because each needs the other
            self.tuner._backend = self.farm._run_backend
        self._own_scheduler = scheduler is None
        self.scheduler = scheduler if scheduler is not None else \
            TenantScheduler(workers=workers,
                            default_max_queued=default_max_queued,
                            default_max_inflight=default_max_inflight,
                            time_source=time_source, device=self.device)
        if self.shard:
            # shard-namespaced tenant ids (runtime/scheduler.py
            # ShardScheduler): fleet replicas sharing one device
            # runtime must not collide on client identity
            self.scheduler = self.scheduler.namespaced(self.shard)
        # client table + pending counters are LOOP-ONLY by contract:
        # admission runs on the event loop, scheduler quanta only touch
        # the farm (no lock needed; the sim scenario and tests drive one
        # loop)
        self.clients: dict[str, _Client] = {}
        self._pending_items = 0
        self._closed = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._rate_ewma = 0.0   # resolved items/s (deadline admission)
        self.stats = {
            "requests": 0, "admitted_items": 0, "resolved_items": 0,
            "shed": {}, "pending_peak": 0, "clients_peak": 0,
        }
        from ..obs import health as health_mod

        # liveness contract: while admitted items are pending, the
        # resolved counter must advance within the deadline — a wedged
        # farm backend or dead scheduler worker shows on /readyz
        self._watchdog = health_mod.Watchdog(
            self._component,
            progress=lambda: self.stats["resolved_items"],
            active=lambda: self._pending_items > 0,
            deadline_s=stall_deadline_s)

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        """Bind the loop, register the health probe, and race+persist
        the batch-sizing model (off-loop; a warm host loads it)."""
        self._loop = asyncio.get_running_loop()
        from ..obs import health as health_mod
        from ..obs import remediate as remediate_mod

        health_mod.HEALTH.register(self._component, self._watchdog.check)
        # recovery hook beside the watchdog (obs/remediate.py): a
        # wedged-drain verdict resets the farm's lanes — stuck client
        # requests fail typed and re-submit instead of pinning the
        # service until an operator restart
        remediate_mod.ACTIONS.register(self._component,
                                       remediate_mod.RESET_FARM_LANES,
                                       self.farm.reset_lanes)
        await asyncio.to_thread(self.tuner.ensure_raced)

    async def aclose(self) -> None:
        """Graceful drain: stop admission, let admitted work finish,
        then close the scheduler and farm.  Idempotent; never strands a
        client future (undrained work resolves VerifydClosed)."""
        if self._closed:
            return
        self._closed = True
        try:
            # admitted jobs drain through scheduler workers + the farm
            # (both need this loop alive, hence to_thread)
            await asyncio.to_thread(self.scheduler.drain,
                                    self._drain_timeout_s)
            if self._own_scheduler:
                await asyncio.to_thread(self.scheduler.close)
            if self._own_farm:
                await self.farm.aclose()
        finally:
            from ..obs import health as health_mod
            from ..obs import remediate as remediate_mod

            health_mod.HEALTH.unregister(self._component,
                                         self._watchdog.check)
            remediate_mod.ACTIONS.unregister(
                self._component, remediate_mod.RESET_FARM_LANES,
                self.farm.reset_lanes)
            if self.shard:
                # this shard's service-level gauge series go with it
                metrics.verifyd_clients.remove(shard=self.shard)
                metrics.verifyd_pending.remove(shard=self.shard)

    # -- clients --------------------------------------------------------

    def _mcid(self, cid: str) -> str:
        """The client's metric-label identity: shard-namespaced so a
        client re-routed between fleet replicas in one process never
        shares (or clobbers) series across shards — and the OLD shard's
        unregister_client drops exactly its own series."""
        return f"{self.shard}/{cid}" if self.shard else cid

    def _gauge_clients(self) -> None:
        if self.shard:
            metrics.verifyd_clients.set(len(self.clients),
                                        shard=self.shard)
        else:
            metrics.verifyd_clients.set(len(self.clients))

    def _gauge_pending(self) -> None:
        if self.shard:
            metrics.verifyd_pending.set(self._pending_items,
                                        shard=self.shard)
        else:
            metrics.verifyd_pending.set(self._pending_items)

    def register_client(self, cid: str, *, weight: float | None = None,
                        rate: float | None = None,
                        burst: float | None = None,
                        max_queued: int | None = None,
                        max_inflight: int | None = None) -> dict:
        """Register (or re-configure) a client identity; pair with
        :meth:`unregister_client` when it disconnects.  Raises a typed
        ``registry_full`` Shed at the ``max_clients`` bound — the knob
        that keeps per-client metric cardinality finite."""
        if self._closed:
            raise VerifydClosed("verifyd closed")
        cid = str(cid)
        c = self.clients.get(cid)
        now = self._now()
        if c is None:
            if len(self.clients) >= self.max_clients:
                metrics.verifyd_shed.inc(client=self._mcid("-"),
                                         reason=protocol.SHED_REGISTRY_FULL)
                raise Shed(protocol.SHED_REGISTRY_FULL,
                           f"{len(self.clients)} clients registered "
                           f">= max_clients {self.max_clients}",
                           replica_hint=self.replica_hint)
            self.scheduler.register_tenant(
                cid, weight=weight if weight is not None else 1.0,
                max_queued=max_queued, max_inflight=max_inflight)
            c = self.clients[cid] = _Client(
                cid, weight if weight is not None else 1.0,
                _TokenBucket(rate if rate is not None
                             else self._default_rate,
                             burst if burst is not None
                             else self._default_burst, now), now)
            self._gauge_clients()
            self.stats["clients_peak"] = max(self.stats["clients_peak"],
                                             len(self.clients))
        else:
            # re-registration is RECONFIG: every unspecified knob keeps
            # its value (a rate-only update must not silently reset the
            # client's fair-share weight)
            if weight is not None:
                c.weight = weight
            if rate is not None:
                c.bucket.rate = max(float(rate), 1e-9)
            if burst is not None:
                c.bucket.burst = max(float(burst), 1.0)
            self.scheduler.register_tenant(
                cid, weight=weight, max_queued=max_queued,
                max_inflight=max_inflight)
        return {"client": cid, "weight": c.weight,
                "rate": c.bucket.rate, "burst": c.bucket.burst,
                "clients": len(self.clients),
                "max_clients": self.max_clients}

    def unregister_client(self, cid: str) -> bool:
        """Drop a client: its queued scheduler jobs fail, and EVERY
        per-client metric series disappears from the scrape (a gone
        identity must not pin registry entries)."""
        c = self.clients.pop(str(cid), None)
        if c is None:
            return False
        self.scheduler.unregister_tenant(c.id)
        self._gauge_clients()
        mcid = self._mcid(c.id)
        metrics.verifyd_client_pending.remove(client=mcid)
        for inst in (metrics.verifyd_requests, metrics.verifyd_items,
                     metrics.verifyd_shed):
            inst.remove_matching(client=mcid)
        return True

    # -- admission ------------------------------------------------------

    def _shed(self, c: _Client | None, cid: str, reason: str,
              detail: str = "",
              retry_after_s: float | None = None) -> None:
        if c is not None:
            c.shed += 1
        self.stats["shed"][reason] = self.stats["shed"].get(reason, 0) + 1
        mcid = self._mcid(cid if c is not None else "-")
        metrics.verifyd_shed.inc(client=mcid, reason=reason)
        metrics.verifyd_requests.inc(client=mcid, outcome="shed")
        hint = self.replica_hint if reason in (
            protocol.SHED_SHUTTING_DOWN,
            protocol.SHED_REGISTRY_FULL) else None
        raise Shed(reason, detail, retry_after_s, replica_hint=hint)

    def estimated_wait_s(self) -> float:
        """Predicted queue wait for a newly admitted item: the pending
        backlog over the resolved-rate EWMA (0.0 while idle or before
        any resolution — admission never blocks on an unknown)."""
        if self._pending_items <= 0 or self._rate_ewma <= 0:
            return 0.0
        return self._pending_items / self._rate_ewma

    async def verify(self, client_id: str, reqs: list,
                     lane: Lane = Lane.GOSSIP,
                     deadline_s: float | None = None,
                     trace_parent: str | None = None) -> list[bool]:
        """Admit one request (a list of farm request objects) and await
        its verdicts.  Raises :class:`Shed` (typed) on rejection and
        :class:`VerifydClosed` when the service shuts down mid-flight.
        ``trace_parent`` is an opaque caller-side span link token
        (``tracing.link_token()``); merge_captures() resolves it into a
        cross-process parent edge on the ``verifyd.request`` span.
        """
        cid = str(client_id)
        self.stats["requests"] += 1
        if self._closed:
            self._shed(self.clients.get(cid), cid,
                       protocol.SHED_SHUTTING_DOWN, "service is draining")
        c = self.clients.get(cid)
        if c is None:
            self._shed(None, cid, protocol.SHED_UNREGISTERED,
                       f"client {cid!r} is not registered")
        if not reqs:
            metrics.verifyd_requests.inc(client=self._mcid(cid),
                                         outcome="ok")
            return []
        lane = Lane(lane)
        n = len(reqs)
        now = self._now()
        cost = sum(KIND_WEIGHTS.get(r.kind, 1.0) for r in reqs)
        retry = c.bucket.take(cost, now)
        if retry > 0:
            self._shed(c, cid, protocol.SHED_RATE,
                       f"rate limit: {cost:.0f} weighted items over "
                       f"budget", retry_after_s=retry)
        share = self.max_pending_items / max(len(self.clients), 1)
        if (self._pending_items + n > self.max_pending_items // 2
                and c.pending + n > share):
            # heaviest first, work-conserving: below the high-water
            # mark any client may use idle capacity, but once the
            # queue is half full a client above its fair share sheds —
            # so a flood from one identity caps at its share while
            # light clients keep being admitted up to the global bound
            self._shed(c, cid, protocol.SHED_OVERLOAD,
                       f"client holds {c.pending} of "
                       f"{self._pending_items} pending "
                       f"(fair share {share:.0f})",
                       retry_after_s=self.estimated_wait_s())
        if self._pending_items + n > self.max_pending_items:
            self._shed(c, cid, protocol.SHED_QUEUE_FULL,
                       f"{self._pending_items} items pending >= bound "
                       f"{self.max_pending_items}",
                       retry_after_s=self.estimated_wait_s())
        if deadline_s is not None:
            est = self.estimated_wait_s()
            if est > deadline_s:
                # shedding NOW beats verifying late: the caller can
                # retry elsewhere instead of burning device time on a
                # verdict it will discard
                self._shed(c, cid, protocol.SHED_DEADLINE,
                           f"predicted wait {est:.3f}s exceeds "
                           f"deadline {deadline_s:.3f}s",
                           retry_after_s=est)
        attrs = ({"client": cid, "lane": lane.name.lower(), "n": n}
                 if tracing.is_enabled() else None)
        if attrs is not None and trace_parent:
            attrs["link"] = trace_parent
        sp = tracing.span("verifyd.request", attrs)
        with sp:
            parent = sp.id if tracing.is_enabled() else None
            loop = asyncio.get_running_loop()
            self._loop = loop

            def quantum():
                # scheduler worker thread: release this request's items
                # into the farm (on the loop) and wait for verdicts —
                # the wall cost charges the client's fair-share vtime
                return asyncio.run_coroutine_threadsafe(
                    self._drain_into_farm(reqs, lane, parent), loop).result()

            try:
                handle = self.scheduler.submit_call(
                    cid, quantum, kind="verifyd", deadline_s=deadline_s)
            except QuotaExceeded as exc:
                self._shed(c, cid, protocol.SHED_QUOTA, str(exc),
                           retry_after_s=self.estimated_wait_s())
            except KeyError:
                self._shed(c, cid, protocol.SHED_UNREGISTERED,
                           f"client {cid!r} lost its tenant")
            except SchedulerClosed:
                raise VerifydClosed("scheduler closed") from None
            self._pending_items += n
            c.pending += n
            c.admitted += n
            self.stats["admitted_items"] += n
            self.stats["pending_peak"] = max(self.stats["pending_peak"],
                                             self._pending_items)
            self._gauge_pending()
            metrics.verifyd_client_pending.set(c.pending,
                                               client=self._mcid(cid))
            t0 = self._now()
            settled = False

            def settle() -> None:
                # pending-item accounting releases when the WORK is
                # done, not when the awaiter goes away — a cancelled
                # await (client disconnect) leaves the quantum running
                # and its items still occupying the farm, and freeing
                # their admission slots early would let a
                # disconnect-churn loop bypass the overload shed
                nonlocal settled
                if settled:
                    return
                settled = True
                dt = self._now() - t0
                self._pending_items -= n
                self.stats["resolved_items"] += n
                if dt > 0:
                    rate = n / dt
                    self._rate_ewma = rate if self._rate_ewma <= 0 else (
                        0.2 * rate + 0.8 * self._rate_ewma)
                self._gauge_pending()
                live = self.clients.get(cid)
                if live is c:
                    c.pending -= n
                    metrics.verifyd_client_pending.set(
                        c.pending, client=self._mcid(cid))

            try:
                verdicts = await asyncio.wrap_future(handle.future)
            except (SchedulerClosed, farm_mod.FarmClosed) as exc:
                settle()
                raise VerifydClosed(str(exc)) from None
            except asyncio.CancelledError:
                handle.cancel()  # stops it if still queued

                def on_done(_f) -> None:
                    try:  # worker thread -> loop (state is loop-only)
                        loop.call_soon_threadsafe(settle)
                    except RuntimeError:  # loop gone at teardown
                        pass

                handle.future.add_done_callback(on_done)
                raise
            except BaseException:
                settle()
                raise
            settle()
            metrics.verifyd_request_seconds.observe(
                max(self._now() - t0, 0.0), lane=lane.name.lower())
            metrics.verifyd_requests.inc(client=self._mcid(cid),
                                         outcome="ok")
            kinds: dict[str, int] = {}
            for r in reqs:
                kinds[r.kind] = kinds.get(r.kind, 0) + 1
            for kind, count in kinds.items():
                metrics.verifyd_items.inc(count, client=self._mcid(cid),
                                          kind=kind)
            return verdicts

    async def _drain_into_farm(self, reqs: list, lane: Lane,
                               parent) -> list[bool]:
        # run_coroutine_threadsafe copies the WORKER thread's context, so
        # the request span is re-established explicitly: the farm.request
        # spans below parent into it, and their farm.batch linkage closes
        # the client -> batch causal chain
        async with tracing.span("verifyd.drain",
                                {"n": len(reqs),
                                 "lane": lane.name.lower()}
                                if tracing.is_enabled() else None,
                                parent=parent):
            return list(await asyncio.gather(
                *(self.farm.submit(r, lane) for r in reqs)))

    # -- introspection --------------------------------------------------

    def stats_doc(self) -> dict:
        return {
            "clients": len(self.clients),
            "max_clients": self.max_clients,
            "pending_items": self._pending_items,
            "max_pending_items": self.max_pending_items,
            "estimated_wait_s": round(self.estimated_wait_s(), 6),
            "resolved_items_per_sec": round(self._rate_ewma, 1),
            "requests": self.stats["requests"],
            "admitted_items": self.stats["admitted_items"],
            "resolved_items": self.stats["resolved_items"],
            "pending_peak": self.stats["pending_peak"],
            "shed": dict(self.stats["shed"]),
            "farm": {k: v for k, v in self.farm.stats.items()
                     if isinstance(v, (int, float))},
            "tuner": {
                "stats": dict(self.tuner.stats),
                "targets": {k: self.tuner.target_batch(k)
                            for k in sorted(KIND_WEIGHTS)},
            },
            "closed": self._closed,
            "shard": self.shard,
        }
