"""Dynamic micro-batching verification farm (port of
``spacemesh_tpu/verify/farm.py``).

The continuous-batching pattern from inference serving applied to
crypto verification:

* Callers submit one request (ed25519 signature, VRF proof, POST proof,
  poet membership, k2pow witness) on a priority lane and await a future
  with the boolean verdict.
* A per-kind scheduler coalesces pending requests and dispatches a
  batch when it reaches ``max_batch``, when the oldest request's
  lane-latency deadline (2-10 ms) expires, or immediately when the
  backend is idle, so a lone request never waits out the coalescing
  window.
* Three lanes, BLOCK > GOSSIP > SYNC, with per-lane queue bounds. A
  saturated sync lane backpressures its *submitters*; batches drain
  higher-priority lanes first, and a pending BLOCK request bypasses the
  in-flight dispatch cap.
* Identical in-flight requests deduplicate onto one future.

Verdicts are decision-identical to the inline verifiers: the farm calls
the same ``EdVerifier`` / ``VrfVerifier`` / ``post.verifier.verify_many``
/ ``verify_membership`` / ``ops.pow.verify_many`` code, only batched.

**On the card.** The farm takes ``device=`` (default ``"cuda"``; it
raises without a card) and runs the POST and k2pow kinds there. Each
batch runs in a default-executor thread (``asyncio.to_thread``); a
device batch first takes a CUDA stream from the farm's pool of
``max_inflight`` streams (waiting while all are taken), launches on it,
and synchronizes it before the verdicts return. No device tensor
outlives its batch, so nothing crosses streams, and a batch's copies
never queue behind another batch's kernels. The pool also caps the
memory in flight: each stream's caching allocator keeps at most one
batch's ROMix scratch, ``max_batch * k3 * 128 * N`` bytes (9.25 GiB at
256 proofs, k3=37, N=8192), so the default four streams hold at most
37 GiB of the card's 80 GB. The cached blocks belong to the process's
allocator, not the farm: a closed farm leaves them there for the next
user of the card. A batch wider than the free memory is split into several ROMix launches
by ``ops/romix_cuda.py``.

The spans are the JAX package's: ``farm.request`` per submit (a
coalesced duplicate records ``dedup`` and its ``twin``), ``farm.lane_wait``
under backpressure and ``farm.batch`` per dispatch; the batch span's
``members`` lists its requests' span ids and each request records its
``batch`` id and ``queue_wait_ms``. The backend threads inherit the batch
span as their parent, so the kernels' ``romix.dispatch`` and
``pow_verify.dispatch`` spans nest under it. ``stats`` is loop-only by
contract, checked by the race sanitizer's owner-write ``SharedField``.

One difference: a POST batch is not padded to a power of two (that
padding only spared XLA a compile per shape); the K3 subset is keyed per
item, so the verdicts are the same.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import enum
import os
import queue
import threading
import time
from typing import Optional

from ..core.signing import EdVerifier, VrfVerifier
from ..device import resolve
from ..post import verifier as post_verifier
from ..post.prover import ProofParams
from ..runtime.queue import KindLanes, LaneGroup, QueueClosed
from ..utils import metrics, sanitize, tracing


class FarmClosed(QueueClosed):
    """The farm was shut down while (or before) the request was pending."""


class Lane(enum.IntEnum):
    """Priority lanes, drained in ascending order."""

    BLOCK = 0   # block-critical: certificates, consensus-blocking checks
    GOSSIP = 1  # live gossip ingest
    SYNC = 2    # backfill / historical sync


KIND_SIG = "sig"
KIND_VRF = "vrf"
KIND_POST = "post"
KIND_MEMBERSHIP = "membership"
KIND_POW = "pow"
KINDS = (KIND_SIG, KIND_VRF, KIND_POST, KIND_MEMBERSHIP, KIND_POW)


@dataclasses.dataclass(frozen=True)
class SigRequest:
    """ed25519 signature check (EdVerifier semantics, domain-separated)."""

    domain: int
    public_key: bytes
    msg: bytes
    signature: bytes

    kind = KIND_SIG

    def key(self) -> tuple:
        return (KIND_SIG, self.domain, self.public_key, self.msg,
                self.signature)


@dataclasses.dataclass(frozen=True)
class VrfRequest:
    """ECVRF proof check (VrfVerifier semantics)."""

    public_key: bytes
    alpha: bytes
    proof: bytes

    kind = KIND_VRF

    def key(self) -> tuple:
        return (KIND_VRF, self.public_key, self.alpha, self.proof)


@dataclasses.dataclass(frozen=True)
class MembershipRequest:
    """PoET merkle-membership check (consensus.poet.verify_membership)."""

    member: bytes
    proof: object  # core.types.MerkleProof
    root: bytes
    leaf_count: int

    kind = KIND_MEMBERSHIP

    def key(self) -> tuple:
        return (KIND_MEMBERSHIP, self.member, self.root, self.leaf_count,
                self.proof.leaf_index, tuple(self.proof.nodes))


@dataclasses.dataclass(frozen=True)
class PostRequest:
    """POST proof check (post.verifier.VerifyItem)."""

    item: post_verifier.VerifyItem

    kind = KIND_POST

    def key(self) -> tuple:
        it = self.item
        return (KIND_POST, it.challenge, it.node_id, it.commitment,
                it.scrypt_n, it.total_labels, it.proof.nonce,
                it.proof.pow_nonce, tuple(it.proof.indices))


@dataclasses.dataclass(frozen=True)
class PowRequest:
    """k2pow witness check (ops/pow.py verify semantics), batched across
    items with per-item prefixes and difficulties."""

    challenge: bytes
    node_id: bytes
    difficulty: bytes
    nonce: int

    kind = KIND_POW

    def key(self) -> tuple:
        return (KIND_POW, self.challenge, self.node_id, self.difficulty,
                self.nonce)


class _Pending:
    __slots__ = ("req", "lane", "future", "enqueued", "deadline", "span")

    def __init__(self, req, lane: Lane, future: asyncio.Future,
                 enqueued: float, deadline: float):
        self.req = req
        self.lane = lane
        self.future = future
        self.enqueued = enqueued
        self.deadline = deadline
        self.span = tracing._NOP


class _KindState:
    """Per-kind scheduler state: the runtime's per-lane deques
    (runtime/queue.py KindLanes) + arrival signal + in-flight tasks."""

    def __init__(self, group: LaneGroup) -> None:
        self.lanes = KindLanes(group)
        self.arrived = asyncio.Event()
        self.inflight: set[asyncio.Task] = set()
        self.worker: Optional[asyncio.Task] = None


# default coalescing windows per lane (the 2-10 ms band): block work
# dispatches almost immediately, backfill may wait longest for a fuller
# batch
DEFAULT_MAX_WAIT_S = {Lane.BLOCK: 0.002, Lane.GOSSIP: 0.005,
                      Lane.SYNC: 0.010}
DEFAULT_LANE_BOUNDS = {Lane.BLOCK: 4096, Lane.GOSSIP: 8192,
                       Lane.SYNC: 16384}
# threads a wide sig/vrf batch fans out over
SIG_THREADS = min(8, os.cpu_count() or 1)


class VerificationFarm:
    """Micro-batching admission service for verification work.

    ``submit`` may only be called from a running event loop; workers
    start lazily on first submit and rebind automatically if the embedder
    runs multiple event loops over the farm's lifetime. ``device`` is
    where the POST and k2pow kinds run (default ``"cuda"``).
    ``post_timing`` accumulates the host seconds of the POST batches'
    stages (``post/verifier.py:verify_many``'s ``timing``).
    """

    def __init__(self, *, ed_verifier: EdVerifier | None = None,
                 vrf_verifier: VrfVerifier | None = None,
                 post_params: ProofParams | None = None,
                 post_seed: bytes | None = None,
                 max_batch: int = 256,
                 max_inflight: int = 4,
                 max_wait_s: dict[Lane, float] | None = None,
                 lane_bounds: dict[Lane, int] | None = None,
                 stall_deadline_s: float = 30.0,
                 tuner=None,
                 device="cuda"):
        self.device = resolve(device)
        self.ed_verifier = ed_verifier or EdVerifier()
        self.vrf_verifier = vrf_verifier or VrfVerifier()
        self.post_params = post_params or ProofParams()
        # deterministic K3 seed for reproducible verification (tests,
        # benches); None = fresh random seed per dispatch, exactly like
        # the inline verify_many default
        self.post_seed = post_seed
        self.max_batch = max(int(max_batch), 1)
        self.max_inflight = max(int(max_inflight), 1)
        self.max_wait_s = dict(DEFAULT_MAX_WAIT_S)
        if max_wait_s:
            self.max_wait_s.update(max_wait_s)
        self.lane_bounds = dict(DEFAULT_LANE_BOUNDS)
        if lane_bounds:
            self.lane_bounds.update(lane_bounds)
        # optional speculative batch-sizing policy (verifyd/batchtune.py
        # BatchTuner, or anything with note_arrival/observe/target_batch/
        # dispatch_now). None keeps the static max_batch + deadline policy.
        self._tuner = tuner
        self._pool = None  # lazy ThreadPoolExecutor for sig/vrf fan-out
        self._streams: queue.Queue | None = None  # lazy, on the card
        self._streams_lock = threading.Lock()
        self._timing_lock = threading.Lock()
        self.post_timing: dict[str, float] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        # mutated on the loop only: backend threads return results and
        # the loop-side finally block does the accounting
        self.stats = {
            "requests": 0, "dedup_hits": 0, "batches": 0, "items": 0,
            "max_occupancy": 0, "dispatch_s": 0.0, "rejected": 0,
            "queue_peak": {lane.name.lower(): 0 for lane in Lane},
        }
        self._shared_stats = sanitize.SharedField("verify.farm.stats",
                                                  mode="owner-write")
        self._group = LaneGroup(Lane, self.lane_bounds,
                                make_exc=lambda: FarmClosed("farm closed"),
                                on_depth=self._on_depth)
        self._kinds: dict[str, _KindState] = {}
        self._closed = False
        # liveness contract (obs/health.py): while ANY lane holds queued
        # requests, the dispatched-item counter must advance within the
        # deadline
        from ..obs import health as health_mod
        from ..obs import remediate as remediate_mod

        self._watchdog = health_mod.Watchdog(
            "verify.farm",
            progress=lambda: self.stats["items"],
            active=lambda: self._group.total() > 0,
            deadline_s=stall_deadline_s)
        health_mod.HEALTH.register("verify.farm", self._watchdog.check)
        # per-kind backend breakers (obs/remediate.py): a backend that
        # keeps raising fails its batches fast with a typed BreakerOpen
        # until a half-open probe batch finds it recovered
        self._breakers: dict[str, remediate_mod.CircuitBreaker] = {}
        self._breaker_cfg = {"failure_budget": 5, "window_s": 30.0,
                             "cooldown_s": 5.0, "cooldown_cap_s": 60.0}
        remediate_mod.ACTIONS.register("verify.farm",
                                       remediate_mod.RESET_FARM_LANES,
                                       self.reset_lanes)

    def _on_depth(self, lane: Lane, depth: int) -> None:
        lname = lane.name.lower()
        metrics.verify_farm_queue_depth.set(depth, lane=lname)
        if depth > self.stats["queue_peak"][lname]:
            self.stats["queue_peak"][lname] = depth

    # --- lifecycle ----------------------------------------------------

    def _bind(self) -> None:
        """Bind scheduler state to the CURRENT running loop; a farm that
        outlives an asyncio.run() rebinds on the next submit (pending
        work from the dead loop is unrecoverable and dropped)."""
        loop = asyncio.get_running_loop()
        if not self._group.bind(loop):
            return
        self._loop = loop
        self._kinds = {kind: _KindState(self._group) for kind in KINDS}

    def _ensure_worker(self, kind: str) -> None:
        st = self._kinds[kind]
        if st.worker is None or st.worker.done():
            st.worker = self._loop.create_task(self._worker(kind))

    def _fail_pending(self) -> None:
        """Fail every queued request and backpressure waiter with
        FarmClosed (the bound loop must still be alive)."""
        for st in self._kinds.values():
            st.arrived.set()
            for p in st.lanes.drain_all():
                if not p.future.done():
                    p.future.set_exception(FarmClosed("farm closed"))
        self._group.fail_waiters()

    async def aclose(self) -> None:
        """Stop workers and fail pending requests with FarmClosed."""
        self._closed = True
        self._group.closed = True
        workers = [st.worker for st in self._kinds.values()
                   if st.worker is not None]
        for w in workers:
            w.cancel()
        self._fail_pending()
        await asyncio.gather(*workers, return_exceptions=True)
        inflight = [t for st in self._kinds.values() for t in st.inflight]
        await asyncio.gather(*inflight, return_exceptions=True)
        self.shutdown()

    def shutdown(self) -> None:
        """Synchronous teardown: drop scheduler state and the worker
        pool. Safe to call twice. With the loop still alive, pending
        futures and backpressure waiters fail with FarmClosed, or
        coroutines awaiting submit() would hang forever."""
        self._closed = True
        self._group.closed = True
        for st in self._kinds.values():
            if st.worker is not None:
                try:
                    st.worker.cancel()
                except RuntimeError:  # task's loop already torn down
                    pass
        if self._loop is not None and not self._loop.is_closed():
            self._fail_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        from ..obs import health as health_mod
        from ..obs import remediate as remediate_mod

        health_mod.HEALTH.unregister("verify.farm", self._watchdog.check)
        remediate_mod.ACTIONS.unregister("verify.farm",
                                         remediate_mod.RESET_FARM_LANES,
                                         self.reset_lanes)
        for br in self._breakers.values():
            remediate_mod.BREAKERS.unregister(br)
        self._breakers.clear()

    def reset_lanes(self) -> None:
        """The ``reset_farm_lanes`` recovery action: fail every queued
        request and backpressure waiter with a typed FarmClosed and
        restart the workers, so a wedged lane recovers to an empty,
        serving farm. Pending verdicts are LOST (their callers see the
        typed error and re-submit); in-flight backend batches resolve
        normally."""
        if self._closed or self._loop is None or self._loop.is_closed():
            return
        reset_exc = FarmClosed("farm lanes reset by remediation")
        for st in self._kinds.values():
            st.arrived.set()
            for p in st.lanes.drain_all():
                # the farm keeps serving: every drained entry's lane slot
                # must be released or the lanes stay "full" forever
                self._group.release(p.lane)
                if self._group.dedup.get(p.req.key()) is p:
                    del self._group.dedup[p.req.key()]
                if not p.future.done():
                    p.future.set_exception(reset_exc)
            if st.worker is not None and not st.worker.done():
                st.worker.cancel()
                st.worker = None
        self._group.fail_waiters()

    def _breaker(self, kind: str):
        br = self._breakers.get(kind)
        if br is None:
            from ..obs import remediate as remediate_mod

            br = self._breakers[kind] = remediate_mod.BREAKERS.register(
                remediate_mod.CircuitBreaker(
                    f"verify.farm.{kind}",
                    time_source=self._loop.time,
                    **self._breaker_cfg))
        return br

    # --- submission ---------------------------------------------------

    async def submit(self, req, lane: Lane = Lane.GOSSIP) -> bool:
        """Queue one verification and await its verdict."""
        if self._closed:
            raise FarmClosed("farm closed")
        self._bind()
        lane = Lane(lane)
        self._shared_stats.touch()
        self.stats["requests"] += 1
        metrics.verify_farm_requests.inc(kind=req.kind,
                                         lane=lane.name.lower())
        if self._tuner is not None:
            # arrival-rate EWMA feeds the speculative dispatch decision
            self._tuner.note_arrival(req.kind, self._loop.time())
        key = req.key()
        ent = self._group.dedup.get(key)
        if ent is not None and not ent.future.done():
            self.stats["dedup_hits"] += 1
            metrics.verify_farm_dedup_hits.inc()
            if lane < ent.lane:
                # a higher-priority caller must not inherit the queued
                # twin's lane position
                self._promote(ent, lane)
            # the twin's request span owns the lifecycle; this caller's
            # span records that it coalesced onto it
            async with tracing.span(
                    "farm.request",
                    {"kind": req.kind, "lane": lane.name.lower(),
                     "dedup": True, "twin": ent.span.id}
                    if tracing.is_enabled() else None):
                return await self._await(ent.future)
        sp = tracing.span("farm.request",
                          {"kind": req.kind, "lane": lane.name.lower()}
                          if tracing.is_enabled() else None)
        with sp:
            # backpressure: a full lane blocks ITS OWN submitters only
            # (the waiter/slot-handoff semantics live in runtime/queue.py)
            if self._group.count(lane) >= self.lane_bounds[lane]:
                async with tracing.span("farm.lane_wait",
                                        {"lane": lane.name.lower()}
                                        if tracing.is_enabled() else None):
                    await self._group.acquire(lane)
            now = self._loop.time()
            pend = _Pending(req, lane, self._loop.create_future(), now,
                            now + self.max_wait_s[lane])
            pend.span = sp
            st = self._kinds[req.kind]
            st.lanes.append(pend)
            self._group.dedup[key] = pend
            self._ensure_worker(req.kind)
            st.arrived.set()
            return await self._await(pend.future)

    @staticmethod
    async def _await(fut: asyncio.Future) -> bool:
        # shield: dedup can hand one future to many awaiters — a caller
        # cancelling its own await must not cancel everyone's verdict
        try:
            return await asyncio.shield(fut)
        except asyncio.CancelledError:
            if fut.cancelled():
                raise FarmClosed("farm closed") from None
            raise

    # --- scheduler ----------------------------------------------------

    async def _worker(self, kind: str) -> None:
        st = self._kinds[kind]
        try:
            while not self._closed:
                st.arrived.clear()
                if st.lanes.count() == 0:
                    await st.arrived.wait()
                    continue
                # one loop turn so same-tick submitters (gather bursts)
                # land in this batch
                await asyncio.sleep(0)
                await self._coalesce(kind, st)
                if self._closed:
                    break
                # take() is NOT capped at the tuned target: a deeper
                # backlog dispatching as one batch amortizes better and
                # feeds the tuner observations above the target
                batch = st.lanes.take(self.max_batch)
                if not batch:
                    continue
                self._on_taken(batch)
                task = self._loop.create_task(self._dispatch(kind, batch))
                st.inflight.add(task)
                task.add_done_callback(st.inflight.discard)
        except asyncio.CancelledError:
            pass

    def _batch_limit(self, kind: str) -> int:
        """Per-kind batch-size cap: the tuner's measured-rate target when
        one is attached (capped by max_batch), else max_batch."""
        if self._tuner is not None:
            target = self._tuner.target_batch(kind)
            if target:
                return max(1, min(int(target), self.max_batch))
        return self.max_batch

    def _tuner_go(self, kind: str, st: _KindState, n: int,
                  now: float) -> bool:
        """Speculative early dispatch: the tuner predicts that waiting for
        a fuller batch costs more than it gains. It can only dispatch
        EARLIER than the lane deadline."""
        if self._tuner is None:
            return False
        oldest = min((q[0].enqueued for q in st.lanes.lanes.values()
                      if q), default=now)
        return bool(self._tuner.dispatch_now(kind, n,
                                             max(now - oldest, 0.0)))

    async def _coalesce(self, kind: str, st: _KindState) -> None:
        """Hold the batch open until it is worth dispatching: the batch
        is full; the backend is idle; the oldest pending deadline has
        passed and an in-flight slot is free; or the tuner says the
        marginal wait exceeds the predicted gain. The in-flight cap gates
        every dispatch, but a pending BLOCK request bypasses it."""
        while not self._closed:
            n = st.lanes.count()
            if n == 0:
                return
            can_go = (len(st.inflight) < self.max_inflight
                      or bool(st.lanes.lanes[Lane.BLOCK]))
            now = self._loop.time()
            if self._tuner is None:
                # static policy: full batch, idle fast-path, deadline
                go = (n >= self.max_batch
                      or not st.inflight
                      or st.lanes.earliest_deadline() <= now)
            else:
                # tuned policy: the idle fast-path routes through the
                # speculative model too
                go = (n >= self._batch_limit(kind)
                      or st.lanes.earliest_deadline() <= now
                      or self._tuner_go(kind, st, n, now))
            if can_go and go:
                return
            st.arrived.clear()
            arr = self._loop.create_task(st.arrived.wait())
            waits = {arr} | set(st.inflight)
            # dispatch-eligible: sleep at most until the deadline;
            # capped: sleep until a slot frees or something arrives
            timeout = max(st.lanes.earliest_deadline() - self._loop.time(),
                          0.0005) if can_go else None
            await asyncio.wait(waits, timeout=timeout,
                               return_when=asyncio.FIRST_COMPLETED)
            arr.cancel()

    def _promote(self, ent: _Pending, lane: Lane) -> None:
        """Move a still-queued pending entry to a higher-priority lane
        (dedup hit from that lane); no-op once it is in a dispatch."""
        st = self._kinds[ent.req.kind]
        if not st.lanes.remove(ent):
            return  # already taken into a batch
        ent.lane = lane
        ent.deadline = min(ent.deadline,
                           self._loop.time() + self.max_wait_s[lane])
        st.lanes.append(ent)
        st.arrived.set()

    def _on_taken(self, batch: list[_Pending]) -> None:
        now = self._loop.time()
        for p in batch:
            self._group.release(p.lane)
            wait = max(now - p.enqueued, 0.0)
            metrics.verify_farm_queue_wait_seconds.observe(
                wait, kind=p.req.kind)
            p.span.set(queue_wait_ms=round(wait * 1e3, 3))

    async def _dispatch(self, kind: str, batch: list[_Pending]) -> None:
        from ..obs.remediate import BreakerOpen

        # the batch span is the hub of the capture: its args carry the
        # member request-span ids, and each member records the batch id
        # back, so a request's wall time decomposes into lane wait vs its
        # batch's backend dispatch
        bsp = tracing.span("farm.batch",
                           {"kind": kind, "n": len(batch),
                            "members": [p.span.id for p in batch]}
                           if tracing.is_enabled() else None)
        for p in batch:
            p.span.set(batch=bsp.id)
        t0 = time.perf_counter()
        br = self._breaker(kind)
        try:
            with bsp:
                if not br.allow():
                    # the kind's backend is known-dead: fail the batch
                    # fast (a half-open probe batch goes through after
                    # the cooldown)
                    raise BreakerOpen(br.component, br.retry_in())
                results = await asyncio.to_thread(
                    self._run_backend, kind, [p.req for p in batch])
        except Exception as exc:  # noqa: BLE001 — fail the batch, not the farm
            if not isinstance(exc, BreakerOpen):
                br.record_failure()
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
        else:
            br.record_success()
            for p, ok in zip(batch, results):
                if not p.future.done():
                    p.future.set_result(bool(ok))
                if not bool(ok):
                    self.stats["rejected"] += 1
            if self._tuner is not None:
                # successful batches only refine the tuner's model
                self._tuner.observe(kind, len(batch),
                                    time.perf_counter() - t0)
        finally:
            dt = time.perf_counter() - t0
            for p in batch:
                if self._group.dedup.get(p.req.key()) is p:
                    del self._group.dedup[p.req.key()]
            self._shared_stats.touch()
            self.stats["batches"] += 1
            self.stats["items"] += len(batch)
            if len(batch) > self.stats["max_occupancy"]:
                self.stats["max_occupancy"] = len(batch)
            self.stats["dispatch_s"] += dt
            metrics.verify_farm_batches.inc(kind=kind)
            metrics.verify_farm_batch_occupancy.observe(len(batch))
            metrics.verify_farm_dispatch_seconds.observe(dt, kind=kind)

    # --- backends (run in a worker thread) ----------------------------

    @contextlib.contextmanager
    def _device_slot(self):
        """One device batch's stream (module docstring): taken from the
        pool of ``max_inflight`` (blocking while all are out), current
        for this thread while the batch runs, synchronized before the
        verdicts return. Nothing on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        import torch

        with self._streams_lock:
            if self._streams is None:
                self._streams = queue.Queue()
                for _ in range(self.max_inflight):
                    self._streams.put(torch.cuda.Stream(self.device))
            # the pool is made once; the blocking get() waits outside
            # the lock
            streams = self._streams
        stream = streams.get()
        try:
            with torch.cuda.stream(stream):
                yield
            stream.synchronize()
        finally:
            streams.put(stream)

    def _run_backend(self, kind: str, reqs: list) -> list[bool]:
        if kind == KIND_SIG:
            from ..core import signing

            if signing._HAVE_CRYPTOGRAPHY:
                # OpenSSL per-item releases the GIL: thread fan-out wins
                return self._fanout(self._verify_sig, reqs)
            # pure-Python path: one random-linear-combination batch
            # check (Pippenger MSM) beats N independent ladders
            return self.ed_verifier.verify_many(
                [(r.domain, r.public_key, r.msg, r.signature)
                 for r in reqs])
        if kind == KIND_VRF:
            return self._fanout(self._verify_vrf, reqs)
        if kind == KIND_MEMBERSHIP:
            from ..consensus.poet import verify_membership

            return [verify_membership(r.member, r.proof, r.root,
                                      r.leaf_count) for r in reqs]
        if kind == KIND_POST:
            with self._device_slot():
                return self._verify_posts(reqs)
        if kind == KIND_POW:
            from ..ops import pow as k2pow

            with self._device_slot():
                return k2pow.verify_many(
                    [(r.challenge, r.node_id, r.difficulty, r.nonce)
                     for r in reqs], device=self.device)
        raise ValueError(f"unknown verify kind {kind!r}")

    def _verify_sig(self, r: SigRequest) -> bool:
        return self.ed_verifier.verify(r.domain, r.public_key, r.msg,
                                       r.signature)

    def _verify_vrf(self, r: VrfRequest) -> bool:
        return self.vrf_verifier.verify(r.public_key, r.alpha, r.proof)

    def _fanout(self, fn, reqs: list) -> list[bool]:
        """Chunk a big batch across the worker pool (OpenSSL ed25519
        releases the GIL, so wide batches verify on every core)."""
        threads = SIG_THREADS
        if threads <= 1 or len(reqs) < 2 * threads:
            return [fn(r) for r in reqs]
        if self._pool is None:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=threads,
                thread_name_prefix="verify-farm")
        chunk = (len(reqs) + threads - 1) // threads
        parts = [reqs[i:i + chunk] for i in range(0, len(reqs), chunk)]
        futs = [self._pool.submit(lambda part=part: [fn(r) for r in part])
                for part in parts]
        out: list[bool] = []
        for f in futs:
            out.extend(f.result())
        return out

    def _verify_posts(self, reqs: list[PostRequest]) -> list[bool]:
        timing: dict[str, float] = {}
        out = post_verifier.verify_many(
            [r.item for r in reqs], self.post_params, seed=self.post_seed,
            device=self.device, timing=timing)
        with self._timing_lock:
            for k, v in timing.items():
                self.post_timing[k] = self.post_timing.get(k, 0.0) + v
        return out
