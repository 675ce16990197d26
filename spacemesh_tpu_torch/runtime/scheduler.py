"""Fair-share multi-tenant scheduling of one device.

Port of ``spacemesh_tpu/runtime/scheduler.py`` for one card. A smesher with
many identities (BASELINE.json's "16 smeshers x 4 SU") serves them all from
one device. Per-job ownership (one Initializer or Prover holding the device
for a whole job) leaves it idle in every host-side gap; the scheduler
admits work from every tenant into the dispatch -> retire engine
(``runtime/engine.py``) instead:

* **Per-tenant queues and fair share.** Tenants register with a weight;
  each quantum (a prove window, a verify batch, a k2pow search, a packed
  init dispatch's lane share) charges its tenant's virtual time by wall
  cost / weight, and the next quantum goes to the runnable tenant with the
  least virtual time (stride scheduling).
* **Deadlines.** A job submitted with ``deadline_s`` jumps fair-share order
  once its deadline is within the admission slack (EDF among overdue jobs).
* **Quotas.** Per-tenant ``max_queued`` (submit raises
  :class:`QuotaExceeded`) and ``max_inflight`` (concurrent quanta).
* **Cross-tenant init packing.** A packer thread cuts lanes from many
  tenants' init jobs, in fair-share order, into one per-lane-commitment
  label batch (``ops/scrypt.py:scrypt_labels_packed``), keeps ``inflight``
  packs on the device through the engine, writes each segment's bytes to
  its tenant's store and folds each tenant's VRF minimum on the host
  (``runtime/workloads.py:fold_min_host``, bit-identical to the device
  scan).
* **Gang-scheduled prove windows.** One prove window (a whole disk pass)
  runs as one quantum on one worker, gated by a ``gang_windows``
  semaphore, so at most that many windows hold device state at once.
* **Tenant labels.** The ``runtime_*`` metrics of scheduled work carry the
  tenant id.

On the card every worker thread and the packer launch on a CUDA stream of
their own. On one shared stream a quantum's device-to-host copy would wait
behind every pack queued before it (up to ``inflight`` ROMix launches of
about 31 ms each at 32768 lanes). Each quantum's tensors live on the
stream of the thread that made them, and no device tensor outlives its
quantum, so nothing crosses streams. The scheduler takes ``device=``
(default ``"cuda"``; it raises without a card) and runs every quantum and
pack there.

The locks and conditions are the race sanitizer's (``utils/sanitize.py``)
and the tenant tables are declared shared to it; each quantum is a
``runtime.quantum`` span, each pack's launches a ``runtime.pack.dispatch``
span and each tenant's share of a retired pack a ``runtime.segment`` span.

Packs take the shared mesh routing (``ops/autotune.py:
resolve_auto_mesh``, as ``spacemesh_tpu/runtime/scheduler.py`` does): on
the card it stripes over every visible card, so with one card each pack
runs on the scheduler's device; when it stripes, each stripe's labels run
on its own device and stream (``parallel/mesh.py``) and come back through
a ``HostCopy`` on that stream. The packs' lanes split raggedly over the
stripes; the JAX package pads them to a shape bucket the mesh divides.

The scheduler is thread-based and needs no event loop.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import threading
import time
import zlib
from collections import deque
from pathlib import Path

from ..device import resolve
from ..utils import metrics, sanitize, tracing
from . import engine, workloads

DEFAULT_PACK_LANES = 4096  # the JAX package's pack width, kept on the CPU
_DEADLINE_SLACK_S = 0.05   # jobs due within this window jump fair share


class SchedulerClosed(RuntimeError):
    """The scheduler was closed while (or before) the job was pending."""


class QuotaExceeded(RuntimeError):
    """The tenant's max_queued admission bound rejected the submit."""


class JobHandle:
    """One submitted job: a concurrent future plus identity and job labels.

    Consume every handle: wait on :meth:`result` (or :meth:`wait`) on every
    path, or :meth:`cancel` it in a ``finally``."""

    def __init__(self, scheduler: "TenantScheduler", job_id: str,
                 tenant: str, kind: str):
        self.scheduler = scheduler
        self.id = job_id
        self.tenant = tenant
        self.kind = kind
        self.future: concurrent.futures.Future = concurrent.futures.Future()

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: float | None = None):
        return self.future.result(timeout)

    def wait(self, timeout: float | None = None) -> bool:
        concurrent.futures.wait([self.future], timeout=timeout)
        return self.future.done()

    def cancel(self) -> bool:
        """Cancel a queued job (or stop an init job packing further lanes).
        A running quantum finishes; a cancelled prove job stops at its next
        window boundary."""
        return self.scheduler._cancel(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<JobHandle {self.id} {self.kind}@{self.tenant}>"


class _Tenant:
    __slots__ = ("id", "weight", "max_inflight", "max_queued", "vtime",
                 "running", "jobs", "init_jobs", "queued_jobs")

    def __init__(self, tid: str, weight: float, max_inflight: int,
                 max_queued: int):
        self.id = tid
        self.weight = max(float(weight), 1e-6)
        self.max_inflight = max(int(max_inflight), 1)
        self.max_queued = max(int(max_queued), 1)
        self.vtime = 0.0
        self.running = 0          # worker quanta executing now
        self.jobs: deque = deque()       # queued worker jobs (FIFO)
        self.init_jobs: deque = deque()  # init jobs with lanes left to pack
        self.queued_jobs = 0      # admission count (all kinds, live jobs)

    def charge(self, seconds: float) -> None:
        self.vtime += seconds / self.weight


class _Job:
    """A worker-pool job: runs as one or more quanta."""

    __slots__ = ("handle", "tenant", "kind", "fn", "deadline", "cancelled",
                 "gang", "abort")

    def __init__(self, handle: JobHandle, tenant: _Tenant, kind: str, fn,
                 deadline: float | None, gang: bool = False, abort=None):
        self.handle = handle
        self.tenant = tenant
        self.kind = kind
        # fn() -> ("done", result) | ("continue", None); a multi-quantum
        # job (prove) returns "continue" between windows
        self.fn = fn
        self.deadline = deadline
        self.cancelled = False
        self.gang = gang
        # abort() releases mid-job resources (an open prove session) when
        # the job resolves without completing; never called while a
        # quantum runs
        self.abort = abort


class _InitJob:
    """A packed init job: the packer composes its lanes, not a worker."""

    __slots__ = ("handle", "tenant", "store", "meta", "writer", "cw",
                 "total", "next_index", "outstanding", "written",
                 "min_carry", "cancelled", "error", "progress",
                 "finalized", "crc")

    def __init__(self, handle: JobHandle, tenant: _Tenant, store, meta,
                 writer, cw, progress=None):
        self.handle = handle
        self.tenant = tenant
        self.store = store
        self.meta = meta
        self.writer = writer
        self.cw = cw                       # (8,) u32 commitment words
        self.total = meta.total_labels
        self.next_index = meta.labels_written   # next lane to pack
        self.outstanding = 0               # lanes dispatched, not retired
        self.written = meta.labels_written
        # running CRC32 of the bytes written inline: a job's segments retire
        # in ascending order (next_index is monotone and packs retire
        # FIFO); finalize appends it to the checkpoint ledger, so the next
        # reopen's recovery does not roll the cursor back
        self.crc = 0
        self.min_carry = None              # (u128 value, index) | None
        if meta.vrf_nonce is not None and meta.vrf_nonce_value is not None:
            v = bytes.fromhex(meta.vrf_nonce_value)
            self.min_carry = (int.from_bytes(v, "little"), meta.vrf_nonce)
        self.cancelled = False
        self.error: Exception | None = None
        self.progress = progress
        self.finalized = False

    @property
    def packable(self) -> int:
        return 0 if self.cancelled or self.error else \
            self.total - self.next_index


@dataclasses.dataclass
class PackStats:
    """The packer's host-side accounting (the packer thread writes it)."""

    packs: int = 0
    lanes: int = 0
    segments: int = 0
    fetch_s: float = 0.0   # blocked on the packs' device-to-host copies
    fold_s: float = 0.0    # fold_min_host over every segment
    write_s: float = 0.0   # store writes (or writer submits) and CRCs

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class TenantScheduler:
    """Many identities, one device (module docstring).

    ``workers``        worker threads for prove/verify/pow/call quanta.
    ``pack_lanes``     target lanes per packed init dispatch. Default:
                       :data:`DEFAULT_PACK_LANES` on the CPU; on the card
                       the Initializer's batch (32768), where ROMix runs at
                       its full rate (ROMix splits a pack whose V scratch
                       does not fit the free memory).
    ``inflight``       packed init dispatches in flight (engine window).
    ``gang_windows``   prove windows allowed on the device at once.
    ``writer_threads`` background writer threads per init job (0 = writes
                       inline on the packer thread).
    ``time_source``    injectable clock for deadline tests.
    ``device``         where every quantum and pack runs (default "cuda").

    Lifecycle: construct -> (``start`` unless ``autostart``) -> submit;
    ``unregister_tenant`` / ``close`` in a ``finally``.
    """

    def __init__(self, *, workers: int = 2,
                 pack_lanes: int | None = None,
                 inflight: int = 3, gang_windows: int = 1,
                 writer_threads: int = 0,
                 pack_linger_s: float = 0.002,
                 default_weight: float = 1.0,
                 default_max_inflight: int = 4,
                 default_max_queued: int = 256,
                 autostart: bool = True,
                 time_source=time.monotonic,
                 device="cuda"):
        from ..post import initializer

        self.device = resolve(device)
        if pack_lanes is None:
            pack_lanes = (initializer.DEFAULT_BATCH
                          if self.device.type == "cuda"
                          else DEFAULT_PACK_LANES)
        self.pack_lanes = max(int(pack_lanes), 1)
        self.inflight = max(int(inflight), 1)
        self.writer_threads = int(writer_threads)
        self.pack_linger_s = max(float(pack_linger_s), 0.0)
        self._defaults = (default_weight, default_max_inflight,
                          default_max_queued)
        self._now = time_source
        self._lock = sanitize.lock("runtime.scheduler")
        self._work = sanitize.condition(  # workers wait here
            "runtime.scheduler.work", self._lock)
        self._pack_work = sanitize.condition(  # the packer waits
            "runtime.scheduler.pack_work", self._lock)
        self._idle = sanitize.condition(  # drain() waits
            "runtime.scheduler.idle", self._lock)
        # the tenant tables are declared shared to the lockset sanitizer:
        # submitters, workers, the packer and close() all meet here,
        # always under _lock
        self._shared = sanitize.SharedField("runtime.scheduler.tenants")
        self._tenants: dict[str, _Tenant] = {}
        self._jobs: dict[str, object] = {}  # live job id -> job
        self._ids = itertools.count(1)
        self._closed = False
        self._lane_cost_ema = 1e-4  # seconds per packed init lane
        self.pack_stats = PackStats()
        self._gang = threading.Semaphore(max(int(gang_windows), 1))
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"runtime-worker-{i}")
            for i in range(max(int(workers), 1))]
        self._packer = threading.Thread(target=self._packer_loop,
                                        daemon=True, name="runtime-packer")
        self._started = False
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for t in self._workers:
            t.start()
        self._packer.start()

    def close(self) -> None:
        """Stop the pool; queued jobs fail with SchedulerClosed. Safe to
        call twice. Running quanta finish, and their jobs then resolve as
        closed."""
        with self._lock:
            self._shared.touch()
            if self._closed:
                return
            self._closed = True
            failed: list = []
            for t in self._tenants.values():
                failed.extend(t.jobs)
                t.jobs.clear()
                t.init_jobs.clear()
            self._work.notify_all()
            self._pack_work.notify_all()
        for job in failed:
            self._resolve(job, error=SchedulerClosed("scheduler closed"))
        if self._started:
            for t in self._workers:
                t.join(timeout=30)
            self._packer.join(timeout=30)
        # no thread touches jobs past this point: finalize what the packer
        # left mid-flight (writers drained and closed, futures failed), so
        # close() never strands a handle
        with self._lock:
            self._shared.touch()
            leftovers = list(self._jobs.values())
        closed_exc = SchedulerClosed("scheduler closed")
        for job in leftovers:
            if isinstance(job, _InitJob):
                job.error = job.error or closed_exc
                self._finalize_init(job)
            else:
                self._resolve(job, error=closed_exc)

    def __enter__(self) -> "TenantScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted job resolved; False on timeout."""
        deadline = None if timeout is None else self._now() + timeout
        with self._idle:
            self._shared.touch()
            while self._jobs:
                left = None if deadline is None else deadline - self._now()
                if left is not None and left <= 0:
                    return False
                self._idle.wait(left if left is not None else 1.0)
        return True

    def _stream(self):
        """The calling thread's own CUDA stream on the card (module
        docstring); nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        import torch

        return torch.cuda.stream(torch.cuda.Stream(self.device))

    # -- tenants -------------------------------------------------------

    def register_tenant(self, tid: str, *, weight: float | None = None,
                        max_inflight: int | None = None,
                        max_queued: int | None = None) -> str:
        """Register (or re-weight) a tenant; pair with
        :meth:`unregister_tenant` when the identity goes away."""
        dw, di, dq = self._defaults
        with self._lock:
            self._shared.touch()
            t = self._tenants.get(tid)
            if t is None:
                t = self._tenants[tid] = _Tenant(
                    tid, weight if weight is not None else dw,
                    max_inflight if max_inflight is not None else di,
                    max_queued if max_queued is not None else dq)
                # a new tenant starts at the leading edge of virtual time,
                # not at 0, or it would owe the whole backlog of every
                # long-running tenant and stall them on arrival
                live = [x.vtime for x in self._tenants.values() if x is not t]
                t.vtime = min(live) if live else 0.0
            else:
                if weight is not None:
                    t.weight = max(float(weight), 1e-6)
                if max_inflight is not None:
                    t.max_inflight = max(int(max_inflight), 1)
                if max_queued is not None:
                    t.max_queued = max(int(max_queued), 1)
        return tid

    def unregister_tenant(self, tid: str) -> None:
        """Drop a tenant: its queued jobs fail with SchedulerClosed, and
        its per-tenant metric series leave the registry."""
        exc = SchedulerClosed(f"tenant {tid} unregistered")
        with self._lock:
            self._shared.touch()
            t = self._tenants.pop(tid, None)
            if t is None:
                return
            failed = list(t.jobs)
            failed_inits = []
            for ij in t.init_jobs:
                if ij.outstanding == 0:
                    failed_inits.append(ij)
                else:
                    # lanes still in flight: the packer's retire finalizes
                    # (and resolves) the job when they land
                    ij.error = ij.error or exc
            t.jobs.clear()
            t.init_jobs.clear()
        for job in failed:
            self._resolve(job, error=exc)
        for job in failed_inits:
            # through finalize: the job's writer and store close with it
            job.error = job.error or exc
            self._finalize_init(job)
        # the resolutions above count nothing into these series (the JAX
        # package's failed jobs add them back after it removes them)
        metrics.runtime_tenant_queued.remove(tenant=tid)
        for inst in (metrics.runtime_tenant_jobs,
                     metrics.runtime_tenant_labels,
                     metrics.runtime_quantum_seconds):
            inst.remove_matching(tenant=tid)

    def tenants(self) -> list[str]:
        with self._lock:
            self._shared.touch()
            return sorted(self._tenants)

    def namespaced(self, shard: str) -> "ShardScheduler":
        """A view that registers every tenant as ``<shard>/<tid>``, so
        several services can share one scheduler without their tenant ids
        colliding."""
        return ShardScheduler(self, shard)

    # -- submission ----------------------------------------------------

    # guarded by: self._lock — every submit_* caller enters with the scheduler lock held
    def _admit(self, tid: str, kind: str) -> tuple[_Tenant, JobHandle]:
        """Under the lock: admission and quota checks for one job."""
        if self._closed:
            raise SchedulerClosed("scheduler closed")
        t = self._tenants.get(tid)
        if t is None:
            raise KeyError(f"tenant {tid!r} is not registered")
        if t.queued_jobs >= t.max_queued:
            metrics.runtime_tenant_jobs.inc(tenant=tid, kind=kind,
                                            state="rejected")
            raise QuotaExceeded(
                f"tenant {tid}: {t.queued_jobs} jobs queued >= "
                f"max_queued {t.max_queued}")
        handle = JobHandle(self, f"{kind}-{next(self._ids)}", tid, kind)
        t.queued_jobs += 1
        metrics.runtime_tenant_queued.set(t.queued_jobs, tenant=tid)
        return t, handle

    def _enqueue(self, tid: str, kind: str, fn, deadline_s: float | None,
                 gang: bool = False, abort=None) -> JobHandle:
        with self._lock:
            self._shared.touch()
            t, handle = self._admit(tid, kind)
            job = _Job(handle, t, kind, fn,
                       None if deadline_s is None
                       else self._now() + deadline_s, gang=gang, abort=abort)
            self._jobs[handle.id] = job
            t.jobs.append(job)
            self._work.notify()
        return handle

    def submit_call(self, tid: str, fn, *, kind: str = "call",
                    deadline_s: float | None = None) -> JobHandle:
        """A single-quantum job: ``fn()`` runs on a worker; its return
        value resolves the handle."""
        return self._enqueue(tid, kind, lambda: ("done", fn()), deadline_s)

    def submit_pow(self, tid: str, challenge: bytes, node_id: bytes,
                   difficulty: bytes, *, deadline_s: float | None = None,
                   **search_opts) -> JobHandle:
        """A k2pow nonce search as one quantum (``ops/pow.py:search``)."""
        from ..ops import pow as k2pow

        return self.submit_call(
            tid, lambda: k2pow.search(challenge, node_id, difficulty,
                                      tenant=tid, device=self.device,
                                      **search_opts),
            kind="k2pow", deadline_s=deadline_s)

    def submit_verify(self, tid: str, items: list, params=None, *,
                      seed: bytes | None = None,
                      deadline_s: float | None = None) -> JobHandle:
        """One batched PoST verification (``post/verifier.py:verify_many``)
        as one quantum; resolves to the per-item bool list."""
        from ..post import verifier as post_verifier

        return self.submit_call(
            tid, lambda: post_verifier.verify_many(items, params, seed=seed,
                                                   device=self.device),
            kind="verify", deadline_s=deadline_s)

    def submit_prove(self, tid: str, data_dir, challenge: bytes,
                     params=None, *, deadline_s: float | None = None,
                     **prover_opts) -> JobHandle:
        """A whole prove as a multi-quantum job: opening the session is one
        quantum, the k2pow gate the next, then each nonce window is one
        gang quantum (one disk pass). Resolves to the Proof."""
        from ..post.prover import Prover

        state: dict = {}

        def quantum():
            if "session" not in state:
                prover = Prover(data_dir, params, device=self.device,
                                **prover_opts)
                state["session"] = prover.session(challenge, tenant=tid)
                return "continue", None
            session = state["session"]
            try:
                proof = session.step()
            except Exception:
                session.close()
                raise
            if proof is None:
                return "continue", None
            session.close()
            return "done", proof

        def abort():
            session = state.pop("session", None)
            if session is not None:
                session.close()

        return self._enqueue(tid, "prove", quantum, deadline_s, gang=True,
                             abort=abort)

    def submit_init(self, tid: str, data_dir, *, node_id: bytes,
                    commitment: bytes, num_units: int, labels_per_unit: int,
                    scrypt_n: int = 8192,
                    max_file_size: int = 64 * 1024 * 1024,
                    progress=None) -> JobHandle:
        """Create or resume one identity's PoST init as a packed job: its
        lanes dispatch interleaved with every other tenant's. Resolves to
        the final PostMetadata."""
        from ..ops import scrypt
        from ..post.data import LabelStore
        from ..post.initializer import open_or_create_meta

        meta = open_or_create_meta(
            Path(data_dir), node_id=node_id, commitment=commitment,
            num_units=num_units, labels_per_unit=labels_per_unit,
            scrypt_n=scrypt_n, max_file_size=max_file_size)
        store = LabelStore(data_dir, meta)
        cw = scrypt.commitment_to_words(commitment)
        try:
            with self._lock:
                self._shared.touch()
                t, handle = self._admit(tid, "init")
                writer = (store.start_writer(self.writer_threads,
                                             queue_depth=8)
                          if self.writer_threads > 0 else None)
                job = _InitJob(handle, t, store, meta, writer, cw,
                               progress=progress)
                self._jobs[handle.id] = job
                if job.packable > 0:
                    t.init_jobs.append(job)
                    self._pack_work.notify()
                else:
                    # already complete: resolve now
                    self._jobs.pop(handle.id, None)
                    t.queued_jobs -= 1
                    handle.future.set_result(meta)
                    metrics.runtime_tenant_jobs.inc(tenant=tid, kind="init",
                                                    state="done")
        except Exception:
            store.close()
            raise
        return handle

    # -- cancellation / resolution -------------------------------------

    def _cancel(self, handle: JobHandle) -> bool:
        with self._lock:
            self._shared.touch()
            job = self._jobs.get(handle.id)
            if job is None:
                return False
            job.cancelled = True
            if isinstance(job, _InitJob):
                with contextlib.suppress(ValueError):
                    job.tenant.init_jobs.remove(job)
                if job.outstanding > 0:
                    return True  # the packer finalizes after in-flight retires
            else:
                try:
                    job.tenant.jobs.remove(job)
                except ValueError:
                    return True  # running: stops at its next quantum edge
        if isinstance(job, _InitJob):
            self._finalize_init(job)  # the writer and store close too
        else:
            self._resolve(job, cancelled=True)
        return True

    def _resolve(self, job, result=None, error: Exception | None = None,
                 cancelled: bool = False) -> None:
        handle = job.handle
        with self._lock:
            self._shared.touch()
            if self._jobs.pop(handle.id, None) is None:
                return  # already resolved
            # the job's own tenant, if still registered: a tenant id
            # unregistered and registered again is a fresh count (the JAX
            # package decrements whatever holds the id now, taking the new
            # tenant's count below zero)
            live = self._tenants.get(handle.tenant) is job.tenant
            if live:
                job.tenant.queued_jobs -= 1
                metrics.runtime_tenant_queued.set(job.tenant.queued_jobs,
                                                  tenant=handle.tenant)
            self._idle.notify_all()
        state = ("cancelled" if cancelled
                 else "failed" if error is not None else "done")
        if live:  # an unregistered tenant's series stay removed
            metrics.runtime_tenant_jobs.inc(tenant=handle.tenant,
                                            kind=handle.kind, state=state)
        if state != "done" and isinstance(job, _Job) \
                and job.abort is not None:
            try:
                job.abort()
            except Exception:  # noqa: BLE001 — cleanup must not mask the outcome
                pass
        if cancelled:
            handle.future.cancel()
        elif error is not None:
            handle.future.set_exception(error)
        else:
            handle.future.set_result(result)

    # -- worker pool (prove/verify/pow/call quanta) ---------------------

    # guarded by: self._lock — _worker_loop picks with the scheduler lock held
    def _pick_job(self) -> _Job | None:
        """Under the lock: the next quantum by deadline, then fair share."""
        now = self._now()
        best_t = None
        overdue_job = None
        overdue_deadline = None
        for t in self._tenants.values():
            if not t.jobs or t.running >= t.max_inflight:
                continue
            for job in t.jobs:
                if job.deadline is not None \
                        and job.deadline <= now + _DEADLINE_SLACK_S \
                        and (overdue_deadline is None
                             or job.deadline < overdue_deadline):
                    overdue_job, overdue_deadline = job, job.deadline
            if best_t is None or t.vtime < best_t.vtime:
                best_t = t
        if best_t is None:
            return None
        if overdue_job is not None:
            if overdue_job is not best_t.jobs[0]:
                metrics.runtime_deadline_boosts.inc()
            overdue_job.tenant.jobs.remove(overdue_job)
            return overdue_job
        return best_t.jobs.popleft()

    def _worker_loop(self) -> None:
        with self._stream():
            while True:
                with self._lock:
                    self._shared.touch()
                    job = None
                    while not self._closed:
                        job = self._pick_job()
                        if job is not None:
                            break
                        self._work.wait()
                    if job is None:  # closed
                        return
                    job.tenant.running += 1
                self._run_quantum(job)

    def _run_quantum(self, job: _Job) -> None:
        t0 = time.perf_counter()
        outcome, result, error = "continue", None, None
        # the gang gate covers every quantum of a gang job (the pow gate
        # is cheap)
        if job.gang:
            self._gang.acquire()
        try:
            with tracing.span("runtime.quantum",
                              {"tenant": job.tenant.id, "kind": job.kind,
                               "job": job.handle.id}
                              if tracing.is_enabled() else None):
                try:
                    outcome, result = job.fn()
                except Exception as exc:  # noqa: BLE001 — the job fails, the pool survives
                    outcome, error = "error", exc
        finally:
            if job.gang:
                self._gang.release()
            dt = time.perf_counter() - t0
            with self._lock:
                self._shared.touch()
                # unregistered while this quantum ran: the detached tenant
                # is never picked again (the JAX package requeues onto it,
                # stranding the handle and a prove job's open session)
                live = self._tenants.get(job.tenant.id) is job.tenant
                if live:
                    metrics.runtime_quantum_seconds.inc(
                        dt, kind=job.kind, tenant=job.tenant.id)
                job.tenant.charge(dt)
                job.tenant.running -= 1
                # read once under the lock: the error below names the
                # same cause that stopped the requeue
                closed = self._closed
                requeue = (outcome == "continue" and error is None
                           and not job.cancelled and not closed and live)
                if requeue:
                    # a multi-quantum job goes on ahead of its tenant's
                    # later jobs; fair share decides across tenants
                    job.tenant.jobs.appendleft(job)
                self._work.notify()
            if error is not None:
                self._resolve(job, error=error)
            elif job.cancelled:
                self._resolve(job, cancelled=True)
            elif outcome == "done":
                self._resolve(job, result=result)
            elif not requeue:
                # dropped at close or unregister mid-job: the handle must
                # not strand, and abort() closes what the job holds
                self._resolve(job, error=SchedulerClosed(
                    "scheduler closed" if closed
                    else f"tenant {job.tenant.id} unregistered"))

    # -- the init packer ------------------------------------------------

    # guarded by: self._lock — _compose_pack, the only caller, holds it (its _pack_work waits re-acquire it)
    def _ready(self) -> tuple[list, int]:
        """Under the lock: tenants with init lanes left, and their lanes."""
        ready = [t for t in self._tenants.values() if t.init_jobs]
        return ready, sum(j.packable for t in ready for j in t.init_jobs)

    def _compose_pack(self, block: bool):
        """Cut one pack of init lanes in fair-share order.

        ``block``: wait for work (the engine window is empty); False
        returns None at once when there is too little (the packer then
        yields IDLE so packs in flight keep retiring). Returns
        ``(segments, scrypt_n)``, or None on close or no work.

        A burst of submits races the packer, so a partial pack lingers up
        to ``pack_linger_s`` for more lanes, and with work in flight
        (``block`` False) a pack under half full is deferred: the engine
        retires meanwhile and the lanes join the next, fuller pack."""
        with self._lock:
            self._shared.touch()
            while True:
                if self._closed:
                    return None
                ready, avail = self._ready()
                if ready:
                    if avail >= self.pack_lanes:
                        break
                    if not block:
                        if avail >= self.pack_lanes // 2:
                            break
                        return None
                    deadline = time.monotonic() + self.pack_linger_s
                    while avail < self.pack_lanes and not self._closed:
                        left = deadline - time.monotonic()
                        if left <= 0 or not self._pack_work.wait(left):
                            break
                        ready, avail = self._ready()
                    ready, _ = self._ready()
                    if ready:
                        break
                    continue
                if not block:
                    return None
                self._pack_work.wait()
            segments: list[workloads.PackSegment] = []
            lanes = 0
            n = None
            for t in sorted(ready, key=lambda t: t.vtime):
                while t.init_jobs and lanes < self.pack_lanes:
                    job = t.init_jobs[0]
                    take = min(job.packable, self.pack_lanes - lanes)
                    if take == 0:
                        # cancelled or failed (packable 0): drop it; never
                        # emit a zero-lane segment
                        if job.packable == 0:
                            t.init_jobs.popleft()
                            continue
                        break
                    if n is None:
                        n = job.meta.scrypt_n
                    elif job.meta.scrypt_n != n:
                        break  # one N per pack
                    segments.append(workloads.PackSegment(
                        job, job.next_index, take, lanes))
                    job.next_index += take
                    job.outstanding += take
                    lanes += take
                    # provisional fair-share charge at the lane-cost EMA
                    # (the measured cost enters the EMA at retire)
                    t.charge(take * self._lane_cost_ema)
                    if job.packable == 0:
                        t.init_jobs.popleft()
                if lanes >= self.pack_lanes:
                    break
            return segments, n

    def _dispatch_pack(self, pack):
        import numpy as np

        from ..device import HostCopy
        from ..ops import autotune, scrypt, u32

        segments, n = pack
        lanes = sum(s.count for s in segments)
        cw = np.empty((8, lanes), dtype=np.uint32)
        idx = np.empty(lanes, dtype=np.uint64)
        for s in segments:
            cw[:, s.lane0:s.lane0 + s.count] = s.job.cw[:, None]
            idx[s.lane0:s.lane0 + s.count] = np.arange(
                s.start, s.start + s.count, dtype=np.uint64)
        metrics.runtime_pack_occupancy.observe(lanes)
        metrics.runtime_pack_tenants.observe(
            len({s.job.tenant.id for s in segments}))
        dev = self.device
        lo, hi = scrypt.split_indices(idx)
        # the tuned mesh routing every mesh-aware entry point shares
        devs, d = autotune.resolve_auto_mesh(n, lanes, platform=dev.type)
        if devs is not None and len(devs) > 1:
            from ..parallel import mesh as pmesh

            mesh = pmesh.data_mesh(devs)
            parts = pmesh.host_copies(mesh, pmesh.scrypt_labels_sharded(
                mesh, cw, lo, hi, n=n, chunk=d.chunk))
            return ([p for p in parts if p is not None], segments,
                    time.perf_counter())
        words = scrypt.scrypt_labels_packed(
            u32.from_numpy(cw, dev), u32.from_numpy(lo, dev),
            u32.from_numpy(hi, dev), n=n, chunk=d.chunk)
        return [HostCopy(words)], segments, time.perf_counter()

    def _retire_pack(self, ticket) -> None:
        from ..ops import scrypt

        parts, segments, t_dispatch = ticket
        st = self.pack_stats
        tf = time.perf_counter()
        # the pack's only wait on the device (one copy per stripe)
        arrs = [p.get() for p in parts]
        st.fetch_s += time.perf_counter() - tf
        lanes = sum(s.count for s in segments)
        dt = time.perf_counter() - t_dispatch
        # the EMA feeds the provisional charge in _compose_pack, which
        # reads it under the lock
        with self._lock:
            self._shared.touch()
            self._lane_cost_ema += 0.25 * (dt / max(lanes, 1)
                                           - self._lane_cost_ema)
        st.packs += 1
        st.lanes += lanes
        st.segments += len(segments)
        # one byte conversion for the whole pack, sliced per segment
        pack_bytes = b"".join(scrypt.labels_to_bytes(a) for a in arrs)
        finalize: list[_InitJob] = []
        for s in segments:
            job: _InitJob = s.job
            stored = 0  # lanes of this segment that reached the store
            with tracing.span("runtime.segment",
                              {"tenant": job.tenant.id, "start": s.start,
                               "count": s.count}
                              if tracing.is_enabled() else None):
                try:
                    if job.error is None and not job.cancelled:
                        data = pack_bytes[s.lane0 * scrypt.LABEL_BYTES:
                                          (s.lane0 + s.count)
                                          * scrypt.LABEL_BYTES]
                        tw = time.perf_counter()
                        if job.writer is not None:
                            job.writer.submit(s.start, data)
                        else:
                            job.store.write_labels(s.start, data)
                            job.crc = zlib.crc32(data, job.crc)
                        tm = time.perf_counter()
                        job.min_carry = workloads.fold_min_host(
                            job.min_carry, data, s.start)
                        st.write_s += tm - tw
                        st.fold_s += time.perf_counter() - tm
                        job.written = max(job.written, s.start + s.count)
                        stored = s.count
                        if job.progress is not None:
                            job.progress(job.written, job.total)
                except Exception as exc:  # noqa: BLE001 — fail this job, not the pack
                    job.error = exc
            with self._lock:
                self._shared.touch()
                # a tenant unregistered mid-pack no longer owns its series
                if stored and self._tenants.get(job.tenant.id) is job.tenant:
                    metrics.runtime_tenant_labels.inc(
                        stored, tenant=job.tenant.id)
                job.outstanding -= s.count
                if job.error is not None or job.cancelled:
                    # packable is 0 now: drop the queued remainder so the
                    # compose loop stops counting this tenant as ready
                    with contextlib.suppress(ValueError):
                        job.tenant.init_jobs.remove(job)
                done = (job.outstanding == 0
                        and (job.next_index >= job.total or job.cancelled
                             or job.error is not None))
            if done and job not in finalize:
                finalize.append(job)
        for job in finalize:
            self._finalize_init(job)

    def _finalize_init(self, job: _InitJob) -> None:
        # idempotent: unregister, close and retire can race to finalize a
        # job; only the first pass drains, closes and resolves it
        with self._lock:
            self._shared.touch()
            if job.finalized:
                return
            job.finalized = True
        error = job.error
        try:
            if job.writer is not None:
                # drain and fsync before advancing the durable cursor, and
                # take the interval CRC for the ledger
                job.writer.drain()
                durable, crc = job.writer.checkpoint()
                job.writer.close(drain=False)
            else:
                job.store.sync()
                durable, crc = job.written, job.crc
            if error is None and not job.cancelled:
                meta = job.meta
                meta.labels_written = durable
                # the checkpoint ledger must cover the cursor it backs, or
                # the next reopen's recovery rolls the cursor back
                prev_end = meta.intervals[-1][0] if meta.intervals else 0
                if durable > prev_end:
                    meta.intervals.append([durable, crc])
                nonce, value = workloads.min_carry_to_meta(job.min_carry)
                if nonce is not None:
                    meta.vrf_nonce = nonce
                    meta.vrf_nonce_value = value
                meta.save(job.store.dir)
        except Exception as exc:  # noqa: BLE001 — surfaced through the handle
            error = error or exc
        finally:
            job.store.close()
        if job.cancelled and error is None:
            self._resolve(job, cancelled=True)
        elif error is not None:
            self._resolve(job, error=error)
        else:
            self._resolve(job, result=job.meta)

    def _packer_loop(self) -> None:
        """The shared init stream: one engine pipeline whose items are
        cross-tenant packs, kept ``inflight`` deep for the scheduler's
        whole life, so tenant boundaries never drain the device."""
        pipe = engine.Pipeline(kind="init_pack", tenant="*",
                               inflight=self.inflight, span="runtime.pack",
                               attrs=lambda p: {
                                   "lanes": sum(s.count for s in p[0]),
                                   "tenants": len({s.job.tenant.id
                                                   for s in p[0]})},
                               stop=lambda: self._closed)  # spacecheck: ok=SC007 monotonic close flag; a stale read only delays stop by one batch

        def packs():
            while True:
                if self._closed:
                    return
                # block for work only with the window empty: with packs in
                # flight an empty queue yields IDLE, so the engine retires
                # instead of holding a full window behind a quiet queue
                pack = self._compose_pack(block=pipe.pending_count == 0)
                if pack is None or not pack[0]:
                    if self._closed:
                        return
                    if pipe.pending_count:
                        yield engine.IDLE
                    continue
                yield pack

        try:
            with self._stream():
                pipe.run(packs(), self._dispatch_pack, self._retire_pack)
        except Exception as exc:  # noqa: BLE001 — fail the init jobs, not the thread
            with self._lock:
                self._shared.touch()
                jobs = [j for j in self._jobs.values()
                        if isinstance(j, _InitJob)]
            for j in jobs:
                j.error = j.error or exc
                if j.outstanding == 0:
                    self._finalize_init(j)


class ShardScheduler:
    """One shard's view of a shared :class:`TenantScheduler`.

    Prefixes every tenant id with ``<shard>/`` on the way in and strips it
    on the way out. ``close``, ``drain`` and ``start`` pass through: the
    owner of the scheduler decides its lifetime."""

    def __init__(self, inner: TenantScheduler, shard: str):
        self.inner = inner
        self.shard = str(shard)
        self._prefix = f"{self.shard}/"

    def _tid(self, tid: str) -> str:
        return self._prefix + str(tid)

    def register_tenant(self, tid: str, **kwargs) -> str:
        self.inner.register_tenant(self._tid(tid), **kwargs)
        return str(tid)

    def unregister_tenant(self, tid: str) -> None:
        self.inner.unregister_tenant(self._tid(tid))

    def submit_call(self, tid: str, fn, **kwargs) -> JobHandle:
        return self.inner.submit_call(self._tid(tid), fn, **kwargs)

    def tenants(self) -> list[str]:
        return [t[len(self._prefix):] for t in self.inner.tenants()
                if t.startswith(self._prefix)]

    def start(self) -> None:
        self.inner.start()

    def drain(self, timeout: float | None = None) -> bool:
        return self.inner.drain(timeout)

    def close(self) -> None:
        self.inner.close()
