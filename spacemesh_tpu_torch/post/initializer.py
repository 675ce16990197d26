"""PoST initialization: fill the data directory with scrypt labels.

Port of ``spacemesh_tpu/post/initializer.py`` for one device. The loop is a
streaming pipeline over the bounded window of ``runtime/engine.py``:

  dispatch — enqueue one label batch on the device (PBKDF2 expand, the
             ROMix kernel, PBKDF2 finish) chained to the VRF min-scan that
             folds the batch into a running carry kept on the device;
  retire   — copy the oldest batch's label words to the host (the only
             per-batch sync) and hand the bytes to the background writer
             pool (``post/data.py``), so disk, copies and compute overlap.

Metadata is rewritten on a time/label interval; the persisted
``labels_written`` is the writer pool's durable cursor, never the dispatch
frontier. The VRF scan may run ahead of it: labels are deterministic, so a
resume recomputes them and the min-merge is idempotent.

The pipeline options are the JAX ``Initializer``'s: ``inflight``,
``writers`` (with the ``SPACEMESH_INFLIGHT``/``SPACEMESH_WRITERS``
overrides), the metadata intervals, ``fs`` (the injectable I/O layer,
``post/faultfs.py``), ``enospc_retry_s`` and ``save_barrier``. An ENOSPC
anywhere in the storage plane (a label write, the checkpoint fsync, the
metadata save) parks the session until space returns instead of failing
it.

``tenant`` labels the runtime metrics (``runtime/engine.py``); the
multi-tenant scheduler's packed init (``runtime/scheduler.py``) shares
:func:`open_or_create_meta` with this module.

While a session runs, three probes sit on ``obs.health.HEALTH``:
``post.init`` (the fetch frontier must advance within
:data:`STALL_DEADLINE_S`), ``post.writer`` (the writer's flushed/durable
cursors) and ``post.store`` (ENOSPC parking), with ``restart_component``
hooks that stop the session. The spans are the JAX package's:
``init.run``, ``init.dispatch`` (the engine's), ``init.fetch``,
``init.write_stall``, ``init.write`` (writer threads, parented across the
pool), ``init.drain_stall`` and ``init.save_meta``.

``mesh`` is the JAX ``Initializer``'s: ``None`` (one device), ``"auto"``
(the default: ``ops/autotune.py:resolve_auto_mesh``, which on the card
stripes over every visible card and so, with one card, keeps one device;
``SPACEMESH_MESH`` forces either way) or a mesh of ``parallel/``
(``data_mesh([...])``). The session's kernel decision (the ROMix lane
chunk, and the device count) is taken once, at its batch size, and
logged as one ``romix kernel:`` line on stderr; ``post_mesh_devices``
reads its device count. A striped batch goes through
``parallel/mesh.py:labels_with_min_sharded``: each stripe's labels come
back through a ``HostCopy`` on its own stream and are written at their
own first index, and the VRF carry stays replicated on the stripes from
batch to batch (placed once per pass). The per-stripe fetch seconds feed
``post_mesh_shard_labels_per_sec`` and ``post_mesh_shard_imbalance``.

Left out against the JAX package: the ``writer_queue`` option (no caller
sets it: the queue depth is :data:`DEFAULT_WRITER_QUEUE`).

The ``post_pipeline_*`` metrics are the JAX package's, recorded at its
sites: batches dispatched, the in-flight depth, the write-queue depth, the
writer-backpressure stall, the stage seconds (dispatch/fetch/write/stall),
the metadata saves and the last session's labels/s. They are host
counters: no launch and no sync on the card's path.
"""

from __future__ import annotations

import dataclasses
import enum
import errno
import os
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np

from ..device import HostCopy, resolve
from ..obs import health as health_mod
from ..obs import remediate as remediate_mod
from ..ops import scrypt, u32
from ..runtime import engine
from ..utils import metrics, tracing
from .data import LabelStore, LabelWriter, PostMetadata, recover_store

# labels per device batch: ROMix scratch is batch * N * 128 bytes, 32 GiB
# at N=8192 (romix_cuda caps each launch to the card's free memory)
DEFAULT_BATCH = 1 << 15
DEFAULT_INFLIGHT = 3   # device batches in flight before the oldest retires
DEFAULT_WRITERS = 2    # background writer threads
DEFAULT_WRITER_QUEUE = 8  # pending writes before dispatch backpressure
# metadata is rewritten when either interval has passed since the last save
META_INTERVAL_S = 5.0
META_INTERVAL_LABELS = 1 << 20
# the init and writer watchdogs' deadline (obs/health.py)
STALL_DEADLINE_S = 30.0


class Status(enum.Enum):
    NOT_STARTED = "not_started"
    IN_PROGRESS = "in_progress"
    COMPLETE = "complete"
    STOPPED = "stopped"


@dataclasses.dataclass
class PipelineStats:
    """Host-side per-stage accounting for one run."""

    batches: int = 0
    shards: int = 0           # stripes fetched (one per unstriped batch)
    dispatch_s: float = 0.0   # host time enqueueing device work
    first_dispatch_s: float = 0.0  # the first batch's share of dispatch_s
    fetch_s: float = 0.0      # blocked on device->host label copies
    write_stall_s: float = 0.0  # blocked on writer-pool backpressure
    write_s: float = 0.0      # filesystem time inside the writer pool
    save_s: float = 0.0       # metadata rewrites
    meta_saves: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class InitResult:
    labels_written: int
    vrf_nonce: int
    elapsed_s: float
    labels_per_s: float
    stats: PipelineStats | None = None


class Initializer:
    """Fills (or resumes) one identity's PoST data directory.

    ``progress(done, total)`` reports the fetch frontier: labels whose
    bytes reached the host and were handed to the writer pool.
    ``save_barrier`` drains the writer pool before every metadata
    checkpoint, so the operations on ``fs`` follow the batch schedule
    alone, not the writer threads' timing (what a fault plan needs to
    replay); by default saves overlap the writes. The metadata intervals
    default to :data:`META_INTERVAL_S` and :data:`META_INTERVAL_LABELS`."""

    def __init__(self, data_dir: str | Path, meta: PostMetadata,
                 batch_size: int = DEFAULT_BATCH,
                 progress: Callable[[int, int], None] | None = None,
                 inflight: int | None = None,
                 writers: int | None = None,
                 meta_interval_s: float | None = None,
                 meta_interval_labels: int | None = None,
                 fs=None,
                 enospc_retry_s: float = 0.5,
                 save_barrier: bool = False,
                 tenant: str = "-",
                 mesh="auto",
                 device="cuda"):
        self.device = resolve(device)
        self._mesh_arg = mesh
        self.tenant = tenant
        self.store = LabelStore(data_dir, meta, fs=fs)
        self.meta = meta
        self.batch = batch_size
        self.progress = progress
        self.inflight = max(int(
            inflight if inflight is not None
            else os.environ.get("SPACEMESH_INFLIGHT", DEFAULT_INFLIGHT)), 1)
        self.writers = max(int(
            writers if writers is not None
            else os.environ.get("SPACEMESH_WRITERS", DEFAULT_WRITERS)), 1)
        self.meta_interval_s = (META_INTERVAL_S if meta_interval_s is None
                                else meta_interval_s)
        self.meta_interval_labels = (
            META_INTERVAL_LABELS if meta_interval_labels is None
            else meta_interval_labels)
        self.enospc_retry_s = enospc_retry_s
        self.save_barrier = save_barrier
        self._fetched = meta.labels_written  # fetch frontier (watchdog)
        self._resume_at = meta.labels_written  # submit-frontier base
        self.status = (Status.COMPLETE
                       if meta.labels_written >= meta.total_labels
                       else Status.NOT_STARTED)
        self._stop = False

    def stop(self) -> None:
        """Request stop; checked before each dispatch. The durable cursor
        of already-retired batches is persisted on the way out."""
        self._stop = True

    # -- mesh routing -------------------------------------------------------

    def _resolve_plan(self, batch_hint: int):
        """-> (mesh | None, autotune.Decision) for this session: the JAX
        ``Initializer._resolve_plan``. ``auto`` takes the shared routing
        (``autotune.resolve_auto_mesh``); an explicit mesh of one stripe
        is one device."""
        from ..ops import autotune

        n, plat = self.meta.scrypt_n, self.device.type
        if self._mesh_arg is None:
            return None, autotune.decide(n, batch_hint, platform=plat)
        if self._mesh_arg != "auto":
            mesh = self._mesh_arg if self._mesh_arg.size > 1 else None
            return mesh, autotune.decide(n, batch_hint, platform=plat)
        devs, d = autotune.resolve_auto_mesh(n, batch_hint, platform=plat)
        if devs is None:
            return None, d
        from ..parallel import mesh as pmesh

        return pmesh.data_mesh(devs), d

    def run(self) -> InitResult:
        meta = self.meta
        dev = self.device
        total = meta.total_labels
        self.status = Status.IN_PROGRESS
        t0 = time.monotonic()
        written0 = meta.labels_written
        stats = PipelineStats()
        cw_host = scrypt.commitment_to_words(bytes.fromhex(meta.commitment))
        cw = u32.from_numpy(cw_host, dev)

        # the kernel and mesh choice, resolved (and if needed raced and
        # persisted) up front, so the session logs what it runs with and
        # the first dispatch does not absorb the race
        from ..ops import autotune

        if total > written0:
            mesh, decision = self._resolve_plan(min(self.batch,
                                                    total - written0))
            print(f"romix kernel: impl={decision.impl} "
                  f"chunk={decision.chunk} devices={mesh.size if mesh else 1}"
                  f" (source={decision.source})", file=sys.stderr, flush=True)
            metrics.post_mesh_devices.set(mesh.size if mesh else 1)
        else:  # nothing to do: never race for a no-op resume
            mesh, decision = None, autotune.default_decision(
                dev.type, meta.scrypt_n, self.batch)
        self._decision = decision

        resumed = None
        if meta.vrf_nonce_value is not None and meta.vrf_nonce is not None:
            v = bytes.fromhex(meta.vrf_nonce_value)
            resumed = (int.from_bytes(v[8:], "little"),
                       int.from_bytes(v[:8], "little"))
        carry_host = scrypt.vrf_carry_init(resumed, meta.vrf_nonce or 0)
        # the carry rolls on the device (on every stripe, under a mesh);
        # the snapshot of the last retired batch is what a metadata save
        # may persist
        if mesh is not None:
            from ..parallel import mesh as pmesh

            carry_cell = [pmesh.replicate(mesh, carry_host)]
        else:
            carry_cell = [u32.from_numpy(carry_host, dev)]
        self._snapshot = carry_host

        writer = self.store.start_writer(
            self.writers, DEFAULT_WRITER_QUEUE,
            enospc_retry_s=self.enospc_retry_s)
        self._last_save_t = time.monotonic()
        self._last_save_labels = written0
        # liveness: the fetch frontier and the writer's cursors must keep
        # advancing while the session runs; an ENOSPC park is post.store's
        # DEGRADED verdict, not an init stall, so it pauses the init probe
        init_wd = health_mod.Watchdog(
            "post.init", progress=lambda: self._fetched,
            deadline_s=STALL_DEADLINE_S,
            active=lambda: (self.status == Status.IN_PROGRESS
                            and not writer.degraded()))
        writer_wd = health_mod.writer_watchdog(writer,
                                               deadline_s=STALL_DEADLINE_S)
        store_probe = health_mod.store_probe(writer)
        health_mod.HEALTH.register("post.init", init_wd.check)
        health_mod.HEALTH.register("post.writer", writer_wd.check)
        health_mod.HEALTH.register("post.store", store_probe)
        # a stalled-init verdict stops the session: init resumes from the
        # durable cursor, so a clean stop hands the restart to the owner
        remediate_mod.ACTIONS.register("post.init",
                                       remediate_mod.RESTART_COMPONENT,
                                       self.stop)
        remediate_mod.ACTIONS.register("post.writer",
                                       remediate_mod.RESTART_COMPONENT,
                                       self.stop)
        session = tracing.span("init.run",
                               {"total": total, "resume_at": written0,
                                "batch": self.batch,
                                "devices": mesh.size if mesh else 1,
                                "impl": decision.impl,
                                "tenant": self.tenant}
                               if tracing.is_enabled() else None)
        session.__enter__()

        def batches():
            dispatched = written0
            while dispatched < total:
                count = min(self.batch, total - dispatched)
                yield dispatched, count
                dispatched += count

        def dispatch(item):
            start, count = item
            lo, hi = scrypt.split_indices(
                np.arange(start, start + count, dtype=np.uint64))
            metrics.post_pipeline_dispatched.inc()
            if mesh is not None:
                words, carry_cell[0], snap = pmesh.labels_with_min_sharded(
                    mesh, cw_host, lo, hi, carry_cell[0], n=meta.scrypt_n,
                    chunk=decision.chunk)
                firsts = np.cumsum([0] + [w.shape[1] for w in words])
                parts = [(int(f), hc) for f, hc in zip(
                    firsts, pmesh.host_copies(mesh, words)) if hc]
                return (start, count, parts,
                        pmesh.host_copies(mesh, [snap])[0])
            words, carry_cell[0], snap = scrypt.scrypt_labels_with_min(
                cw, u32.from_numpy(lo, dev), u32.from_numpy(hi, dev),
                carry_cell[0], n=meta.scrypt_n, chunk=decision.chunk)
            return start, count, [(0, HostCopy(words))], HostCopy(snap)

        def retire(ticket):
            self._retire(ticket, writer, stats)
            self._maybe_save(writer, stats)
            return None

        pipe = engine.Pipeline(
            kind="init", tenant=self.tenant, inflight=self.inflight,
            stop=lambda: self._stop, span="init",
            attrs=lambda item: {"start": item[0], "count": item[1]},
            on_inflight=metrics.post_pipeline_inflight.set)
        try:
            pipe.run(batches(), dispatch, retire)
            if pipe.stats.stopped:
                self.status = Status.STOPPED
            tw = time.perf_counter()
            with tracing.span("init.drain_stall"):
                writer.drain()
            stats.write_stall_s += time.perf_counter() - tw
            self._save_meta(writer, stats)
        finally:
            session.__exit__(None, None, None)
            stats.batches = pipe.stats.batches
            stats.dispatch_s = pipe.stats.dispatch_s
            stats.first_dispatch_s = pipe.stats.first_dispatch_s
            stats.write_s = writer.write_seconds
            writer.close(drain=False)
            health_mod.HEALTH.unregister("post.init", init_wd.check)
            health_mod.HEALTH.unregister("post.writer", writer_wd.check)
            health_mod.HEALTH.unregister("post.store", store_probe)
            remediate_mod.ACTIONS.unregister(
                "post.init", remediate_mod.RESTART_COMPONENT, self.stop)
            remediate_mod.ACTIONS.unregister(
                "post.writer", remediate_mod.RESTART_COMPONENT, self.stop)
            # clears the degraded gauge only if this session's writer set
            # it (the gauge is process-global)
            writer.clear_degraded()
            metrics.post_pipeline_inflight.set(0)
            metrics.post_pipeline_queue_depth.set(0)

        if meta.labels_written >= total:
            self.status = Status.COMPLETE
        elapsed = time.monotonic() - t0
        done = meta.labels_written - written0
        rate = done / elapsed if elapsed > 0 else 0.0
        metrics.post_pipeline_labels_per_sec.set(rate)
        for stage, secs in (("dispatch", stats.dispatch_s),
                            ("fetch", stats.fetch_s),
                            ("write", stats.write_s),
                            ("stall", stats.write_stall_s)):
            metrics.post_pipeline_stage_seconds.inc(secs, stage=stage)
        return InitResult(
            labels_written=meta.labels_written,
            vrf_nonce=meta.vrf_nonce if meta.vrf_nonce is not None else -1,
            elapsed_s=elapsed,
            labels_per_s=rate,
            stats=stats,
        )

    def _retire(self, item, writer: LabelWriter, stats: PipelineStats) -> None:
        """Fetch the oldest in-flight batch and hand it to the writers: one
        part per stripe, each written at its own first index."""
        start, count, parts, snap = item
        stall = 0.0
        shard_times: list[tuple[int, float]] = []  # (lanes, fetch s)
        with tracing.span("init.fetch", {"start": start, "count": count}
                          if tracing.is_enabled() else None) as rsp:
            tf = time.perf_counter()
            for first, hc in parts:
                t0 = time.perf_counter()
                arr = hc.get()  # waits for the stripe's batch
                # the first stripe's time includes the wait for the batch;
                # later ones are (nearly) the copy alone
                shard_times.append((arr.shape[1], time.perf_counter() - t0))
                data = scrypt.labels_to_bytes(arr)
                ts = time.perf_counter()
                with tracing.span("init.write_stall"):
                    writer.submit(start + first, data)
                stall += time.perf_counter() - ts
            self._snapshot = u32.to_numpy(snap.get())
            stats.shards += len(parts)
            if len(shard_times) > 1:
                secs = [t for _, t in shard_times]
                top, low = max(secs), min(secs)
                imbalance = (top - low) / top if top > 0 else 0.0
                rates = [m / t for m, t in shard_times if t > 0]
                metrics.post_mesh_shard_imbalance.set(imbalance)
                if rates:
                    metrics.post_mesh_shard_labels_per_sec.set(
                        sum(rates) / len(rates))
                rsp.set(shards=len(shard_times),
                        shard_imbalance=round(imbalance, 4))
        stats.fetch_s += time.perf_counter() - tf - stall
        stats.write_stall_s += stall
        if stall > 0:
            metrics.post_pipeline_stall_seconds.inc(stall)
        metrics.post_pipeline_queue_depth.set(writer.queue_depth())
        metrics.post_pipeline_labels.inc(count)
        self._fetched = start + count
        if self.progress:
            self.progress(start + count, self.meta.total_labels)

    # -- metadata durability -------------------------------------------------

    def _maybe_save(self, writer: LabelWriter, stats: PipelineStats) -> None:
        # the label trigger fires on the submit frontier (deterministic per
        # batch schedule), not the flushed cursor (writer-thread timing)
        frontier = self._resume_at + writer.labels_submitted
        if (time.monotonic() - self._last_save_t < self.meta_interval_s
                and frontier - self._last_save_labels
                < self.meta_interval_labels):
            return
        self._save_meta(writer, stats)

    def _save_meta(self, writer: LabelWriter, stats: PipelineStats) -> None:
        """Persist resume metadata. The cursor is the writer's durable
        (contiguous-fsynced) label count; ``checkpoint()`` fsyncs the dirty
        label files first and hands back the interval CRC that recovery
        verifies on reopen. ENOSPC on the fsync or the save parks through
        ``writer.wait_for_space`` and retries, like a label write."""
        meta = self.meta
        t0 = time.perf_counter()
        if self.save_barrier:
            writer.drain()
        while True:
            try:
                durable, crc = writer.checkpoint()
                break
            except OSError as e:
                if e.errno != errno.ENOSPC or not writer.enospc_wait:
                    raise
                writer.wait_for_space("label-file fsync")
        decoded = scrypt.vrf_carry_decode(self._snapshot)
        meta.labels_written = durable
        prev_end = meta.intervals[-1][0] if meta.intervals else 0
        if durable > prev_end:
            meta.intervals.append([durable, crc])
        if decoded is not None:
            idx, (hi, lo) = decoded
            meta.vrf_nonce = idx
            meta.vrf_nonce_value = (
                lo.to_bytes(8, "little") + hi.to_bytes(8, "little")).hex()
        with tracing.span("init.save_meta", {"durable": durable}
                          if tracing.is_enabled() else None):
            while True:
                try:
                    meta.save(self.store.dir, fs=self.store.fs)
                    break
                except OSError as e:
                    if e.errno != errno.ENOSPC or not writer.enospc_wait:
                        raise
                    writer.wait_for_space("metadata save")
        writer.clear_degraded()
        stats.meta_saves += 1
        stats.save_s += time.perf_counter() - t0
        metrics.post_pipeline_meta_saves.inc()
        self._last_save_t = time.monotonic()
        # the same frontier the trigger compares against, so a writer
        # backlog cannot re-trip the label trigger on every retire
        self._last_save_labels = self._resume_at + writer.labels_submitted


def open_or_create_meta(data_dir: Path, *, node_id: bytes,
                        commitment: bytes, num_units: int,
                        labels_per_unit: int, scrypt_n: int = 8192,
                        max_file_size: int = 64 * 1024 * 1024,
                        fs=None) -> PostMetadata:
    """Load (and parameter-check) or create one identity's metadata. Every
    reopen runs crash recovery (``post/data.py:recover_store``)."""
    dir_ = Path(data_dir)
    if (dir_ / "postdata_metadata.json").exists():
        meta = PostMetadata.load(dir_, fs=fs)
        if (meta.node_id != node_id.hex()
                or meta.commitment != commitment.hex()
                or meta.scrypt_n != scrypt_n
                or meta.labels_per_unit != labels_per_unit
                or meta.num_units != num_units
                or meta.max_file_size != max_file_size):
            raise ValueError(
                "existing POST data directory was initialized with different "
                "parameters; refusing to mix label sets")
        recover_store(dir_, meta, fs=fs)
        return meta
    meta = PostMetadata(
        node_id=node_id.hex(), commitment=commitment.hex(),
        scrypt_n=scrypt_n, num_units=num_units,
        labels_per_unit=labels_per_unit, max_file_size=max_file_size)
    if any(dir_.glob("postdata_*.bin")):
        # label bytes with no durable claim behind them: recovery wipes
        # them so a fresh init cannot build on torn data
        recover_store(dir_, meta, fs=fs)
    return meta


def initialize(data_dir: str | Path, *, node_id: bytes, commitment: bytes,
               num_units: int, labels_per_unit: int, scrypt_n: int = 8192,
               max_file_size: int = 64 * 1024 * 1024,
               batch_size: int = DEFAULT_BATCH,
               progress: Callable[[int, int], None] | None = None,
               fs=None, device="cuda",
               **pipeline_opts) -> tuple[PostMetadata, InitResult]:
    """Create-or-resume an init session. Returns final metadata + timing.
    ``pipeline_opts`` pass through to :class:`Initializer` (inflight,
    writers, the metadata intervals, enospc_retry_s, save_barrier, tenant,
    mesh);
    ``fs`` is the injectable I/O layer."""
    dev = resolve(device)
    dir_ = Path(data_dir)
    meta = open_or_create_meta(
        dir_, node_id=node_id, commitment=commitment, num_units=num_units,
        labels_per_unit=labels_per_unit, scrypt_n=scrypt_n,
        max_file_size=max_file_size, fs=fs)
    init = Initializer(dir_, meta, batch_size=batch_size, progress=progress,
                       fs=fs, device=dev, **pipeline_opts)
    return meta, init.run()
