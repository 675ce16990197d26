"""On-disk PoST data: label files + resume metadata.

Port of ``spacemesh_tpu/post/data.py``; the on-disk format is
byte-identical, so a store written by either package opens in the other:

* ``postdata_N.bin`` files of concatenated 16-byte labels, ``max_file_size``
  bytes each;
* ``postdata_metadata.json``, written durably (``utils/fsio.py``), whose
  ``labels_written`` cursor is the writer pool's *durable* (fsynced)
  cursor and whose ``intervals`` ledger holds a CRC32 per checkpointed
  label interval, so reopen can verify the tail and truncate torn bytes
  back to the last checkpoint that checks out (:func:`recover_store`);
* all file I/O goes through an injectable ``fs`` (``utils/fsio.RealFS`` by
  default), so the disk-fault shim (``post/faultfs.py``) can crash the
  pipeline at exact operation counts;
* ENOSPC in the writer pool parks instead of failing: the pool retries on
  an interval, ``LabelWriter.degraded()`` says why, and the init resumes
  when space returns;
* the writer's cursors, the reader's state and the store's fd cache are
  declared shared to the race sanitizer (``utils/sanitize.py``); the pool
  threads record ``init.write`` / ``prove.read_io`` spans under the
  submitting side's span, and reopen records ``init.recover``.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import os
import queue
import threading
import time
import zlib
from pathlib import Path

from ..ops.scrypt import LABEL_BYTES
from ..utils import fsio, metrics, sanitize, tracing

METADATA_FILE = "postdata_metadata.json"

# bounded retry for transient read errors during the prover's disk passes
READ_RETRIES = 3
READ_BACKOFF_BASE_S = 0.05
READ_BACKOFF_CAP_S = 1.0

# ledger backfill segment for pre-checksum stores (recover_store)
BACKFILL_INTERVAL_LABELS = 1 << 20


class PostMetaCorrupt(ValueError):
    """postdata_metadata.json exists but cannot be decoded."""

    def __init__(self, path, detail: str):
        super().__init__(f"corrupt POST metadata at {path}: {detail}")
        self.path = str(path)


class LabelWriteError(RuntimeError):
    """The background label writer failed; ``errno`` is set for OS-level
    failures."""

    def __init__(self, msg: str = "background label writer failed",
                 errno_: int | None = None):
        super().__init__(msg)
        self.errno = errno_


@dataclasses.dataclass
class PostMetadata:
    """Identity + geometry of one smesher's PoST data directory."""

    node_id: str               # hex, 32 bytes
    commitment: str            # hex, 32 bytes
    scrypt_n: int
    num_units: int
    labels_per_unit: int
    max_file_size: int         # bytes per postdata file
    labels_written: int = 0    # resume cursor: contiguous FSYNCED labels
    vrf_nonce: int | None = None       # index of the numerically smallest label
    vrf_nonce_value: str | None = None  # hex of that label (16 bytes)
    # checkpoint ledger: [[end_label, crc32-of-[prev_end, end)], ...]
    intervals: list = dataclasses.field(default_factory=list)

    @property
    def total_labels(self) -> int:
        return self.num_units * self.labels_per_unit

    @property
    def labels_per_file(self) -> int:
        return self.max_file_size // LABEL_BYTES

    def save(self, data_dir: str | Path, fs=None) -> None:
        path = Path(data_dir) / METADATA_FILE
        fsio.atomic_write_text(
            path, json.dumps(dataclasses.asdict(self), indent=1), fs=fs)

    @classmethod
    def load(cls, data_dir: str | Path, fs=None) -> "PostMetadata":
        path = Path(data_dir) / METADATA_FILE
        fsio.cleanup_stale_tmps(path, fs=fs)
        text = path.read_text()  # FileNotFoundError propagates: no store
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise PostMetaCorrupt(path, f"unparseable JSON ({e})") from e
        if not isinstance(doc, dict):
            raise PostMetaCorrupt(path, "document is not an object")
        try:
            return cls(**doc)
        except TypeError as e:
            raise PostMetaCorrupt(path, f"wrong schema ({e})") from e


class LabelStore:
    """Reads/writes the ``postdata_N.bin`` files for one data directory."""

    def __init__(self, data_dir: str | Path, meta: PostMetadata, fs=None):
        self.dir = Path(data_dir)
        self.meta = meta
        self.fs = fs if fs is not None else fsio.REAL
        self.dir.mkdir(parents=True, exist_ok=True)
        self._fd_lock = sanitize.lock("post.data.LabelStore.fds")
        self._read_fds: dict[int, int] = {}
        self._dirty: set[int] = set()  # file indices written, not fsynced

    def _file(self, i: int) -> Path:
        return self.dir / f"postdata_{i}.bin"

    def _read_fd(self, i: int) -> int:
        """Cached O_RDONLY fd for file ``i``."""
        with self._fd_lock:
            fd = self._read_fds.get(i)
            if fd is None:
                fd = self.fs.open(self._file(i), os.O_RDONLY)
                self._read_fds[i] = fd
            return fd

    def _drop_read_fd(self, i: int) -> None:
        with self._fd_lock:
            fd = self._read_fds.pop(i, None)
        if fd is not None:
            try:
                self.fs.close(fd)
            except OSError:
                pass

    def close(self) -> None:
        """Drop cached read fds (safe to call repeatedly; reads reopen)."""
        with self._fd_lock:
            fds, self._read_fds = self._read_fds, {}
        for fd in fds.values():
            try:
                self.fs.close(fd)
            except OSError:
                pass

    def write_labels(self, start_index: int, labels: bytes) -> None:
        """Write ``labels`` (concatenated 16B records) at ``start_index``.
        Positioned writes without O_TRUNC, so concurrent writers never
        clobber each other's ranges; short writes are retried."""
        lpf = self.meta.labels_per_file
        idx = start_index
        off = 0
        while off < len(labels):
            fi, within = divmod(idx, lpf)
            take = min(len(labels) - off, (lpf - within) * LABEL_BYTES)
            fd = self.fs.open(self._file(fi), os.O_CREAT | os.O_WRONLY,
                              0o644)
            try:
                view = memoryview(labels)[off:off + take]
                pos = within * LABEL_BYTES
                while len(view):
                    n = self.fs.pwrite(fd, view, pos)
                    if n <= 0:
                        raise IOError(
                            f"zero-length write at label {idx} (file {fi})")
                    view = view[n:]
                    pos += n
            finally:
                self.fs.close(fd)
            with self._fd_lock:
                self._dirty.add(fi)
            off += take
            idx += take // LABEL_BYTES

    def sync(self) -> None:
        """fsync every label file written since the last sync. On failure
        the un-synced files stay marked dirty."""
        with self._fd_lock:
            dirty, self._dirty = self._dirty, set()
        done = set()
        try:
            for fi in sorted(dirty):
                try:
                    fd = self.fs.open(self._file(fi), os.O_RDONLY)
                except FileNotFoundError:
                    done.add(fi)  # recovery removed it; nothing to sync
                    continue
                try:
                    self.fs.fsync(fd)
                finally:
                    self.fs.close(fd)
                metrics.post_store_fsyncs.inc()
                done.add(fi)
        finally:
            failed = dirty - done
            if failed:
                with self._fd_lock:
                    self._dirty |= failed

    def start_writer(self, threads: int = 2, queue_depth: int = 8,
                     **writer_opts) -> "LabelWriter":
        """A background writer pool: ``threads`` threads, ``queue_depth``
        queued writes before the submitter blocks (``writer_opts``:
        enospc_wait, enospc_retry_s)."""
        return LabelWriter(self, threads=threads, queue_depth=queue_depth,
                           **writer_opts)

    def start_reader(self, ranges, threads: int = 2,
                     depth: int = 4) -> "LabelReader":
        """A read-ahead pool over ``ranges``: ``threads`` threads, at most
        ``depth`` ranges buffered or in flight."""
        return LabelReader(self, ranges, threads=threads, depth=depth)

    def _pread_retry(self, fi: int, nbytes: int, offset: int) -> bytes:
        """One positioned read with bounded EIO retry and a reopen between
        attempts; anything else propagates."""
        attempt = 0
        while True:
            try:
                return self.fs.pread(self._read_fd(fi), nbytes, offset)
            except OSError as e:
                if e.errno != errno.EIO or attempt >= READ_RETRIES:
                    raise
                metrics.post_store_read_retries.inc()
                self._drop_read_fd(fi)
                time.sleep(min(READ_BACKOFF_CAP_S,
                               READ_BACKOFF_BASE_S * (2 ** attempt)))
                attempt += 1

    def read_labels(self, start_index: int, count: int) -> bytes:
        lpf = self.meta.labels_per_file
        out = bytearray()
        idx = start_index
        remaining = count
        while remaining > 0:
            fi, within = divmod(idx, lpf)
            take = min(remaining, lpf - within)
            chunk = self._pread_retry(fi, take * LABEL_BYTES,
                                      within * LABEL_BYTES)
            if len(chunk) != take * LABEL_BYTES:
                raise IOError(
                    f"short read at label {idx}: file {fi} truncated")
            out += chunk
            idx += take
            remaining -= take
        metrics.post_store_read_calls.inc()
        metrics.post_store_read_bytes.inc(count * LABEL_BYTES)
        return bytes(out)


class LabelWriter:
    """Bounded-queue background writer pool over one LabelStore.

    The flushed cursor is the label index up to which all bytes are
    contiguously handed to the OS (writes complete out of order across pool
    threads); the durable cursor is the index up to which they are
    contiguously fsynced, advanced only at :meth:`checkpoint` and
    :meth:`drain`. The initializer never persists a cursor beyond the
    durable one.

    ENOSPC parks instead of failing (``enospc_wait=True``): the failing
    worker retries every ``enospc_retry_s`` (or at :meth:`kick`),
    :meth:`degraded` says why, backpressure pauses the submitter, and the
    pool resumes by itself when space returns. Any other OS error, or
    ENOSPC with the wait off, fails the pool with a typed
    :class:`LabelWriteError` and unblocks queued submitters.
    """

    _STOP = object()

    def __init__(self, store: LabelStore, threads: int = 2,
                 queue_depth: int = 8, enospc_wait: bool = True,
                 enospc_retry_s: float = 0.5):
        self.store = store
        self.enospc_wait = enospc_wait
        self.enospc_retry_s = enospc_retry_s
        self._q: queue.Queue = queue.Queue(maxsize=max(queue_depth, 1))
        self._lock = sanitize.lock("post.data.LabelWriter")
        self._idle = sanitize.condition("post.data.LabelWriter.idle",
                                        self._lock)
        # the cursors and their completion map are declared shared to the
        # lockset sanitizer: the dispatch thread, the pool threads and the
        # watchdog all meet here, always under _lock
        self._shared = sanitize.SharedField("post.data.LabelWriter.cursor")
        self._done: dict[int, tuple[int, bytes]] = {}  # start -> (end, bytes)
        self._flushed = store.meta.labels_written
        self._durable = store.meta.labels_written
        # running CRC32 over [open interval start, _flushed); cut at
        # checkpoint()
        self._crc = 0
        self._degraded: str | None = None
        self._ckpt_active = False  # parks the flushed/CRC advance
        self._inflight = 0
        self._error: BaseException | None = None
        self._closed = False
        self.labels_submitted = 0
        self.write_seconds = 0.0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"label-writer-{i}")
            for i in range(max(threads, 1))]
        for t in self._threads:
            t.start()

    def submit(self, start_index: int, labels: bytes) -> None:
        """Enqueue one write; blocks while the queue is full. A blocked
        submitter re-checks the pool's failure flag between bounded put
        attempts, so a dead pool cannot deadlock it."""
        self._raise_if_failed()
        with self._lock:
            self._shared.touch()
            if self._closed:
                raise RuntimeError("writer is closed")
            self._inflight += 1
        self.labels_submitted += len(labels) // LABEL_BYTES
        # pool threads are long-lived and cannot inherit the submitter's
        # contextvars; the span parent rides along with the work item
        item = (start_index, labels, tracing.current_id())
        while True:
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                try:
                    self._raise_if_failed()
                except LabelWriteError:
                    with self._lock:
                        self._shared.touch()
                        self._inflight -= 1
                    raise

    def flushed(self) -> int:
        """Label index up to which every label was handed to the OS."""
        with self._lock:
            self._shared.touch()
            return self._flushed

    def durable(self) -> int:
        """Label index up to which every label is fsynced."""
        with self._lock:
            self._shared.touch()
            return self._durable

    def pending(self) -> int:
        """Writes submitted but not yet on disk: the stall watchdog's
        activity gate (``obs/health.py:writer_watchdog``)."""
        with self._lock:
            self._shared.touch(write=False)
            return self._inflight

    def degraded(self) -> str | None:
        """Why the pool is parked (ENOSPC), or None while healthy."""
        with self._lock:
            self._shared.touch()
            return self._degraded

    def kick(self) -> None:
        """Wake a parked ENOSPC retry now (the operator's "space is
        free" signal, and tests)."""
        with self._idle:
            self._shared.touch()
            self._idle.notify_all()

    def wait_for_space(self, what: str) -> None:
        """Park the caller in the ENOSPC degraded state for one retry
        interval: set ``degraded()``, then wait ``enospc_retry_s`` or a
        :meth:`kick`. The pool's writes park here, and the initializer's
        checkpoint and metadata saves too."""
        with self._idle:
            self._shared.touch()
            if self._closed:
                raise LabelWriteError("writer closed while waiting "
                                      "for disk space",
                                      errno_=errno.ENOSPC)
            self._degraded = f"enospc: {what} waiting for space"
            metrics.post_store_degraded.set(1.0)
            metrics.post_store_enospc_waits.inc()
            self._idle.wait(timeout=self.enospc_retry_s)

    def clear_degraded(self) -> None:
        with self._idle:
            self._shared.touch()
            was = self._degraded is not None
            self._degraded = None
        if was:
            metrics.post_store_degraded.set(0.0)

    def checkpoint(self) -> tuple[int, int]:
        """Make the flushed prefix durable. Returns ``(durable, crc)`` with
        the CRC of [previous checkpoint, durable). The flushed advance is
        parked while the fsync runs, so the CRC cut lands exactly at the
        durable cursor."""
        with self._lock:
            self._shared.touch()
            self._ckpt_active = True
            f = self._flushed
            crc = self._crc
        try:
            self.store.sync()
        except BaseException:
            with self._idle:
                self._shared.touch()
                self._ckpt_active = False
                self._advance_locked()
                self._idle.notify_all()
            raise
        with self._idle:
            self._shared.touch()
            self._durable = f
            self._crc = 0
            self._ckpt_active = False
            self._advance_locked()
            self._idle.notify_all()
        return f, crc

    def queue_depth(self) -> int:
        return self._q.qsize()

    def drain(self) -> None:
        """Block until every submitted write is durably on disk. Does not
        cut the checkpoint CRC interval."""
        with self._idle:
            self._shared.touch()
            while self._inflight > 0 and self._error is None:
                self._idle.wait(timeout=0.1)
        self._raise_if_failed()
        with self._lock:
            self._shared.touch()
            f = self._flushed
        while True:
            try:
                self.store.sync()
                break
            except OSError as e:
                if e.errno != errno.ENOSPC or not self.enospc_wait:
                    raise
                self.wait_for_space("label fsync at drain")
        self.clear_degraded()
        with self._lock:
            self._shared.touch()
            self._durable = f

    def close(self, drain: bool = True) -> None:
        try:
            with self._lock:
                self._shared.touch()
                if self._closed:
                    return
                failed = self._error is not None
            if drain and not failed:
                self.drain()
        finally:
            # a worker parked on ENOSPC is kicked awake (it sees _closed
            # and fails), so a full queue makes room for the sentinels
            with self._lock:
                self._shared.touch()
                self._closed = True
            self.kick()
            for _ in self._threads:
                while True:
                    try:
                        self._q.put(self._STOP, timeout=0.2)
                        break
                    except queue.Full:
                        self.kick()
            for t in self._threads:
                t.join(timeout=10)

    def _raise_if_failed(self) -> None:
        with self._lock:
            self._shared.touch()
            error = self._error
        if error is not None:
            raise LabelWriteError(
                errno_=getattr(error, "errno", None)) from error

    def _write_with_enospc_wait(self, start: int, labels: bytes) -> None:
        """One write; ENOSPC parks this worker in a retry loop instead of
        failing the pool. Every retry is a real write attempt, so under
        a fault plan the release is at a set operation count."""
        while True:
            try:
                self.store.write_labels(start, labels)
                self.clear_degraded()
                return
            except OSError as e:
                if e.errno != errno.ENOSPC or not self.enospc_wait:
                    raise
                self.wait_for_space(f"label write at {start}")

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            start, labels, parent = item
            t0 = time.perf_counter()
            try:
                with tracing.span("init.write",
                                  {"start": start,
                                   "labels": len(labels) // LABEL_BYTES}
                                  if tracing.is_enabled() else None,
                                  parent=parent):
                    self._write_with_enospc_wait(start, labels)
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                with self._idle:
                    self._shared.touch()
                    if self._error is None:
                        self._error = e
                    self._inflight -= 1
                    self._idle.notify_all()
                continue
            count = len(labels) // LABEL_BYTES
            with self._idle:
                self._shared.touch()
                self.write_seconds += time.perf_counter() - t0
                self._done[start] = (start + count, labels)
                self._advance_locked()
                self._inflight -= 1
                self._idle.notify_all()

    # guarded by: self._lock
    def _advance_locked(self) -> None:
        """Advance the contiguous-flushed cursor, feeding each chunk to the
        open interval's CRC in order."""
        if self._ckpt_active:
            return
        while self._flushed in self._done:
            end, chunk = self._done.pop(self._flushed)
            self._crc = zlib.crc32(chunk, self._crc)
            self._flushed = end


class LabelReader:
    """Bounded read-ahead pool over one LabelStore.

    Pool threads read the ``(start_index, count)`` ranges of a pass plan
    ahead of the consumer; ``get()`` yields each range's bytes in plan
    order, with at most ``depth`` ranges buffered or in flight.
    """

    def __init__(self, store: LabelStore, ranges, threads: int = 2,
                 depth: int = 4):
        self.store = store
        self.ranges: list[tuple[int, int]] = list(ranges)
        # pool threads cannot inherit contextvars; reads parent under the
        # span that planned the pass (the prover's window span)
        self._trace_parent = tracing.current_id()
        self._cond = sanitize.condition("post.data.LabelReader")
        self._shared = sanitize.SharedField("post.data.LabelReader.state")
        self._results: dict[int, bytes] = {}
        self._claim = 0          # next plan slot a worker may take
        self._consume = 0        # next plan slot get() returns
        self._budget = max(depth, 1)  # free read-ahead slots
        self._error: BaseException | None = None
        self._closed = False
        self.read_seconds = 0.0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"label-reader-{i}")
            for i in range(max(threads, 1))]
        for t in self._threads:
            t.start()

    def get(self) -> bytes:
        """Bytes of the next range in plan order; blocks until read. A
        background failure surfaces on the first range actually missing."""
        with self._cond:
            self._shared.touch()
            while (self._consume not in self._results
                   and self._error is None):
                if self._consume >= len(self.ranges):
                    raise IndexError("read plan exhausted")
                self._cond.wait(timeout=0.1)
            if self._consume in self._results:
                data = self._results.pop(self._consume)
                self._consume += 1
                self._budget += 1
                self._cond.notify_all()
                return data
            raise RuntimeError("background label reader failed") \
                from self._error

    def close(self) -> None:
        """Stop the pool; safe mid-plan (an early exit drops reads)."""
        with self._cond:
            self._shared.touch()
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    def _worker(self) -> None:
        while True:
            with self._cond:
                self._shared.touch()
                while (not self._closed and self._error is None
                       and (self._budget <= 0
                            or self._claim >= len(self.ranges))):
                    if self._claim >= len(self.ranges):
                        return  # plan fully claimed
                    self._cond.wait(timeout=0.1)
                if self._closed or self._error is not None:
                    return
                slot = self._claim
                self._claim += 1
                self._budget -= 1
            start, count = self.ranges[slot]
            t0 = time.perf_counter()
            try:
                with tracing.span("prove.read_io",
                                  {"start": start, "count": count}
                                  if tracing.is_enabled() else None,
                                  parent=self._trace_parent):
                    data = self.store.read_labels(start, count)
            except BaseException as e:  # noqa: BLE001 — surfaced via get()
                with self._cond:
                    self._shared.touch()
                    if self._error is None:
                        self._error = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._shared.touch()
                self.read_seconds += time.perf_counter() - t0
                self._results[slot] = data
                self._cond.notify_all()


# --- crash recovery ------------------------------------------------------


@dataclasses.dataclass
class RecoveryReport:
    """What reopen had to repair (all zero on a clean shutdown)."""

    verified_labels: int = 0       # tail-interval labels crc-checked
    truncated_bytes: int = 0       # torn/un-fsynced bytes removed
    removed_files: int = 0         # label files wholly past the cursor
    intervals_dropped: int = 0     # checkpoints that failed their CRC
    rolled_back_labels: int = 0    # cursor retreat across dropped intervals
    cursor: int = 0                # the verified resume cursor

    @property
    def acted(self) -> bool:
        return bool(self.truncated_bytes or self.removed_files
                    or self.intervals_dropped)


def _disk_extent(store: LabelStore, total: int) -> int:
    """Contiguous labels actually present on disk from index 0."""
    lpf = store.meta.labels_per_file
    extent = 0
    fi = 0
    while extent < total:
        try:
            size = store.fs.getsize(store._file(fi))
        except OSError:
            break
        extent += min(size // LABEL_BYTES, lpf)
        if size < lpf * LABEL_BYTES:
            break
        fi += 1
    return min(extent, total)


def _crc_of_range(store: LabelStore, start: int, end: int,
                  chunk: int = 1 << 16) -> int:
    crc = 0
    idx = start
    while idx < end:
        take = min(chunk, end - idx)
        crc = zlib.crc32(store.read_labels(idx, take), crc)
        idx += take
    return crc


def recover_store(data_dir: str | Path, meta: PostMetadata,
                  fs=None) -> RecoveryReport:
    """Reopen-time recovery: converge the label files and the metadata
    cursor to a verified, mutually consistent state.

    1. Clamp the cursor to the contiguous on-disk extent.
    2. Verify the tail checkpoint interval's CRC32, stepping back through
       ``meta.intervals`` until one checks out (pre-checksum stores are
       trusted up to the bytes present, and their ledger is backfilled).
    3. Truncate bytes past the verified cursor, remove label files wholly
       past it, fsync what was touched.
    4. Persist the repaired metadata.

    Repairs count in the ``post_store_recovery_*`` metrics; the pass is
    an ``init.recover`` span.
    """
    st = LabelStore(data_dir, meta, fs=fs)
    report = RecoveryReport()
    span = tracing.span("init.recover", {"dir": str(data_dir)}
                        if tracing.is_enabled() else None)
    span.__enter__()
    try:
        total = meta.total_labels
        lpf = meta.labels_per_file
        cursor = min(meta.labels_written, total)
        intervals = [list(map(int, iv)) for iv in (meta.intervals or [])]
        extent = _disk_extent(st, total)

        if intervals:
            cursor = min(cursor, intervals[-1][0])
            while intervals and intervals[-1][0] > extent:
                intervals.pop()
                report.intervals_dropped += 1
            cursor = min(cursor, intervals[-1][0] if intervals else 0)
            while intervals:
                end, want = intervals[-1]
                prev = intervals[-2][0] if len(intervals) > 1 else 0
                try:
                    got = _crc_of_range(st, prev, end)
                except OSError:
                    got = None  # an unreadable tail counts as failed
                if got == want:
                    report.verified_labels += end - prev
                    cursor = end
                    break
                intervals.pop()
                report.intervals_dropped += 1
                cursor = prev
            if not intervals:
                cursor = 0
        else:
            cursor = min(cursor, extent)
            if cursor > 0:
                intervals = []
                start = 0
                while start < cursor:
                    end = min(start + BACKFILL_INTERVAL_LABELS, cursor)
                    intervals.append([end, _crc_of_range(st, start, end)])
                    start = end

        report.rolled_back_labels = max(meta.labels_written - cursor, 0)

        touched = False
        for path in sorted(Path(st.dir).glob("postdata_*.bin")):
            try:
                fi = int(path.stem.rsplit("_", 1)[1])
            except ValueError:
                continue
            try:
                size = st.fs.getsize(path)
            except OSError:
                continue
            expect = max(0, min(cursor - fi * lpf, lpf)) * LABEL_BYTES
            if size > expect:
                if expect == 0 and fi * lpf >= cursor:
                    st.fs.unlink(path)
                    report.removed_files += 1
                else:
                    st.fs.truncate(path, expect)
                report.truncated_bytes += size - expect
                touched = True
        if touched:
            fsio.fsync_dir(st.dir, fs=st.fs)

        changed = (cursor != meta.labels_written
                   or intervals != [list(map(int, iv))
                                    for iv in (meta.intervals or [])])
        meta.labels_written = cursor
        meta.intervals = intervals
        report.cursor = cursor
        if changed or report.acted:
            meta.save(st.dir, fs=st.fs)
            metrics.post_store_recovery_runs.inc()
            metrics.post_store_recovery_truncated_bytes.inc(
                report.truncated_bytes)
            metrics.post_store_recovery_intervals_dropped.inc(
                report.intervals_dropped)
        return report
    finally:
        span.__exit__(None, None, None)
        st.close()
