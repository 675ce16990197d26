"""The port's crash-safe PoST store against the JAX package, on the CPU.

The port's init runs over ``spacemesh_tpu_torch/post/faultfs.py``: a power
cut (or torn write) at every write-path operation, then reboot, recovery
and resume, must give a store byte-identical to the JAX package's
uninjected one. ENOSPC parks the writer (``degraded()``, ``kick()``) and
the session completes; EIO fails typed and a rerun resumes; short writes
are retried; a power cut inside a metadata save keeps the old content; the
``post_store_*`` counters move as the JAX package's do. Recovery on a
caller's store (``recover_store(..., store=)``) drops the store's cached
read fds, so no read serves the pre-recovery inode; its report equals the
JAX package's. A recovery is an ``init.recover`` span, ENOSPC flips the
``post.store`` readiness probe, and a scheduler-finished resume keeps a
ledger that covers its cursor. The port's operation numbering may differ
from the JAX package's, so outcomes are compared, never operation indices.
"""

import dataclasses
import errno
import hashlib
import os
import sys
import threading
import time
import zlib
from unittest import mock

import pytest
import torch

from spacemesh_tpu.post import data as jdata
from spacemesh_tpu.post import faultfs as jfaultfs
from spacemesh_tpu.post import initializer as jinit
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.post import data as tdata
from spacemesh_tpu_torch.post import faultfs
from spacemesh_tpu_torch.post import initializer as tinit
from spacemesh_tpu_torch.post.data import (LabelStore, LabelWriteError,
                                           PostMetaCorrupt, PostMetadata,
                                           recover_store)
from spacemesh_tpu_torch.obs import health
from spacemesh_tpu_torch.utils import fsio, metrics, tracing

NODE = hashlib.sha256(b"torch-crash-node").digest()
COMMIT = hashlib.sha256(b"torch-crash-commitment").digest()

TOTAL = 256
BATCH = 128
N = 2
FILE_BYTES = 2048  # 128 labels per file -> 2 files
STORE_COUNTERS = ("post_store_fault_injections", "post_store_recovery_runs",
                  "post_store_recovery_truncated_bytes",
                  "post_store_recovery_intervals_dropped",
                  "post_store_fsyncs", "post_store_read_calls",
                  "post_store_read_bytes", "post_store_enospc_waits")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def label_memo():
    """These tests rerun one small init dozens of times; on the CPU the
    plain PBKDF2 twin is most of each run. Memoize the label batches (a
    pure function of commitment, indices and N, each computed once by the
    real function) so the time goes to the storage plane; the VRF
    min-scan and every file operation still run, and the stores are held
    against the JAX package's."""
    real = tscrypt.scrypt_labels_words
    memo = {}

    def labels(cw, lo, hi, *, n, chunk=None):
        key = tuple(t.numpy().tobytes() for t in (cw, lo, hi)) + (n,)
        if key not in memo:
            memo[key] = real(cw, lo, hi, n=n)
        return memo[key].clone()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscrypt, "scrypt_labels_words", labels)
        yield


def _op_log(ff):
    """A FaultFS of module ``ff`` that also logs each mutating op it
    counts as (primitive, file name), in op order."""

    class Logged(ff.FaultFS):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.log = []

        def _next_op(self, on, path, *a, **k):
            if on == "write":
                self.log.append((sys._getframe(1).f_code.co_name,
                                 os.path.basename(path or "")))
            return super()._next_op(on, path, *a, **k)

    return Logged


def _op_index(log, prim, prefix, nth=1) -> int:
    """1-based op number of the ``nth`` ``prim`` on a file named
    ``prefix``..."""
    hits = [i for i, (p, name) in enumerate(log, 1)
            if p == prim and name.startswith(prefix)]
    return hits[nth - 1]


def _kwargs(**over):
    kw = dict(node_id=NODE, commitment=COMMIT, num_units=1,
              labels_per_unit=TOTAL, scrypt_n=N, max_file_size=FILE_BYTES,
              batch_size=BATCH, writers=1, save_barrier=True,
              meta_interval_s=1e9, meta_interval_labels=BATCH)
    kw.update(over)
    return kw


def _port_init(d, **over):
    return tinit.initialize(d, device="cpu", **_kwargs(**over))


def _jax_init(d, **over):
    return jinit.initialize(d, mesh=None, **_kwargs(**over))


def _store_state(d):
    meta = PostMetadata.load(d)
    store = LabelStore(d, meta)
    try:
        sha = hashlib.sha256(
            store.read_labels(0, meta.total_labels)).hexdigest()
    finally:
        store.close()
    return sha, meta.vrf_nonce, meta.vrf_nonce_value, meta.intervals


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's uninjected store (the ground truth), and the
    port's mutating-op count for the same init (the crash sites)."""
    jdir = tmp_path_factory.mktemp("crash-jax")
    _jax_init(jdir)
    tdir = tmp_path_factory.mktemp("crash-port")
    fs = faultfs.FaultFS()
    _port_init(tdir, fs=fs)
    assert not fs.injected
    ref = _store_state(jdir)
    assert _store_state(tdir) == ref
    return ref, fs.write_ops


def _counters(mod) -> dict:
    return {name: sum(getattr(mod, name).sample().values())
            for name in STORE_COUNTERS}


# --- the sweep ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["powercut", "torn"])
def test_crash_sweep_every_op_site_matches_jax(tmp_path, reference, kind):
    """At every write-path op of the port's init: crash there, reboot
    (un-fsynced bytes and un-committed renames vanish), reopen, resume.
    The completed store equals the JAX package's uninjected one."""
    ref, total_ops = reference
    assert total_ops > 0
    failures = []
    for op in range(1, total_ops + 1):
        d = tmp_path / f"crash-{op}"
        fs = faultfs.FaultFS(faultfs.FaultPlan(
            [faultfs.FaultSpec(op=op, kind=kind)], seed=11))
        crashed = 0
        for _ in range(5):
            try:
                _port_init(d, fs=fs)
                break
            except BaseException as e:  # noqa: BLE001 — PowerCut behind pool errors
                assert faultfs.power_cut_behind(e) is not None, \
                    f"op {op} {kind}: non-powercut failure {e!r}"
                fs.reboot()
                crashed += 1
        else:
            failures.append((op, "did not converge"))
            continue
        assert crashed >= 1, f"op {op}: fault never surfaced ({fs.injected})"
        if _store_state(d) != ref:
            failures.append((op, "store diverged"))
    assert not failures, failures


# (primitive, file, occurrence, fault): a power cut in the metadata save
# after the second batch's fsync leaves durable labels past the durable
# cursor, which recovery truncates; one at that fsync leaves nothing to do
COUNTER_SITES = [("pwrite", "postdata_metadata.json", 2, "powercut"),
                 ("fsync", "postdata_1.bin", 1, "powercut"),
                 ("pwrite", "postdata_1.bin", 1, "torn")]


@pytest.mark.parametrize("site", COUNTER_SITES,
                         ids=lambda s: f"{s[3]}-{s[0]}-{s[1]}-{s[2]}")
def test_store_counters_move_as_jax_does(tmp_path, reference, site):
    """The same fault in each package (found by its own op numbering),
    reboot, recovery, resume: each ``post_store_*`` counter moves by what
    the JAX package's moves by, and both stores end equal."""
    ref, _ = reference
    prim, prefix, nth, kind = site
    moved = {}
    for name, init, ff, mod in (
            ("jax", _jax_init, jfaultfs, jmetrics),
            ("port", _port_init, faultfs, metrics)):
        probe = _op_log(ff)()
        init(tmp_path / f"{name}-probe", fs=probe)
        op = _op_index(probe.log, prim, prefix, nth)
        d = tmp_path / name
        before = _counters(mod)
        fs = ff.FaultFS(ff.FaultPlan([ff.FaultSpec(op=op, kind=kind)],
                                     seed=5))
        with pytest.raises(BaseException) as ei:
            init(d, fs=fs)
        assert ff.power_cut_behind(ei.value) is not None
        fs.reboot()
        init(d, fs=fs)
        after = _counters(mod)
        moved[name] = {k: after[k] - before[k] for k in STORE_COUNTERS}
        assert _store_state(d) == ref
    assert moved["port"] == moved["jax"]
    assert moved["port"]["post_store_fault_injections"] == 1
    if site == COUNTER_SITES[0]:
        assert moved["port"]["post_store_recovery_runs"] == 1
        assert moved["port"]["post_store_recovery_truncated_bytes"] > 0


def test_store_metrics_expose_like_jax():
    """The text exposition of the same instrument operations is the same
    in both packages."""
    from spacemesh_tpu.utils.metrics import Registry as JRegistry

    out = []
    for reg in (JRegistry(), metrics.Registry()):
        c = reg.counter("post_store_fault_injections_total", "faults")
        c.inc(kind="eio")
        c.inc(2, kind='we"ird\n')
        reg.gauge("post_store_degraded", "parked").set(1.0)
        out.append(reg.expose())
    assert out[0] == out[1]


def test_eio_in_writer_fails_typed_and_resumes(tmp_path, reference):
    ref, _ = reference
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="eio")], seed=2))
    with pytest.raises(LabelWriteError) as ei:
        _port_init(tmp_path, fs=fs)
    assert ei.value.errno == errno.EIO
    _port_init(tmp_path, fs=fs)
    assert _store_state(tmp_path) == ref


def test_short_writes_are_retried_to_completion(tmp_path, reference):
    ref, _ = reference
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="short")], seed=9))
    _port_init(tmp_path, fs=fs)
    assert [e["kind"] for e in fs.injected] == ["short"]
    assert _store_state(tmp_path) == ref


# --- ENOSPC: degraded, not dead ------------------------------------------------


def test_enospc_parks_the_init_then_it_completes(tmp_path, reference):
    """ENOSPC mid-init parks the pipeline (the degraded gauge reads 1
    while the disk stays full) and the init completes, identical to the
    JAX store, once the plan frees space; the gauge is 0 after."""
    ref, _ = reference
    waits0 = sum(metrics.post_store_enospc_waits.sample().values())
    seen = []

    def on_inject(spec, n):
        seen.append(metrics.post_store_degraded.sample().get((), 0.0))

    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="enospc", hold_ops=5)],
        seed=4, on_inject=on_inject))
    _port_init(tmp_path, fs=fs, enospc_retry_s=0.01)
    assert _store_state(tmp_path) == ref
    assert len(seen) >= 5 and 1.0 in seen, seen
    assert sum(metrics.post_store_enospc_waits.sample().values()) > waits0
    assert metrics.post_store_degraded.sample().get((), 1.0) == 0.0


@pytest.mark.parametrize("site", ["write", "checkpoint", "save"])
def test_enospc_at_each_storage_site_parks_then_completes(tmp_path,
                                                          reference, site):
    """ENOSPC on the label write, the checkpoint fsync or the metadata
    save: every one parks and retries, none fails the session."""
    ref, _ = reference
    probe = _op_log(faultfs)()
    _port_init(tmp_path / "probe", fs=probe)
    op = _op_index(probe.log, *{
        "write": ("pwrite", "postdata_0.bin"),
        "checkpoint": ("fsync", "postdata_0.bin"),
        "save": ("replace", "postdata_metadata.json")}[site])
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=op, kind="enospc", hold_ops=2)], seed=3))
    _port_init(tmp_path / "run", fs=fs, enospc_retry_s=0.01)
    assert [e["kind"] for e in fs.injected] == ["enospc"] * 2
    assert _store_state(tmp_path / "run") == ref


def test_enospc_kick_wakes_a_parked_writer(tmp_path):
    """With a long retry interval, only ``kick()`` can wake the parked
    writer in time: ``degraded()`` says why while it waits and clears
    once the write lands."""
    meta = PostMetadata(node_id=NODE.hex(), commitment=COMMIT.hex(),
                        scrypt_n=N, num_units=1, labels_per_unit=TOTAL,
                        max_file_size=1 << 20)
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="enospc", hold_ops=3)], seed=1))
    store = LabelStore(tmp_path, meta, fs=fs)
    w = store.start_writer(threads=1, enospc_retry_s=600.0)
    payload = bytes(range(256)) * 4
    reasons = []
    try:
        w.submit(0, payload)
        deadline = time.monotonic() + 30
        while w.flushed() < len(payload) // 16:
            assert time.monotonic() < deadline, "kick() did not wake it"
            why = w.degraded()
            if why is not None:
                reasons.append(why)
                w.kick()
            time.sleep(0.005)
        w.drain()
        assert w.degraded() is None
        assert w.durable() == len(payload) // 16
    finally:
        w.close(drain=False)
        store.close()
    assert reasons and "enospc" in reasons[0]
    assert (tmp_path / "postdata_0.bin").read_bytes() == payload


def test_enospc_with_full_queue_unblocks_submitters(tmp_path):
    """enospc_wait=False: ENOSPC is a typed failure, and a submitter
    blocked on the full queue unblocks with it instead of deadlocking."""
    meta = PostMetadata(node_id=NODE.hex(), commitment=COMMIT.hex(),
                        scrypt_n=N, num_units=1, labels_per_unit=TOTAL,
                        max_file_size=1 << 20)
    store = LabelStore(tmp_path, meta)
    gate = threading.Event()

    def failing(self, start, labels):
        gate.wait(10)
        raise OSError(errno.ENOSPC, "disk full (injected)")

    outcome = []
    with mock.patch.object(LabelStore, "write_labels", failing):
        w = store.start_writer(threads=1, queue_depth=1, enospc_wait=False)
        try:
            w.submit(0, bytes(16))          # the worker takes it, waits
            w.submit(1, bytes(16))          # fills the 1-deep queue

            def blocked_submit():
                try:
                    w.submit(2, bytes(16))  # blocks: the queue is full
                    outcome.append(("queued", None))
                except LabelWriteError as e:
                    outcome.append(("raised", e.errno))

            t = threading.Thread(target=blocked_submit)
            t.start()
            gate.set()                      # ENOSPC lands; the pool fails
            t.join(timeout=10)
            assert not t.is_alive(), "submitter deadlocked on a dead pool"
            with pytest.raises(LabelWriteError) as ei:
                w.drain()
            assert ei.value.errno == errno.ENOSPC
            assert outcome and outcome[0][0] in ("queued", "raised")
            if outcome[0][0] == "raised":
                assert outcome[0][1] == errno.ENOSPC
        finally:
            gate.set()
            w.close(drain=False)
            store.close()


# --- fsync discipline and interval checksums --------------------------------


def test_durable_means_fsynced(tmp_path):
    meta = PostMetadata(node_id=NODE.hex(), commitment=COMMIT.hex(),
                        scrypt_n=N, num_units=1, labels_per_unit=TOTAL,
                        max_file_size=1 << 20)
    store = LabelStore(tmp_path, meta)
    w = store.start_writer(threads=1)
    try:
        payload = bytes(range(256)) * (BATCH * 16 // 256)
        w.submit(0, payload)
        deadline = time.monotonic() + 10
        while w.flushed() < BATCH:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert w.durable() == 0, "durable advanced without an fsync"
        d, crc = w.checkpoint()
        assert d == BATCH and w.durable() == BATCH
        assert crc == zlib.crc32(payload)
    finally:
        w.close(drain=False)
        store.close()


def test_tail_corruption_rolls_back_to_verified_checkpoint(tmp_path,
                                                           reference):
    ref, _ = reference
    _port_init(tmp_path)
    meta = PostMetadata.load(tmp_path)
    assert len(meta.intervals) >= 2, meta.intervals
    first_end = meta.intervals[0][0]
    fi, within = divmod(first_end, meta.labels_per_file)
    path = tmp_path / f"postdata_{fi}.bin"
    raw = bytearray(path.read_bytes())
    raw[within * 16] ^= 0xFF
    path.write_bytes(raw)

    report = recover_store(tmp_path, meta)
    assert report.intervals_dropped >= 1
    assert report.cursor == first_end == meta.labels_written
    _port_init(tmp_path)
    assert _store_state(tmp_path) == ref


def test_bytes_past_cursor_are_truncated(tmp_path, reference):
    ref, _ = reference
    _port_init(tmp_path)
    meta = PostMetadata.load(tmp_path)
    meta.intervals.pop()
    meta.labels_written = meta.intervals[-1][0]
    meta.save(tmp_path)
    last = sorted(tmp_path.glob("postdata_*.bin"))[-1]
    with open(last, "ab") as fh:
        fh.write(b"\x99" * 7)  # a torn, non-record-aligned tail
    stray = tmp_path / "postdata_9.bin"
    stray.write_bytes(b"\x77" * 64)

    report = recover_store(tmp_path, PostMetadata.load(tmp_path))
    assert report.truncated_bytes > 0
    assert report.removed_files >= 1
    assert not stray.exists()
    _port_init(tmp_path)
    assert _store_state(tmp_path) == ref


def test_legacy_metadata_without_intervals_backfills(tmp_path, reference,
                                                     monkeypatch):
    ref, _ = reference
    _port_init(tmp_path)
    meta = PostMetadata.load(tmp_path)
    meta.intervals = []
    meta.save(tmp_path)
    monkeypatch.setattr(tdata, "BACKFILL_INTERVAL_LABELS", BATCH)
    meta2 = PostMetadata.load(tmp_path)
    recover_store(tmp_path, meta2)
    assert meta2.intervals and meta2.intervals[-1][0] == TOTAL
    assert len(meta2.intervals) == TOTAL // BATCH, meta2.intervals
    report = recover_store(tmp_path, PostMetadata.load(tmp_path))
    assert report.intervals_dropped == 0
    assert report.verified_labels <= BATCH  # the tail segment only
    assert _store_state(tmp_path)[:3] == ref[:3]


def test_fresh_dir_with_stray_label_files_is_wiped(tmp_path, reference):
    ref, _ = reference
    (tmp_path / "postdata_0.bin").write_bytes(b"\x55" * 333)
    _port_init(tmp_path)
    assert _store_state(tmp_path) == ref


def _swap_inodes(d, meta, good):
    """Replace both label files by NEW inodes: file 0 keeps the first
    interval's bytes, file 1 is garbage that fails the tail CRC."""
    lpf = meta.labels_per_file
    f0, f1 = d / "postdata_0.bin", d / "postdata_1.bin"
    os.unlink(f0)
    f0.write_bytes(good[:lpf * 16])
    os.unlink(f1)
    f1.write_bytes(b"\x13" * (TOTAL - lpf) * 16)
    return f0


def test_read_fd_cache_invalidated_across_recovery(tmp_path, reference):
    """Recovery on a caller's store drops the store's cached read fds: a
    cached fd pins the pre-recovery inode, so later reads must see the
    repaired file, not the unlinked one. The report and the metadata
    equal the JAX package's on the same surgery."""
    ref, _ = reference
    out = {}
    for name, init, Store, recover, Meta in (
            ("jax", _jax_init, jdata.LabelStore, jdata.recover_store,
             jdata.PostMetadata),
            ("port", _port_init, LabelStore, recover_store, PostMetadata)):
        d = tmp_path / name
        init(d)
        meta = Meta.load(d)
        store = Store(d, meta)
        good = store.read_labels(0, TOTAL)  # caches one fd per file
        assert hashlib.sha256(good).hexdigest() == ref[0]
        f0 = _swap_inodes(d, meta, good)
        report = recover(d, meta, store=store)
        out[name] = (dataclasses.asdict(report), meta.labels_written,
                     meta.intervals)
        # the store was the caller's: still open, and reading the CURRENT
        # inode, as a direct write to it shows
        with open(f0, "r+b") as fh:
            fh.write(b"\xEE" * 16)
        assert store.read_labels(0, 1) == b"\xEE" * 16, \
            f"{name}: a cached fd served the pre-recovery inode"
        store.close()
    assert out["port"] == out["jax"]
    report, written, _ = out["port"]
    assert report["intervals_dropped"] >= 1  # the garbage tail failed
    assert written == FILE_BYTES // 16


def test_recovery_reuses_only_the_store_it_was_given(tmp_path, reference):
    """Without ``store=`` recovery opens and closes a store of its own, and
    a caller's store goes on serving the unlinked inode through its cached
    fd; recovery with ``store=`` drops that fd and leaves the store open
    on the files as they are now."""
    _port_init(tmp_path)
    meta = PostMetadata.load(tmp_path)
    lpf = meta.labels_per_file
    store = LabelStore(tmp_path, meta)
    good = store.read_labels(0, TOTAL)
    fds = dict(store._read_fds)
    f0 = _swap_inodes(tmp_path, meta, good)
    report = recover_store(tmp_path, PostMetadata.load(tmp_path))
    assert report.intervals_dropped >= 1 and report.removed_files == 1
    assert store._read_fds == fds  # recovery never saw this store
    # file 1 is gone from the directory, yet the cached fd still reads it
    assert store.read_labels(lpf, 1) == good[lpf * 16:(lpf + 1) * 16]
    again = recover_store(tmp_path, PostMetadata.load(tmp_path), store=store)
    assert not again.acted and again.verified_labels == lpf
    assert 1 not in store._read_fds
    with pytest.raises(OSError):
        store.read_labels(lpf, 1)
    with open(f0, "r+b") as fh:
        fh.write(b"\xEE" * 16)
    assert store.read_labels(0, 1) == b"\xEE" * 16
    store.close()


def test_recovery_emits_span_and_metrics(tmp_path, reference):
    """A power cut late in the init, a reboot and a rerun: the rerun's
    recovery is an ``init.recover`` span, the injection and recovery
    counters move, and the store is the JAX package's."""
    ref, total_ops = reference
    inj0 = sum(metrics.post_store_fault_injections.sample().values())
    rec0 = sum(metrics.post_store_recovery_runs.sample().values())
    tracing.start(capacity=16384)
    try:
        fs = faultfs.FaultFS(faultfs.FaultPlan(
            [faultfs.FaultSpec(op=max(total_ops - 2, 1), kind="powercut")],
            seed=5))
        with pytest.raises(BaseException) as ei:
            _port_init(tmp_path, fs=fs)
        assert faultfs.power_cut_behind(ei.value) is not None
        fs.reboot()
        _port_init(tmp_path, fs=fs)
        names = {e["name"] for e in tracing.export()["traceEvents"]}
    finally:
        tracing.stop()
    assert "init.recover" in names
    assert _store_state(tmp_path) == ref
    assert sum(metrics.post_store_fault_injections.sample().values()) > inj0
    assert sum(metrics.post_store_recovery_runs.sample().values()) >= rec0


def test_enospc_degrades_readyz_then_resumes(tmp_path, reference):
    """ENOSPC mid-init flips the ``post.store`` probe and a health report's
    readiness without ending the process, and the init completes to the
    JAX package's store once the plan releases space."""
    ref, _ = reference
    waits0 = sum(metrics.post_store_enospc_waits.sample().values())
    engine = health.HealthEngine(time_source=lambda: 1000.0)
    seen = []

    def on_inject(spec, n):
        if spec.kind != "enospc" or len(seen) > 3:
            return
        report = engine.tick(1000.0)
        ent = report["components"].get("post.store")
        if ent is not None:
            seen.append((report["ready"], ent["healthy"], ent["reason"]))

    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="enospc", hold_ops=5)], seed=4,
        on_inject=on_inject))
    _port_init(tmp_path, fs=fs, enospc_retry_s=0.01)
    assert _store_state(tmp_path) == ref
    degraded = [x for x in seen if not x[1]]
    assert degraded, f"post.store never flipped degraded: {seen}"
    assert not degraded[0][0], "/readyz stayed ready through ENOSPC"
    assert "enospc" in degraded[0][2]
    assert sum(metrics.post_store_enospc_waits.sample().values()) > waits0
    # ...and cleared with the session
    assert "post.store" not in health.HEALTH.names()
    assert metrics.post_store_degraded.sample().get((), 1.0) == 0.0


def test_scheduler_resume_preserves_checkpoint_ledger(tmp_path, reference):
    """A partial init, then the scheduler's packed path finishes the store:
    the ledger covers the persisted cursor, so the next reopen's recovery
    keeps every label. The ledgers and the recovery reports equal the JAX
    package's."""
    from spacemesh_tpu.runtime import TenantScheduler as JScheduler
    from spacemesh_tpu_torch.runtime import TenantScheduler

    ref, _ = reference
    out = {}
    for name, init_mod, data_mod, sched_cls, cpu in (
            ("port", tinit, tdata, TenantScheduler, dict(device="cpu")),
            ("jax", jinit, jdata, JScheduler, {})):
        d = tmp_path / name
        meta = init_mod.open_or_create_meta(
            d, node_id=NODE, commitment=COMMIT, num_units=1,
            labels_per_unit=TOTAL, scrypt_n=N, max_file_size=FILE_BYTES)
        init = init_mod.Initializer(
            d, meta, batch_size=BATCH, writers=1, mesh=None, inflight=1,
            save_barrier=True, meta_interval_s=1e9,
            meta_interval_labels=BATCH,
            progress=lambda done, total: init.stop(), **cpu)
        init.run()
        partial = data_mod.PostMetadata.load(d)
        assert 0 < partial.labels_written < TOTAL and partial.intervals
        with sched_cls(workers=2, pack_lanes=BATCH, **cpu) as sched:
            sched.register_tenant("t")
            try:
                sched.submit_init(
                    "t", d, node_id=NODE, commitment=COMMIT, num_units=1,
                    labels_per_unit=TOTAL, scrypt_n=N,
                    max_file_size=FILE_BYTES).result(timeout=300)
            finally:
                sched.unregister_tenant("t")
        done = data_mod.PostMetadata.load(d)
        report = data_mod.recover_store(d, data_mod.PostMetadata.load(d))
        out[name] = (partial.labels_written, partial.intervals,
                     done.labels_written, done.intervals,
                     dataclasses.asdict(report))
        assert _store_state(d) == ref
    assert out["port"] == out["jax"]
    _, _, written, intervals, report = out["port"]
    assert written == TOTAL and intervals[-1][0] == TOTAL
    assert report["rolled_back_labels"] == 0
    assert report["truncated_bytes"] == 0


# --- typed metadata errors, staging cleanup, the fsio contract ---------------


def test_corrupt_metadata_raises_typed(tmp_path):
    p = tmp_path / "postdata_metadata.json"
    p.write_text('{"node_id": "ab", "trunca')
    with pytest.raises(PostMetaCorrupt) as ei:
        PostMetadata.load(tmp_path)
    assert ei.value.path == str(p)
    p.write_text('{"unexpected_key": 1}')
    with pytest.raises(PostMetaCorrupt):
        PostMetadata.load(tmp_path)
    p.write_text('["not", "an", "object"]')
    with pytest.raises(PostMetaCorrupt):
        PostMetadata.load(tmp_path)


def test_stale_staging_tmps_removed_on_load(tmp_path):
    meta = PostMetadata(node_id=NODE.hex(), commitment=COMMIT.hex(),
                        scrypt_n=N, num_units=1, labels_per_unit=TOTAL,
                        max_file_size=1 << 20)
    meta.save(tmp_path)
    stale_new = tmp_path / "postdata_metadata.json.tmp.9999"
    stale_legacy = tmp_path / "postdata_metadata.tmp"
    stale_new.write_text("{half-written")
    stale_legacy.write_text("{older-half-written")
    assert PostMetadata.load(tmp_path).labels_written == 0
    assert not stale_new.exists() and not stale_legacy.exists()


def test_powercut_mid_metadata_save_keeps_old_content(tmp_path):
    """A power cut at each of the save's 4 mutating ops (pwrite, fsync,
    replace, dir fsync) leaves the old metadata after reboot."""
    geom = dict(node_id=NODE.hex(), commitment=COMMIT.hex(), scrypt_n=N,
                num_units=1, labels_per_unit=TOTAL, max_file_size=1 << 20)
    PostMetadata(labels_written=42, **geom).save(tmp_path)
    for op in range(1, 5):
        fs = faultfs.FaultFS(faultfs.FaultPlan(
            [faultfs.FaultSpec(op=op, kind="powercut")], seed=1))
        with pytest.raises(faultfs.PowerCut):
            PostMetadata(labels_written=777, **geom).save(tmp_path, fs=fs)
        fs.reboot()
        assert PostMetadata.load(tmp_path).labels_written == 42, \
            f"op {op}: old metadata not intact after reboot"
    PostMetadata(labels_written=777, **geom).save(tmp_path)
    assert PostMetadata.load(tmp_path).labels_written == 777


def test_atomic_write_survives_powercut_after_dir_fsync(tmp_path):
    target = tmp_path / "winners.json"
    target.write_text("old")
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=5, kind="powercut")], seed=1))
    fsio.atomic_write_text(target, "new", fs=fs)  # 4 ops: completes
    fs.reboot()
    assert target.read_text() == "new"


def test_persist_directory_fsyncs_contained_files(tmp_path):
    src = tmp_path / "bundle.tmp"
    src.mkdir()
    (src / "manifest.json").write_text("m")
    (src / "trace.json").write_text("t")
    fs = faultfs.FaultFS()
    fsio.persist(src, tmp_path / "bundle", fs=fs)
    # 2 file fsyncs + tmp-dir fsync + rename + parent-dir fsync
    assert fs.write_ops == 5, fs.write_ops
    assert (tmp_path / "bundle" / "manifest.json").read_text() == "m"


def test_prover_reads_retry_transient_eio(tmp_path, reference):
    ref, _ = reference
    retries0 = sum(metrics.post_store_read_retries.sample().values())
    _port_init(tmp_path)
    meta = PostMetadata.load(tmp_path)
    fs = faultfs.FaultFS(faultfs.FaultPlan(
        [faultfs.FaultSpec(op=1, kind="eio", on="read")], seed=1))
    store = LabelStore(tmp_path, meta, fs=fs)
    try:
        got = store.read_labels(0, TOTAL)
    finally:
        store.close()
    assert hashlib.sha256(got).hexdigest() == ref[0]
    assert [e["kind"] for e in fs.injected] == ["eio"]
    assert sum(metrics.post_store_read_retries.sample().values()) \
        > retries0
