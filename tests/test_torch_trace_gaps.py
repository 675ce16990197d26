"""The spans that name every host step between two label launches, the
tracer's garbage-collection hook, the allocator collector and the
scheduler's queue wait, on the CPU.

* a traced tiny init and a traced tiny packed init record each new span
  under its parent (``romix.launch``, which runs on the card alone, is held
  in ``tests/test_torch_cuda.py``);
* ``gc.callbacks`` holds the tracer's hook only between ``start()`` and
  ``stop()``, and each collection in between is a ``host.gc`` span;
* with tracing off, the new call sites of the init path get the no-op span
  and read no clock of the tracer's;
* ``device_allocator_calls`` from the caching allocator's statistics;
* the scheduler: one ``runtime.queue_wait`` span and one
  ``runtime_quantum_wait_seconds`` observation per quantum, and gang
  quanta shared fairly among tenants that all keep submitting.

Every wait has a timeout, so no test can hang the run.
"""

import gc
import hashlib
import threading
import time

import pytest
import torch

from spacemesh_tpu_torch import device
from spacemesh_tpu_torch.post import initializer
from spacemesh_tpu_torch.runtime import TenantScheduler
from spacemesh_tpu_torch.utils import metrics, tracing

T = 10.0  # seconds any single wait may take
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in parallel
    workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.stop()
    yield
    tracing.stop()


def _geom(salt: bytes, total: int) -> dict:
    return dict(node_id=hashlib.sha256(b"gap-node" + salt).digest(),
                commitment=hashlib.sha256(b"gap-commit" + salt).digest(),
                num_units=1, labels_per_unit=total, scrypt_n=2,
                max_file_size=1 << 12)


def _spans(doc) -> list:
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def _parents(evs) -> dict:
    """span name -> the set of its spans' parents' names."""
    by_id = {e["args"]["id"]: e["name"] for e in evs}
    out: dict = {}
    for e in evs:
        out.setdefault(e["name"], set()).add(
            by_id.get(e["args"].get("parent")))
    return out


def _traced(fn) -> list:
    tracing.start(capacity=1 << 16, torch_bridge=False)
    try:
        fn()
    finally:
        tracing.stop()
    return _spans(tracing.export())


# --- the init path's spans ------------------------------------------------


def test_traced_init_names_every_host_step(tmp_path):
    evs = _traced(lambda: initializer.initialize(
        tmp_path, batch_size=64, device="cpu", **_geom(b"solo", 192)))
    parents = _parents(evs)
    assert parents["init.build"] == {"init.dispatch"}
    assert parents["romix.dispatch"] == {"init.dispatch"}
    assert parents["scrypt.minscan"] == {"init.dispatch"}
    for name in ("romix.scratch", "scrypt.expand", "scrypt.finish"):
        assert parents[name] == {"romix.dispatch"}, name
    # the labels' and the VRF snapshot's copies
    assert parents["device.host_copy"] == {"init.dispatch"}
    assert parents["device.host_wait"] == {"init.fetch"}
    assert parents["init.to_bytes"] == {"init.fetch"}
    assert parents["init.checkpoint"] == {"init.run"}
    counts = {}
    for e in evs:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts["init.dispatch"] == counts["init.build"] == 3
    assert counts["scrypt.expand"] == counts["scrypt.finish"] == 3
    assert counts["device.host_copy"] == counts["device.host_wait"] == 6
    assert counts["init.checkpoint"] == counts["init.save_meta"]
    # the card's launch span is the card's alone
    assert "romix.launch" not in counts


def test_traced_packed_init_names_every_packer_step(tmp_path):
    def run():
        with TenantScheduler(pack_lanes=64, autostart=False, **CPU) as s:
            for i in range(2):
                s.register_tenant(f"t{i}")
            handles = [s.submit_init(f"t{i}", tmp_path / f"t{i}",
                                     **_geom(b"%d" % i, 96))
                       for i in range(2)]
            s.start()
            for h in handles:
                h.result(timeout=T)

    evs = _traced(run)
    parents = _parents(evs)
    assert parents["runtime.pack.build"] == {"runtime.pack.dispatch"}
    assert parents["romix.dispatch"] == {"runtime.pack.dispatch"}
    assert parents["device.host_copy"] == {"runtime.pack.dispatch"}
    for name in ("romix.scratch", "scrypt.expand", "scrypt.finish"):
        assert parents[name] == {"romix.dispatch"}, name
    assert parents["device.host_wait"] == {"runtime.pack.fetch"}
    # the packer thread's loop and retire run outside any span
    for name in ("runtime.pack.compose", "runtime.pack.fetch",
                 "runtime.pack.to_bytes", "runtime.segment"):
        assert parents[name] == {None}, name
    packs = sum(1 for e in evs if e["name"] == "runtime.pack.dispatch")
    assert packs == 3
    for name in ("runtime.pack.build", "runtime.pack.fetch",
                 "runtime.pack.to_bytes"):
        assert sum(1 for e in evs if e["name"] == name) == packs, name
    assert sum(1 for e in evs if e["name"] == "runtime.pack.compose") \
        >= packs


@pytest.mark.parametrize("packed", [False, True])
def test_untraced_init_path_builds_no_span_and_reads_no_clock(
        tmp_path, monkeypatch, packed):
    """Tracing off: every span call of the init path, old or new, gets the
    no-op singleton with no attribute dict, the tracer's clock is never
    read, and no collection runs the tracer's hook."""
    calls: list = []
    real = tracing.span

    def spy(name, attrs=None, parent=None, cat="host"):
        sp = real(name, attrs, parent, cat)
        calls.append((name, attrs, sp))
        return sp

    def no_clock():
        raise AssertionError("the tracer read its clock with tracing off")

    class Clock:
        perf_counter_ns = staticmethod(no_clock)

    monkeypatch.setattr(tracing, "span", spy)
    monkeypatch.setattr(tracing, "time", Clock)
    assert tracing.TRACER._on_gc not in gc.callbacks
    if packed:
        with TenantScheduler(pack_lanes=64, **CPU) as s:
            s.register_tenant("t0")
            s.submit_init("t0", tmp_path, **_geom(b"off", 128)).result(
                timeout=T)
    else:
        initializer.initialize(tmp_path, batch_size=64, device="cpu",
                               **_geom(b"off", 128))
    gc.collect()
    names = {n for n, _, _ in calls}
    new = {"romix.scratch", "scrypt.expand", "scrypt.finish",
           "device.host_copy", "device.host_wait"}
    new |= ({"runtime.pack.compose", "runtime.pack.build",
             "runtime.pack.fetch", "runtime.pack.to_bytes"} if packed else
            {"init.build", "scrypt.minscan", "init.to_bytes",
             "init.checkpoint"})
    assert new <= names, new - names
    assert all(sp is tracing._NOP and attrs is None
               for _, attrs, sp in calls)


# --- garbage collection ----------------------------------------------------


def test_gc_hook_only_while_tracing():
    hook = tracing.TRACER._on_gc
    assert hook not in gc.callbacks
    tracing.start(capacity=256, torch_bridge=False)
    try:
        assert gc.callbacks.count(hook) == 1
        tracing.start(capacity=256, torch_bridge=False)  # a restart
        assert gc.callbacks.count(hook) == 1
        junk = [[i] for i in range(100)]
        junk.append(junk)  # a cycle for the collector to find
        del junk
        gc.collect()
    finally:
        tracing.stop()
    assert hook not in gc.callbacks
    gcs = [e for e in _spans(tracing.export()) if e["name"] == "host.gc"]
    assert any(e["args"]["generation"] == 2 and e["args"]["collected"] >= 1
               for e in gcs)
    assert all(e["dur"] >= 0 for e in gcs)
    n = len(gcs)
    gc.collect()
    assert len([e for e in _spans(tracing.export())
                if e["name"] == "host.gc"]) == n


# --- the caching allocator's device calls ------------------------------------


def test_allocator_collector_sums_the_cards_statistics(monkeypatch):
    stats = {0: {"num_device_alloc": 5, "num_device_free": 2,
                 "num_alloc_retries": 0},
             1: {"num_device_alloc": 1, "num_device_free": 1,
                 "num_alloc_retries": 3}}
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda index: stats[index])
    monkeypatch.setattr(device, "_cards", {0, 1})
    device._collect_allocator_calls()
    got = metrics.device_allocator_calls.sample()
    assert got[(("call", "malloc"),)] == 6
    assert got[(("call", "free"),)] == 3
    assert got[(("call", "retry"),)] == 3


def test_no_card_resolved_sets_no_allocator_gauge(monkeypatch):
    monkeypatch.setattr(device, "_cards", set())
    monkeypatch.setattr(metrics.device_allocator_calls, "_values", {})
    assert device.resolve("cpu").type == "cpu"
    assert device._cards == set()
    metrics.REGISTRY.sample()  # runs the collector
    assert metrics.device_allocator_calls.sample() == {}


# --- the scheduler's queue wait and gang fairness ----------------------------


def _gang_job(quanta: int, sleep_s: float):
    left = [quanta]

    def quantum():
        time.sleep(sleep_s)
        left[0] -= 1
        return ("done", None) if left[0] == 0 else ("continue", None)
    return quantum


def test_queue_wait_span_per_quantum():
    before = metrics.runtime_quantum_wait.sample().get(
        (("kind", "gangtest"),), ([], 0.0, 0))[2]
    tracing.start(capacity=1 << 12, torch_bridge=False)
    try:
        with TenantScheduler(workers=2, gang_windows=1, **CPU) as s:
            for tid in ("a", "b"):
                s.register_tenant(tid)
            hs = [s._enqueue(tid, "gangtest", _gang_job(3, 0.001), None,
                             gang=True) for tid in ("a", "b")]
            for h in hs:
                h.result(timeout=T)
    finally:
        tracing.stop()
    evs = _spans(tracing.export())
    waits = [e for e in evs if e["name"] == "runtime.queue_wait"]
    quanta = [e for e in evs if e["name"] == "runtime.quantum"]
    assert len(waits) == len(quanta) == 6
    assert {(e["args"]["tenant"], e["args"]["kind"], e["args"]["gang"])
            for e in waits} == {("a", "gangtest", True),
                                ("b", "gangtest", True)}
    assert {e["args"]["job"] for e in waits} == {h.id for h in hs}
    after = metrics.runtime_quantum_wait.sample()[
        (("kind", "gangtest"),)][2]
    assert after - before == 6


def test_gang_quanta_are_shared_by_every_submitting_tenant():
    """2 workers, one gang slot, 5 tenants each submitting multi-quantum
    gang jobs in a closed loop: every tenant completes jobs while all the
    others are still submitting. A worker that took a job and then waited
    for the slot let the releasing worker take the slot again, and that
    tenant starved until the others stopped."""
    tenants = [f"g{i}" for i in range(5)]
    done = {tid: 0 for tid in tenants}
    lock = threading.Lock()
    submitting = threading.Event()
    submitting.set()
    with TenantScheduler(workers=2, gang_windows=1, **CPU) as s:
        for tid in tenants:
            s.register_tenant(tid)

        def submit(tid):
            h = s._enqueue(tid, "gangtest", _gang_job(4, 0.002), None,
                           gang=True)
            h.future.add_done_callback(lambda f, tid=tid: finished(tid, f))

        def finished(tid, fut):
            if fut.cancelled() or fut.exception() is not None:
                return
            with lock:
                done[tid] += 1
            if submitting.is_set():
                submit(tid)

        for tid in tenants:
            submit(tid)
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            with lock:
                if min(done.values()) >= 3:
                    break
            time.sleep(0.01)
        submitting.clear()
        with lock:
            snapshot = dict(done)
    assert min(snapshot.values()) >= 3, snapshot
