"""The port's multi-tenant runtime (spacemesh_tpu_torch/runtime) against the
JAX package, on the CPU, with exact equality.

* packed multi-tenant init: every tenant's store is sha256-equal to the JAX
  ``TenantScheduler``'s and to the JAX solo ``Initializer``'s, with the same
  VRF nonce, at N=16, ragged totals and a resume across packages; sampled
  labels equal ``hashlib.scrypt``;
* quanta: proofs through ``submit_prove`` equal the JAX ``Prover``'s,
  ``submit_verify`` gives the JAX ``verify_many``'s verdicts, and
  ``submit_pow`` the JAX ``ops.pow.search``'s nonce;
* the JAX scheduler tests' twins (fair share, deadlines, quotas, gang
  windows, cancel, unregister, close), run on the port's scheduler;
* a seeded schedule fuzz (random submits, cancels and re-registrations on
  a shortened thread switch interval) in which every handle resolves;
* the engine's ``IDLE`` sentinel and ``tenant`` label;
* the gRPC worker's scheduler route, driven by the JAX node's
  ``GrpcApiServer``.

Every wait has a timeout, so no test can hang the run.
"""

import asyncio
import concurrent.futures
import dataclasses
import hashlib
import random
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spacemesh_tpu.api.rpc import GrpcApiServer
from spacemesh_tpu.ops import pow as jpow
from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.post import initializer as jinit
from spacemesh_tpu.post import verifier as jverifier
from spacemesh_tpu.post import workload as jworkload
from spacemesh_tpu.post.data import PostMetadata as JMeta
from spacemesh_tpu.post.prover import Prover as JProver
from spacemesh_tpu.runtime import TenantScheduler as JScheduler
from spacemesh_tpu.runtime import workloads as jworkloads
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.ops import u32
from spacemesh_tpu_torch.post import initializer as tinit
from spacemesh_tpu_torch.post import verifier as tverifier
from spacemesh_tpu_torch.post import workload as tworkload
from spacemesh_tpu_torch.post.data import LabelStore
from spacemesh_tpu_torch.post.grpc_worker import GrpcWorker
from spacemesh_tpu_torch.post.prover import Prover, ProveSession
from spacemesh_tpu_torch.post.service import PostClient, PostService
from spacemesh_tpu_torch.runtime import TenantScheduler, engine, workloads
from spacemesh_tpu_torch.runtime.scheduler import (QuotaExceeded,
                                                   SchedulerClosed,
                                                   ShardScheduler)
from spacemesh_tpu_torch.utils import metrics, tracing

N = 16           # packed-init N
PACK = 256       # the JAX scheduler's pack width in the packed-init tests
# the port's: a plain-PyTorch pack on the CPU costs about the same at any
# width (eager SHA-256 calls), and labels do not depend on it
TPACK = 1024
# the JAX solo Initializer's batch: with totals in (256, 1024] its label
# batches share one compiled shape (512 lanes), and the JAX scheduler's
# packs another (256), so the JAX side compiles little
JAX_BATCH = 512
T = 60           # seconds any single wait may take
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(count, salt=b""):
    return [(f"t{i}", hashlib.sha256(b"node-%d" % i + salt).digest(),
             hashlib.sha256(b"commit-%d" % i + salt).digest())
            for i in range(count)]


def _geom(node, commit, total, n=N):
    return dict(node_id=node, commitment=commit, num_units=1,
                labels_per_unit=total, scrypt_n=n, max_file_size=1 << 12)


def _digests(d):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.glob("postdata_*.bin"))}


def _vrf(meta):
    return meta.labels_written, meta.vrf_nonce, meta.vrf_nonce_value


def _hashlib_label(commit, i, n=N):
    return hashlib.scrypt(commit, salt=int(i).to_bytes(8, "little"), n=n,
                          r=1, p=1, dklen=16)


def _host_vrf_nonce(label_bytes):
    halves = np.frombuffer(label_bytes, dtype="<u8").reshape(-1, 2)
    return int(np.lexsort((np.arange(halves.shape[0]),
                           halves[:, 0], halves[:, 1]))[0])


def _init_all(sched, base, ids, totals, n=N):
    """Packed init of every tenant; the scheduler starts once all are
    submitted, so the JAX one cuts its packs at the 256-lane bucket alone
    (a pack cut while submits race the packer would compile another)."""
    handles = [sched.submit_init(tid, base / tid, **_geom(node, commit, tot,
                                                          n))
               for (tid, node, commit), tot in zip(ids, totals)]
    sched.start()
    return [h.result(timeout=T) for h in handles]


def _jax_solo(d, node, commit, total):
    jinit.initialize(d, batch_size=JAX_BATCH, mesh=None, meta_interval_s=1e9,
                     **_geom(node, commit, total))


def _same_proof(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.fixture(scope="module")
def prove_store(tmp_path_factory):
    """The shared reduced-parameter prove fixture (N=2, 512 labels), made
    by the port, and the JAX Prover's proof over it."""
    d = tmp_path_factory.mktemp("prove-store")
    tworkload.build(d, 512, 256, **CPU)
    proof = JProver(d, jworkload.PARAMS, batch_labels=256,
                    mesh=None).prove(jworkload.CHALLENGE)
    return d, proof


# --- packed init held to the JAX package --------------------------------------


def test_packed_init_matches_solo_initializer(tmp_path):
    """4 tenants at ragged totals (263, 300, 457, 1000): the port's packed
    path writes stores sha256-equal to the JAX scheduler's and to the JAX
    solo Initializer's, with the same VRF nonce and value."""
    totals = [263, 300, 457, 1000]
    ids = _ids(4)
    with TenantScheduler(workers=1, pack_lanes=TPACK, autostart=False,
                         **CPU) as sched:
        for tid, _, _ in ids:
            sched.register_tenant(tid)
        metas = _init_all(sched, tmp_path / "port", ids, totals)
    with JScheduler(workers=1, pack_lanes=PACK, autostart=False) as jsched:
        for tid, _, _ in ids:
            jsched.register_tenant(tid)
        jmetas = _init_all(jsched, tmp_path / "jax", ids, totals)
    rng = np.random.default_rng(1)
    for (tid, node, commit), total, meta, jmeta in zip(ids, totals, metas,
                                                       jmetas):
        _jax_solo(tmp_path / "solo" / tid, node, commit, total)
        solo = JMeta.load(tmp_path / "solo" / tid)
        port = _digests(tmp_path / "port" / tid)
        assert port == _digests(tmp_path / "jax" / tid)
        assert port == _digests(tmp_path / "solo" / tid)
        assert _vrf(meta) == _vrf(jmeta) == _vrf(solo)
        store = LabelStore(tmp_path / "port" / tid, meta)
        got = store.read_labels(0, total)
        store.close()
        assert meta.vrf_nonce == _host_vrf_nonce(got)
        for i in rng.choice(total, min(total, 4), replace=False):
            assert got[16 * i:16 * i + 16] == _hashlib_label(commit, i)


def test_packed_init_resume(tmp_path):
    """A directory the JAX solo Initializer left half done resumes through
    the port's scheduler and through the JAX one to the same store as a
    from-scratch JAX run: only the rest is computed, and the min-merge is
    idempotent."""
    tid, node, commit = _ids(1, salt=b"resume")[0]
    part = tmp_path / "partial"
    init = jinit.Initializer(
        part, jinit.open_or_create_meta(part, **_geom(node, commit, 1000)),
        batch_size=JAX_BATCH, mesh=None)
    init.progress = lambda done, total: init.stop()
    init.run()
    resumed_at = JMeta.load(part).labels_written
    assert 0 < resumed_at < 1000
    shutil.copytree(part, tmp_path / "port")
    shutil.copytree(part, tmp_path / "jax")
    with TenantScheduler(workers=1, pack_lanes=TPACK, **CPU) as sched:
        sched.register_tenant(tid)
        meta = sched.submit_init(tid, tmp_path / "port",
                                 **_geom(node, commit, 1000)).result(timeout=T)
    with JScheduler(workers=1, pack_lanes=PACK, autostart=False) as jsched:
        jsched.register_tenant("jax")
        [jmeta] = _init_all(jsched, tmp_path, [("jax", node, commit)],
                            [1000])
    _jax_solo(tmp_path / "solo", node, commit, 1000)
    port = _digests(tmp_path / "port")
    assert port == _digests(tmp_path / "jax") == _digests(tmp_path / "solo")
    assert _vrf(meta) == _vrf(jmeta) == _vrf(JMeta.load(tmp_path / "solo"))
    assert meta.intervals[-1][0] == 1000  # the ledger covers the cursor


def test_tiny_and_ragged_tenants_match_the_solo_initializer(tmp_path):
    """Tenants of 1, 7, 65 and 130 labels share packs of 128 lanes: each
    store equals the port's solo Initializer's (itself held to the JAX
    one in tests/test_torch_post.py) and every label hashlib's."""
    totals = [1, 7, 65, 130]
    ids = _ids(4, salt=b"tiny")
    with TenantScheduler(workers=1, pack_lanes=128, autostart=False,
                         **CPU) as sched:
        for tid, _, _ in ids:
            sched.register_tenant(tid)
        metas = _init_all(sched, tmp_path, ids, totals)
    for (tid, node, commit), total, meta in zip(ids, totals, metas):
        solo, _ = tinit.initialize(tmp_path / "solo" / tid, batch_size=256,
                                   meta_interval_s=1e9,
                                   **_geom(node, commit, total), **CPU)
        assert _digests(tmp_path / tid) == _digests(tmp_path / "solo" / tid)
        assert _vrf(meta) == _vrf(solo)
        store = LabelStore(tmp_path / tid, meta)
        got = store.read_labels(0, total)
        store.close()
        assert got == b"".join(_hashlib_label(commit, i)
                               for i in range(total))


def test_packed_labels_match_jax_per_lane_program():
    """``scrypt_labels_packed`` equals the JAX package's per-lane-commitment
    label program."""
    rng = np.random.default_rng(2)
    b = 200  # the JAX program runs at the scheduler tests' 256-lane bucket
    cw = rng.integers(0, 2**32, (8, b), dtype=np.uint32)
    idx = rng.integers(0, 2**40, b, dtype=np.uint64)
    lo, hi = tscrypt.split_indices(idx)
    got = tscrypt.scrypt_labels_packed(u32.from_numpy(cw), u32.from_numpy(lo),
                                       u32.from_numpy(hi), n=N)
    want = jscrypt.scrypt_labels_jit(cw, lo, hi, n=N)
    assert np.array_equal(u32.to_numpy(got), np.asarray(want))
    with pytest.raises(ValueError):
        tscrypt.scrypt_labels_packed(u32.from_numpy(cw[:, 0]),
                                     u32.from_numpy(lo), u32.from_numpy(hi),
                                     n=N)


def test_fold_min_host_matches_jax_and_keeps_first_tie():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (300, 16), dtype=np.uint8)
    raw[200] = raw[17] = 0  # a tie at the minimum: the earlier index wins
    carry = jcarry = None
    for start in range(0, 300, 64):
        chunk = raw[start:start + 64].tobytes()
        carry = workloads.fold_min_host(carry, chunk, start)
        jcarry = jworkloads.fold_min_host(jcarry, chunk, start)
        assert carry == jcarry
    assert carry == (0, 17)
    assert workloads.fold_min_host(carry, b"", 999) == carry
    assert workloads.min_carry_to_meta(carry) \
        == jworkloads.min_carry_to_meta(carry)
    assert workloads.min_carry_to_meta(None) == (None, None)


def test_workload_registry_mirrors_jax_and_warms_on_the_cpu():
    names = [k.name for k in workloads.registered()]
    assert names == [k.name for k in jworkloads.registered()]
    for kind in workloads.registered():
        doc = kind.warm(2, 64, **CPU)
        assert doc and all(isinstance(v, (int, float)) for v in doc.values())
    assert workloads.get("init_pack") is workloads.INIT_PACK
    with pytest.raises(ValueError):
        workloads.register(workloads.INIT)


def test_scheduler_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TenantScheduler()
    with TenantScheduler(autostart=False, **CPU) as sched:
        assert sched.device.type == "cpu"
        assert sched.pack_lanes == 4096  # the JAX default, on the CPU
    with TenantScheduler(pack_lanes=300, autostart=False, **CPU) as sched:
        assert sched.pack_lanes == 300  # as given: ROMix caps by memory


# --- quanta held to the JAX package ---------------------------------------------


def test_quanta_match_jax(prove_store):
    """submit_prove == the JAX Prover's proof, submit_verify == the JAX
    verify_many's verdicts, submit_pow == the JAX ops.pow.search nonce."""
    d, jproof = prove_store
    ch = jworkload.CHALLENGE
    with TenantScheduler(workers=2, **CPU) as sched:
        sched.register_tenant("p")
        proof = sched.submit_prove("p", d, ch, tworkload.PARAMS,
                                   batch_labels=256).result(timeout=T)
        assert _same_proof(proof, jproof)
        bad = dataclasses.replace(proof, indices=list(proof.indices))
        bad.indices[0] = next(i for i in range(512) if i not in proof.indices)
        items = [tverifier.VerifyItem(
            proof=p, challenge=ch, node_id=tworkload.NODE,
            commitment=tworkload.COMMITMENT, scrypt_n=2, total_labels=512)
            for p in (proof, bad)]
        seed = b"sched-seed".ljust(32, b"\0")
        verdicts = sched.submit_verify("p", items, tworkload.PARAMS,
                                       seed=seed).result(timeout=T)
        jitems = [jverifier.VerifyItem(**{
            f.name: getattr(it, f.name) for f in dataclasses.fields(it)})
            for it in items]
        for it in jitems:
            it.proof = type(jproof)(**dataclasses.asdict(it.proof))
        assert verdicts == jverifier.verify_many(jitems, jworkload.PARAMS,
                                                 seed=seed)
        assert verdicts[0] is True
        diff = b"\x00\x8f" + b"\xff" * 30  # a few hundred hashes
        nonce = sched.submit_pow("p", ch, tworkload.NODE, diff).result(
            timeout=T)
        assert nonce == jpow.search(ch, tworkload.NODE, diff)
        sched.unregister_tenant("p")


def test_post_client_submit_proof(prove_store):
    d, jproof = prove_store
    client = PostClient(d, tworkload.PARAMS, batch_labels=256, **CPU)
    with TenantScheduler(workers=1, **CPU) as sched:
        sched.register_tenant("id")
        h = client.submit_proof(sched, "id", jworkload.CHALLENGE)
        assert h.tenant == "id" and h.kind == "prove"
        assert _same_proof(h.result(timeout=T), jproof)


def test_prove_session_parked_is_not_watched(prove_store):
    """A session holds no device state between quanta: it steps as the JAX
    session steps (the k2pow gate, then one window per step) and ends on
    the JAX proof; a scheduler quantum can run it on any worker."""
    d, jproof = prove_store
    port = Prover(d, tworkload.PARAMS, batch_labels=256,
                  **CPU).session(jworkload.CHALLENGE, tenant="x")
    jax = JProver(d, jworkload.PARAMS, batch_labels=256,
                  mesh=None).session(jworkload.CHALLENGE)
    try:
        assert port.tenant == "x"
        steps = 0
        while True:
            got, want = port.step(), jax.step()
            steps += 1
            assert (got is None) == (want is None)
            if got is not None:
                break
        assert steps >= 2 and _same_proof(got, jproof)
        assert port.pow_nonce == jax.pow_nonce
    finally:
        port.close()
        jax.close()


# --- scheduling (the JAX scheduler tests' twins, on the port) -------------------


def test_fair_share_under_starvation_pressure():
    """A tenant flooding 24 jobs cannot starve a 3-job tenant."""
    order = []
    with TenantScheduler(workers=1, autostart=False, **CPU) as sched:
        sched.register_tenant("flood")
        sched.register_tenant("light")
        handles = []
        for i in range(24):
            handles.append(sched.submit_call(
                "flood", lambda i=i: (time.sleep(0.002),
                                      order.append(("flood", i)))[1]))
        for i in range(3):
            handles.append(sched.submit_call(
                "light", lambda i=i: (time.sleep(0.002),
                                      order.append(("light", i)))[1]))
        sched.start()
        for h in handles:
            h.result(timeout=T)
    light_done = [k for k, (t, _) in enumerate(order) if t == "light"]
    assert max(light_done) < 10, order


def test_deadline_job_jumps_fair_share_order():
    order = []
    gate = threading.Event()
    with TenantScheduler(workers=1, autostart=False, **CPU) as sched:
        sched.register_tenant("a")
        sched.register_tenant("b")
        hs = [sched.submit_call("a", lambda: gate.wait(10))]
        hs += [sched.submit_call("a", lambda i=i: order.append(("a", i)))
               for i in range(3)]
        hs.append(sched.submit_call("b", lambda: order.append(("b", 0)),
                                    deadline_s=0.0))
        boosts = sum(metrics.runtime_deadline_boosts.sample().values())
        sched.start()
        gate.set()
        for h in hs:
            h.result(timeout=T)
    assert order[0] == ("b", 0), order
    assert sum(metrics.runtime_deadline_boosts.sample().values()) > boosts


def test_quota_max_queued_rejects():
    with TenantScheduler(workers=1, autostart=False, **CPU) as sched:
        sched.register_tenant("q", max_queued=2)
        gate = threading.Event()
        h1 = sched.submit_call("q", lambda: gate.wait(10))
        h2 = sched.submit_call("q", lambda: None)
        rejected = metrics.runtime_tenant_jobs.sample().get(
            (("kind", "call"), ("state", "rejected"), ("tenant", "q")), 0)
        with pytest.raises(QuotaExceeded):
            sched.submit_call("q", lambda: None)
        assert metrics.runtime_tenant_jobs.sample()[
            (("kind", "call"), ("state", "rejected"), ("tenant", "q"))] \
            == rejected + 1
        sched.start()
        gate.set()
        h1.result(timeout=T)
        h2.result(timeout=T)
        assert sched.submit_call("q", lambda: True).result(timeout=T)


def test_quota_max_inflight_caps_concurrency():
    peak = [0]
    live = [0]
    lock = threading.Lock()

    def job():
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.01)
        with lock:
            live[0] -= 1

    with TenantScheduler(workers=4, autostart=False, **CPU) as sched:
        sched.register_tenant("capped", max_inflight=1)
        hs = [sched.submit_call("capped", job) for _ in range(6)]
        sched.start()
        for h in hs:
            h.result(timeout=T)
    assert peak[0] == 1, f"max_inflight=1 tenant ran {peak[0]} quanta"


def test_gang_windows_serialize_prove_passes(tmp_path, monkeypatch,
                                             prove_store):
    """gang_windows=1: two tenants' prove windows never overlap, even with
    two free workers; both proofs equal the JAX Prover's."""
    d0, jproof = prove_store
    d1 = tmp_path / "store-1"
    shutil.copytree(d0, d1)
    live = [0]
    peak = [0]
    lock = threading.Lock()
    orig = Prover._scan_window

    def traced(self, *a, **kw):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        try:
            time.sleep(0.01)  # widen the window an overlap would need
            return orig(self, *a, **kw)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(Prover, "_scan_window", traced)
    with TenantScheduler(workers=2, gang_windows=1, **CPU) as sched:
        sched.register_tenant("p0")
        sched.register_tenant("p1")
        hs = [sched.submit_prove(f"p{i}", d, jworkload.CHALLENGE,
                                 tworkload.PARAMS, batch_labels=256)
              for i, d in enumerate((d0, d1))]
        proofs = [h.result(timeout=T) for h in hs]
    assert peak[0] == 1, "two prove windows overlapped despite gang=1"
    for proof in proofs:
        assert _same_proof(proof, jproof)


def test_cancel_and_unregister_and_close():
    sched = TenantScheduler(workers=1, autostart=False, **CPU)
    sched.register_tenant("x")
    gate = threading.Event()
    try:
        running = sched.submit_call("x", lambda: gate.wait(10))
        queued = sched.submit_call("x", lambda: None)
        assert queued.cancel()
        assert not queued.cancel()  # already resolved
        sched.start()
        with pytest.raises(concurrent.futures.CancelledError):
            queued.result(timeout=T)
        # unregister fails that tenant's queued jobs and drops its series
        sched.register_tenant("gone")
        orphan = sched.submit_call("gone", lambda: None)
        sched.unregister_tenant("gone")
        with pytest.raises(SchedulerClosed):
            orphan.result(timeout=T)
        assert (("tenant", "gone"),) \
            not in metrics.runtime_tenant_queued.sample()
        assert not [k for k in metrics.runtime_tenant_jobs.sample()
                    if ("tenant", "gone") in k]
        with pytest.raises(KeyError):
            sched.submit_call("gone", lambda: None)
        gate.set()
        assert running.result(timeout=T) is True
        stuck = sched.submit_call("x", lambda: gate.wait(10))
        blocked = sched.submit_call("x", lambda: None)
    finally:
        sched.close()
    sched.close()  # twice is safe
    with pytest.raises(SchedulerClosed):
        blocked.result(timeout=T)
    assert stuck.done()
    with pytest.raises(SchedulerClosed):
        sched.submit_call("x", lambda: None)


def test_unregister_with_lanes_in_flight_resolves_handle(tmp_path):
    """Unregistering a tenant whose init job has packed lanes in flight
    (and more unpacked) still resolves the handle."""
    tid, node, commit = _ids(1, salt=b"strand")[0]
    sched = TenantScheduler(workers=1, pack_lanes=128, autostart=False,
                            **CPU)
    orig = TenantScheduler._retire_pack

    def slow_retire(self, ticket):
        time.sleep(0.05)
        return orig(self, ticket)

    sched._retire_pack = slow_retire.__get__(sched)
    try:
        sched.register_tenant(tid)
        h = sched.submit_init(tid, tmp_path / "strand",
                              **_geom(node, commit, 1000, n=2))
        sched.start()
        job = sched._jobs[h.id]
        for _ in range(400):
            if job.outstanding > 0:
                break
            time.sleep(0.005)
        assert job.outstanding > 0
        sched.unregister_tenant(tid)
        with pytest.raises(SchedulerClosed):
            h.result(timeout=T)
        assert sched.drain(timeout=T)
    finally:
        sched.close()


def test_unregister_during_a_prove_window_resolves_handle(prove_store,
                                                         monkeypatch):
    """Unregistering a tenant while one quantum of its prove job runs
    resolves the handle when the quantum ends, closes the job's session,
    and leaves nothing for drain() to wait on (the JAX scheduler requeues
    the job onto the detached tenant, where nothing picks it again)."""
    d, _ = prove_store
    sessions = []
    entered, go = threading.Event(), threading.Event()
    orig_session, orig_step = Prover.session, ProveSession.step

    def session(self, *a, **kw):
        sessions.append(orig_session(self, *a, **kw))
        return sessions[-1]

    def step(self):
        entered.set()
        assert go.wait(T)
        return orig_step(self)  # the k2pow gate: "continue"

    monkeypatch.setattr(Prover, "session", session)
    monkeypatch.setattr(ProveSession, "step", step)
    with TenantScheduler(workers=1, **CPU) as sched:
        sched.register_tenant("p")
        h = sched.submit_prove("p", d, jworkload.CHALLENGE, tworkload.PARAMS,
                               batch_labels=256)
        assert entered.wait(T)
        sched.unregister_tenant("p")
        go.set()
        with pytest.raises(SchedulerClosed, match="unregistered"):
            h.result(timeout=T)
        assert sched.drain(timeout=T)
        assert len(sessions) == 1 and sessions[0]._closed
        assert not [k for k in metrics.runtime_quantum_seconds.sample()
                    if ("tenant", "p") in k]


def test_cancel_init_and_close_with_init_queued(tmp_path):
    """A cancelled init job and one still queued at close both resolve,
    and neither advances its durable cursor past what was written."""
    ids = _ids(2, salt=b"cancel")
    sched = TenantScheduler(workers=1, pack_lanes=64, autostart=False, **CPU)
    sched.register_tenant("a")
    sched.register_tenant("b")
    ha = sched.submit_init("a", tmp_path / "a", **_geom(*ids[0][1:], 500,
                                                        n=2))
    hb = sched.submit_init("b", tmp_path / "b", **_geom(*ids[1][1:], 500,
                                                        n=2))
    assert ha.cancel()
    with pytest.raises(concurrent.futures.CancelledError):
        ha.result(timeout=T)
    sched.close()
    with pytest.raises(SchedulerClosed):
        hb.result(timeout=T)
    assert not (tmp_path / "a" / "postdata_metadata.json").exists()


def test_multi_tenant_mixed_e2e(tmp_path, prove_store):
    """4 tenants, mixed init + prove + verify + pow through one scheduler:
    every output equals its JAX twin, and the per-tenant metrics advance."""
    d, jproof = prove_store
    ids = _ids(4, salt=b"e2e")
    labels_before = {tid: metrics.runtime_tenant_labels.sample().get(
        (("tenant", tid),), 0) for tid, _, _ in ids}
    with TenantScheduler(workers=2, pack_lanes=TPACK, **CPU) as sched:
        inits = []
        for tid, node, commit in ids:
            sched.register_tenant(tid)
            inits.append(sched.submit_init(tid, tmp_path / tid,
                                           **_geom(node, commit, 300)))
        sched.register_tenant("prover")
        hp = sched.submit_prove("prover", d, jworkload.CHALLENGE,
                                tworkload.PARAMS, batch_labels=256)
        hw = sched.submit_pow("prover", jworkload.CHALLENGE, tworkload.NODE,
                              tworkload.PARAMS.pow_difficulty)
        proof = hp.result(timeout=T)
        assert _same_proof(proof, jproof)
        assert hw.result(timeout=T) == jproof.pow_nonce
        item = tverifier.VerifyItem(
            proof=proof, challenge=jworkload.CHALLENGE, node_id=tworkload.NODE,
            commitment=tworkload.COMMITMENT, scrypt_n=2, total_labels=512)
        hv = sched.submit_verify("prover", [item], tworkload.PARAMS,
                                 seed=b"e2e-seed".ljust(32, b"\0"))
        assert hv.result(timeout=T) == [True]
        for (tid, node, commit), h in zip(ids, inits):
            meta = h.result(timeout=T)
            _jax_solo(tmp_path / "jax" / tid, node, commit, 300)
            assert _digests(tmp_path / tid) == _digests(tmp_path / "jax" / tid)
            assert _vrf(meta) == _vrf(JMeta.load(tmp_path / "jax" / tid))
        assert sched.drain(timeout=T)
    after = metrics.runtime_tenant_labels.sample()
    for tid, _, _ in ids:
        assert after[(("tenant", tid),)] == labels_before[tid] + 300
    quanta = metrics.runtime_quantum_seconds.sample()
    assert {("kind", k) for k in ("prove", "k2pow", "verify")} <= {
        kv for key in quanta if ("tenant", "prover") in key for kv in key}
    assert metrics.runtime_dispatched.sample()[
        (("kind", "prove"), ("tenant", "prover"))] > 0


def test_traced_prove_session_hops_worker_threads(tmp_path, prove_store,
                                                  monkeypatch):
    """The JAX multi-tenant e2e's capture (test_runtime_scheduler.py),
    with the prove job's later quanta forced onto the other worker than
    the one that opened its session: the proof equals the JAX one, the
    session closes its store, every init tenant's ``runtime.segment`` and
    the prover's ``runtime.quantum`` spans are captured, and the
    session's ``prove.run`` span parents its k2pow and windows."""
    d, jproof = prove_store
    sessions, steps = [], []
    opened, first_held, second_held = [], threading.Event(), threading.Event()
    free_first, free_second = threading.Event(), threading.Event()
    orig_session, orig_step = Prover.session, ProveSession.step
    box = {}

    def blocker(held, free):
        def fn():
            held.set()
            assert free.wait(T)
        return fn

    def session(self, *a, **kw):
        sessions.append(orig_session(self, *a, **kw))
        opened.append(threading.get_ident())
        # the other worker takes the first blocker; the second is overdue,
        # so this worker picks it next and the prove job moves over
        box["sched"].submit_call("blk", blocker(first_held, free_first))
        assert first_held.wait(T)
        box["sched"].submit_call("blk", blocker(second_held, free_second),
                                 deadline_s=0)
        return sessions[-1]

    def step(self):
        steps.append(threading.get_ident())
        return orig_step(self)

    monkeypatch.setattr(Prover, "session", session)
    monkeypatch.setattr(ProveSession, "step", step)
    ids = _ids(2, salt=b"hop")
    tracing.start(capacity=1 << 14)
    try:
        with TenantScheduler(workers=2, pack_lanes=TPACK, **CPU) as sched:
            box["sched"] = sched
            sched.register_tenant("blk", max_inflight=2)
            inits = []
            for tid, node, commit in ids:
                sched.register_tenant(tid)
                inits.append(sched.submit_init(tid, tmp_path / tid,
                                               **_geom(node, commit, 300)))
            sched.register_tenant("prover")
            hp = sched.submit_prove("prover", d, jworkload.CHALLENGE,
                                    tworkload.PARAMS, batch_labels=256)
            assert second_held.wait(T)
            free_first.set()
            try:
                proof = hp.result(timeout=T)
            finally:
                free_second.set()
            assert _same_proof(proof, jproof)
            for h in inits:
                h.result(timeout=T)
            assert sched.drain(timeout=T)
    finally:
        tracing.stop()
    assert len(opened) == 1 and len(sessions) == 1
    assert len(steps) >= 2 and opened[0] not in steps
    assert sessions[0]._closed and sessions[0].prover.store._read_fds == {}

    doc = tracing.export()
    assert tracing.validate(doc) == []
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_tenant: dict = {}
    for e in spans:
        if e["args"].get("tenant"):
            by_tenant.setdefault(e["args"]["tenant"], set()).add(e["name"])
    for tid, _, _ in ids:
        assert "runtime.segment" in by_tenant.get(tid, set()), by_tenant
    assert "runtime.quantum" in by_tenant.get("prover", set())
    run = [e for e in spans if e["name"] == "prove.run"]
    assert len(run) == 1 and run[0]["args"]["tenant"] == "prover"
    kids = [e for e in spans if e["name"] in ("prove.k2pow", "prove.window")]
    assert {e["name"] for e in kids} == {"prove.k2pow", "prove.window"}
    assert all(e["args"]["parent"] == run[0]["args"]["id"] for e in kids)
    assert all("parent" not in e["args"] for e in spans
               if e["name"] == "runtime.quantum")


def test_shard_scheduler_namespaces_tenants():
    with TenantScheduler(workers=1, **CPU) as sched:
        view = sched.namespaced("s1")
        assert isinstance(view, ShardScheduler)
        assert view.register_tenant("alice") == "alice"
        assert sched.tenants() == ["s1/alice"] and view.tenants() == ["alice"]
        h = view.submit_call("alice", lambda: 7)
        assert h.tenant == "s1/alice" and h.result(timeout=T) == 7
        assert view.drain(timeout=T)
        view.unregister_tenant("alice")
        assert sched.tenants() == []


@pytest.mark.parametrize("seed", [5, 17, 2024])
def test_schedule_fuzz_every_handle_resolves(seed, tmp_path):
    """A seeded random interleaving of submits, cancels, deadlines, quota
    hits and re-registrations across 3 workers and the packer, on a
    shortened thread switch interval: every handle resolves to its own
    value, a cancellation, a closed error or a quota refusal; no tenant
    keeps a queued job; completed init stores equal hashlib. A failure
    replays from its seed."""
    rng = random.Random(seed)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    calls, inits, refused = [], [], 0
    tenants = [f"z{seed}-{i}" for i in range(4)]
    try:
        sched = TenantScheduler(workers=3, pack_lanes=64, inflight=2,
                                default_max_queued=8, **CPU)
        try:
            for t in tenants:
                sched.register_tenant(t, weight=rng.choice([0.5, 1.0, 2.0]))
            for step in range(80):
                op = rng.random()
                tid = rng.choice(tenants)
                try:
                    if op < 0.55:
                        pause = rng.choice([0.0, 0.001, 0.003])
                        calls.append((step, sched.submit_call(
                            tid, lambda s=step, p=pause: (time.sleep(p), s)[1],
                            deadline_s=rng.choice([None, None, 0.0, 0.01]))))
                    elif op < 0.65:
                        total = rng.randint(1, 150)
                        commit = hashlib.sha256(b"fz%d-%d" % (seed, step)
                                                ).digest()
                        d = tmp_path / f"s{step}"
                        inits.append((commit, total, d, sched.submit_init(
                            tid, d, **_geom(commit, commit, total, n=2))))
                    elif op < 0.85 and calls + inits:
                        rng.choice(calls + inits)[-1].cancel()
                    else:
                        sched.unregister_tenant(tid)
                        sched.register_tenant(tid)
                except QuotaExceeded:
                    refused += 1
                if rng.random() < 0.2:
                    time.sleep(0.002)
            assert sched.drain(timeout=T)
        finally:
            sched.close()
        for step, h in calls:
            assert h.done()
            try:
                assert h.result(timeout=0) == step
            except (concurrent.futures.CancelledError, SchedulerClosed):
                pass
        for commit, total, d, h in inits:
            assert h.done()
            try:
                meta = h.result(timeout=0)
            except (concurrent.futures.CancelledError, SchedulerClosed):
                continue
            assert meta.labels_written == total
            store = LabelStore(d, meta)
            got = store.read_labels(0, total)
            store.close()
            assert got[-16:] == _hashlib_label(commit, total - 1, n=2)
            assert meta.vrf_nonce == _host_vrf_nonce(got)
        queued = metrics.runtime_tenant_queued.sample()
        for t in tenants:
            assert queued.get((("tenant", t),), 0) == 0
    finally:
        sys.setswitchinterval(old)
    assert calls and inits



# --- engine ---------------------------------------------------------------------


def test_pipeline_idle_sentinel_retires_without_dispatch():
    retired = []
    pipe = engine.Pipeline(kind="t", inflight=8)

    def items():
        yield 1
        yield 2
        assert pipe.pending_count == 2
        yield engine.IDLE      # retires 1
        yield engine.IDLE      # retires 2
        assert pipe.pending_count == 0
        yield engine.IDLE      # no-op on an empty window
        yield 3

    pipe.run(items(), dispatch=lambda i: i, retire=retired.append)
    assert retired == [1, 2, 3]


def test_pipeline_tenant_label_on_metrics():
    key = (("kind", "t-label"), ("tenant", "alice"))
    before = metrics.runtime_dispatched.sample().get(key, 0)
    retired = metrics.runtime_retired.sample().get(key, 0)
    pipe = engine.Pipeline(kind="t-label", tenant="alice", inflight=1)
    pipe.run(range(3), lambda i: i, lambda t: None)
    assert metrics.runtime_dispatched.sample()[key] == before + 3
    assert metrics.runtime_retired.sample()[key] == retired + 3
    assert metrics.runtime_inflight.sample()[(("kind", "t-label"),)] == 0


def test_runtime_metrics_expose_like_jax():
    """The runtime family's names, help, types and buckets, and the
    histogram exposition, are the JAX package's."""
    for name in ("runtime_dispatched", "runtime_retired", "runtime_inflight",
                 "runtime_stage_seconds", "runtime_tenant_jobs",
                 "runtime_tenant_labels", "runtime_tenant_queued",
                 "runtime_quantum_seconds", "runtime_deadline_boosts",
                 "runtime_pack_occupancy", "runtime_pack_tenants"):
        ours, theirs = getattr(metrics, name), getattr(jmetrics, name)
        assert (type(ours).__name__, ours.name, ours.help) \
            == (type(theirs).__name__, theirs.name, theirs.help)
        assert getattr(ours, "buckets", None) == getattr(theirs, "buckets",
                                                         None)
    ours = metrics.Histogram("h_test", "help", buckets=(1, 4, float("inf")))
    theirs = jmetrics.Histogram("h_test", "help",
                                buckets=(1, 4, float("inf")))
    for v, lbl in ((0.5, "a"), (3, "a"), (9, 'q"b')):
        ours.observe(v, tenant=lbl)
        theirs.observe(v, tenant=lbl)
    assert ours.expose() == theirs.expose()
    assert ours.sample() == theirs.sample()
    assert ours.remove_matching(tenant="a") == 1
    assert list(ours.sample()) == [(("tenant", 'q"b'),)]
    reg = metrics.Registry()
    assert reg.histogram("x", buckets=(1, 2)) is reg.histogram("x")
    with pytest.raises(ValueError):
        reg.histogram("x", buckets=(1, 3))


# --- the gRPC worker's scheduler route ------------------------------------------


def test_grpc_worker_scheduler_route_against_the_jax_node(prove_store):
    d, jproof = prove_store
    svc = PostService()
    svc.register(tworkload.NODE, PostClient(d, tworkload.PARAMS,
                                            batch_labels=256, **CPU))
    tenant = tworkload.NODE.hex()[:16]

    async def go(sched):
        server = GrpcApiServer(app=None, listen="127.0.0.1:0",
                               post_query_interval=0.05)
        port = await server.start()
        worker = GrpcWorker(svc, f"127.0.0.1:{port}", reconnect_backoff=0.2,
                            scheduler=sched)
        await worker.start()
        try:
            assert sched.tenants() == [tenant]
            await worker.wait_connected(timeout=10)
            await server.post_service.wait_registered([tworkload.NODE],
                                                      timeout=10)
            client = server.post_service.client(tworkload.NODE)
            proof, _ = await asyncio.wait_for(
                asyncio.to_thread(client.proof, jworkload.CHALLENGE), T)
            return proof
        finally:
            await worker.stop()
            await server.stop()

    with TenantScheduler(workers=1, **CPU) as sched:
        seen = []
        orig = sched.submit_prove
        sched.submit_prove = lambda *a, **kw: seen.append(a[0]) or orig(
            *a, **kw)
        proof = asyncio.run(go(sched))
        assert seen == [tenant]
        assert sched.tenants() == []  # unregistered on stop
    assert _same_proof(proof, jproof)
    # the gone identity's series left the registry
    assert (("tenant", tenant),) not in metrics.post_prove_inflight.sample()
    assert not [k for k in metrics.runtime_tenant_jobs.sample()
                if ("tenant", tenant) in k]
