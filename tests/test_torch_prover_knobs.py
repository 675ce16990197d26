"""The port prover's knobs against the JAX package, on the CPU.

The proof must not depend on how the search is cut: at ``window_groups``
1, 2 and 4 (one scan launch of 16 x G nonces per batch), at 1 and 3
readers and batches in flight, and on the serial path, the port's proof
equals the JAX ``Prover``'s at ``window_groups`` 1 and 4 on the same
store. The parameters put the winning nonce in the third group (46), so
the windows cut the search differently, and the prove batch leaves a
ragged tail.

Then the twins of ``tests/test_prove_pipeline.py`` that no other port
test holds: one disk pass per nonce window, an early exit that reads
less than the store, a device-to-host copy of compacted hits rather
than masks, the scan step's hit state across batches, the
``LabelReader`` pool's contract (plan order, bounded read-ahead, error
propagation, close mid-plan, cached and thread-safe read fds) and
``PostClient``'s prove options. Each runs the same inputs through the
JAX package and the port: the proofs, the bytes read, the pass
accounting and the hit state are equal, and the port keeps the
invariant the JAX test asserts.
"""

import dataclasses
import hashlib
import threading
import time

import numpy as np
import pytest
import torch

from spacemesh_tpu.ops import proving as jproving
from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.post import data as jdata
from spacemesh_tpu.post.prover import ProofParams as JParams
from spacemesh_tpu.post.prover import Prover as JProver
from spacemesh_tpu.post.service import PostClient as JPostClient
from spacemesh_tpu.utils import metrics as jmetrics
from spacemesh_tpu_torch import convert
from spacemesh_tpu_torch.ops import proving as tproving
from spacemesh_tpu_torch.ops import u32
from spacemesh_tpu_torch.post import data as tdata
from spacemesh_tpu_torch.post import initializer as tinit
from spacemesh_tpu_torch.post import prover as tprover
from spacemesh_tpu_torch.post.service import PostClient
from spacemesh_tpu_torch.utils import metrics as tmetrics

NODE = hashlib.sha256(b"knobs-node").digest()
COMMIT = hashlib.sha256(b"knobs-commit").digest()
CHALLENGE = hashlib.sha256(b"knobs-challenge").digest()
TOTAL = 2048
BATCH = 768  # 768, 768, 512: a ragged last batch
PARAMS = dict(k1=8, k2=16, k3=4, pow_difficulty=b"\xff" * 32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("knobs")
    tinit.initialize(d, node_id=NODE, commitment=COMMIT, num_units=1,
                     labels_per_unit=TOTAL, scrypt_n=2, batch_size=TOTAL,
                     device="cpu")
    return d


@pytest.fixture(scope="module")
def jax_proofs(store):
    """The JAX prover's proof at window_groups 1 and 4; they agree."""
    proofs = [dataclasses.asdict(
        JProver(store, JParams(**PARAMS), batch_labels=BATCH, mesh=None,
                window_groups=g).prove(CHALLENGE)) for g in (1, 4)]
    assert proofs[0] == proofs[1]
    assert proofs[0]["nonce"] // 16 == 2  # the third group
    return proofs[0]


@pytest.fixture
def scan_steps(monkeypatch):
    """The n_nonces of every prove scan step the port launches."""
    calls = []
    real = tprover.proving.prove_scan_step

    def step(*args, n_nonces, max_hits):
        calls.append(n_nonces)
        return real(*args, n_nonces=n_nonces, max_hits=max_hits)

    monkeypatch.setattr(tprover.proving, "prove_scan_step", step)
    return calls


@pytest.mark.parametrize("pool", [1, 3], ids=lambda n: f"readers-inflight-{n}")
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_proof_equals_jax_at_every_window_and_pool(store, jax_proofs,
                                                   scan_steps, groups, pool):
    pv = tprover.Prover(store, tprover.ProofParams(**PARAMS),
                        batch_labels=BATCH, window_groups=groups,
                        readers=pool, inflight=pool, device="cpu")
    assert (pv.window_groups, pv.readers, pv.inflight) == (groups, pool, pool)
    proof = pv.prove(CHALLENGE)
    assert dataclasses.asdict(proof) == jax_proofs
    stats = pv.last_stats
    # one scan launch of 16 x G nonces per batch; the winner's group 2
    # falls in window 2 // G
    assert scan_steps == [16 * groups] * stats.batches
    assert stats.windows == 2 // groups + 1
    assert stats.batches <= stats.windows * -(-TOTAL // BATCH)


def test_serial_path_and_environment_overrides(store, jax_proofs,
                                               monkeypatch):
    params = tprover.ProofParams(**PARAMS)
    serial = tprover.Prover(store, params, batch_labels=BATCH,
                            pipelined=False, device="cpu")
    assert not serial.pipelined
    assert dataclasses.asdict(serial.prove(CHALLENGE)) == jax_proofs
    for name, value in (("PIPELINE", "0"), ("WINDOW_GROUPS", "4"),
                        ("INFLIGHT", "2"), ("READERS", "3"),
                        ("QUEUE", "5")):
        monkeypatch.setenv(f"SPACEMESH_PROVE_{name}", value)
    pv = tprover.Prover(store, params, batch_labels=BATCH, device="cpu")
    assert (pv.pipelined, pv.window_groups, pv.inflight, pv.readers,
            pv.reader_queue) == (False, 4, 2, 3, 5)
    # an argument beats the environment
    pv = tprover.Prover(store, params, batch_labels=BATCH, pipelined=True,
                        window_groups=2, device="cpu")
    assert (pv.pipelined, pv.window_groups) == (True, 2)
    assert dataclasses.asdict(pv.prove(CHALLENGE)) == jax_proofs


def test_defaults_are_one_group_three_inflight_two_readers(store,
                                                           monkeypatch):
    for name in ("PIPELINE", "WINDOW_GROUPS", "INFLIGHT", "READERS",
                 "QUEUE"):
        monkeypatch.delenv(f"SPACEMESH_PROVE_{name}", raising=False)
    pv = tprover.Prover(store, device="cpu")
    assert (pv.pipelined, pv.window_groups, pv.inflight, pv.readers,
            pv.reader_queue) == (True, 1, 3, 2, 4)


def test_last_window_is_clamped_to_the_search_bound(store, monkeypatch):
    """A window never scans past MAX_GROUPS: with the bound at 3 groups
    and windows of 2, the second window scans one group and still finds
    the winner in group 2; with the bound at 2 groups, the search gives
    up as the serial one does."""
    params = tprover.ProofParams(**PARAMS)
    monkeypatch.setattr(tprover, "MAX_GROUPS", 3)
    pv = tprover.Prover(store, params, batch_labels=BATCH, window_groups=2,
                        device="cpu")
    assert pv.prove(CHALLENGE).nonce // 16 == 2
    monkeypatch.setattr(tprover, "MAX_GROUPS", 2)
    for pipelined in (True, False):
        pv = tprover.Prover(store, params, batch_labels=BATCH,
                            window_groups=4, pipelined=pipelined,
                            device="cpu")
        with pytest.raises(RuntimeError, match="no winning nonce"):
            pv.prove(CHALLENGE)


# --- twins of tests/test_prove_pipeline.py ----------------------------------

LABEL_BYTES = 16
# k1=64 >> k2=16: nonce 0 qualifies after a fraction of the store
EARLY = dict(k1=64, k2=16, k3=8, pow_difficulty=b"\xff" * 32)
PASS_FIELDS = ("windows", "batches", "labels_swept", "d2h_bytes",
               "early_exited")


def _read_bytes(mod) -> float:
    return mod.post_store_read_bytes._values.get((), 0.0)


def _both_provers(store, params, **knobs):
    """One prove by each package with the same knobs: the port's prover,
    then (proof, bytes read, pass accounting) of the port and of the JAX
    package."""
    out = []
    for prover, params_cls, mets, extra in (
            (tprover.Prover, tprover.ProofParams, tmetrics,
             dict(device="cpu")),
            (JProver, JParams, jmetrics, dict(mesh=None))):
        before = _read_bytes(mets)
        pv = prover(store, params_cls(**params), **knobs, **extra)
        proof = dataclasses.asdict(pv.prove(CHALLENGE))
        stats = {f: getattr(pv.last_stats, f) for f in PASS_FIELDS}
        out.append((pv, (proof, _read_bytes(mets) - before, stats)))
    return out[0][0], out[0][1], out[1][1]


def test_one_disk_pass_per_window(store):
    pv, port, jax = _both_provers(store, PARAMS, batch_labels=512)
    assert port == jax
    _, read, stats = port
    # at most one store read per scanned nonce window (the reader may run
    # past an early exit by at most its queue depth)
    slack = pv.reader_queue * pv.batch_labels * LABEL_BYTES
    assert stats["windows"] == 3  # the winner's group 2, one group each
    assert read <= stats["windows"] * TOTAL * LABEL_BYTES + slack


def test_early_exit_reads_less_than_store(store):
    _, port, jax = _both_provers(store, EARLY, batch_labels=256, inflight=1,
                                 reader_queue=1)
    assert port == jax
    proof, read, stats = port
    assert stats["early_exited"] and proof["nonce"] == 0
    assert read < TOTAL * LABEL_BYTES


@pytest.mark.parametrize("groups", [1, 2])
def test_d2h_is_compacted_hits_not_masks(store, groups):
    pv, port, jax = _both_provers(store, PARAMS, batch_labels=512,
                                  window_groups=groups)
    d2h, jax_d2h = port[2].pop("d2h_bytes"), jax[2].pop("d2h_bytes")
    assert port == jax
    # the port scans a window's G groups in one launch with one hit state
    # and fetches that whole state for the winner; the JAX package keeps a
    # state per group and fetches the winner's only. The per-batch count
    # vectors are the same bytes.
    group_state = (2 * tprover.NONCE_GROUP * PARAMS["k2"]
                   + tprover.NONCE_GROUP) * 4
    assert d2h - jax_d2h == (groups - 1) * group_state
    # full masks would be (nonces per window) x batch bytes per batch;
    # the compacted path moves one count vector per batch plus one hit
    # carry per pass
    nonces = tprover.NONCE_GROUP * pv.window_groups
    mask_bytes = port[2]["batches"] * nonces * pv.batch_labels
    assert 0 < d2h < mask_bytes / 8


def test_prove_step_accumulates_across_batches():
    import jax.numpy as jnp

    total, b, ng, cap = 1024, 512, 4, 8
    labels = jscrypt.scrypt_labels(COMMIT, np.arange(total, dtype=np.uint64),
                                   n=2)
    t = jproving.threshold_u32(24, total)
    cw = jproving.challenge_words(CHALLENGE)
    jc, jcarry = jproving.init_hit_state(ng, cap)
    tc, tcarry = tproving.init_hit_state(ng, cap)
    for start in range(0, total, b):
        lo, hi = jscrypt.split_indices(
            np.arange(start, start + b, dtype=np.uint64))
        lw = jscrypt.labels_to_words(labels[start:start + b])
        jc, _, jcarry = jproving.prove_scan_step_jit(
            jnp.asarray(cw), jnp.uint32(0), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(lw), jnp.uint32(t), jc, jcarry, jnp.uint32(b),
            jnp.uint32(start), jnp.uint32(0), n_nonces=ng, max_hits=cap)
        tc, _, tcarry = tproving.prove_scan_step(
            cw, 0, u32.from_numpy(lo), u32.from_numpy(hi),
            u32.from_numpy(lw), t, tc, tcarry, b, start, 0, n_nonces=ng,
            max_hits=cap)
        got = convert.hit_state_from_torch(tc, tcarry)
        assert np.array_equal(got[0], np.asarray(jc))
        assert np.array_equal(got[1], np.asarray(jcarry))
    idx = np.arange(total, dtype=np.uint64)
    for k in range(ng):
        vals = tproving.proving_hashes(CHALLENGE, k, idx, labels,
                                       device="cpu")
        want = np.nonzero(vals < t)[0]
        assert int(tc[k]) == len(want)
        assert tproving.decode_hits(tc, tcarry, k, cap) \
            == jproving.decode_hits(jc, jcarry, k, cap) \
            == [int(i) for i in want[:cap]]


# the LabelReader pool, over a store of each package holding the same bytes


def _tiny_stores(tmp_path, labels=512):
    data = bytes(range(256)) * (labels * LABEL_BYTES // 256)
    out = {}
    for name, mod in (("port", tdata), ("jax", jdata)):
        meta = mod.PostMetadata(
            node_id=NODE.hex(), commitment=COMMIT.hex(), scrypt_n=2,
            num_units=1, labels_per_unit=labels, max_file_size=1 << 20,
            labels_written=labels)
        st = mod.LabelStore(tmp_path / name, meta)
        st.write_labels(0, data)
        out[name] = st
    return out, data


def test_reader_delivers_in_plan_order(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    ranges = [(i * 64, 64) for i in range(8)]
    got = {}
    for name, st in stores.items():
        reader = st.start_reader(ranges, threads=3, depth=2)
        try:
            got[name] = [reader.get() for _ in ranges]
        finally:
            reader.close()
        assert reader.bytes_read == len(data)
        with pytest.raises(IndexError):
            reader.get()  # the plan is exhausted
        st.close()
    assert got["port"] == got["jax"] == [
        data[s * LABEL_BYTES:(s + c) * LABEL_BYTES] for s, c in ranges]


def test_reader_bounded_readahead(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    ranges = [(i * 32, 32) for i in range(16)]
    for name, st in stores.items():
        reader = st.start_reader(ranges, threads=2, depth=3)
        try:
            time.sleep(0.2)  # let the pool run ahead as far as allowed
            with reader._cond:
                buffered = len(reader._results)
            assert 0 < buffered <= 3, name
            assert b"".join(reader.get() for _ in ranges) == data
        finally:
            reader.close()
        st.close()


def test_reader_error_propagates(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    ranges = [(0, 32), (100000, 32)]  # the second range is past EOF
    for name, st in stores.items():
        reader = st.start_reader(ranges, threads=1, depth=2)
        try:
            time.sleep(0.3)  # the pool buffers slot 0 AND fails slot 1
            # a result buffered before the failure still delivers; the
            # error surfaces on the range that is actually missing
            assert reader.get() == data[:32 * LABEL_BYTES]
            with pytest.raises(RuntimeError, match="label reader failed"):
                reader.get()
        finally:
            reader.close()
        st.close()


def test_reader_close_mid_plan(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    ranges = [(i * 16, 16) for i in range(32)]
    for name, st in stores.items():
        reader = st.start_reader(ranges, threads=2, depth=2)
        assert reader.get() == data[:16 * LABEL_BYTES]
        reader.close()  # an early exit: pending reads dropped, no hang
        assert all(not t.is_alive() for t in reader._threads), name
        assert reader.bytes_read < len(data)
        st.close()


def test_read_fds_cached(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    for name, st in stores.items():
        for _ in range(5):
            assert st.read_labels(10, 4) == data[10 * 16:14 * 16]
        assert len(st._read_fds) == 1, name
        st.close()
        assert not st._read_fds
        assert st.read_labels(0, 2) == data[:32]  # reads reopen
        st.close()


def test_read_fds_thread_safe(tmp_path):
    stores, data = _tiny_stores(tmp_path)
    for name, st in stores.items():
        errs = []

        def hammer():
            try:
                for i in range(50):
                    assert st.read_labels(i % 32, 8) \
                        == data[(i % 32) * 16:((i % 32) + 8) * 16]
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, name
        assert len(st._read_fds) == 1
        st.close()


def test_post_client_prove_opts(store, jax_proofs):
    client = PostClient(store, tprover.ProofParams(**PARAMS),
                        batch_labels=512, pipelined=False, device="cpu")
    proof, meta = client.proof(CHALLENGE)
    assert meta.total_labels == TOTAL
    jproof, jmeta = JPostClient(store, JParams(**PARAMS), batch_labels=512,
                                pipelined=False).proof(CHALLENGE)
    assert dataclasses.asdict(proof) == dataclasses.asdict(jproof) \
        == jax_proofs
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
