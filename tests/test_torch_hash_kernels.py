"""The proving hash and k2pow wrappers of the port (ops/proving_cuda.py,
ops/pow_cuda.py) against the JAX package and hashlib on the CPU, with exact
equality; the verifier's on-device label words; and the routing that keeps
the plain twins off the card's paths.

On the CPU each wrapper runs its plain twin; the kernels themselves are
held against those twins on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import hashlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacemesh_tpu.ops import pow as jpow
from spacemesh_tpu.ops import proving as jproving
from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.post import verifier as jverifier
from spacemesh_tpu.post import workload as jworkload
from spacemesh_tpu_torch.ops import pow as tpow
from spacemesh_tpu_torch.ops import pbkdf2_cuda, pow_cuda, proving_cuda
from spacemesh_tpu_torch.ops import romix_cuda
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.ops import u32
from spacemesh_tpu_torch.post import prover as tprover
from spacemesh_tpu_torch.post import verifier as tverifier
from spacemesh_tpu_torch.post import workload as tworkload

T = u32.from_numpy
N_ = u32.to_numpy
CH = hashlib.sha256(b"torch-hash-kernels-ch").digest()
NODE = hashlib.sha256(b"torch-hash-kernels-node").digest()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_ops.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


# --- proving hash ----------------------------------------------------------


@pytest.mark.parametrize("per_lane_challenge", [False, True])
@pytest.mark.parametrize("per_lane_nonce", [False, True])
def test_proving_hash_wrapper_matches_jax(per_lane_challenge,
                                          per_lane_nonce):
    b = 37
    seed = 10 * per_lane_challenge + per_lane_nonce
    ch = _rand_u32((8, b) if per_lane_challenge else (8,), seed)
    nonce = (_rand_u32(b, seed + 1) if per_lane_nonce
             else int(_rand_u32(1, seed + 1)[0]))
    lo, hi = _rand_u32(b, seed + 2), _rand_u32(b, seed + 3)
    lo[:3] = [0, 2**31, 2**32 - 1]
    le = _rand_u32((4, b), seed + 4)
    want = np.asarray(_jax_hash(ch, nonce, lo, hi, le))
    tn = T(nonce) if per_lane_nonce else nonce
    got = proving_cuda.proving_hash(T(ch), tn, T(lo), T(hi), T(le))
    assert np.array_equal(N_(got), want)
    # the same labels handed over big-endian, as finish leaves them
    be = le.byteswap()
    got = proving_cuda.proving_hash(T(ch), tn, T(lo), T(hi), T(be),
                                    big_endian=True)
    assert np.array_equal(N_(got), want)
    assert np.array_equal(N_(proving_cuda.proving_hash_plain(
        T(ch), tn, T(lo), T(hi), T(be), big_endian=True)), want)


def _jax_hash(ch, nonce, lo, hi, le):
    return jproving.proving_hash_jit(
        jnp.asarray(ch), jnp.asarray(nonce, dtype=jnp.uint32),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(le))


def test_proving_hash_wrapper_rejects_other_devices():
    b = 4
    args = [T(a).to("meta") for a in (_rand_u32(8, 1), _rand_u32(b, 2),
                                      _rand_u32(b, 3), _rand_u32((4, b), 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        proving_cuda.proving_hash(args[0], 3, *args[1:])


# --- k2pow -----------------------------------------------------------------


@pytest.mark.parametrize("base", [0, 2**32 - 200])
def test_k2pow_search_mask_matches_jax_and_hashlib(base):
    diff = bytes([9]) + bytes([255]) * 31
    count = 512
    pre = tpow.prefix_state(CH, NODE)
    tgt = np.frombuffer(diff, dtype=">u4").astype(np.uint32)
    got = pow_cuda.search_batch(pre, tgt, base, count, "cpu")
    nonces = np.arange(base, base + count, dtype=np.uint64)
    lo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (nonces >> np.uint64(32)).astype(np.uint32)
    jmask = jpow.below_target_jit(
        jpow.pow_hash_batch_jit(jnp.asarray(jpow.prefix_state(CH, NODE)),
                                jnp.asarray(lo), jnp.asarray(hi)),
        jnp.asarray(tgt))
    truth = [hashlib.sha256(CH + NODE + int(n).to_bytes(8, "little"))
             .digest() < diff for n in nonces]
    assert got.dtype == torch.bool and got.shape == (count,)
    assert got.tolist() == np.asarray(jmask).tolist() == truth
    assert 0 < sum(truth) < count
    assert tpow.search(CH, NODE, diff, batch=64, start=base,
                       device="cpu") == base + truth.index(True)


def _witnesses(b, seed):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(b):
        c, n = (bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                for _ in range(2))
        nonce = int(rng.integers(0, 2**64, dtype=np.uint64))
        d = bytes([int(rng.integers(0, 256))]) + bytes([255]) * 31
        if i % 5 == 0:  # equal to the target: not below it
            d = tpow.pow_hash(c, n, nonce)
        if i % 5 == 1:
            nonce = 2**32 + i
        items.append((c, n, d, nonce))
    return items


def test_k2pow_verify_mask_matches_jax_and_hashlib():
    items = _witnesses(40, 3)
    block1 = np.stack([np.frombuffer(c + n, dtype=">u4").astype(np.uint32)
                       for c, n, _, _ in items], axis=1)
    targets = np.stack([np.frombuffer(d, dtype=">u4").astype(np.uint32)
                        for _, _, d, _ in items], axis=1)
    nonces = np.array([x[3] for x in items], dtype=np.uint64)
    lo, hi = pow_cuda.split_nonces(nonces, "cpu")
    got = tpow.pow_verify_batch(T(block1), lo, hi, T(targets))
    want = jpow.pow_verify_batch_jit(
        jnp.asarray(block1), jnp.asarray(N_(lo)), jnp.asarray(N_(hi)),
        jnp.asarray(targets))
    truth = [tpow.pow_hash(c, n, x) < d for c, n, d, x in items]
    assert got.tolist() == np.asarray(want).tolist() == truth
    assert 0 < sum(truth) < len(items)
    assert torch.equal(pow_cuda.verify_batch(T(block1), lo, hi, T(targets)),
                       got)


def test_k2pow_wrappers_reject_other_devices():
    pre = tpow.prefix_state(CH, NODE)
    with pytest.raises(ValueError, match="unsupported device"):
        pow_cuda.search_batch(pre, pre, 0, 8, "meta")
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pow_cuda.verify_batch(torch.zeros((16, 4), dtype=torch.int32,
                                          device="meta"), z, z,
                              torch.zeros((8, 4), dtype=torch.int32,
                                          device="meta"))


# --- the k2pow search window -------------------------------------------------

DEFAULT_DIFF = bytes([0, 255]) + bytes([255]) * 30   # the prover's default
BLOCK1 = np.frombuffer(CH + NODE, dtype=">u4").astype(np.uint32)


def _first_hit(diff, start, limit=1 << 16):
    """The smallest nonce >= start below ``diff``, by hashlib."""
    return next(n for n in range(start, start + limit)
                if tpow.pow_hash(CH, NODE, n) < diff)


def _window(diff, start, count, cell):
    pow_cuda.search_window(BLOCK1, np.frombuffer(diff, dtype=">u4")
                           .astype(np.uint32), start, count, cell, "cpu")
    return pow_cuda.cell_value(cell)


@pytest.mark.parametrize("diff", [DEFAULT_DIFF, bytes([8]) + bytes([255]) * 31,
                                  bytes([255]) * 32])
def test_search_window_plain_folds_the_smallest_hit(diff):
    """One window, then the next window of the same search sharing the
    cell: the smallest hit, as hashlib has it; a fresh cell holds
    NO_WINNER; a window behind the winner leaves the cell as it is."""
    cell = pow_cuda.new_cell("cpu")
    assert pow_cuda.cell_value(cell) == pow_cuda.NO_WINNER
    want = _first_hit(diff, 0)
    assert _window(diff, 0, 4096, cell) == want
    assert _window(diff, 4096, 4096, cell) == want
    # the JAX package's serial search agrees
    assert jpow.search(CH, NODE, diff, batch=64) == want


def test_search_window_with_a_zero_target_finds_nothing():
    cell = pow_cuda.new_cell("cpu")
    assert _window(bytes(32), 2**32 - 100, 300, cell) == pow_cuda.NO_WINNER


def test_search_window_behind_a_winner_hashes_nothing(monkeypatch):
    """The speculative window launched behind a window that hit: it reads
    the cell and stops, block 1 included."""
    cell = pow_cuda.new_cell("cpu")
    want = _window(DEFAULT_DIFF, 0, 4096, cell)

    def boom(*args, **kwargs):
        raise AssertionError("hashed behind a winner")

    monkeypatch.setattr(pow_cuda, "sha256_compress", boom)
    assert _window(DEFAULT_DIFF, 4096, 4096, cell) == want


def test_search_window_rejects_bad_cells_and_ranges():
    tgt = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
    with pytest.raises(ValueError, match="cell"):
        pow_cuda.search_window(BLOCK1, tgt, 0, 8, torch.zeros(2, dtype=torch
                                                              .int64), "cpu")
    with pytest.raises(ValueError, match="unsigned 64-bit"):
        pow_cuda.search_window(BLOCK1, tgt, 2**64 - 4, 8,
                               pow_cuda.new_cell("cpu"), "cpu")
    with pytest.raises(ValueError, match="16 u32 words"):
        pow_cuda.search_window(BLOCK1[:8], tgt, 0, 8, pow_cuda.new_cell("cpu"),
                               "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        pow_cuda.search_window(BLOCK1, tgt, 0, 8, pow_cuda.new_cell("cpu"),
                               "meta")


def _search_cases():
    """(name, difficulty, start): a winner at nonce 0, at the last nonce
    of a window and at the first of the next (windows of 128 nonces), and
    past the 2^32 carry."""
    d8 = bytes([8]) + bytes([255]) * 31
    h = _first_hit(d8, 1000)
    carry = next(s for s in range(2**32 - 64, 2**32 - 8)
                 if _first_hit(d8, s) >= 2**32)
    return [("winner at nonce 0", bytes([255]) * 32, 0),
            ("default difficulty", DEFAULT_DIFF, 0),
            ("last nonce of a window", d8, h - 127),
            ("first nonce of the next window", d8, h - 128),
            ("across the 2^32 carry", d8, carry)]


@pytest.mark.parametrize("case", range(5))
def test_search_over_windows_equals_jax_and_hashlib(case, monkeypatch):
    """``ops.pow.search`` on the CPU, windows of two batches of 64, held to
    the JAX package's search and to hashlib; the window that follows the
    winner's is dispatched too (inflight 2) and changes nothing."""
    name, diff, start = _search_cases()[case]
    monkeypatch.setattr(tpow, "WINDOW_NONCES", 128)
    launches = []
    real = pow_cuda.search_window
    monkeypatch.setattr(pow_cuda, "search_window",
                        lambda *a, **k: launches.append(a[2]) or real(*a, **k))
    got = tpow.search(CH, NODE, diff, batch=64, start=start, device="cpu")
    assert got == jpow.search(CH, NODE, diff, batch=64, start=start) \
        == _first_hit(diff, start), name
    assert tpow.verify(CH, NODE, diff, got)
    first = (got - start) // 128 * 128 + start  # the winner's window
    assert launches[-2:] == [first, first + 128], name


def test_search_exhausted_returns_none_like_jax():
    got = tpow.search(CH, NODE, bytes(32), batch=64, start=5, max_batches=3,
                      device="cpu")
    assert got is None
    assert jpow.search(CH, NODE, bytes(32), batch=64, start=5,
                       max_batches=3) is None


def test_search_on_the_card_compresses_nothing_on_the_host(monkeypatch):
    """``ops.pow.search(device="cuda")`` hands block 1 to the window kernel:
    with every ``sha256_compress`` of the port made to raise and a stub
    standing in for the window launch (hashlib in place of the kernel, a
    host cell in place of the device one), the search still answers, in
    one window and the speculative one behind it."""
    import sys

    def boom(*args, **kwargs):
        raise AssertionError("host SHA-256 compression on the card's path")

    for key, mod in list(sys.modules.items()):
        if key.startswith("spacemesh_tpu_torch") and hasattr(
                mod, "sha256_compress"):
            monkeypatch.setattr(mod, "sha256_compress", boom)
    launches = []

    def stub(block1, target, start, count, found, device, **kwargs):
        assert torch.device(device).type == "cuda"
        launches.append(start)
        prefix = np.asarray(block1, dtype=">u4").tobytes()
        diff = np.asarray(target, dtype=">u4").tobytes()
        best = pow_cuda.cell_value(found)
        for nonce in range(start, min(start + count, best)):
            if hashlib.sha256(prefix + nonce.to_bytes(8, "little")
                              ).digest() < diff:
                found.fill_(nonce)
                break

    monkeypatch.setattr(pow_cuda, "search_window", stub)
    monkeypatch.setattr(pow_cuda, "new_cell",
                        lambda device: torch.full((1,), -1,
                                                  dtype=torch.int64))
    monkeypatch.setattr(tpow, "resolve", torch.device)
    got = tpow.search(CH, NODE, DEFAULT_DIFF, device="cuda")
    assert got == _first_hit(DEFAULT_DIFF, 0)
    assert launches == [0, tpow.WINDOW_NONCES]
    with pytest.raises(AssertionError, match="host SHA-256"):
        tpow.prefix_state(CH, NODE)


# --- the verifier's label words --------------------------------------------


def test_verifier_label_words_are_big_endian_and_hash_like_jax():
    """The verifier hands finish's (4, B) BE words straight to the hash
    with big_endian=True: the words are the labels' bytes in big-endian
    groups, their byteswap is labels_to_words(labels) (the JAX package's
    LE layout), and the hash equals proving_hash_jit on the JAX labels."""
    b, n = 9, 4
    rng = np.random.default_rng(8)
    commits = rng.integers(0, 256, (b, 32), dtype=np.uint8)
    idx = rng.integers(0, 2**64, b, dtype=np.uint64)
    idx[:2] = [2**32 - 1, 2**32]
    lo, hi = tscrypt.split_indices(idx)
    cw = np.stack([tscrypt.commitment_to_words(bytes(c))
                   for c in commits]).T
    words = tscrypt.scrypt_labels_words(T(cw), T(lo), T(hi), n=n)
    jlabels = np.asarray(jscrypt.scrypt_labels_multi(commits, idx, n=n))
    assert tscrypt.labels_to_bytes(words) == jlabels.tobytes()
    le = jscrypt.labels_to_words(jlabels)
    assert np.array_equal(N_(words).byteswap(), le)
    assert np.array_equal(
        tscrypt.labels_to_words(np.frombuffer(
            tscrypt.labels_to_bytes(words), dtype=np.uint8).reshape(b, 16)),
        le)
    ch = _rand_u32((8, b), 9)
    nonce = _rand_u32(b, 10)
    got = proving_cuda.proving_hash(T(ch), T(nonce), T(lo), T(hi), words,
                                    big_endian=True)
    want = _jax_hash(ch, nonce, lo, hi, le)
    assert np.array_equal(N_(got), np.asarray(want))
    # read little-endian instead, the words would hash to other values
    wrong = proving_cuda.proving_hash(T(ch), T(nonce), T(lo), T(hi), words)
    assert not np.array_equal(N_(wrong), np.asarray(want))


@pytest.mark.parametrize("per_lane_challenge", [False, True])
@pytest.mark.parametrize("per_lane_commitment", [False, True])
def test_finish_hash_equals_finish_then_the_hash_and_jax(per_lane_challenge,
                                                         per_lane_commitment):
    """PBKDF2 finish with the proving hash as its epilogue (its CPU path):
    the values equal finish -> proving_hash_plain over the big-endian words
    and the JAX package's proving_hash_jit over labels_to_words(labels);
    the words, when asked for, equal finish's."""
    b, n = 16, 2
    rng = np.random.default_rng(20 + 2 * per_lane_challenge
                                + per_lane_commitment)
    commits = rng.integers(0, 256, (b if per_lane_commitment else 1, 32),
                           dtype=np.uint8)
    idx = rng.integers(0, 2**64, b, dtype=np.uint64)
    idx[:2] = [2**32 - 1, 2**32]
    lo, hi = tscrypt.split_indices(idx)
    cw = np.stack([tscrypt.commitment_to_words(bytes(c))
                   for c in commits]).T
    cw = cw if per_lane_commitment else cw[:, 0]
    ch = _rand_u32((8, b) if per_lane_challenge else (8,), 21)
    nonce = _rand_u32(b, 22) if per_lane_challenge else 7
    tn = T(nonce) if per_lane_challenge else nonce
    blk = romix_cuda.romix(pbkdf2_cuda.expand(T(cw), T(lo), T(hi)), n)
    values, words = pbkdf2_cuda.finish_hash(T(cw), blk, T(ch), tn, T(lo),
                                            T(hi), words_out=True)
    want_words = pbkdf2_cuda.finish(T(cw), blk)
    assert torch.equal(words, want_words)
    assert torch.equal(values, proving_cuda.proving_hash_plain(
        T(ch), tn, T(lo), T(hi), want_words, big_endian=True))
    jlabels = np.asarray(jscrypt.scrypt_labels_multi(
        np.repeat(commits, b // len(commits), axis=0), idx, n=n))
    jvals = _jax_hash(ch, nonce, lo, hi, jscrypt.labels_to_words(jlabels))
    assert np.array_equal(N_(values), np.asarray(jvals))
    only, none = pbkdf2_cuda.finish_hash(T(cw), blk, T(ch), tn, T(lo), T(hi))
    assert none is None and torch.equal(only, values)
    # the whole recompute, as the verifier calls it
    got, _ = tscrypt.scrypt_labels_hash(T(cw), T(lo), T(hi), T(ch), tn, n=n)
    assert torch.equal(got, values)


def test_finish_hash_rejects_bad_shapes_and_devices():
    b = 4
    cw, lo, hi = T(_rand_u32(8, 1)), T(_rand_u32(b, 2)), T(_rand_u32(b, 3))
    blk, ch = T(_rand_u32((32, b), 4)), T(_rand_u32(8, 5))
    with pytest.raises(ValueError, match="blk must be"):
        pbkdf2_cuda.finish_hash(cw, blk[:16], ch, 1, lo, hi)
    with pytest.raises(ValueError, match="idx_lo"):
        pbkdf2_cuda.finish_hash(cw, blk, ch, 1, lo[:2], hi)
    meta = [t.to("meta") for t in (cw, blk, ch, lo, hi)]
    with pytest.raises(ValueError, match="unsupported device"):
        pbkdf2_cuda.finish_hash(meta[0], meta[1], meta[2], 1, *meta[3:])


@pytest.fixture(scope="module")
def workload_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("hash-kernels-workload")
    jp = jworkload.build(d, labels=2048, batch=256, mesh=None)
    return d, jp


def _items(pkg, cases, total):
    return [pkg.VerifyItem(proof=p, challenge=jworkload.CHALLENGE,
                           node_id=jworkload.NODE, commitment=c,
                           scrypt_n=n, total_labels=total)
            for p, c, n in cases]


def test_verify_many_matches_jax_across_scrypt_n_and_tampering(
        workload_store):
    """The on-device recompute and hash path over two label passes (two
    scrypt N in one call), honest and tampered proofs interleaved: the
    same verdicts as the JAX verifier."""
    d, jp = workload_store
    proof = jp.prove(jworkload.CHALLENGE)
    total = jp.meta.total_labels
    seed = b"\x07" * 32
    sampled = jverifier._k3_subset(_items(jverifier, [
        (proof, jworkload.COMMITMENT, 2)], total)[0], jworkload.PARAMS.k3,
        seed)
    tampered = dataclasses.replace(proof, indices=list(proof.indices))
    tampered.indices[proof.indices.index(sampled[-1])] = next(
        i for i in range(total) if i not in proof.indices)
    other_nonce = dataclasses.replace(proof, nonce=proof.nonce + 1)
    cases = [(proof, jworkload.COMMITMENT, 2),
             (proof, jworkload.COMMITMENT, 4),
             (tampered, jworkload.COMMITMENT, 2),
             (other_nonce, jworkload.COMMITMENT, 2),
             (proof, jworkload.COMMITMENT, 2)]
    want = jverifier.verify_many(_items(jverifier, cases, total),
                                 jworkload.PARAMS, seed=seed)
    tcases = [(tprover.Proof.from_dict(dataclasses.asdict(p)), c, n)
              for p, c, n in cases]
    timing: dict = {}
    got = tverifier.verify_many(_items(tverifier, tcases, total),
                                tworkload.PARAMS, seed=seed, device="cpu",
                                timing=timing)
    assert got == want == [True, False, False, False, True]
    assert set(timing) == {"prep", "labels", "hash", "check"}


def test_verify_many_recomputes_through_scrypt_labels_hash(workload_store,
                                                           monkeypatch):
    """verify_many hashes the labels in PBKDF2 finish's epilogue: with the
    standalone proving hash made to raise, its verdicts over honest and
    tampered proofs still equal the JAX verifier's, and each scrypt N is
    one scrypt_labels_hash call."""
    from spacemesh_tpu_torch.ops import proving as tproving

    d, jp = workload_store
    proof = jp.prove(jworkload.CHALLENGE)
    total = jp.meta.total_labels
    seed = b"\x0b" * 32
    other_nonce = dataclasses.replace(proof, nonce=proof.nonce + 1)
    cases = [(proof, jworkload.COMMITMENT, 2),
             (other_nonce, jworkload.COMMITMENT, 2),
             (proof, jworkload.COMMITMENT, 4)]
    want = jverifier.verify_many(_items(jverifier, cases, total),
                                 jworkload.PARAMS, seed=seed)

    def boom(*args, **kwargs):
        raise AssertionError("the standalone proving hash ran")

    for mod in (proving_cuda, tproving):
        monkeypatch.setattr(mod, "proving_hash", boom)
    calls = []
    real = tscrypt.scrypt_labels_hash
    monkeypatch.setattr(tscrypt, "scrypt_labels_hash",
                        lambda *a, **k: calls.append(k["n"]) or real(*a, **k))
    tcases = [(tprover.Proof.from_dict(dataclasses.asdict(p)), c, n)
              for p, c, n in cases]
    got = tverifier.verify_many(_items(tverifier, tcases, total),
                                tworkload.PARAMS, seed=seed, device="cpu")
    assert got == want == [True, False, False]
    assert calls == [2, 4]


# --- routing: the plain twins are reached only through the wrappers --------


class _Route:
    """Spies on the kernel wrappers (recording each call) and on the plain
    twins (recording each call made outside every wrapper)."""

    WRAPPERS = [(proving_cuda, "proving_hash"), (pow_cuda, "search_window"),
                (pow_cuda, "search_batch"), (pow_cuda, "verify_batch"),
                (pbkdf2_cuda, "expand"), (pbkdf2_cuda, "finish"),
                (pbkdf2_cuda, "finish_hash"), (romix_cuda, "romix")]
    TWINS = ("salsa20_8", "sha256_compress", "blockmix_r1")

    def __init__(self, monkeypatch):
        import sys

        self.calls: list = []
        self.stray: list = []
        self.local = threading.local()
        for mod, name in self.WRAPPERS:
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))
        from spacemesh_tpu_torch.ops import proving as tproving
        monkeypatch.setattr(tproving, "proving_hash",
                            proving_cuda.proving_hash)
        for key, mod in list(sys.modules.items()):
            if not key.startswith("spacemesh_tpu_torch"):
                continue
            for name in self.TWINS:
                fn = getattr(mod, name, None)
                if callable(fn):
                    monkeypatch.setattr(mod, name, self._twin(name, fn))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls.append((name, kwargs))
            self.local.depth = getattr(self.local, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.local.depth -= 1
        return spy

    def _twin(self, name, fn):
        def spy(*args, **kwargs):
            if not getattr(self.local, "depth", 0):
                self.stray.append(name)
            return fn(*args, **kwargs)
        return spy

    def names(self):
        return [name for name, _ in self.calls]


def test_verify_many_search_and_the_farm_pow_kind_route_through_wrappers(
        workload_store, monkeypatch):
    import asyncio

    from spacemesh_tpu_torch.verify.farm import PowRequest, VerificationFarm

    d, jp = workload_store
    proof = tprover.Proof.from_dict(dataclasses.asdict(
        jp.prove(jworkload.CHALLENGE)))
    route = _Route(monkeypatch)
    item = tverifier.VerifyItem(
        proof=proof, challenge=jworkload.CHALLENGE, node_id=jworkload.NODE,
        commitment=jworkload.COMMITMENT, scrypt_n=2,
        total_labels=jp.meta.total_labels)
    assert tverifier.verify_many([item, item], tworkload.PARAMS,
                                 device="cpu") == [True, True]
    assert route.names() == ["expand", "romix", "finish_hash"]
    assert route.calls[-1] == ("finish_hash", {"words_out": False})

    del route.calls[:]
    diff = bytes([9]) + bytes([255]) * 31
    nonce = tpow.search(CH, NODE, diff, batch=64, device="cpu")
    assert tpow.verify(CH, NODE, diff, nonce)
    assert set(route.names()) == {"search_window"}

    del route.calls[:]
    reqs = [PowRequest(c, n, d_, x) for c, n, d_, x in _witnesses(40, 4)]

    async def farm_pow():
        farm = VerificationFarm(device="cpu", max_batch=64)
        try:
            return await asyncio.gather(*(farm.submit(r) for r in reqs))
        finally:
            await farm.aclose()

    got = asyncio.run(farm_pow())
    assert got == [tpow.verify(r.challenge, r.node_id, r.difficulty,
                               r.nonce) for r in reqs]
    assert "verify_batch" in route.names()
    assert route.stray == []
