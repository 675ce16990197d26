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


# --- routing: the plain twins are reached only through the wrappers --------


class _Route:
    """Spies on the kernel wrappers (recording each call) and on the plain
    twins (recording each call made outside every wrapper and outside the
    host midstate helper ``ops.pow.prefix_state``, which hashes a CPU
    tensor it makes itself)."""

    WRAPPERS = [(proving_cuda, "proving_hash"), (pow_cuda, "search_batch"),
                (pow_cuda, "verify_batch"), (pbkdf2_cuda, "expand"),
                (pbkdf2_cuda, "finish"), (romix_cuda, "romix")]
    TWINS = ("salsa20_8", "sha256_compress", "blockmix_r1")

    def __init__(self, monkeypatch):
        import sys

        self.calls: list = []
        self.stray: list = []
        self.local = threading.local()
        for mod, name in self.WRAPPERS + [(tpow, "prefix_state")]:
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
    assert route.names() == ["expand", "romix", "finish", "proving_hash"]
    assert route.calls[-1] == ("proving_hash", {"big_endian": True})

    del route.calls[:]
    diff = bytes([9]) + bytes([255]) * 31
    nonce = tpow.search(CH, NODE, diff, batch=64, device="cpu")
    assert tpow.verify(CH, NODE, diff, nonce)
    assert set(route.names()) == {"search_batch", "prefix_state"}

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
