"""The port's ops (spacemesh_tpu_torch/ops) against the JAX package and
hashlib, on the CPU, with exact equality (all integer).

Inputs come from numpy seeds and go through the JAX function and the
port's plain counterpart (``device="cpu"``). Pallas kernels run in
interpret mode, as the JAX package's own tests run them. The CUDA kernels
themselves are held against these plain twins on the card
(tests/test_torch_cuda.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacemesh_tpu.ops import pow as jpow
from spacemesh_tpu.ops import proving as jproving
from spacemesh_tpu.ops import proving_pallas as jproving_pallas
from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.ops import sha256 as jsha
from spacemesh_tpu.ops.romix_pallas import romix_pallas
from spacemesh_tpu_torch import convert
from spacemesh_tpu_torch.ops import pow as tpow
from spacemesh_tpu_torch.ops import proving as tproving
from spacemesh_tpu_torch.ops import proving_cuda, romix_cuda, salsa
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.ops import sha256 as tsha
from spacemesh_tpu_torch.ops import u32

T = u32.from_numpy
N_ = u32.to_numpy
EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores, and its spin-waits make mid-sized CPU ops (the 65536-nonce
    k2pow batch) hundreds of times slower. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def _edge_pairs():
    """Every pair of edge values plus random pairs, as two u32 arrays."""
    a, b = np.meshgrid(EDGES, EDGES)
    ra, rb = _rand_u32(64, 1), _rand_u32(64, 2)
    return (np.concatenate([a.ravel().astype(np.uint32), ra]),
            np.concatenate([b.ravel().astype(np.uint32), rb]))


# --- u32 layer ----------------------------------------------------------------

_BINARY = {
    "add": (lambda x, y: x + y, lambda x, y: x + y),
    "xor": (lambda x, y: x ^ y, lambda x, y: x ^ y),
    "ult": (u32.ult, lambda x, y: x < y),
    "eq": (lambda x, y: x == y, lambda x, y: x == y),
}


@pytest.mark.parametrize("op", sorted(_BINARY))
def test_u32_binary_ops_match_numpy_uint32(op):
    a, b = _edge_pairs()
    tfn, nfn = _BINARY[op]
    got = tfn(T(a), T(b))
    want = nfn(a, b)
    if got.dtype == torch.bool:
        assert np.array_equal(got.numpy(), want)
    else:
        assert np.array_equal(N_(got), want.astype(np.uint32))


@pytest.mark.parametrize("n", [1, 7, 13, 18, 24, 31])
def test_u32_shifts_and_rotates_match_numpy_uint32(n):
    a, _ = _edge_pairs()
    x = T(a)
    assert np.array_equal(N_(u32.shr(x, n)), a >> np.uint32(n))
    assert np.array_equal(N_(x << n), a << np.uint32(n))
    rotl = (a << np.uint32(n)) | (a >> np.uint32(32 - n))
    assert np.array_equal(N_(u32.rotl(x, n)), rotl)
    rotr = (a >> np.uint32(n)) | (a << np.uint32(32 - n))
    assert np.array_equal(N_(u32.rotr(x, n)), rotr)


def test_u32_scalar_compare_byteswap_and_min():
    a, _ = _edge_pairs()
    x = T(a)
    for thr in (0, 1, 2**31 - 1, 2**31, 2**32 - 1):
        assert np.array_equal(u32.ult(x, thr).numpy(), a < np.uint32(thr))
    assert np.array_equal(N_(u32.byteswap32(x)), a.byteswap())
    # the unsigned min through the order-preserving flip
    assert N_(u32.flip(u32.flip(x).min()).view(1))[0] == a.min()
    assert u32.s32(2**32 - 1) == -1 and u32.s32(2**31) == -2**31


# --- SHA-256 ------------------------------------------------------------------


def test_sha256_compress_matches_jax_and_hashlib():
    state, block = _rand_u32((8, 37), 3), _rand_u32((16, 37), 4)
    want = np.asarray(jsha.sha256_compress(jnp.asarray(state),
                                           jnp.asarray(block)))
    assert np.array_equal(N_(tsha.sha256_compress(T(state), T(block))), want)
    msg = b"spacemesh torch port"
    blocks = tsha.pad_message_np(msg)
    assert np.array_equal(blocks, jsha.pad_message_np(msg))
    st = T(tsha.IV)
    for blk in blocks:
        st = tsha.sha256_compress(st, T(blk)[:, None])[:, 0]
    assert N_(st).astype(">u4").tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("per_lane", [False, True])
def test_hmac_midstates_match_jax(per_lane):
    key = _rand_u32((8, 5) if per_lane else (8,), 5)
    want = jsha.hmac_midstates(jnp.asarray(key))
    got = tsha.hmac_midstates(T(key))
    for g, w in zip(got, want):
        assert np.array_equal(N_(g), np.asarray(w))


# --- Salsa20/8, ROMix -----------------------------------------------------------


def test_salsa20_8_and_blockmix_match_jax():
    x = _rand_u32((32, 9), 6)
    assert np.array_equal(N_(salsa.salsa20_8(T(x[:16]))),
                          np.asarray(jscrypt.salsa20_8(jnp.asarray(x[:16]))))
    assert np.array_equal(N_(salsa.blockmix_r1(T(x))),
                          np.asarray(jscrypt.blockmix_r1(jnp.asarray(x))))


@pytest.mark.parametrize("n,b", [(2, 5), (16, 13), (1024, 7)])
def test_romix_matches_jax_and_pallas_interpret(n, b):
    x = _rand_u32((32, b), 7 + n)
    before = romix_cuda.launches
    got = N_(romix_cuda.romix(T(x), n))
    assert romix_cuda.launches == before  # a CPU tensor never launches
    assert np.array_equal(got, np.asarray(jscrypt.romix_r1(jnp.asarray(x),
                                                           n)))
    pallas = romix_pallas(jnp.asarray(x), n=n, lane_tile=b, interpret=True)
    assert np.array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("n,b", [(16, 13), (1024, 5)])
def test_romix_fill_phase_matches_jax_and_pallas_interpret(n, b):
    """mix_phase=False stops after the fill (the fill/mix time split)."""
    x = _rand_u32((32, b), 70 + n)
    before = romix_cuda.launches
    got = N_(romix_cuda.romix(T(x), n, mix_phase=False))
    assert romix_cuda.launches == before
    assert np.array_equal(got, N_(romix_cuda.romix_r1(T(x), n,
                                                      mix_phase=False)))
    assert np.array_equal(got, np.asarray(jscrypt.romix_r1(
        jnp.asarray(x), n, mix_phase=False)))
    pallas = romix_pallas(jnp.asarray(x), n=n, lane_tile=b, interpret=True,
                          mix_phase=False)
    assert np.array_equal(got, np.asarray(pallas))
    assert not np.array_equal(got, N_(romix_cuda.romix(T(x), n)))


def test_romix_rejects_bad_inputs():
    with pytest.raises(ValueError):
        romix_cuda.romix(torch.zeros((32, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        romix_cuda.romix(torch.zeros((16, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        romix_cuda.romix(torch.zeros((32, 4), dtype=torch.int32,
                                     device="meta"), 4)


# --- labels -------------------------------------------------------------------


def test_labels_match_jax_multi_and_hashlib():
    rng = np.random.default_rng(8)
    commits = rng.integers(0, 256, (11, 32), dtype=np.uint8)
    idx = rng.integers(0, 2**64, 11, dtype=np.uint64)
    idx[:3] = [0, 2**32 - 1, 2**32]
    got = tscrypt.scrypt_labels_multi(commits, idx, n=16, device="cpu")
    assert np.array_equal(got, jscrypt.scrypt_labels_multi(commits, idx,
                                                           n=16))
    for i in range(11):
        want = hashlib.scrypt(bytes(commits[i]),
                              salt=int(idx[i]).to_bytes(8, "little"),
                              n=16, r=1, p=1, dklen=16)
        assert bytes(got[i]) == want
    one = tscrypt.scrypt_labels(bytes(commits[0]), idx[:5], n=2,
                                device="cpu")
    assert np.array_equal(one, jscrypt.scrypt_labels(bytes(commits[0]),
                                                     idx[:5], n=2))
    assert tscrypt.scrypt_labels(bytes(commits[0]), [], n=2,
                                 device="cpu").shape == (0, 16)


def test_label_word_helpers_match_jax():
    labels = np.random.default_rng(9).integers(0, 256, (6, 16),
                                               dtype=np.uint8)
    assert np.array_equal(tscrypt.labels_to_words(labels),
                          jscrypt.labels_to_words(labels))
    words = _rand_u32((4, 6), 10)
    assert tscrypt.labels_to_bytes(T(words)) == jscrypt.labels_to_bytes(words)
    idx = np.array([0, 2**32 + 5, 2**64 - 1], dtype=np.uint64)
    for a, b in zip(tscrypt.split_indices(idx), jscrypt.split_indices(idx)):
        assert np.array_equal(a, b)
    c = hashlib.sha256(b"c").digest()
    assert np.array_equal(tscrypt.commitment_to_words(c),
                          jscrypt.commitment_to_words(c))
    with pytest.raises(ValueError):
        tscrypt.scrypt_labels(c, [1], n=12, device="cpu")


def _minscan_both(words, lo, hi, carry):
    jn, js = jscrypt._minscan(jnp.asarray(words), jnp.asarray(lo),
                              jnp.asarray(hi), jnp.asarray(carry))
    tn, ts = tscrypt._minscan(T(words), T(lo), T(hi), T(carry))
    return (np.asarray(jn), np.asarray(js)), (N_(tn), N_(ts))


def test_minscan_tie_keeps_first_lane_like_jax():
    words = _rand_u32((4, 40), 11)
    words[:, 9] = 0x01000000       # a small key ...
    words[:, 30] = 0x01000000      # ... tied at a later lane
    words[:, 31] = 0x01000000
    words[0, 31] = 0x02000000      # larger in its lowest limb only
    # the low halves wrap past 2^32 at lane 20
    lo = ((np.arange(40, dtype=np.uint64) + 2**32 - 20)
          & 0xFFFFFFFF).astype(np.uint32)
    hi = np.where(np.arange(40) >= 20, 6, 5).astype(np.uint32)
    j, t = _minscan_both(words, lo, hi, jscrypt.vrf_carry_init())
    assert np.array_equal(j[0], t[0]) and np.array_equal(j[1], t[1])
    assert t[0][4] == 5 and t[0][5] == lo[9]
    # an equal key in a later batch does not displace the carried index
    j2, t2 = _minscan_both(words[:, [30]], lo[[30]], hi[[30]], t[0])
    assert np.array_equal(j2[0], t2[0]) and t2[0][5] == lo[9]


def test_labels_with_min_carry_matches_jax_at_ragged_batches():
    c = hashlib.sha256(b"vrf").digest()
    cw = jscrypt.commitment_to_words(c)
    jcarry = jnp.asarray(jscrypt.vrf_carry_init())
    tcarry = convert.vrf_carry_to_torch(jscrypt.vrf_carry_init())
    start = 2**32 - 30  # the second batch crosses into idx_hi = 1
    snaps = []
    for count in (37, 23):
        lo, hi = jscrypt.split_indices(np.arange(start, start + count,
                                                 dtype=np.uint64))
        jw, jcarry, jsnap = jscrypt.scrypt_labels_with_min(
            jnp.asarray(cw), jnp.asarray(lo), jnp.asarray(hi), jcarry, n=2)
        tw, tcarry, tsnap = tscrypt.scrypt_labels_with_min(
            T(cw), T(lo), T(hi), tcarry, n=2)
        assert np.array_equal(N_(tw), np.asarray(jw))
        assert np.array_equal(convert.vrf_carry_from_torch(tcarry),
                              np.asarray(jcarry))
        assert np.array_equal(N_(tsnap), np.asarray(jsnap))
        snaps.append((tsnap, N_(tsnap).copy()))
        start += count
    # each snapshot is its own buffer: rolling the carry never moves it
    tcarry.fill_(0)
    for snap, frozen in snaps:
        assert np.array_equal(N_(snap), frozen)
    assert tscrypt.vrf_carry_decode(snaps[-1][0]) == \
        jscrypt.vrf_carry_decode(snaps[-1][1])


# --- proving --------------------------------------------------------------------

CH = hashlib.sha256(b"torch-ch").digest()
COMMIT = hashlib.sha256(b"torch-commit").digest()


def _scan_inputs(count, batch, start):
    idx = np.arange(start, start + batch, dtype=np.uint64)
    labels = jscrypt.scrypt_labels(COMMIT, idx[:count], n=2)
    padded = np.concatenate(
        [labels, np.zeros((batch - count, 16), labels.dtype)])
    lo, hi = jscrypt.split_indices(idx)
    return idx, labels, lo, hi, jscrypt.labels_to_words(padded)


@pytest.mark.parametrize("count,batch,nonce_base,n_nonces,start", [
    (700, 1024, 0, 4, 0),                  # unaligned tail
    (512, 512, 12, 8, 0),                  # window crossing a group boundary
    (448, 512, 2**32 - 3, 3, 2**32 - 200),  # nonce wrap, start_hi > 0
])
def test_scan_matches_pallas_interpret(count, batch, nonce_base, n_nonces,
                                       start):
    _, _, lo, hi, lw = _scan_inputs(count, batch, start)
    cw = jproving.challenge_words(CH)
    t = jproving.threshold_u32(120, count)
    jmask, jseg = jproving_pallas._scan_pallas(
        jnp.asarray(cw), jnp.uint32(nonce_base), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(lw), jnp.uint32(t), jnp.uint32(count),
        n_nonces=n_nonces, interpret=True)
    before = proving_cuda.launches
    mask, seg = proving_cuda.scan(cw, nonce_base, T(lo), T(hi), T(lw), t,
                                  count, n_nonces=n_nonces)
    assert proving_cuda.launches == before
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert np.array_equal(seg.numpy(), np.asarray(jseg))
    assert mask.any()


@pytest.mark.parametrize("count,batch,nonce_base,n_nonces,start", [
    (700, 1024, 0, 4, 0),
    (512, 512, 24, 16, 0),
    (448, 512, 5, 4, 2**32 - 200),         # hits carry into idx_hi
])
def test_prove_step_matches_jax_step(count, batch, nonce_base, n_nonces,
                                     start):
    _, _, lo, hi, lw = _scan_inputs(count, batch, start)
    cw = jproving.challenge_words(CH)
    t = jproving.threshold_u32(120, count)
    cap = 8
    jc, jcarry = jproving.init_hit_state(n_nonces, cap)
    jc, jbc, jcarry = jproving.prove_scan_step_jit(
        jnp.asarray(cw), jnp.uint32(nonce_base), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(lw), jnp.uint32(t), jc, jcarry,
        jnp.uint32(count), jnp.uint32(start & 0xFFFFFFFF),
        jnp.uint32(start >> 32), n_nonces=n_nonces, max_hits=cap)
    tc, tcarry = tproving.init_hit_state(n_nonces, cap)
    tc, tbc, tcarry = tproving.prove_scan_step(
        cw, nonce_base, T(lo), T(hi), T(lw), t, tc, tcarry, count,
        start & 0xFFFFFFFF, start >> 32, n_nonces=n_nonces, max_hits=cap)
    got = convert.hit_state_from_torch(tc, tcarry)
    assert np.array_equal(got[0], np.asarray(jc))
    assert np.array_equal(got[1], np.asarray(jcarry))
    assert np.array_equal(tbc.numpy(), np.asarray(jbc))
    for k in range(n_nonces):
        assert (tproving.decode_hits(tc, tcarry, k, cap)
                == jproving.decode_hits(jc, jcarry, k, cap))


def test_compact_and_merge_hits_match_jax():
    rng = np.random.default_rng(12)
    mask = rng.random((5, 256)) < 0.04
    mask[3] = False                              # a nonce with no hits
    mask[4, :] = True                            # more hits than max_hits
    jout = jproving.compact_hits(jnp.asarray(mask), max_hits=6)
    tout = tproving.compact_hits(torch.from_numpy(mask), max_hits=6)
    for g, w in zip(tout, jout):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    counts0 = np.array([0, 3, 5, 1, 2], dtype=np.int32)  # some slots used
    carry0 = _rand_u32((2, 5, 7), 13)
    jc, jcarry = jnp.asarray(counts0), jnp.asarray(carry0)
    tc, tcarry = convert.hit_state_to_torch(counts0, carry0)
    jm = jproving.merge_hits(jc, jcarry, *jout, jnp.uint32(2**32 - 100),
                             jnp.uint32(9))
    tm = tproving.merge_hits(tc, tcarry, *tout, 2**32 - 100, 9)
    assert np.array_equal(tm[0].numpy(), np.asarray(jm[0]))
    assert np.array_equal(tm[1].numpy(), np.asarray(jm[1]))
    assert np.array_equal(N_(tm[2]), np.asarray(jm[2]))
    assert np.array_equal(N_(tcarry), carry0)  # inputs are left alone


def test_proving_host_entries_match_jax():
    idx, labels, *_ = _scan_inputs(300, 300, 2**32 - 7)
    t = jproving.threshold_u32(40, 300)
    assert tproving.threshold_u32(40, 300) == t
    assert np.array_equal(tproving.challenge_words(CH),
                          jproving.challenge_words(CH))
    assert np.array_equal(
        tproving.proving_hashes(CH, 11, idx, labels, device="cpu"),
        jproving.proving_hashes(CH, 11, idx, labels))
    got = tproving.proving_scan(CH, 3, idx, labels, t, n_nonces=2,
                                device="cpu")
    want = jproving_pallas.proving_scan(CH, 3, idx, labels, t, n_nonces=2,
                                        interpret=True)
    assert got.shape == (2, 300) and np.array_equal(got, want)


# --- k2pow ------------------------------------------------------------------------

NODE = hashlib.sha256(b"torch-node").digest()
DIFF = bytes([6]) + bytes([255]) * 31


def test_pow_search_matches_jax_and_hashlib_across_hi_u32():
    start = 2**32 - 150  # the scan crosses into nonce_hi = 1
    got = tpow.search(CH, NODE, DIFF, batch=64, start=start, device="cpu")
    assert got == jpow.search(CH, NODE, DIFF, batch=64, start=start)
    assert tpow.verify(CH, NODE, DIFF, got)
    for nonce in range(start, got):
        assert not tpow.verify(CH, NODE, DIFF, nonce)
    assert np.array_equal(tpow.prefix_state(CH, NODE),
                          jpow.prefix_state(CH, NODE))


def test_pow_verify_many_matches_jax_and_hashlib():
    rng = np.random.default_rng(14)
    items = []
    for i in range(20):
        nonce = int(rng.integers(0, 2**64, dtype=np.uint64))
        if i % 4 == 0:
            nonce = 2**32 + i
        diff = bytes([int(rng.integers(0, 256))]) + bytes([255]) * 31
        items.append((bytes(rng.integers(0, 256, 32, dtype=np.uint8)), NODE,
                      diff, nonce))
    want = [hashlib.sha256(c + n + int(x).to_bytes(8, "little")).digest() < d
            for c, n, d, x in items]
    assert any(want) and not all(want)
    got = tpow.verify_many(items, batch=8, device="cpu")
    assert got == want == jpow.verify_many(items, batch=8)
    assert tpow.verify_many(items[:3], device="cpu") == want[:3]
    with pytest.raises(ValueError):
        tpow.verify_many([(CH, NODE, DIFF, 2**64)], device="cpu")
