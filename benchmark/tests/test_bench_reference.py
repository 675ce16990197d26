"""The plain reference against the standard library and against the PoST
definitions, at tiny sizes on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark.reference import k2pow, labels, proving, store, vrf

MASK = 0xFFFFFFFF


def _le_words(data: bytes) -> torch.Tensor:
    return torch.tensor(np.frombuffer(data, "<u4").astype(np.int64))


def _blockmix(x: torch.Tensor) -> torch.Tensor:
    """scrypt BlockMix for r=1 on (32,) words, over the reference's
    Salsa20/8."""
    y0 = proving.salsa20_8((x[16:] ^ x[:16])[:, None])[:, 0]
    y1 = proving.salsa20_8((y0 ^ x[16:])[:, None])[:, 0]
    return torch.cat([y0, y1])


def _scrypt(password: bytes, salt: bytes, n: int) -> bytes:
    """scrypt (r=1, p=1, 16 bytes) with ROMix built on the reference's
    Salsa20/8, PBKDF2 from hashlib."""
    b = hashlib.pbkdf2_hmac("sha256", password, salt, 1, 128)
    x = _le_words(b)
    v = []
    for _ in range(n):
        v.append(x)
        x = _blockmix(x)
    for _ in range(n):
        j = int(x[16]) % n
        x = _blockmix(x ^ v[j])
    out = x.numpy().astype("<u4").tobytes()
    return hashlib.pbkdf2_hmac("sha256", password, out, 1, 16)


@pytest.mark.parametrize("n", [2, 16, 64])
def test_salsa20_8_makes_hashlib_scrypt(n):
    commitment = hashlib.sha256(b"bench-reference").digest()
    for index in (0, 1, 2**32 + 5):
        salt = index.to_bytes(8, "little")
        assert _scrypt(commitment, salt, n) == hashlib.scrypt(
            commitment, salt=salt, n=n, r=1, p=1, dklen=16)


def test_labels_are_hashlib_scrypt_in_order():
    c = b"\x07" * 32
    picks = [5, 0, 2**33 + 1, 77]
    assert labels.labels(c, picks, 16, threads=3) == [
        hashlib.scrypt(c, salt=i.to_bytes(8, "little"), n=16, r=1, p=1,
                       dklen=16) for i in picks]


def test_threshold():
    assert proving.threshold(26, 1 << 16) == 26 << 16
    assert proving.threshold(26, 1) == MASK
    assert proving.threshold(1, 1 << 32) == 1


def test_proving_hash_state_layout():
    """Word 0 of Salsa20/8 over challenge || nonce || index || 0 || label,
    each qualifying label below the threshold."""
    rng = np.random.default_rng(3)
    ch = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    labs = rng.integers(0, 256, (40, 16), dtype=np.uint8)
    q = proving.qualifying_counts(ch, 9, 3, labs, 1 << 31, "cpu")
    for k in range(3):
        for i in (0, 17, 39):
            state = torch.cat([
                _le_words(ch), torch.tensor([9 + k, i, 0, 0]),
                _le_words(labs[i].tobytes())])
            v = int(proving.salsa20_8(state[:, None])[0, 0])
            assert bool(q[k, i]) == (v < 1 << 31)


def test_prove_finds_the_lowest_winning_nonce():
    rng = np.random.default_rng(5)
    labs = rng.integers(0, 256, (256, 16), dtype=np.uint8)
    ch = b"\x11" * 32
    nonce, idx = proving.prove(ch, labs, 26, 37)
    thr = proving.threshold(26, 256)
    q = proving.qualifying_counts(ch, 0, nonce + 1, labs, thr, "cpu")
    counts = q.sum(1).tolist()
    assert counts[nonce] >= 37 and all(c < 37 for c in counts[:nonce])
    assert idx == torch.nonzero(q[nonce])[:37, 0].tolist()
    assert proving.prove(ch, labs, 26, 10**6, max_nonce=32) is None


def test_k2pow_smallest_against_a_scan():
    ch, node = b"\x01" * 32, b"\x02" * 32
    diff = bytes([0, 255]) + bytes([255]) * 30
    w = k2pow.smallest(ch, node, diff)
    assert k2pow.valid(ch, node, diff, w)
    assert not any(k2pow.valid(ch, node, diff, i) for i in range(w))
    assert k2pow.smallest(ch, node, bytes(32), limit=100) is None


def test_store_reads_across_files(tmp_path):
    mfs = 16 * 10  # ten labels a file
    data = bytes(range(256)) * 2  # 32 labels
    for k in range(4):
        chunk = data[k * mfs:(k + 1) * mfs]
        if chunk:
            (tmp_path / f"postdata_{k}.bin").write_bytes(chunk)
    got = store.read_labels(tmp_path, [0, 9, 10, 31, 32, 45], mfs)
    assert got[:4] == [data[i * 16:(i + 1) * 16] for i in (0, 9, 10, 31)]
    assert got[4:] == [None, None]
    arr = store.read_range(tmp_path, 32, mfs)
    assert arr.tobytes() == data
    with pytest.raises(ValueError):
        store.read_range(tmp_path, 33, mfs)


def test_reference_proof_equals_the_ports_on_the_cpu(tmp_path):
    """The reference and the port's CPU path agree on a tiny store; the
    reference still imports nothing of the port."""
    from spacemesh_tpu_torch.post import initializer
    from spacemesh_tpu_torch.post.prover import ProofParams, Prover

    node, commit = b"\x03" * 32, b"\x04" * 32
    meta, _ = initializer.initialize(
        tmp_path, node_id=node, commitment=commit, num_units=4,
        labels_per_unit=64, scrypt_n=16, batch_size=256, device="cpu")
    labs = store.read_range(tmp_path, 256, meta.max_file_size)
    assert bytes(labs[100]) == labels.label(commit, 100, 16)
    params = ProofParams()
    for j in range(2):
        ch = hashlib.sha256(b"ch%d" % j).digest()
        p = Prover(tmp_path, params, device="cpu").prove(ch)
        assert (p.nonce, p.indices) == proving.prove(ch, labs, 26, 37)
        assert p.pow_nonce == k2pow.smallest(ch, node, params.pow_difficulty)


def test_the_vrf_nonce_is_the_smallest_label_lowest_index_first():
    rng = np.random.default_rng(5)
    labs = rng.integers(0, 256, size=(1000, 16), dtype=np.uint8)
    want = min(range(1000),
               key=lambda i: (int.from_bytes(labs[i].tobytes(), "little"), i))
    assert vrf.smallest(labs) == (want, labs[want].tobytes())
    # the high half decides first; a tie goes to the lower index
    labs[7] = 0
    labs[3] = 0
    assert vrf.smallest(labs) == (3, bytes(16))
    labs[:] = 255
    labs[9, :8] = 0       # low half smallest, high half not
    labs[4, 8:] = 254     # high half smaller
    assert vrf.smallest(labs)[0] == 4
    assert vrf.smallest(labs[:0]) is None
