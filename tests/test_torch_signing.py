"""The port's identity layer (``spacemesh_tpu_torch/core/signing.py``),
blake3 (``core/hashing.py``) and poet membership (``consensus/poet.py``)
against the JAX package's.

ed25519 runs through OpenSSL where ``cryptography`` imports and through
the RFC 8032 pure-Python path (cofactored, Pippenger batch check) where
it does not; a host may have either, so every ed25519 case runs on both
branches (``_HAVE_CRYPTOGRAPHY`` patched).
The VRF is pure Python in both packages.
"""

import hashlib

import pytest

from spacemesh_tpu.consensus import poet as jpoet
from spacemesh_tpu.core import hashing as jhashing
from spacemesh_tpu.core import signing as jsig
from spacemesh_tpu_torch.consensus import poet as tpoet
from spacemesh_tpu_torch.core import hashing as thashing
from spacemesh_tpu_torch.core import signing as tsig
from spacemesh_tpu_torch.core.types import MerkleProof

RFC_SEED = bytes.fromhex("4ccd089b28ff96da9db6c346ec114e0f"
                         "5b8a319f35aba624da8cf6ed4fb8a6fb")
RFC_PK = bytes.fromhex("3d4017c3e843895a92b70aa74d1b7ebc"
                       "9c982ccf2ec4968cc0cd55f12af4660c")
RFC_SIG = bytes.fromhex("92a009a9f0d4cab8720e820b5f642540"
                        "a2b27b5416503f8fb3762223ebdb69da"
                        "085ac1e43e15996e458f3613d0f11d8c"
                        "387b2eaeb4302aeeb00d291612bb0c00")


@pytest.fixture(params=["openssl", "pure-python"])
def branch(request, monkeypatch):
    """Both ed25519 backends of the port; the JAX package's too, so its
    verdicts are those of the same branch."""
    if request.param == "openssl":
        if not tsig._HAVE_CRYPTOGRAPHY:
            pytest.skip("cryptography is not installed here")
    else:
        monkeypatch.setattr(tsig, "_HAVE_CRYPTOGRAPHY", False)
        monkeypatch.setattr(jsig, "_HAVE_CRYPTOGRAPHY", False)
    tsig.clear_verify_cache()
    jsig.clear_verify_cache()
    yield request.param
    tsig.clear_verify_cache()
    jsig.clear_verify_cache()


def test_rfc8032_vector(branch):
    s = tsig.EdSigner(seed=RFC_SEED)
    assert s.public_key == RFC_PK
    # domain byte 0x72 + empty msg == the vector's one-byte message
    assert s.sign(0x72, b"") == RFC_SIG
    v = tsig.EdVerifier()
    assert v.verify(0x72, RFC_PK, b"", RFC_SIG)
    assert not v.verify(0x72, RFC_PK, b"x", RFC_SIG)
    assert v.verify_many([(0x72, RFC_PK, b"", RFC_SIG),
                          (0x72, RFC_PK, b"x", RFC_SIG)]) == [True, False]


def _items(prefix=b"bt", n=24):
    signers = [tsig.EdSigner(seed=hashlib.sha256(b"s%d" % k).digest(),
                             prefix=prefix) for k in range(3)]
    items = []
    for i in range(n):
        s = signers[i % 3]
        msg = b"bmsg" + i.to_bytes(2, "little")
        sig = s.sign(tsig.Domain.HARE, msg)
        if i % 5 == 0:
            sig = bytes(64) if i % 2 else sig[:40]  # invalid / malformed
        items.append((int(tsig.Domain.HARE), s.public_key, msg, sig))
    return items


def test_batch_equals_serial_equals_jax(branch):
    items = _items()
    v = tsig.EdVerifier(prefix=b"bt")
    serial = [v.verify(d, p, m, g) for d, p, m, g in items]
    assert 0 < sum(serial) < len(serial)
    tsig.clear_verify_cache()
    assert v.verify_many(items) == serial
    jv = jsig.EdVerifier(prefix=b"bt")
    assert [jv.verify(d, p, m, g) for d, p, m, g in items] == serial
    valid = [it for it, ok in zip(items, serial) if ok]
    tsig.clear_verify_cache()
    assert v.verify_many(valid) == [True] * len(valid)


def test_signatures_cross_between_packages(branch):
    """Signed by either package, verified by the other, with and without
    a genesis prefix; the signatures themselves are byte-equal."""
    for prefix in (b"", b"genesis-id"):
        seed = hashlib.sha256(b"cross" + prefix).digest()
        ts = tsig.EdSigner(seed=seed, prefix=prefix)
        js = jsig.EdSigner(seed=seed, prefix=prefix)
        assert ts.public_key == js.public_key
        for dom in (tsig.Domain.ATX, tsig.Domain.BALLOT):
            msg = b"m" + prefix
            assert ts.sign(dom, msg) == js.sign(dom, msg)
            assert jsig.EdVerifier(prefix=prefix).verify(
                dom, ts.public_key, msg, ts.sign(dom, msg))
            assert tsig.EdVerifier(prefix=prefix).verify(
                dom, js.public_key, msg, js.sign(dom, msg))
            assert not tsig.EdVerifier(prefix=b"other").verify(
                dom, js.public_key, msg, js.sign(dom, msg))


def _torsion_forgery():
    """An honest (r, s) published with R' = R + T, T a small-order point:
    the prime-order part of the equation holds, the torsion part not."""
    t8, i = None, 0
    while t8 is None:
        pt = tsig._pt_decode(hashlib.sha256(b"torsion%d" % i).digest())
        i += 1
        if pt is None:
            continue
        cand = tsig._pt_mul(tsig._Q, pt)
        if not tsig._pt_eq(cand, tsig._ID):
            t8 = cand
    scalar, nonce_prefix = tsig._expand_key(bytes(31) + b"\x07")
    pub = tsig._pt_encode(tsig._pt_mul_base(scalar))
    msg = b"torsion-msg"
    data = bytes([int(tsig.Domain.ATX)]) + msg
    r = int.from_bytes(hashlib.sha512(nonce_prefix + data).digest(),
                       "little") % tsig._Q
    r_enc = tsig._pt_encode(tsig._pt_add(tsig._pt_mul_base(r), t8))
    k = int.from_bytes(hashlib.sha512(r_enc + pub + data).digest(),
                       "little") % tsig._Q
    s = (r + k * scalar) % tsig._Q
    return pub, msg, r_enc + s.to_bytes(32, "little")


def test_torsion_defect_batch_serial_and_jax_agree(branch):
    """On the pure-Python branch the forged signature is accepted by the
    cofactored equation, batch and serial alike, deterministically; on
    OpenSSL (cofactorless) both reject it. Either way the port's verdicts
    equal the JAX package's on the same branch."""
    pub, msg, forged = _torsion_forgery()
    honest = tsig.EdSigner(seed=bytes(31) + b"\x09")
    items = [(int(tsig.Domain.ATX), pub, msg, forged)]
    for j in range(9):  # >= 8 candidates so the MSM batch path engages
        m = b"hm%d" % j
        items.append((int(tsig.Domain.ATX), honest.public_key, m,
                      honest.sign(tsig.Domain.ATX, m)))
    v, jv = tsig.EdVerifier(), jsig.EdVerifier()
    for _ in range(3):  # the old divergence was probabilistic
        tsig.clear_verify_cache()
        batch = v.verify_many(items)
        tsig.clear_verify_cache()
        serial = [v.verify(d, p, m, g) for d, p, m, g in items]
        jsig.clear_verify_cache()
        assert batch == serial == jv.verify_many(items)
        assert serial[0] is (branch == "pure-python")
    bad = list(items[1])
    bad[3] = bytes(64)
    tsig.clear_verify_cache()
    assert v.verify_many(items + [tuple(bad)])[-1] is False


@pytest.mark.parametrize("k", range(3))
def test_vrf_proofs_and_outputs_equal_the_jax_package(k):
    seed = hashlib.sha256(b"vrf-seed-%d" % k).digest()
    ts = tsig.EdSigner(seed=seed).vrf_signer()
    js = jsig.EdSigner(seed=seed).vrf_signer()
    assert ts.public_key == js.public_key
    for alpha in (b"", b"alpha-%d" % k):
        proof = ts.prove(alpha)
        assert proof == js.prove(alpha)
        assert tsig.vrf_output(proof) == jsig.vrf_output(proof)
        assert len(tsig.vrf_output(proof)) == tsig.VRF_OUTPUT_SIZE


def test_vrf_verification_across_packages():
    seed = hashlib.sha256(b"vrf-cross").digest()
    ts = tsig.EdSigner(seed=seed).vrf_signer()
    js = jsig.EdSigner(seed=seed).vrf_signer()
    tv, jv = tsig.VrfVerifier(), jsig.VrfVerifier()
    proof_t, proof_j = ts.prove(b"a"), js.prove(b"a")
    assert jv.verify(ts.public_key, b"a", proof_t)
    assert tv.verify(js.public_key, b"a", proof_j)
    bad = proof_t[:40] + bytes([proof_t[40] ^ 1]) + proof_t[41:]
    cases = [(ts.public_key, b"b", proof_t), (ts.public_key, b"a", bad),
             (ts.public_key, b"a", proof_t[:31]), (bytes(32), b"a", proof_t)]
    for pk, alpha, proof in cases:
        assert tv.verify(pk, alpha, proof) is False
        assert tv.verify(pk, alpha, proof) == jv.verify(pk, alpha, proof)
    with pytest.raises(ValueError):
        tsig.VrfSigner(seed, public_key=bytes(32))


@pytest.mark.parametrize("n", [0, 1, 64, 65, 1024, 1025, 2049, 5000])
def test_blake3_equals_the_jax_package(n):
    data = bytes((i * 7 + 3) & 0xFF for i in range(n))
    assert thashing.sum256(data) == jhashing.sum256(data)
    assert thashing.sum256(data[:n // 2], data[n // 2:]) == \
        jhashing.sum256(data)
    key = hashlib.sha256(b"k").digest()
    assert (thashing.Hasher(key=key).update(data).digest(32)
            == jhashing.keyed(key, data))
    assert (thashing.Hasher().update(data).digest(131)
            == jhashing.Hasher().update(data).digest(131))


def test_blake3_empty_input_vector():
    # the BLAKE3 reference test vector for the empty input
    assert thashing.sum256(b"").hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")


@pytest.mark.parametrize("leaves", [1, 2, 5, 16, 17])
def test_membership_equals_the_jax_package(leaves):
    members = [b"member-%d" % i for i in range(leaves)]
    root = tpoet.merkle_root(members)
    assert root == jpoet.merkle_root(members)
    for i in range(leaves):
        proof = tpoet.merkle_path(members, i)
        jproof = jpoet.merkle_path(members, i)
        assert (proof.leaf_index, proof.nodes) == (jproof.leaf_index,
                                                   jproof.nodes)
        assert tpoet.verify_membership(members[i], proof, root, leaves)
        assert not tpoet.verify_membership(b"x", proof, root, leaves)
    if leaves > 1:
        p = tpoet.merkle_path(members, 0)
        cut = MerkleProof(leaf_index=0, nodes=p.nodes[:-1])
        extra = MerkleProof(leaf_index=0, nodes=p.nodes + [bytes(32)])
        out = MerkleProof(leaf_index=leaves, nodes=p.nodes)
        for bad in (cut, extra, out):
            assert not tpoet.verify_membership(members[0], bad, root,
                                               leaves)
            assert not jpoet.verify_membership(members[0], bad, root,
                                               leaves)
