"""The port's native twins (``spacemesh_tpu_torch/native``: ``blake3.cpp``
and ``ecvrf.cpp``) against the port's pure-Python twins and the JAX
package's ``core/hashing.py`` and ``core/signing.py``.

Twins of ``tests/test_native_blake3.py`` and ``tests/test_native_ecvrf.py``:
the same tree shapes, keyed lengths, seeded VRF trials and bit flips, held
with exact equality (bytes and verdicts). Besides: the port builds its
own libraries, by source hash, under ``spacemesh_tpu_torch/``; a stale
source builds into a new name; a failed build leaves the Python twin
answering, visibly; ``SPACEMESH_NO_NATIVE_VRF`` is honoured; and the
counters name the path that ran. No torch, no card.
"""

import ctypes
import hashlib
import random
import shutil
import time
from pathlib import Path

import pytest

from spacemesh_tpu.core import hashing as jhashing
from spacemesh_tpu.core import signing as jsig
from spacemesh_tpu_torch import native
from spacemesh_tpu_torch.core import hashing as thashing
from spacemesh_tpu_torch.core import signing as tsig

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "spacemesh_tpu_torch"

SIZES = [0, 1, 31, 32, 63, 64, 65, 127, 128, 512, 1023, 1024, 1025,
         2048, 3072, 4096, 5000, 16384, 31744, 65536 + 17]


@pytest.fixture(scope="module")
def libs():
    """Both port libraries, loaded (g++ is in this repo's toolchain)."""
    b3, vrf = native.load("blake3"), tsig._native_vrf()
    assert b3 is not None, native.status()["blake3"]
    assert vrf is not None, native.status()["ecvrf"]
    return b3, vrf


def _python_hash(data: bytes, key=None, length=32) -> bytes:
    return thashing.Hasher(key=key).update(data).digest(length)


def _seeded(size: int, seed: int) -> bytes:
    rng = random.Random(seed)
    data = bytes(rng.randrange(256) for _ in range(min(size, 4096)))
    return (data * (size // max(len(data), 1) + 1))[:size]


@pytest.mark.parametrize("size", SIZES)
def test_blake3_native_python_jax_across_tree_shapes(libs, size):
    data = _seeded(size, 42 + size)
    got = thashing._hash_oneshot(data, None, 32)
    assert got == _python_hash(data)
    assert got == jhashing._hash_oneshot(data, None, 32)
    assert got == jhashing.Hasher().update(data).digest(32)


@pytest.mark.parametrize("size", [0, 65, 1024, 4097, 1 << 16, 1 << 20])
def test_blake3_keyed_and_lengths(libs, size):
    key = bytes(range(32))
    data = _seeded(size, size) if size <= 1 << 16 else b"\xab" * size
    for length in (20, 32, 64, 131):
        want = jhashing._hash_oneshot(data, key, length)
        assert thashing._hash_oneshot(data, key, length) == want, length
        if size <= 4097:  # the Python twin at 1 MiB takes seconds
            assert _python_hash(data, key=key, length=length) == want


def test_blake3_api_functions(libs):
    a, b = b"hello ", b"world" * 300
    key = b"k" * 32
    assert thashing.sum256(a, b) == jhashing.sum256(a, b) == \
        _python_hash(a + b)
    assert thashing.sum160(a, b) == jhashing.sum160(a, b) == \
        _python_hash(a + b, length=20)
    assert thashing.keyed(key, a, b) == jhashing.keyed(key, a, b) == \
        _python_hash(a + b, key=key)
    with pytest.raises(ValueError):
        thashing.keyed(b"short", a)


def test_blake3_native_is_the_faster_path(libs, monkeypatch):
    data = b"x" * 512
    t0 = time.perf_counter()
    for _ in range(2000):
        thashing.sum256(data)
    fast = 2000 / (time.perf_counter() - t0)
    monkeypatch.setattr(thashing, "_native", False)
    t0 = time.perf_counter()
    for _ in range(40):
        thashing.sum256(data)
    slow = 40 / (time.perf_counter() - t0)
    assert fast > 10 * slow, (fast, slow)


def test_counters_name_the_path(libs, monkeypatch):
    native.zero_counts()
    thashing.sum256(b"a")
    thashing.keyed(bytes(32), b"b")
    seed = hashlib.sha256(b"counted").digest()
    signer = tsig.VrfSigner(seed)          # public key
    proof = signer.prove(b"alpha")
    tsig.vrf_output(proof)
    assert tsig.VrfVerifier().verify(signer.public_key, b"alpha", proof)
    assert native.counts() == {"blake3": {"native": 2, "python": 0},
                               "vrf": {"native": 4, "python": 0}}
    monkeypatch.setattr(thashing, "_native", False)
    monkeypatch.setattr(tsig, "_NATIVE_VRF", None)
    native.zero_counts()
    assert thashing.sum256(b"a") == jhashing.sum256(b"a")
    py = tsig.VrfSigner(seed)
    assert py.prove(b"alpha") == proof
    assert tsig.vrf_output(proof) == jsig.vrf_output(proof)
    assert tsig.VrfVerifier().verify(signer.public_key, b"alpha", proof)
    assert native.counts() == {"blake3": {"native": 0, "python": 1},
                               "vrf": {"native": 0, "python": 4}}


def test_loaded_libraries_are_the_ports_own(libs):
    st = native.status()
    for name in native.NAMES:
        assert st[name]["loaded"] and st[name]["why"] == "loaded", st
        path = Path(st[name]["path"]).resolve()
        assert path.is_relative_to(PORT / "build"), path
        assert path == native.library_path(name).resolve()
        assert path.name.startswith(f"libsmtpu_{name}-")
    for lib in libs:
        here = Path(lib._name).resolve()
        assert here.is_relative_to(PORT)
        assert not here.is_relative_to(REPO / "spacemesh_tpu" / "native")


def test_stale_source_rebuilds_into_a_new_name(tmp_path):
    src, out = tmp_path / "src", tmp_path / "build"
    src.mkdir()
    shutil.copy(native.SRC / "blake3.cpp", src / "blake3.cpp")
    first = native.build("blake3", src_dir=src, build_dir=out)
    assert first.exists() and first.parent == out
    assert native.build("blake3", src_dir=src, build_dir=out) == first
    with open(src / "blake3.cpp", "a") as f:
        f.write("\n// edited\n")
    second = native.build("blake3", src_dir=src, build_dir=out)
    assert second != first and second.exists() and first.exists()
    assert not list(out.glob("*.tmp.*"))
    lib = ctypes.CDLL(str(second))
    lib.smtpu_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_size_t]
    buf = ctypes.create_string_buffer(32)
    lib.smtpu_blake3(b"abc", 3, None, buf, 32)
    assert buf.raw == jhashing.sum256(b"abc")


def test_failed_build_raises_and_the_twin_answers(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "blake3.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("blake3", src_dir=src, build_dir=tmp_path / "b")
    assert not list((tmp_path / "b").glob("*"))

    def broken(name, *a, **kw):
        raise RuntimeError("g++ failed for native/blake3.cpp (rc=1): boom")

    monkeypatch.delitem(native._LIBS, "blake3", raising=False)
    monkeypatch.setitem(native._STATUS, "blake3", {})
    monkeypatch.setattr(native, "build", broken)
    monkeypatch.setattr(thashing, "_native", None)
    native.zero_counts()
    assert thashing.sum256(b"fallback") == jhashing.sum256(b"fallback")
    st = native.status()["blake3"]
    assert not st["loaded"] and st["path"] is None and "boom" in st["why"]
    assert native.counts()["blake3"] == {"native": 0, "python": 1}
    monkeypatch.undo()
    assert native.load("blake3") is not None


def test_no_native_vrf_env_is_honoured(monkeypatch):
    seed = hashlib.sha256(b"opt-out").digest()
    native_proof = tsig.VrfSigner(seed).prove(b"x")
    monkeypatch.setenv("SPACEMESH_NO_NATIVE_VRF", "1")
    monkeypatch.setattr(tsig, "_NATIVE_VRF", tsig._NATIVE_VRF_UNSET)
    monkeypatch.setitem(native._STATUS, "ecvrf", {})
    assert tsig._native_vrf() is None
    st = native.status()["ecvrf"]
    assert not st["loaded"] and "SPACEMESH_NO_NATIVE_VRF" in st["why"]
    native.zero_counts()
    assert tsig.VrfSigner(seed).prove(b"x") == native_proof
    assert native.counts()["vrf"] == {"native": 0, "python": 2}


# --- ECVRF: native == port Python == JAX -------------------------------


@pytest.mark.parametrize("trial", range(12))
def test_vrf_differential_prove_verify_output(libs, monkeypatch, trial):
    """Proofs are deterministic (RFC 9381 TAI nonce): the port's native
    path, its Python path and the JAX package's give identical bytes and
    verify each other's proofs."""
    rng = random.Random(0xECF + trial)
    seed = hashlib.sha256(b"dvrf-%d" % trial).digest()
    alpha = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 100)))
    signer = tsig.VrfSigner(seed)
    proof = signer.prove(alpha)
    out = tsig.vrf_output(proof)
    jsigner = jsig.VrfSigner(seed)
    assert signer.public_key == jsigner.public_key
    assert proof == jsigner.prove(alpha)
    assert out == jsig.vrf_output(proof)
    assert tsig.VrfVerifier().verify(signer.public_key, alpha, proof)
    assert jsig.VrfVerifier().verify(signer.public_key, alpha, proof)
    monkeypatch.setattr(tsig, "_NATIVE_VRF", None)
    monkeypatch.setattr(jsig, "_NATIVE_VRF", None)
    py = tsig.VrfSigner(seed)
    assert py.public_key == signer.public_key
    assert py.prove(alpha) == proof == jsig.VrfSigner(seed).prove(alpha)
    assert tsig.vrf_output(proof) == out
    assert tsig.VrfVerifier().verify(signer.public_key, alpha, proof)


def _python_verify(pk, alpha, proof):
    saved = tsig._NATIVE_VRF
    tsig._NATIVE_VRF = None
    try:
        return tsig.VrfVerifier().verify(pk, alpha, proof)
    finally:
        tsig._NATIVE_VRF = saved


@pytest.mark.parametrize("seed_n", range(4))
def test_vrf_rejections_agree(libs, seed_n):
    """Bit flips anywhere in pk/proof/alpha: the port's native and Python
    verifiers and the JAX package's give one verdict."""
    seed = hashlib.sha256(b"rej-%d" % seed_n).digest()
    signer = tsig.VrfSigner(seed)
    alpha = b"alpha-rejections"
    proof = signer.prove(alpha)
    pk = signer.public_key
    rng = random.Random(7 + seed_n)
    for _ in range(10):
        what = rng.randrange(3)
        p, k, a = bytearray(proof), bytearray(pk), bytearray(alpha)
        if what == 0:
            p[rng.randrange(len(p))] ^= 1 << rng.randrange(8)
        elif what == 1:
            k[rng.randrange(len(k))] ^= 1 << rng.randrange(8)
        else:
            a[rng.randrange(len(a))] ^= 1 << rng.randrange(8)
        k, a, p = bytes(k), bytes(a), bytes(p)
        nat = tsig.VrfVerifier().verify(k, a, p)
        assert nat == _python_verify(k, a, p) == \
            jsig.VrfVerifier().verify(k, a, p), what
        assert not nat


def test_vrf_edges_rejected_alike(libs):
    seed = hashlib.sha256(b"srange").digest()
    signer = tsig.VrfSigner(seed)
    proof = signer.prove(b"a")
    pk = signer.public_key
    for bad_pk, bad in ((pk, proof[:48] + b"\xff" * 32),   # s >= q
                        (pk, b"\xff" * 32 + proof[32:]),   # gamma off-curve
                        (b"\xff" * 32, proof),             # pk off-curve
                        (pk, proof[:79]), (pk[:31], proof)):
        assert not tsig.VrfVerifier().verify(bad_pk, b"a", bad)
        assert not _python_verify(bad_pk, b"a", bad)
        assert not jsig.VrfVerifier().verify(bad_pk, b"a", bad)
    with pytest.raises(ValueError):
        tsig.vrf_output(b"\xff" * 80)
    with pytest.raises(ValueError):
        jsig.vrf_output(b"\xff" * 80)


def test_vrf_native_is_the_faster_path(libs):
    seed = hashlib.sha256(b"perf").digest()
    signer = tsig.VrfSigner(seed)
    proof = signer.prove(b"perf-alpha")
    v = tsig.VrfVerifier()
    t0 = time.perf_counter()
    for _ in range(60):
        assert v.verify(signer.public_key, b"perf-alpha", proof)
    fast = 60 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(3):
        assert _python_verify(signer.public_key, b"perf-alpha", proof)
    slow = 3 / (time.perf_counter() - t0)
    assert fast > 5 * slow, (fast, slow)
