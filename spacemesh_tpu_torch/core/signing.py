"""Identity signatures and VRF.

Mirrors the reference signing package (reference signing/signer.go:157
EdSigner with domain separation + genesis-prefix, signing/verifier.go
EdVerifier, signing/vrf.go ECVRF via curve25519-voi):

- EdSigner/EdVerifier: ed25519 (via the `cryptography` library) over
  ``prefix || domain_byte || message`` where prefix is the genesis id —
  signatures from different networks or domains never collide.
- VrfSigner/VrfVerifier: ECVRF-EDWARDS25519-SHA512-TAI (RFC 9381 suite
  0x03), implemented from spec in pure Python (curve arithmetic below).
  The VRF output (beta) drives eligibility sampling and the beacon's weak
  coin, so it must be a *proof* (unique, verifiable), not a bare signature.

Port of ``spacemesh_tpu/core/signing.py``, with the same rule for ed25519:
OpenSSL through ``cryptography`` where it imports, the RFC 8032
pure-Python path (cofactored, with the Pippenger batch check) where it
does not. As in the JAX package, the VRF's public key, prove, output and
verify go through the native twin (``native/ecvrf.cpp``, the port's own
copy, about 20x the Python rate) when it builds; the Python
implementation is the fallback AND the test oracle
(``tests/test_torch_native.py`` holds the two bit-identical). Set
``SPACEMESH_NO_NATIVE_VRF=1`` to force the Python path;
``native.counts()["vrf"]`` says which path answered each call.
"""

from __future__ import annotations

import enum
import hashlib
import os

from .. import native as _native

try:  # the fast path: OpenSSL ed25519 via pyca/cryptography
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.exceptions import InvalidSignature

    _HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:  # pure-Python ed25519 over the VRF's curve
    # code below (RFC 8032); containers without `cryptography` must not
    # lose the whole identity layer
    _HAVE_CRYPTOGRAPHY = False

PUBLIC_KEY_SIZE = 32
PRIVATE_KEY_SIZE = 64  # seed || public, like the reference's ed25519
SIGNATURE_SIZE = 64
VRF_PROOF_SIZE = 80
VRF_OUTPUT_SIZE = 64


class Domain(enum.IntEnum):
    """Signature domains (reference signing/signer.go:18-38)."""

    ATX = 0
    BEACON_FIRST_MSG = 1
    BEACON_FOLLOWUP_MSG = 2
    BALLOT = 3
    HARE = 4
    POET = 5
    BEACON_PROPOSAL = 6
    MALFEASANCE = 7
    TX = 8               # this framework's tx envelope (vm/vm.py)
    CERTIFY = 9
    TRANSPORT = 10       # p2p channel-binding signature (p2p/noise.py)
    POET_CERT = 11       # poet certifier certificates (consensus/certifier.py)


# --- ed25519 identity signatures -----------------------------------------


class EdSigner:
    def __init__(self, seed: bytes | None = None, prefix: bytes = b""):
        if seed is None:
            seed = os.urandom(32)
        elif len(seed) not in (32, 64):
            raise ValueError("seed must be 32 (seed) or 64 (seed||pub) bytes")
        self._seed = seed[:32]
        self.prefix = prefix
        if _HAVE_CRYPTOGRAPHY:
            self._sk = Ed25519PrivateKey.from_private_bytes(self._seed)
            from cryptography.hazmat.primitives import serialization

            self._pub = self._sk.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        else:
            self._sk = None
            self._scalar, self._nonce_prefix = _expand_key(self._seed)
            self._pub = _pt_encode(_pt_mul_base(self._scalar))

    @property
    def node_id(self) -> bytes:
        return self._pub

    @property
    def public_key(self) -> bytes:
        return self._pub

    def private_bytes(self) -> bytes:
        return self._seed + self._pub

    def sign(self, domain: Domain, msg: bytes) -> bytes:
        data = self.prefix + bytes([domain]) + msg
        if self._sk is not None:
            return self._sk.sign(data)
        # RFC 8032 EdDSA over the VRF's curve arithmetic
        r = int.from_bytes(
            hashlib.sha512(self._nonce_prefix + data).digest(),
            "little") % _Q
        r_enc = _pt_encode(_pt_mul_base(r))
        k = int.from_bytes(
            hashlib.sha512(r_enc + self._pub + data).digest(),
            "little") % _Q
        s = (r + k * self._scalar) % _Q
        return r_enc + s.to_bytes(32, "little")

    def vrf_signer(self) -> "VrfSigner":
        return VrfSigner(self._seed, self._pub)


class EdVerifier:
    def __init__(self, prefix: bytes = b""):
        self.prefix = prefix

    def verify(self, domain: Domain, public_key: bytes, msg: bytes,
               sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE or len(public_key) != PUBLIC_KEY_SIZE:
            return False
        data = self.prefix + bytes([domain]) + msg
        if _HAVE_CRYPTOGRAPHY:
            try:
                Ed25519PublicKey.from_public_bytes(public_key).verify(
                    sig, data)
                return True
            except (InvalidSignature, ValueError):
                return False
        return _ed_verify_cached(public_key, data, sig)

    def verify_many(self, items) -> list[bool]:
        """Batch-verify ``(domain, public_key, msg, sig)`` tuples —
        decisions identical to per-item verify(), but one random-linear-
        combination multi-scalar check instead of N ladders (the
        verification farm's sig backend; see ed25519_batch_verify)."""
        return ed25519_batch_verify([
            (pk, self.prefix + bytes([dom]) + msg, sig)
            for dom, pk, msg, sig in items])


# --- edwards25519 arithmetic (for the VRF) --------------------------------

_P = 2**255 - 19
_Q = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


# extended homogeneous coordinates (X, Y, Z, T), x*y == z*t
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
_B = (_BX, _BY, 1, (_BX * _BY) % _P)
_ID = (0, 1, 1, 0)


def _pt_add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % _P
    b = ((y1 + x1) * (y2 + x2)) % _P
    c = (2 * t1 * t2 * _D) % _P
    dd = (2 * z1 * z2) % _P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return ((e * f) % _P, (g * h) % _P, (f * g) % _P, (e * h) % _P)


def _pt_mul(s: int, p):
    out = _ID
    while s:
        if s & 1:
            out = _pt_add(out, p)
        p = _pt_add(p, p)
        s >>= 1
    return out


_B_DOUBLES: list | None = None


def _pt_mul_base(s: int):
    """s*B via a cached table of B's doublings — the ed25519 fallback
    signs/verifies against the base point constantly; halving the adds
    matters when this is the only ed25519 in the container."""
    global _B_DOUBLES
    if _B_DOUBLES is None:
        table, p = [], _B
        for _ in range(256):
            table.append(p)
            p = _pt_add(p, p)
        _B_DOUBLES = table
    out = _ID
    i = 0
    while s:
        if s & 1:
            out = _pt_add(out, _B_DOUBLES[i])
        s >>= 1
        i += 1
    return out


def _mul8(p):
    """8*P via three doublings (the unified add formula doubles too)."""
    p = _pt_add(p, p)
    p = _pt_add(p, p)
    return _pt_add(p, p)


def _ed_check(a_pt, r_pt, s: int, k: int) -> bool:
    """The COFACTORED verification equation: 8*(s*B) == 8*(R + k*A)
    (ZIP-215 / ed25519consensus style, except encodings stay canonical).

    Cofactored — not RFC 8032's cofactorless s*B == R + k*A — because
    the batch path must be decision-identical to this check: under the
    cofactorless equation an adversarial signature whose R carries a
    small-order torsion component fails per-item but slips through a
    random-linear-combination batch with probability ~1/8 (z_i ≡ 0
    mod 8 annihilates the defect), so batch acceptance would not imply
    per-item acceptance. Multiplying by the cofactor maps every term
    into the prime-order subgroup, where the random 128-bit z_i make
    batch and per-item verdicts agree except with probability 2^-128.
    Honest signatures (torsion-free R, A) verify identically under both
    equations; only adversarial small-order components see the OpenSSL
    path (cofactorless) diverge — and mixed-backend networks already
    require a uniform suite (see p2p/noise.py's module note).

    8*(s*B) folds to (8s mod Q)*B since B generates the prime-order
    subgroup; R and k*A may carry torsion, so the right side must
    double the POINT three times.
    """
    return _pt_eq(_pt_mul_base(8 * s % _Q),
                  _mul8(_pt_add(r_pt, _pt_mul(k, a_pt))))


def _ed_verify_py(public_key: bytes, data: bytes, sig: bytes) -> bool:
    """Pure-Python ed25519 verify (cofactored — see _ed_check)."""
    a_pt = _pt_decode(public_key)
    r_pt = _pt_decode(sig[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _Q:
        return False
    k = int.from_bytes(
        hashlib.sha512(sig[:32] + public_key + data).digest(),
        "little") % _Q
    return _ed_check(a_pt, r_pt, s, k)


def _pt_neg(p):
    return ((-p[0]) % _P, p[1], p[2], (-p[3]) % _P)


# verdict LRU for the pure-Python path: a multi-identity node (and the
# in-proc multinode tests) verifies the SAME gossip signature once per
# consumer; at ~3 ms per Python ladder that repeat work dominates. The
# reference caches verified objects by id for the same reason. OpenSSL
# (~50 us) skips this — the cache churn would cost more than it saves.
_VERIFY_CACHE: dict = {}
_VERIFY_CACHE_MAX = 8192
_VERIFY_CACHE_LOCK = None  # created lazily; farm backends run in threads


def _cache_put(key: bytes, ok: bool) -> None:
    global _VERIFY_CACHE_LOCK
    if _VERIFY_CACHE_LOCK is None:
        import threading

        _VERIFY_CACHE_LOCK = threading.Lock()
    with _VERIFY_CACHE_LOCK:
        if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:
            # dicts iterate in insertion order: evict the oldest half
            for k in list(_VERIFY_CACHE)[:_VERIFY_CACHE_MAX // 2]:
                del _VERIFY_CACHE[k]
        _VERIFY_CACHE[key] = ok


def _ed_verify_cached(public_key: bytes, data: bytes, sig: bytes) -> bool:
    key = hashlib.sha256(public_key + sig + data).digest()
    hit = _VERIFY_CACHE.get(key)  # GIL-atomic read; misses just recompute
    if hit is not None:
        return hit
    ok = _ed_verify_py(public_key, data, sig)
    _cache_put(key, ok)
    return ok


def clear_verify_cache() -> None:
    """Drop cached ed25519 verdicts (benchmarks comparing verification
    paths must not let one path's warm cache subsidize the other)."""
    _VERIFY_CACHE.clear()


def _msm(pairs):
    """Multi-scalar multiplication Σ s_i·P_i (Pippenger buckets):
    ~(N + 2^c) point adds per window instead of N full ladders — the
    reason batch verification beats N serial verifies. Window width c
    adapts to the point count so small groups don't pay a 256-bucket
    constant."""
    n = len(pairs)
    c = max(2, min(8, n.bit_length() - 1))
    result = _ID
    top = ((256 + c - 1) // c) * c - c
    for w in range(top, -1, -c):
        for _ in range(c):
            result = _pt_add(result, result)
        buckets: list = [None] * (1 << c)
        for s, p in pairs:
            idx = (s >> w) & ((1 << c) - 1)
            if idx:
                b = buckets[idx]
                buckets[idx] = p if b is None else _pt_add(b, p)
        running = None
        total = None
        for i in range((1 << c) - 1, 0, -1):
            b = buckets[i]
            if b is not None:
                running = b if running is None else _pt_add(running, b)
            if running is not None:
                total = running if total is None else _pt_add(total, running)
        if total is not None:
            result = _pt_add(result, total)
    return result


def ed25519_batch_verify(items: list[tuple[bytes, bytes, bytes]]
                         ) -> list[bool]:
    """Batch-verify ``(public_key, data, signature)`` triples.

    The random-linear-combination check (the dalek/ed25519consensus
    technique): with fresh 128-bit coefficients z_i,

        8·(Σ z_i·s_i)·B  ==  8·(Σ z_i·R_i + Σ (z_i·k_i)·A_i)

    holds for an all-valid batch, and fails with probability 1-2^-128
    if ANY signature is invalid. Both sides are multiplied by the
    cofactor — and per-item verification uses the same cofactored
    equation (_ed_check) — because a cofactorLESS batch is unsound
    against torsion: a signature with a small-order defect in R passes
    the combination with probability ~1/8, so batch acceptance would
    not imply per-item acceptance. One Pippenger multi-scalar
    multiplication replaces N independent double-scalar ladders. On
    batch failure every candidate is re-checked individually, so the
    returned decisions are always EXACTLY the per-item verdicts —
    callers never observe a semantic difference, only the speed.

    With `cryptography` present, per-item OpenSSL beats the pure-Python
    MSM and is used instead (it also releases the GIL, so callers can
    chunk across threads).
    """
    results = [False] * len(items)
    cand = []  # (index, A, R, s, k, cache_key) for plausible sigs
    for i, (pk, data, sig) in enumerate(items):
        if len(sig) != SIGNATURE_SIZE or len(pk) != PUBLIC_KEY_SIZE:
            continue
        if _HAVE_CRYPTOGRAPHY:
            try:
                Ed25519PublicKey.from_public_bytes(pk).verify(sig, data)
                results[i] = True
            except (InvalidSignature, ValueError):
                pass
            continue
        key = hashlib.sha256(pk + sig + data).digest()
        hit = _VERIFY_CACHE.get(key)
        if hit is not None:  # shares the inline path's verdict LRU
            results[i] = hit
            continue
        a_pt = _pt_decode(pk)
        r_pt = _pt_decode(sig[:32])
        s = int.from_bytes(sig[32:], "little")
        if a_pt is None or r_pt is None or s >= _Q:
            continue
        k = int.from_bytes(
            hashlib.sha512(sig[:32] + pk + data).digest(), "little") % _Q
        cand.append((i, a_pt, r_pt, s, k, key))
    if _HAVE_CRYPTOGRAPHY or not cand:
        return results
    batched_ok = False
    if len(cand) >= 8:  # MSM setup overhead beats tiny batches
        zs = [int.from_bytes(os.urandom(16), "little") | (1 << 127)
              for _ in cand]
        lhs = sum(z * g[3] for z, g in zip(zs, cand)) % _Q
        pairs = []
        for z, (_, a_pt, r_pt, _, k, _key) in zip(zs, cand):
            pairs.append((z, r_pt))
            pairs.append((z * k % _Q, a_pt))
        batched_ok = _pt_eq(_pt_mul_base(8 * lhs % _Q),
                            _mul8(_msm(pairs)))
        # a failed combo means at least one invalid signature: fall
        # through to per-item checks so every caller gets its exact
        # verdict. (Bisecting instead re-verifies the clean halves with
        # fresh MSMs — for realistic contamination that costs MORE than
        # one serial pass, so the penalty is kept flat: one wasted MSM,
        # ~1.3x serial.)
    for i, a_pt, r_pt, s, k, key in cand:
        ok = batched_ok or _ed_check(a_pt, r_pt, s, k)
        results[i] = ok
        _cache_put(key, ok)
    return results


def _pt_eq(p, q) -> bool:
    # cross-multiply to compare projective points
    return ((p[0] * q[2] - q[0] * p[2]) % _P == 0
            and (p[1] * q[2] - q[1] * p[2]) % _P == 0)


def _pt_encode(p) -> bytes:
    zi = _inv(p[2])
    x = (p[0] * zi) % _P
    y = (p[1] * zi) % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _pt_decode(data: bytes):
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= _P:
        return None
    # recover x: x^2 = (y^2 - 1) / (d*y^2 + 1)
    u = (y * y - 1) % _P
    v = (_D * y * y + 1) % _P
    x = (u * v**3 % _P) * pow(u * v**7 % _P, (_P - 5) // 8, _P) % _P
    vx2 = (v * x * x) % _P
    if vx2 == u % _P:
        pass
    elif vx2 == (-u) % _P:
        x = (x * _SQRT_M1) % _P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = _P - x
    return (x, y, 1, (x * y) % _P)


# --- ECVRF-EDWARDS25519-SHA512-TAI (RFC 9381, suite 0x03) -----------------

_SUITE = b"\x03"

_NATIVE_VRF_UNSET = object()
_NATIVE_VRF = _NATIVE_VRF_UNSET


def _native_vrf():
    """libsmtpu_ecvrf handle, or None (build failure / opt-out)."""
    global _NATIVE_VRF
    if _NATIVE_VRF is _NATIVE_VRF_UNSET:
        import ctypes

        lib = None
        if os.environ.get("SPACEMESH_NO_NATIVE_VRF"):
            _native.opt_out("ecvrf", "SPACEMESH_NO_NATIVE_VRF is set")
        else:
            lib = _native.load("ecvrf")
            if lib is not None:
                for fn, args in (
                        ("smtpu_vrf_public_key", 2),
                        ("smtpu_vrf_output", 2)):
                    getattr(lib, fn).argtypes = \
                        [ctypes.c_char_p] * args
                    getattr(lib, fn).restype = ctypes.c_int
                for fn in ("smtpu_vrf_prove", "smtpu_vrf_verify"):
                    getattr(lib, fn).argtypes = [
                        ctypes.c_char_p, ctypes.c_char_p,
                        ctypes.c_size_t, ctypes.c_char_p]
                    getattr(lib, fn).restype = ctypes.c_int
        _NATIVE_VRF = lib
    return _NATIVE_VRF


def _expand_key(seed32: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed32).digest()
    x = int.from_bytes(h[:32], "little")
    x &= (1 << 254) - 8
    x |= 1 << 254
    return x, h[32:]


def _hash_to_curve_tai(y_bytes: bytes, alpha: bytes):
    ctr = 0
    while ctr < 256:
        h = hashlib.sha512(
            _SUITE + b"\x01" + y_bytes + alpha + bytes([ctr]) + b"\x00"
        ).digest()[:32]
        pt = _pt_decode(h)
        if pt is not None:
            return _pt_mul(8, pt)  # clear cofactor
        ctr += 1
    raise RuntimeError("hash_to_curve failed")  # pragma: no cover


def _challenge(points: list) -> int:
    data = _SUITE + b"\x02" + b"".join(_pt_encode(p) for p in points) + b"\x00"
    return int.from_bytes(hashlib.sha512(data).digest()[:16], "little")


class VrfSigner:
    def __init__(self, seed32: bytes, public_key: bytes | None = None):
        if len(seed32) != 32:
            raise ValueError("vrf seed must be 32 bytes")
        self._seed = seed32
        self._x, self._nonce_key = _expand_key(seed32)
        # the Python scalar mult for the public key costs ~1/4 of a full
        # Python prove, and VrfSigners are constructed per eligibility
        # check — when the native library is up it derives the key and
        # the Python point stays lazy
        self.__y = None
        lib = _native_vrf()
        if lib is not None:
            import ctypes

            buf = ctypes.create_string_buffer(32)
            if lib.smtpu_vrf_public_key(seed32, buf) == 0:
                _native.count("vrf", "native")
                self.public_key = buf.raw
            else:  # pragma: no cover - native failure
                _native.count("vrf", "python")
                self.public_key = _pt_encode(self._y_point)
        else:
            _native.count("vrf", "python")
            self.public_key = _pt_encode(self._y_point)
        if public_key is not None and public_key != self.public_key:
            raise ValueError("public key mismatch")

    @property
    def _y_point(self):
        if self.__y is None:
            self.__y = _pt_mul(self._x, _B)
        return self.__y

    def prove(self, alpha: bytes) -> bytes:
        lib = _native_vrf()
        if lib is not None:
            import ctypes

            buf = ctypes.create_string_buffer(VRF_PROOF_SIZE)
            if lib.smtpu_vrf_prove(self._seed, alpha, len(alpha),
                                   buf) == 0:
                _native.count("vrf", "native")
                return buf.raw
            # fall through to the Python twin on any native failure
        _native.count("vrf", "python")
        h_pt = _hash_to_curve_tai(self.public_key, alpha)
        h_bytes = _pt_encode(h_pt)
        gamma = _pt_mul(self._x, h_pt)
        k = int.from_bytes(
            hashlib.sha512(self._nonce_key + h_bytes).digest(), "little") % _Q
        c = _challenge([self._y_point, h_pt, gamma, _pt_mul(k, _B),
                        _pt_mul(k, h_pt)])
        s = (k + c * self._x) % _Q
        return (_pt_encode(gamma) + c.to_bytes(16, "little")
                + s.to_bytes(32, "little"))

    def sign(self, alpha: bytes) -> bytes:  # reference naming: vrf "signature"
        return self.prove(alpha)


def vrf_output(proof: bytes) -> bytes:
    """beta = proof_to_hash(pi): the uniform VRF output (64 bytes)."""
    lib = _native_vrf()
    if lib is not None and len(proof) >= 32:
        import ctypes

        _native.count("vrf", "native")
        out = ctypes.create_string_buffer(64)
        rc = lib.smtpu_vrf_output(proof[:32], out)
        if rc == 0:
            return out.raw
        raise ValueError("invalid vrf proof")
    _native.count("vrf", "python")
    gamma = _pt_decode(proof[:32])
    if gamma is None:
        raise ValueError("invalid vrf proof")
    cg = _pt_mul(8, gamma)
    return hashlib.sha512(_SUITE + b"\x03" + _pt_encode(cg) + b"\x00").digest()


class VrfVerifier:
    def verify(self, public_key: bytes, alpha: bytes, proof: bytes) -> bool:
        if len(proof) != VRF_PROOF_SIZE or len(public_key) != 32:
            return False
        lib = _native_vrf()
        if lib is not None:
            _native.count("vrf", "native")
            return bool(lib.smtpu_vrf_verify(public_key, alpha,
                                             len(alpha), proof))
        _native.count("vrf", "python")
        y = _pt_decode(public_key)
        gamma = _pt_decode(proof[:32])
        if y is None or gamma is None:
            return False
        c = int.from_bytes(proof[32:48], "little")
        s = int.from_bytes(proof[48:80], "little")
        if s >= _Q:
            return False
        h_pt = _hash_to_curve_tai(public_key, alpha)
        # U = s*B - c*Y ; V = s*H - c*Gamma
        neg = lambda p: ((-p[0]) % _P, p[1], p[2], (-p[3]) % _P)  # noqa: E731
        u = _pt_add(_pt_mul(s, _B), _pt_mul(c, neg(y)))
        v = _pt_add(_pt_mul(s, h_pt), _pt_mul(c, neg(gamma)))
        return _challenge([y, h_pt, gamma, u, v]) == c
