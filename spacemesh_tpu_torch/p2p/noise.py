"""Authenticated, encrypted transport channel (noise-style; port of
``spacemesh_tpu/p2p/noise.py``, wire-identical to it).

A plaintext HELLO would carry a self-declared node id, so any peer could
impersonate any identity, poisoning per-peer scoring, bans, and gossip
attribution. The reference binds peer ids to keys via libp2p's noise
security transport (reference p2p/host.go:27-28, 306-309 — noise +
peer-id-from-pubkey; p2p/handshake/handshake.go for the cookie). This
module is the equivalent, built from
the same primitives (X25519 ECDH + ChaCha20-Poly1305 + the node's
ed25519 identity key) without the libp2p framing:

1. Both sides exchange fresh ephemeral X25519 public keys (32 raw bytes
   each way; full-duplex, no ordering deadlock).
2. ECDH -> HKDF-SHA256 (salted with the genesis id — the network cookie
   is mixed into the keys, so wrong-network peers can't even decrypt)
   yields two direction keys and a 32-byte channel-binding token.
3. Each side's first ENCRYPTED frame is the HELLO: its ed25519 public
   key (= its node id), listen port, and a signature over the channel
   binding + its role. The signature proves possession of the identity
   key for THIS channel: ids are unforgeable, and a MITM relaying the
   handshake gets keys neither side signed.
4. Every subsequent frame is ChaCha20-Poly1305 with a per-direction
   64-bit counter nonce (reordering/replay detected by AEAD failure).

Forward secrecy comes from the ephemerals; identity binding from the
signature. Equivalent guarantees to noise XX + identity payload.
"""

from __future__ import annotations

import asyncio
import struct

try:  # the fast path: OpenSSL primitives via pyca/cryptography
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    _HAVE_CRYPTOGRAPHY = True
except ModuleNotFoundError:
    # pure-Python shims (bottom of this module): exact RFC 7748 X25519
    # and RFC 5869 HKDF, plus an hashlib-based encrypt-then-MAC AEAD in
    # place of ChaCha20-Poly1305 (a pure-Python ChaCha20 is orders of
    # magnitude too slow for bulk frames). The AEAD substitution makes
    # this build WIRE-INCOMPATIBLE with OpenSSL-backed peers: a mixed
    # pair fails frame authentication and the connection closes — every
    # node in a network must run the same suite.
    _HAVE_CRYPTOGRAPHY = False

MAX_FRAME = 64 << 20


class ChannelError(Exception):
    pass


class NoiseChannel:
    """Encrypted framed stream over an asyncio reader/writer pair."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *,
                 tx_key: bytes, rx_key: bytes, binding: bytes,
                 initiator: bool):
        self.reader = reader
        self.writer = writer
        self.binding = binding
        self.initiator = initiator
        self._tx = ChaCha20Poly1305(tx_key)
        self._rx = ChaCha20Poly1305(rx_key)
        self._tx_n = 0
        self._rx_n = 0

    @classmethod
    async def establish(cls, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, *,
                        genesis_id: bytes,
                        initiator: bool) -> "NoiseChannel":
        eph = X25519PrivateKey.generate()
        e_pub = eph.public_key().public_bytes_raw()
        writer.write(e_pub)
        await writer.drain()
        peer_e = await reader.readexactly(32)
        try:
            shared = eph.exchange(X25519PublicKey.from_public_bytes(peer_e))
        except ValueError as e:  # low-order / invalid point
            raise ChannelError(f"bad ephemeral key: {e}") from None
        e_i, e_r = (e_pub, peer_e) if initiator else (peer_e, e_pub)
        okm = HKDF(algorithm=hashes.SHA256(), length=96, salt=genesis_id,
                   info=b"smh/noise/1" + e_i + e_r).derive(shared)
        k_i2r, k_r2i, binding = okm[:32], okm[32:64], okm[64:]
        tx_key, rx_key = (k_i2r, k_r2i) if initiator else (k_r2i, k_i2r)
        return cls(reader, writer, tx_key=tx_key, rx_key=rx_key,
                   binding=binding, initiator=initiator)

    def _nonce(self, counter: int) -> bytes:
        return struct.pack("<Q", counter) + bytes(4)

    def encrypt_frame(self, frame_type: int, payload: bytes) -> bytes:
        ct = self._tx.encrypt(self._nonce(self._tx_n),
                              bytes([frame_type]) + payload, b"")
        self._tx_n += 1
        return struct.pack("<I", len(ct)) + ct

    async def send(self, frame_type: int, payload: bytes) -> None:
        self.writer.write(self.encrypt_frame(frame_type, payload))
        await self.writer.drain()

    async def recv(self) -> tuple[int, bytes]:
        head = await self.reader.readexactly(4)
        (length,) = struct.unpack("<I", head)
        if not 17 <= length <= MAX_FRAME:  # 1 type byte + 16 tag minimum
            raise ChannelError(f"bad frame length {length}")
        ct = await self.reader.readexactly(length)
        try:
            pt = self._rx.decrypt(self._nonce(self._rx_n), ct, b"")
        except Exception:  # InvalidTag — tampered/replayed/wrong-key
            raise ChannelError("frame authentication failed") from None
        self._rx_n += 1
        return pt[0], pt[1:]

    def sign_binding(self, signer, role_initiator: bool) -> bytes:
        """Channel-binding signature: proves the identity key holder is
        live on THIS channel in THIS role (role byte stops reflection)."""
        from ..core.signing import Domain

        return signer.sign(Domain.TRANSPORT,
                           self.binding + (b"i" if role_initiator else b"r"))

    def verify_binding(self, verifier, node_id: bytes, sig: bytes,
                       role_initiator: bool) -> bool:
        from ..core.signing import Domain

        return verifier.verify(
            Domain.TRANSPORT, node_id,
            self.binding + (b"i" if role_initiator else b"r"), sig)


# --- pure-Python fallbacks (no `cryptography` in the container) -----------

if not _HAVE_CRYPTOGRAPHY:
    import hashlib
    import hmac as _hmac
    import os as _os

    _P25519 = 2**255 - 19
    _A24 = 121665

    def _x25519(k_bytes: bytes, u_bytes: bytes) -> bytes:
        """RFC 7748 X25519 (Montgomery ladder, section 5)."""
        k = int.from_bytes(k_bytes, "little")
        k &= (1 << 254) - 8
        k |= 1 << 254
        x1 = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
        p = _P25519
        x2, z2, x3, z3 = 1, 0, x1, 1
        swap = 0
        for t in range(254, -1, -1):
            kt = (k >> t) & 1
            if swap ^ kt:
                x2, x3 = x3, x2
                z2, z3 = z3, z2
            swap = kt
            a = (x2 + z2) % p
            aa = a * a % p
            b = (x2 - z2) % p
            bb = b * b % p
            e = (aa - bb) % p
            c = (x3 + z3) % p
            d = (x3 - z3) % p
            da = d * a % p
            cb = c * b % p
            x3 = (da + cb) % p
            x3 = x3 * x3 % p
            z3 = x1 * pow(da - cb, 2, p) % p
            x2 = aa * bb % p
            z2 = e * ((aa + _A24 * e) % p) % p
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        return (x2 * pow(z2, p - 2, p) % p).to_bytes(32, "little")

    class X25519PublicKey:  # noqa: F811 — fallback twin
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
            if len(raw) != 32:
                raise ValueError("x25519 public keys are 32 bytes")
            return cls(raw)

        def public_bytes_raw(self) -> bytes:
            return self._raw

    class X25519PrivateKey:  # noqa: F811 — fallback twin
        def __init__(self, raw: bytes):
            self._raw = raw

        @classmethod
        def generate(cls) -> "X25519PrivateKey":
            return cls(_os.urandom(32))

        def public_key(self) -> "X25519PublicKey":
            return X25519PublicKey(
                _x25519(self._raw, (9).to_bytes(32, "little")))

        def exchange(self, peer: "X25519PublicKey") -> bytes:
            out = _x25519(self._raw, peer._raw)
            if out == bytes(32):  # low-order point: contributory check
                raise ValueError("x25519 shared secret is all zeros")
            return out

    class hashes:  # noqa: F811, N801 — just enough HKDF surface
        class SHA256:
            pass

    class HKDF:  # noqa: F811 — RFC 5869 with SHA-256
        def __init__(self, *, algorithm, length: int, salt: bytes,
                     info: bytes):
            self._length = length
            self._salt = salt or bytes(32)
            self._info = info

        def derive(self, ikm: bytes) -> bytes:
            prk = _hmac.new(self._salt, ikm, hashlib.sha256).digest()
            okm = b""
            t = b""
            i = 1
            while len(okm) < self._length:
                t = _hmac.new(prk, t + self._info + bytes([i]),
                              hashlib.sha256).digest()
                okm += t
                i += 1
            return okm[:self._length]

    class ChaCha20Poly1305:  # noqa: F811 — SHA256-CTR + HMAC substitute
        """Encrypt-then-MAC AEAD from hashlib/hmac (NOT ChaCha20: see
        the module-import note on wire compatibility). Keystream blocks
        are SHA256(key || nonce || counter); the 16-byte tag is
        HMAC-SHA256(mac_key, nonce || len(aad) || aad || ct) truncated
        — the aad length prefix frames the MAC input (mirroring
        Poly1305's aad/ct length block), so distinct (aad, ct) splits
        of one byte string never authenticate identically."""

        TAG = 16

        def __init__(self, key: bytes):
            self._enc = key
            self._mac = hashlib.sha256(b"smh/fallback-mac" + key).digest()

        def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
            aad = aad or b""
            return _hmac.new(
                self._mac,
                nonce + len(aad).to_bytes(8, "little") + aad + ct,
                hashlib.sha256).digest()[:self.TAG]

        def _stream(self, nonce: bytes, n: int) -> bytes:
            out = bytearray()
            ctr = 0
            while len(out) < n:
                out += hashlib.sha256(
                    self._enc + nonce + ctr.to_bytes(8, "little")).digest()
                ctr += 1
            return bytes(out[:n])

        def _xor(self, nonce: bytes, data: bytes) -> bytes:
            n = len(data)
            ks = int.from_bytes(self._stream(nonce, n), "little")
            return (int.from_bytes(data, "little") ^ ks).to_bytes(
                n, "little")

        def encrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
            ct = self._xor(nonce, data)
            return ct + self._tag(nonce, aad, ct)

        def decrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
            if len(data) < self.TAG:
                raise ValueError("ciphertext too short")
            ct, tag = data[:-self.TAG], data[-self.TAG:]
            if not _hmac.compare_digest(tag, self._tag(nonce, aad, ct)):
                raise ValueError("InvalidTag")
            return self._xor(nonce, ct)
