"""k2pow: the proof's gate, ``SHA256(challenge || node_id || le64(nonce))``
below the 32-byte big-endian difficulty; the witness is the smallest such
nonce from 0."""

from __future__ import annotations

import hashlib


def valid(challenge: bytes, node_id: bytes, difficulty: bytes,
          nonce: int) -> bool:
    digest = hashlib.sha256(challenge + node_id
                            + int(nonce).to_bytes(8, "little")).digest()
    return digest < difficulty


def smallest(challenge: bytes, node_id: bytes, difficulty: bytes,
             limit: int = 1 << 24) -> int | None:
    """The smallest valid nonce below ``limit``, or None."""
    prefix = hashlib.sha256(challenge + node_id)
    for nonce in range(limit):
        h = prefix.copy()
        h.update(nonce.to_bytes(8, "little"))
        if h.digest() < difficulty:
            return nonce
    return None
