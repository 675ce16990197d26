"""Hare wire messages (port of the message types of
``spacemesh_tpu/consensus/hare.py``).

Only :class:`HareMessage` and :class:`CompactHareMessage` so far, with the
JAX package's fields and codecs: malfeasance decodes them to hold two
signed hare messages to one protocol slot (``consensus/malfeasance.py``).
The protocol (sessions, rounds, the graded core of ``hare3.py``) goes
with the rest of ``consensus/*``.
"""

from __future__ import annotations

import dataclasses

from ..core import codec
from ..core.codec import fixed, u8, u16, u32, vec

@codec.register
class HareMessage:
    layer: int
    iteration: int
    round: int
    values: list[bytes]          # proposal ids (sorted)
    eligibility_proof: bytes     # VRF
    eligibility_count: int
    atx_id: bytes
    node_id: bytes
    # NOTIFY only: the commit certificate — encoded COMMIT messages whose
    # summed seats reach the threshold (reference hare carries commit
    # certificates so nodes that missed the commits still accept)
    cert_msgs: list[bytes]
    signature: bytes

    FIELDS = [("layer", u32), ("iteration", u8), ("round", u8),
              ("values", vec(fixed(32), 1 << 12)),
              ("eligibility_proof", fixed(80)), ("eligibility_count", u16),
              ("atx_id", fixed(32)), ("node_id", fixed(32)),
              ("cert_msgs", vec(codec.var_bytes, 1 << 11)),
              ("signature", fixed(64))]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()


COMPACT_ID_SIZE = 4


@codec.register
class CompactHareMessage:
    """hare4-style compaction (reference hare4/types.go + hare.go:328):
    messages carry 4-byte proposal-id prefixes plus a root over the full
    ids; receivers reconstruct from their proposal store and fall back to
    a full exchange (hf/1) with the delivering peer on a miss. The
    signature covers THIS compact form; the root binds the full values."""

    layer: int
    iteration: int
    round: int
    compact_ids: list[bytes]     # 4-byte prefixes of sorted proposal ids
    root: bytes                  # hash over the full sorted ids
    eligibility_proof: bytes
    eligibility_count: int
    atx_id: bytes
    node_id: bytes
    cert_msgs: list[bytes]       # NOTIFY: encoded COMPACT commit messages
    signature: bytes

    FIELDS = [("layer", u32), ("iteration", u8), ("round", u8),
              ("compact_ids", vec(fixed(COMPACT_ID_SIZE), 1 << 12)),
              ("root", fixed(32)),
              ("eligibility_proof", fixed(80)), ("eligibility_count", u16),
              ("atx_id", fixed(32)), ("node_id", fixed(32)),
              ("cert_msgs", vec(codec.var_bytes, 1 << 11)),
              ("signature", fixed(64))]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()
