"""verifyd wire protocol: JSON docs <-> farm request objects (port of
``spacemesh_tpu/verifyd/protocol.py``, the same docs).

One codec shared by the HTTP front-end, the gRPC front-end (which
carries the same JSON docs as message bytes, with hand-wired method
handlers) and the client library. It is also how requests cross between
the two packages: a JAX request's doc decodes into the port's request
with an equal ``key()``, and the reverse. Byte fields travel as hex;
every decode error raises :class:`ProtocolError` with a path-qualified
message so a client sees WHICH field was malformed, never a bare 500.

Request doc shapes (``kind`` selects):

  sig        {"kind": "sig", "domain": int, "public_key": hex,
              "msg": hex, "signature": hex}
  vrf        {"kind": "vrf", "public_key": hex, "alpha": hex,
              "proof": hex}
  membership {"kind": "membership", "member": hex, "root": hex,
              "leaf_count": int,
              "proof": {"leaf_index": int, "nodes": [hex]}}
  pow        {"kind": "pow", "challenge": hex, "node_id": hex,
              "difficulty": hex, "nonce": int}
  post       {"kind": "post", "challenge": hex, "node_id": hex,
              "commitment": hex, "scrypt_n": int, "total_labels": int,
              "proof": {"nonce": int, "indices": [int],
                        "pow_nonce": int, "k2": int}}

A verify call: {"client": id, "lane": "block"|"gossip"|"sync",
"deadline_s": seconds | null, "items": [request docs]}.  A shed
response: {"status": "SHED", "reason": ..., "detail": ...,
"retry_after_s": seconds | null}: typed, never a silent drop.
"""

from __future__ import annotations

from ..verify.farm import (
    Lane,
    MembershipRequest,
    PostRequest,
    PowRequest,
    SigRequest,
    VrfRequest,
)

LANES = {"block": Lane.BLOCK, "gossip": Lane.GOSSIP, "sync": Lane.SYNC}

# typed shed reasons (admission policy in service.py)
SHED_RATE = "rate"                    # token bucket empty
SHED_QUOTA = "quota"                  # scheduler per-tenant max_queued
SHED_OVERLOAD = "overload"            # client above fair share at the bound
SHED_QUEUE_FULL = "queue_full"        # global pending bound, client in share
SHED_DEADLINE = "deadline"            # predicted wait exceeds the deadline
SHED_UNREGISTERED = "unregistered"
SHED_REGISTRY_FULL = "registry_full"  # max_clients reached
SHED_SHUTTING_DOWN = "shutting_down"

SHED_REASONS = (SHED_RATE, SHED_QUOTA, SHED_OVERLOAD, SHED_QUEUE_FULL,
                SHED_DEADLINE, SHED_UNREGISTERED, SHED_REGISTRY_FULL,
                SHED_SHUTTING_DOWN)


class ProtocolError(ValueError):
    """Malformed request doc (field-qualified message)."""


def _hex(b: bytes) -> str:
    return b.hex()


def _unhex(doc: dict, field: str, length: int | None = None) -> bytes:
    raw = doc.get(field)
    if not isinstance(raw, str):
        raise ProtocolError(f"{field}: expected a hex string")
    try:
        b = bytes.fromhex(raw)
    except ValueError:
        raise ProtocolError(f"{field}: not valid hex") from None
    if length is not None and len(b) != length:
        raise ProtocolError(f"{field}: expected {length} bytes, "
                            f"got {len(b)}")
    return b


def _int(doc: dict, field: str) -> int:
    v = doc.get(field)
    if not isinstance(v, int) or isinstance(v, bool):
        raise ProtocolError(f"{field}: expected an integer")
    return v


def _u64(doc: dict, field: str) -> int:
    """A remote-supplied u64 (nonces): JSON ints are unbounded, and an
    out-of-range value must be a typed 400 at the protocol boundary —
    deep inside the farm it would raise mid-batch and poison every
    co-batched client's dispatch."""
    v = _int(doc, field)
    if not 0 <= v < 1 << 64:
        raise ProtocolError(f"{field}: expected an unsigned 64-bit "
                            f"integer")
    return v


def parse_lane(name) -> Lane:
    if name is None:
        return Lane.GOSSIP
    lane = LANES.get(str(name).lower())
    if lane is None:
        raise ProtocolError(
            f"lane: expected one of {sorted(LANES)}, got {name!r}")
    return lane


def request_from_doc(doc) -> object:
    """One wire doc -> the farm request object it describes."""
    if not isinstance(doc, dict):
        raise ProtocolError("item: expected an object")
    kind = doc.get("kind")
    if kind == "sig":
        return SigRequest(_int(doc, "domain"),
                          _unhex(doc, "public_key"),
                          _unhex(doc, "msg"), _unhex(doc, "signature"))
    if kind == "vrf":
        return VrfRequest(_unhex(doc, "public_key"),
                          _unhex(doc, "alpha"), _unhex(doc, "proof"))
    if kind == "membership":
        from ..core.types import MerkleProof

        p = doc.get("proof")
        if not isinstance(p, dict) or not isinstance(p.get("nodes"), list):
            raise ProtocolError(
                "proof: expected {leaf_index, nodes: [hex]}")
        nodes = [_unhex({"node": n}, "node") for n in p["nodes"]]
        return MembershipRequest(
            _unhex(doc, "member"),
            MerkleProof(leaf_index=_int(p, "leaf_index"), nodes=nodes),
            _unhex(doc, "root"), _int(doc, "leaf_count"))
    if kind == "pow":
        return PowRequest(_unhex(doc, "challenge", 32),
                          _unhex(doc, "node_id", 32),
                          _unhex(doc, "difficulty", 32),
                          _u64(doc, "nonce"))
    if kind == "post":
        from ..post.prover import Proof
        from ..post.verifier import VerifyItem

        p = doc.get("proof")
        if not isinstance(p, dict) or not isinstance(p.get("indices"),
                                                     list):
            raise ProtocolError(
                "proof: expected {nonce, indices, pow_nonce, k2}")
        if not all(isinstance(i, int) and not isinstance(i, bool)
                   for i in p["indices"]):
            raise ProtocolError("proof.indices: expected integers")
        return PostRequest(VerifyItem(
            proof=Proof(nonce=_int(p, "nonce"),
                        indices=list(p["indices"]),
                        pow_nonce=_u64(p, "pow_nonce"),
                        k2=_int(p, "k2")),
            challenge=_unhex(doc, "challenge"),
            node_id=_unhex(doc, "node_id"),
            commitment=_unhex(doc, "commitment"),
            scrypt_n=_int(doc, "scrypt_n"),
            total_labels=_int(doc, "total_labels")))
    raise ProtocolError(f"kind: unknown request kind {kind!r}")


def request_to_doc(req) -> dict:
    """A farm request object -> its wire doc (the client half)."""
    if isinstance(req, SigRequest):
        return {"kind": "sig", "domain": req.domain,
                "public_key": _hex(req.public_key),
                "msg": _hex(req.msg), "signature": _hex(req.signature)}
    if isinstance(req, VrfRequest):
        return {"kind": "vrf", "public_key": _hex(req.public_key),
                "alpha": _hex(req.alpha), "proof": _hex(req.proof)}
    if isinstance(req, MembershipRequest):
        return {"kind": "membership", "member": _hex(req.member),
                "root": _hex(req.root), "leaf_count": req.leaf_count,
                "proof": {"leaf_index": req.proof.leaf_index,
                          "nodes": [_hex(n) for n in req.proof.nodes]}}
    if isinstance(req, PowRequest):
        return {"kind": "pow", "challenge": _hex(req.challenge),
                "node_id": _hex(req.node_id),
                "difficulty": _hex(req.difficulty), "nonce": req.nonce}
    if isinstance(req, PostRequest):
        it = req.item
        return {"kind": "post", "challenge": _hex(it.challenge),
                "node_id": _hex(it.node_id),
                "commitment": _hex(it.commitment),
                "scrypt_n": it.scrypt_n,
                "total_labels": it.total_labels,
                "proof": {"nonce": it.proof.nonce,
                          "indices": list(it.proof.indices),
                          "pow_nonce": it.proof.pow_nonce,
                          "k2": it.proof.k2}}
    raise ProtocolError(f"unknown request type {type(req).__name__}")
