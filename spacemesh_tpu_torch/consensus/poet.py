"""Poet: proof-of-elapsed-time rounds with merkle membership (port of
``spacemesh_tpu/consensus/poet.py``, whole).

The reference outsources sequential work to an external poet service
(reference activation/poet.go HTTP client; SURVEY.md §2.3) and runs one
in-proc for --standalone (node/node.go:1293). This module is that in-proc
service: per round it collects member challenges, performs the sequential
hash chain (tiny tick counts in fastnet/standalone), and emits a PoetProof
whose statement is a merkle root over the members; members fetch their
inclusion proof.

Merkle: leaves = blake3(member), internal = blake3(left || right), odd
nodes promoted. Verification walks MerkleProof.nodes with the leaf index.
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..core.hashing import sum256
from ..core.types import MerkleProof, PoetProof


def merkle_root(leaves: list[bytes]) -> bytes:
    if not leaves:
        return bytes(32)
    level = [sum256(m) for m in leaves]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(sum256(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def merkle_path(leaves: list[bytes], index: int) -> MerkleProof:
    nodes = []
    level = [sum256(m) for m in leaves]
    i = index
    while len(level) > 1:
        sib = i ^ 1
        if sib < len(level):
            nodes.append(level[sib])
        nxt = []
        for k in range(0, len(level) - 1, 2):
            nxt.append(sum256(level[k], level[k + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        i //= 2
    return MerkleProof(leaf_index=index, nodes=nodes)


def verify_membership(member: bytes, proof: MerkleProof, root: bytes,
                      leaf_count: int) -> bool:
    if not 0 <= proof.leaf_index < leaf_count:
        return False
    h = sum256(member)
    i = proof.leaf_index
    width = leaf_count
    nodes = list(proof.nodes)
    while width > 1:
        sib = i ^ 1
        if sib < width:
            if not nodes:
                return False
            s = nodes.pop(0)
            h = sum256(h, s) if i % 2 == 0 else sum256(s, h)
        i //= 2
        width = (width + 1) // 2
    return not nodes and h == root


def sequential_work(seed: bytes, ticks: int) -> bytes:
    """The honest-to-goodness sequential part (hash chain). Standalone and
    fastnet use tiny tick counts; a real deployment points at an external
    poet instead."""
    h = seed
    for _ in range(ticks):
        h = sum256(h)
    return h


from ..core import codec as _codec
from ..core.codec import u64


@_codec.register
class PoetBlob:
    """Poet proof + the member count its membership proofs verify against
    (gossiped on pt1 and served through fetch so every node can validate
    ATXs referencing the round)."""

    proof: PoetProof
    member_count: int

    FIELDS = [("proof", _codec.struct(PoetProof)), ("member_count", u64)]


@dataclasses.dataclass
class RoundResult:
    proof: PoetProof
    members: list[bytes]

    def membership(self, member: bytes) -> MerkleProof | None:
        try:
            return merkle_path(self.members, self.members.index(member))
        except ValueError:
            return None


class PoetService:
    """In-proc poet: register(challenge) during the open round, run() at
    round end, results keyed by round id."""

    def __init__(self, poet_id: bytes, ticks: int = 64,
                 certifier_pubkey: bytes | None = None,
                 verifier=None):
        self.poet_id = poet_id
        self.ticks = ticks
        # when set, registration requires a certificate signed by this
        # certifier (reference poet deployments gate /submit the same
        # way; consensus/certifier.py issues them against a POST proof)
        self.certifier_pubkey = certifier_pubkey
        self.verifier = verifier
        self._open: dict[str, list[bytes]] = {}
        self._results: dict[str, RoundResult] = {}
        self._lock = asyncio.Lock()

    async def register(self, round_id: str, challenge: bytes,
                       node_id: bytes | None = None,
                       signature: bytes | None = None,
                       cert=None) -> None:
        """Cert-gated mode requires the registration to be BOUND to the
        certified identity: a cert for node_id plus node_id's signature
        over (round_id, challenge) — a stolen/replayed cert without the
        identity's key registers nothing, and rate limits apply per
        certified identity (the reference poet's /submit carries the
        submitter's pubkey + signature the same way)."""
        if self.certifier_pubkey is not None:
            from ..core.signing import Domain
            from .certifier import verify_cert

            if cert is None or node_id is None or signature is None:
                raise PermissionError(
                    "registration requires a certificate + identity proof")
            if cert.node_id != node_id:
                raise PermissionError("certificate is for another identity")
            if not verify_cert(cert, self.certifier_pubkey, self.verifier):
                raise PermissionError("invalid poet certificate")
            if not self.verifier.verify(
                    Domain.POET, node_id,
                    round_id.encode() + challenge, signature):
                raise PermissionError("registration signature invalid")
        async with self._lock:
            if round_id in self._results:
                raise ValueError(f"round {round_id} already closed")
            members = self._open.setdefault(round_id, [])
            if challenge not in members:
                members.append(challenge)

    async def execute_round(self, round_id: str) -> RoundResult:
        async with self._lock:
            members = sorted(self._open.pop(round_id, []))
            root = merkle_root(members)
            # bind the sequential work to the statement
            sequential_work(root, self.ticks)
            proof = PoetProof(poet_id=self.poet_id, round_id=round_id,
                              root=root, ticks=self.ticks)
            result = RoundResult(proof=proof, members=members)
            self._results[round_id] = result
            return result

    def result(self, round_id: str) -> RoundResult | None:
        return self._results.get(round_id)
