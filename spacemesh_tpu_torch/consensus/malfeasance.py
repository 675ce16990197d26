"""Malfeasance: proofs of protocol violations + the gossip handler.

Port of ``spacemesh_tpu/consensus/malfeasance.py``, whole. The Handler
takes ``device`` (default ``"cuda"``) and passes it on to its
``post_checker``, the InvalidPostIndex recompute of the inline path.

Mirrors the reference malfeasance package (reference malfeasance/handler.go:
proof types MultipleATXs / MultipleBallots / HareEquivocation with
per-domain validators registered from each package; on a valid proof the
identity is persisted as malicious and marked everywhere — tortoise, ATX
cache — and the proof regossiped; self-defense check skips proofs against
the local node unless real).

A proof here is two distinct signed messages from one identity in the same
protocol slot (core/types.MalfeasanceProof): domain picks the conflict rule.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core import codec
from ..core.signing import Domain, EdVerifier
from ..core.types import ActivationTx, Ballot, MalfeasanceProof
from ..device import resolve
from ..p2p.pubsub import TOPIC_MALFEASANCE, PubSub
from ..storage import misc as miscstore
from ..storage.cache import AtxCache
from ..storage.db import Database


def proof_from_ballots(b1: Ballot, b2: Ballot) -> MalfeasanceProof:
    return MalfeasanceProof(
        domain=int(Domain.BALLOT), msg1=b1.signed_bytes(), sig1=b1.signature,
        msg2=b2.signed_bytes(), sig2=b2.signature, node_id=b1.node_id)


def proof_from_atxs(a1: ActivationTx, a2: ActivationTx) -> MalfeasanceProof:
    return MalfeasanceProof(
        domain=int(Domain.ATX), msg1=a1.signed_bytes(), sig1=a1.signature,
        msg2=a2.signed_bytes(), sig2=a2.signature, node_id=a1.node_id)


def proof_from_hare(node_id: bytes, msg1: bytes, sig1: bytes, msg2: bytes,
                    sig2: bytes) -> MalfeasanceProof:
    return MalfeasanceProof(domain=int(Domain.HARE), msg1=msg1, sig1=sig1,
                            msg2=msg2, sig2=sig2, node_id=node_id)


# non-signature domain tag: a single ATX whose POST proof carries an index
# that does not qualify (reference malfeasance/handler.go InvalidPostIndex)
DOMAIN_INVALID_POST = 100


def proof_invalid_post(atx: ActivationTx, index_pos: int) -> MalfeasanceProof:
    """msg1 = the signed ATX, msg2 = the offending index position."""
    return MalfeasanceProof(
        domain=DOMAIN_INVALID_POST, msg1=atx.signed_bytes(),
        sig1=atx.signature, msg2=index_pos.to_bytes(4, "little"),
        sig2=bytes(64), node_id=atx.node_id)


def _conflicting(domain: int, msg1: bytes, msg2: bytes) -> bool:
    """Domain rule: the two messages occupy the same protocol slot."""
    try:
        if domain == int(Domain.BALLOT):
            b1 = Ballot.from_bytes(msg1)
            b2 = Ballot.from_bytes(msg2)
            return b1.layer == b2.layer and b1.node_id == b2.node_id
        if domain == int(Domain.ATX):
            a1 = ActivationTx.from_bytes(msg1)
            a2 = ActivationTx.from_bytes(msg2)
            if a1.node_id != a2.node_id:
                return False
            # double publish in one epoch, OR two ATXs claiming the same
            # prev (InvalidPrevATX, reference malfeasance/handler.go:33-42
            # — a forked ATX chain)
            from ..core.types import EMPTY32

            return (a1.publish_epoch == a2.publish_epoch
                    or (a1.prev_atx == a2.prev_atx
                        and a1.prev_atx != EMPTY32))
        if domain == int(Domain.HARE):
            from .hare import CompactHareMessage, HareMessage

            def slot(raw: bytes):
                # both wire encodings are conflict-provable
                for cls in (HareMessage, CompactHareMessage):
                    try:
                        m = cls.from_bytes(raw)
                        return (m.layer, m.iteration, m.round, m.node_id)
                    except (codec.DecodeError, ValueError):
                        continue
                return None

            s1, s2 = slot(msg1), slot(msg2)
            return s1 is not None and s1 == s2
    except (codec.DecodeError, ValueError, TypeError):
        return False
    return False


class Handler:
    def __init__(self, *, db: Database, cache: AtxCache,
                 verifier: EdVerifier, pubsub: PubSub,
                 tortoise=None,
                 on_malicious: Optional[Callable[[bytes], None]] = None,
                 post_checker=None, farm=None, device="cuda"):
        self.db = db
        self.cache = cache
        self.verifier = verifier
        self.pubsub = pubsub
        self.tortoise = tortoise
        self.on_malicious = on_malicious
        # post_checker(atx, index_pos, device) -> True when the ATX's POST
        # index at that position does NOT qualify, recomputed on ``device``
        # (InvalidPostIndex validation; wired by the node with its POST
        # params)
        self.post_checker = post_checker
        self.device = resolve(device)
        # verification farm (verify/farm.py); None = inline verification
        self.farm = farm
        pubsub.register(TOPIC_MALFEASANCE, self._gossip)

    def validate(self, proof: MalfeasanceProof) -> bool:
        if proof.domain == DOMAIN_INVALID_POST:
            return self._validate_invalid_post(proof)
        if proof.msg1 == proof.msg2:
            return False
        dom = Domain(proof.domain) if proof.domain in set(Domain) else None
        if dom is None:
            return False
        if not (self.verifier.verify(dom, proof.node_id, proof.msg1, proof.sig1)
                and self.verifier.verify(dom, proof.node_id, proof.msg2,
                                         proof.sig2)):
            return False
        return _conflicting(proof.domain, proof.msg1, proof.msg2)

    def _validate_invalid_post(self, proof: MalfeasanceProof) -> bool:
        """The ATX really is signed by the accused AND the named POST
        index really fails the recompute (reference InvalidPostIndex)."""
        if self.post_checker is None:
            return False
        if not self.verifier.verify(Domain.ATX, proof.node_id, proof.msg1,
                                    proof.sig1):
            return False
        try:
            atx = ActivationTx.from_bytes(proof.msg1)
            index_pos = int.from_bytes(proof.msg2[:4], "little")
        except (codec.DecodeError, ValueError):
            return False
        if atx.node_id != proof.node_id:
            return False
        if index_pos >= len(atx.nipost.post.indices):
            return False
        return bool(self.post_checker(atx, index_pos, self.device))

    async def validate_async(self, proof: MalfeasanceProof, lane) -> bool:
        """validate(), with the signature pair farm-batched (the two
        checks of one proof dispatch concurrently, and batch with every
        other in-flight verification)."""
        from ..verify.farm import SigRequest

        if proof.domain == DOMAIN_INVALID_POST:
            # post_checker recomputes ONE label inline (k2=1) — cheap
            # enough that routing it through the farm buys nothing
            return self._validate_invalid_post(proof)
        if proof.msg1 == proof.msg2:
            return False
        dom = Domain(proof.domain) if proof.domain in set(Domain) else None
        if dom is None:
            return False
        import asyncio

        ok1, ok2 = await asyncio.gather(
            self.farm.submit(SigRequest(int(dom), proof.node_id,
                                        proof.msg1, proof.sig1), lane=lane),
            self.farm.submit(SigRequest(int(dom), proof.node_id,
                                        proof.msg2, proof.sig2), lane=lane))
        if not (ok1 and ok2):
            return False
        return _conflicting(proof.domain, proof.msg1, proof.msg2)

    def process(self, proof: MalfeasanceProof) -> bool:
        if miscstore.is_malicious(self.db, proof.node_id):
            return True  # already known; don't regossip storms
        if not self.validate(proof):
            return False
        return self._condemn(proof)

    async def process_async(self, proof: MalfeasanceProof,
                            lane=None) -> bool:
        """process() with farm-batched signature checks; inline when no
        farm runs (the sync-fallback contract, docs/VERIFY_FARM.md)."""
        if self.farm is None:
            return self.process(proof)
        from ..verify.farm import Lane

        lane = Lane.GOSSIP if lane is None else lane
        if miscstore.is_malicious(self.db, proof.node_id):
            return True
        if not await self.validate_async(proof, lane):
            return False
        return self._condemn(proof)

    def _condemn(self, proof: MalfeasanceProof) -> bool:
        # the whole equivocation set falls with any member (reference
        # married identities share fate, handler_v2.go/sql/marriage)
        condemned = [proof.node_id]
        marriage = miscstore.marriage_of(self.db, proof.node_id)
        if marriage is not None:
            condemned += [n for n in miscstore.married_set(self.db, marriage)
                          if n != proof.node_id]
        with self.db.tx():
            for node_id in condemned:
                miscstore.set_malicious(self.db, node_id, proof)
        for node_id in condemned:
            self.cache.set_malicious(node_id)
            if self.tortoise is not None:
                self.tortoise.on_malfeasance(node_id)
            if self.on_malicious:
                self.on_malicious(node_id)
        return True

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            proof = MalfeasanceProof.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        return await self.process_async(proof)

    async def publish(self, proof: MalfeasanceProof) -> None:
        if await self.process_async(proof):
            await self.pubsub.publish(TOPIC_MALFEASANCE, proof.to_bytes())
