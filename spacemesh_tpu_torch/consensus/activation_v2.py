"""ATX v2: merged multi-identity ATXs, marriages, equivocation sets.

Port of ``spacemesh_tpu/consensus/activation_v2.py``, whole, with the same
order of checks. ``HandlerV2``'s inline path verifies on ``device``
(default ``"cuda"``); with ``farm=`` every check goes through the farm.

Mirrors the reference's v2 activation pipeline (reference
activation/wire/wire_v2.go:17 ActivationTxV2 w/ NiPosts + Marriages;
activation/handler_v2.go:75 processATX, :379 validateMarriages; married
identities form ONE equivocation set — sql/marriage — so malfeasance by
any member condemns all of them).

Design notes (not a wire copy):
- One envelope, signed by the primary identity, carries a SubPost per
  covered identity. Every covered identity must be the primary or
  married to it (a certificate inside this ATX or a recorded marriage).
- Marriage certificates are the PARTNER's signature over
  "marry" || primary_id — consent, not mere association.
- Each identity keeps its own synthetic ATX id
  (ActivationTxV2.identity_atx_id) so eligibility/cache/tortoise weight
  stays per-identity.
- POST verification runs as ONE batched pass across all subposts
  (post/verifier.py: one label recompute for every subpost's K3 labels)
  — a merged ATX is a batch.
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..core import codec
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import (
    EMPTY32,
    ActivationTxV2,
    MarriageCert,
    NIPost,
    Post,
    PostMetadataWire,
    SubPostV2,
)
from ..device import resolve
from ..post import verifier as post_verifier
from ..post.prover import Proof as PostProof, ProofParams
from ..storage import atxs as atxstore
from ..storage import misc as miscstore
from ..storage.cache import AtxCache, AtxInfo
from ..storage.db import Database
from ..verify.farm import Lane, MembershipRequest, PostRequest, SigRequest
from .activation import commitment_of, nipost_challenge, post_challenge
from .poet import verify_membership

TOPIC_ATX_V2 = "ax2"


class HandlerV2:
    """Gossip/sync ingestion of merged ATXs."""

    def __init__(self, *, db: Database, cache: AtxCache,
                 verifier: EdVerifier, golden_atx: bytes,
                 post_params: ProofParams, labels_per_unit: int,
                 scrypt_n: int, pubsub=None, on_atx=None, now=None,
                 farm=None, device="cuda"):
        import time as _time

        self.now = now or _time.time
        self.db = db
        self.cache = cache
        self.verifier = verifier
        self.golden_atx = golden_atx
        self.post_params = post_params
        self.labels_per_unit = labels_per_unit
        self.scrypt_n = scrypt_n
        self.on_atx = on_atx
        # verification farm (verify/farm.py); None = inline verification
        # on ``device``
        self.farm = farm
        self.device = resolve(device)
        if pubsub is not None:
            pubsub.register(TOPIC_ATX_V2, self._gossip)

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            atx2 = ActivationTxV2.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        return await self.process_async(atx2, lane=Lane.GOSSIP)

    def _married_to_primary(self, atx2: ActivationTxV2) -> set[bytes]:
        """Identities allowed inside this envelope: the primary, partners
        certified IN this ATX, and previously recorded marriages."""
        allowed = {atx2.node_id}
        for cert in atx2.marriages:
            allowed.add(cert.partner_id)
        recorded = miscstore.marriage_of(self.db, atx2.node_id)
        if recorded is not None:
            allowed.update(miscstore.married_set(self.db, recorded))
        return allowed

    # NOTE: process() and process_async() are the same validation
    # sequence — sync/inline vs farm-batched (the per-subpost structure
    # is shared via _subpost_prepare). tests/test_atx_v2.py::
    # test_process_async_parity_with_inline pins their decisions to
    # each other; edit them together.

    def _equivocates(self, sp, atx2: ActivationTxV2) -> bool:
        """Per-identity double-publish guard (marks malicious on hit)."""
        existing = atxstore.by_node_in_epoch(self.db, sp.node_id,
                                             atx2.publish_epoch)
        if existing is not None and \
                existing.id != atx2.identity_atx_id(sp.node_id):
            self.cache.set_malicious(sp.node_id)
            return True
        return False

    def _subpost_prepare(self, sp, atx2: ActivationTxV2):
        """Structural per-subpost validation shared by both paths:
        double-publish guard, poet lookup, VerifyItem + height math.
        Returns (poet, challenge, item, prev_height) or None to reject.
        Membership + POST verification stay with the caller (inline vs
        farm-batched)."""
        if self._equivocates(sp, atx2):
            return None
        poet = miscstore.poet_proof(self.db,
                                    sp.nipost.post_metadata.challenge)
        if poet is None:
            return None
        challenge = nipost_challenge(sp.prev_atx, atx2.publish_epoch)
        item = post_verifier.VerifyItem(
            proof=PostProof(nonce=sp.nipost.post.nonce,
                            indices=list(sp.nipost.post.indices),
                            pow_nonce=sp.nipost.post.pow_nonce,
                            k2=self.post_params.k2),
            challenge=post_challenge(poet.root, challenge),
            node_id=sp.node_id,
            commitment=commitment_of(sp.node_id, self.golden_atx),
            scrypt_n=self.scrypt_n,
            total_labels=sp.num_units * self.labels_per_unit)
        prev_height = 0
        if sp.prev_atx != EMPTY32:
            prev_height = atxstore.tick_height(self.db, sp.prev_atx) or 0
        return poet, challenge, item, prev_height

    def process(self, atx2: ActivationTxV2) -> bool:
        if not atx2.subposts:
            return False
        if atxstore.has(self.db,
                        atx2.identity_atx_id(atx2.subposts[0].node_id)):
            return True
        # envelope signature by the primary
        if not self.verifier.verify(Domain.ATX, atx2.node_id,
                                    atx2.signed_bytes(), atx2.signature):
            return False
        # marriage certificates: partner consent over "marry"||primary
        for cert in atx2.marriages:
            if not self.verifier.verify(
                    Domain.ATX, cert.partner_id,
                    MarriageCert.message(atx2.node_id), cert.signature):
                return False
        allowed = self._married_to_primary(atx2)
        seen_ids: set[bytes] = set()
        items: list[post_verifier.VerifyItem] = []
        ticks: dict[bytes, int] = {}
        heights: dict[bytes, tuple[int, int]] = {}
        for sp in atx2.subposts:
            if sp.node_id not in allowed or sp.node_id in seen_ids:
                return False
            seen_ids.add(sp.node_id)
            prep = self._subpost_prepare(sp, atx2)
            if prep is None:
                return False
            poet, challenge, item, prev_height = prep
            if not verify_membership(challenge, sp.nipost.membership,
                                     poet.root,
                                     leaf_count=self._leaf_count(poet)):
                return False
            items.append(item)
            ticks[sp.node_id] = prev_height + poet.ticks
            heights[sp.node_id] = (prev_height, poet.ticks)
        # ONE batched POST verification across every covered identity
        if not all(post_verifier.verify_many(items, self.post_params,
                                             device=self.device)):
            return False
        self._store(atx2, ticks, heights)
        return True

    async def process_async(self, atx2: ActivationTxV2,
                            lane: Lane = Lane.GOSSIP) -> bool:
        """process(), with every crypto check routed through the farm —
        a merged ATX's subposts batch not just with each other but with
        every OTHER in-flight ATX's proofs. Falls back to the inline
        path when no farm runs."""
        if self.farm is None:
            return self.process(atx2)
        if not atx2.subposts:
            return False
        if atxstore.has(self.db,
                        atx2.identity_atx_id(atx2.subposts[0].node_id)):
            return True
        if not await self.farm.submit(
                SigRequest(int(Domain.ATX), atx2.node_id,
                           atx2.signed_bytes(), atx2.signature), lane=lane):
            return False
        for cert in atx2.marriages:
            if not await self.farm.submit(
                    SigRequest(int(Domain.ATX), cert.partner_id,
                               MarriageCert.message(atx2.node_id),
                               cert.signature), lane=lane):
                return False
        allowed = self._married_to_primary(atx2)
        seen_ids: set[bytes] = set()
        items: list[post_verifier.VerifyItem] = []
        ticks: dict[bytes, int] = {}
        heights: dict[bytes, tuple[int, int]] = {}
        for sp in atx2.subposts:
            if sp.node_id not in allowed or sp.node_id in seen_ids:
                return False
            seen_ids.add(sp.node_id)
            prep = self._subpost_prepare(sp, atx2)
            if prep is None:
                return False
            poet, challenge, item, prev_height = prep
            if not await self.farm.submit(
                    MembershipRequest(challenge, sp.nipost.membership,
                                      poet.root, self._leaf_count(poet)),
                    lane=lane):
                return False
            items.append(item)
            ticks[sp.node_id] = prev_height + poet.ticks
            heights[sp.node_id] = (prev_height, poet.ticks)
        verdicts = await asyncio.gather(
            *(self.farm.submit(PostRequest(it), lane=lane)
              for it in items))
        if not all(verdicts):
            return False
        # re-run the double-publish guard with NO awaits before the
        # store: a conflicting envelope may have landed while the crypto
        # checks above coalesced in the farm (the sync path can't
        # interleave, so only this path needs the recheck)
        for sp in atx2.subposts:
            if self._equivocates(sp, atx2):
                return False
        self._store(atx2, ticks, heights)
        return True

    def _leaf_count(self, poet) -> int:
        from .activation import poet_leaf_count

        return poet_leaf_count(self.db, poet)

    def _store(self, atx2: ActivationTxV2, ticks: dict,
               heights: dict) -> None:
        with self.db.tx():
            atxstore.add_v2(self.db, atx2, tick_heights=ticks,
                            received=self.now())
            # record the equivocation set: everyone in the envelope is
            # married to everyone else via this ATX
            if atx2.marriages:
                for sp in atx2.subposts:
                    miscstore.set_marriage(self.db, sp.node_id, atx2.id)
                miscstore.set_marriage(self.db, atx2.node_id, atx2.id)
        for sp in atx2.subposts:
            prev_height, tick_delta = heights[sp.node_id]
            self.cache.add(
                atx2.target_epoch(), atx2.identity_atx_id(sp.node_id),
                AtxInfo(node_id=sp.node_id,
                        weight=sp.num_units * tick_delta,
                        base_height=prev_height,
                        height=ticks[sp.node_id],
                        num_units=sp.num_units, vrf_nonce=sp.vrf_nonce,
                        vrf_public_key=sp.node_id))
        if self.on_atx:
            self.on_atx(atx2)


def build_marriage_cert(partner: EdSigner, primary_id: bytes) -> MarriageCert:
    return MarriageCert(
        partner_id=partner.node_id,
        signature=partner.sign(Domain.ATX, MarriageCert.message(primary_id)))


async def build_merged_atx(*, primary: EdSigner, partners: list[EdSigner],
                           db: Database, poet, post_clients: dict,
                           golden_atx: bytes, coinbase: bytes,
                           publish_epoch: int,
                           execute_round: bool = False) -> ActivationTxV2:
    """Build one merged ATX covering primary + partners (reference
    activation.Builder v2 path): every identity registers its challenge,
    one poet round serves all, every identity proves POST over the same
    statement, partners sign marriage certificates."""
    import asyncio

    signers = [primary] + partners
    round_id = str(publish_epoch)
    challenges = {}
    for s in signers:
        prev = atxstore.latest_by_node(db, s.node_id)
        prev_id = prev.id if prev is not None else EMPTY32
        ch = nipost_challenge(prev_id, publish_epoch)
        challenges[s.node_id] = (prev_id, ch)
        await poet.register(round_id, ch)
    if execute_round:
        result = await poet.execute_round(round_id)
    else:
        while (result := await asyncio.to_thread(poet.result,
                                                 round_id)) is None:
            # spacecheck: ok=SC001 off-loop poll pacing, not a protocol delay; elapses instantly in virtual time
            await asyncio.sleep(0.05)

    from .activation import store_poet_blob
    from .poet import PoetBlob

    store_poet_blob(db, PoetBlob(proof=result.proof,
                                 member_count=len(result.members)))

    subposts = []
    for s in signers:
        prev_id, ch = challenges[s.node_id]
        membership = result.membership(ch)
        if membership is None:
            raise RuntimeError("challenge missing from poet round")
        client = post_clients[s.node_id]
        proof, meta = await asyncio.to_thread(
            client.proof, post_challenge(result.proof.root, ch))
        info = await asyncio.to_thread(client.info)
        subposts.append(SubPostV2(
            node_id=s.node_id, prev_atx=prev_id,
            num_units=info.num_units, vrf_nonce=info.vrf_nonce,
            nipost=NIPost(
                membership=membership,
                post=Post(nonce=proof.nonce, indices=proof.indices,
                          pow_nonce=proof.pow_nonce),
                post_metadata=PostMetadataWire(
                    challenge=result.proof.id,
                    labels_per_unit=info.labels_per_unit))))

    atx2 = ActivationTxV2(
        publish_epoch=publish_epoch, pos_atx=golden_atx, coinbase=coinbase,
        marriages=[build_marriage_cert(p, primary.node_id)
                   for p in partners],
        subposts=subposts, node_id=primary.node_id, signature=bytes(64))
    return dataclasses.replace(
        atx2, signature=primary.sign(Domain.ATX, atx2.signed_bytes()))
