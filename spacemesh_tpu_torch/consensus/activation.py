"""Activation: building and validating ATXs (the identity/weight layer).

Port of ``spacemesh_tpu/consensus/activation.py``, whole, with the same
order of checks. The Handler's inline path verifies POST proofs on
``device`` (default ``"cuda"``; ``"cpu"`` runs the plain twins); with
``farm=`` every check goes through the farm, on the farm's device.

Mirrors the reference activation package (SURVEY.md §2.2): the Builder is
each smesher's per-epoch loop — POST init once, then per epoch: register
the NIPoST challenge at the poet, wait out the round, prove over the poet
statement with the POST prover, assemble + sign + publish the ATX
(reference activation/activation.go:421 run, nipost.go:188 BuildNIPost).
The Handler ingests gossip/sync ATXs: signature, poet membership, POST
proof verification (through post/verifier.py: on the card, one
three-launch label recompute per batch), then store + cache + consensus
notifications (reference activation/handler.go:189). Only the handler,
on the event loop, touches the database: the farm's worker threads see
requests, never the connection.

Commitment derivation: commitment = blake3(node_id || golden_atx)
binding the label set to the identity and chain genesis.
NIPoST challenge for epoch E: blake3(prev_atx_id or zeros || le32(E)).
POST challenge: blake3(poet_root || nipost_challenge).
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct
from typing import Callable, Optional

from ..core import codec
from ..core.hashing import sum256
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import (
    EMPTY32,
    ActivationTx,
    NIPost,
    PoetProof,
    Post,
    PostMetadataWire,
)
from ..device import resolve
from ..p2p.pubsub import TOPIC_ATX, PubSub
from ..post.prover import Proof as PostProof, ProofParams
from ..post import verifier as post_verifier
from ..storage import atxs as atxstore
from ..storage import misc as miscstore
from ..storage.cache import AtxCache, AtxInfo
from ..storage.db import Database
from ..verify.farm import Lane, MembershipRequest, PostRequest, SigRequest
from .poet import PoetService, verify_membership


def commitment_of(node_id: bytes, golden_atx: bytes) -> bytes:
    return sum256(node_id, golden_atx)


def store_poet_blob(db: Database, blob) -> None:
    """Persist a poet proof + its member count (single writer for the two
    rows the validator reads: proof by ref, count by derived key)."""
    proof = blob.proof
    with db.tx():
        # first write wins: member_count is not covered by proof.id, so a
        # re-gossiped blob with a forged count must not overwrite the
        # count recorded when the proof first arrived
        db.exec(
            "INSERT OR IGNORE INTO poet_proofs (ref, poet_id, round_id,"
            " ticks, data) VALUES (?,?,?,?,?)",
            (proof.id, proof.poet_id, proof.round_id, proof.ticks,
             proof.to_bytes()))
        db.exec(
            "INSERT OR IGNORE INTO active_sets (id, epoch, data)"
            " VALUES (?,?,?)",
            (b"poetcnt!" + proof.id[:24],
             int(proof.round_id) if proof.round_id.isdigit() else 0,
             blob.member_count.to_bytes(8, "little")))


def nipost_challenge(prev_atx: bytes, epoch: int) -> bytes:
    return sum256(prev_atx, struct.pack("<I", epoch))


def poet_leaf_count(db: Database, poet: PoetProof) -> int:
    """Member count recorded beside the proof (store_poet_blob); unknown
    counts are bounded above — membership still binds."""
    row = db.one("SELECT data FROM active_sets WHERE id=?",
                 (b"poetcnt!" + poet.id[:24],))
    if row is None:
        return 1 << 20
    return int.from_bytes(row["data"], "little")


def post_challenge(poet_root: bytes, challenge: bytes) -> bytes:
    return sum256(poet_root, challenge)


class Handler:
    """Gossip/sync ATX ingestion + validation."""

    def __init__(self, *, db: Database, cache: AtxCache, verifier: EdVerifier,
                 golden_atx: bytes, post_params: ProofParams,
                 labels_per_unit: int, scrypt_n: int, pubsub: PubSub,
                 on_atx: Optional[Callable[[ActivationTx], None]] = None,
                 now: Optional[Callable[[], float]] = None,
                 farm=None, device="cuda"):
        import time as _time

        self.now = now or _time.time  # the NODE's clock domain: receipt
        # times must be comparable to the layer clock (virtual in tests)
        self.db = db
        self.cache = cache
        self.verifier = verifier
        self.golden_atx = golden_atx
        self.post_params = post_params
        self.labels_per_unit = labels_per_unit
        self.scrypt_n = scrypt_n
        self.on_atx = on_atx
        # verification farm (verify/farm.py); None = synchronous inline
        # verification on ``device``, the contract unit tests and tools
        # rely on
        self.farm = farm
        self.device = resolve(device)
        pubsub.register(TOPIC_ATX, self._gossip)

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            atx = ActivationTx.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        return await self.process_async(atx, lane=Lane.GOSSIP)

    # NOTE: process() and process_async() are the same validation
    # sequence — sync/inline vs farm-batched. tests/test_atx_v2.py::
    # test_v1_process_async_parity_with_inline pins their decisions to
    # each other; edit them together.

    def process(self, atx: ActivationTx) -> bool:
        if atxstore.has(self.db, atx.id):
            return True
        if not self.verifier.verify(Domain.ATX, atx.node_id,
                                    atx.signed_bytes(), atx.signature):
            return False
        # VRF key must BE the identity: ed25519 and the ECVRF suite share
        # the same seed->pubkey derivation, so an honest smesher's VRF key
        # equals its node id (signing.EdSigner.vrf_signer). Accepting an
        # arbitrary signed key would let a smesher grind fresh VRF keys
        # per epoch to bias beacon/eligibility draws (reference keys VRF
        # verification by the node id itself, signing/vrf.go NewPublicKey).
        if atx.vrf_public_key != atx.node_id:
            return False
        # poet proof must be known and the challenge a member of its round
        poet = miscstore.poet_proof(self.db, atx.nipost.post_metadata.challenge)
        if poet is None:
            return False
        challenge = nipost_challenge(atx.prev_atx, atx.publish_epoch)
        if not verify_membership(challenge, atx.nipost.membership, poet.root,
                                 leaf_count=self._leaf_count(poet)):
            return False
        # POST proof: recompute labels at spot-checked indices
        if not post_verifier.verify(self._verify_item(atx, poet, challenge),
                                    self.post_params, device=self.device):
            return False
        return self._finish(atx, poet)

    async def process_async(self, atx: ActivationTx,
                            lane: Lane = Lane.GOSSIP) -> bool:
        """process(), with every crypto check routed through the farm's
        micro-batches; falls back to the inline path when no farm runs."""
        if self.farm is None:
            return self.process(atx)
        if atxstore.has(self.db, atx.id):
            return True
        if not await self.farm.submit(
                SigRequest(int(Domain.ATX), atx.node_id,
                           atx.signed_bytes(), atx.signature), lane=lane):
            return False
        if atx.vrf_public_key != atx.node_id:
            return False
        poet = miscstore.poet_proof(self.db, atx.nipost.post_metadata.challenge)
        if poet is None:
            return False
        challenge = nipost_challenge(atx.prev_atx, atx.publish_epoch)
        if not await self.farm.submit(
                MembershipRequest(challenge, atx.nipost.membership,
                                  poet.root, self._leaf_count(poet)),
                lane=lane):
            return False
        if not await self.farm.submit(
                PostRequest(self._verify_item(atx, poet, challenge)),
                lane=lane):
            return False
        return self._finish(atx, poet)

    def _verify_item(self, atx: ActivationTx, poet,
                     challenge: bytes) -> post_verifier.VerifyItem:
        return post_verifier.VerifyItem(
            proof=PostProof(nonce=atx.nipost.post.nonce,
                            indices=list(atx.nipost.post.indices),
                            pow_nonce=atx.nipost.post.pow_nonce,
                            k2=self.post_params.k2),
            challenge=post_challenge(poet.root, challenge),
            node_id=atx.node_id,
            commitment=commitment_of(atx.node_id, self.golden_atx),
            scrypt_n=self.scrypt_n,
            total_labels=atx.num_units * self.labels_per_unit)

    def _finish(self, atx: ActivationTx, poet) -> bool:
        # double-publish detection (same node, same epoch, different atx)
        existing = atxstore.by_node_in_epoch(self.db, atx.node_id,
                                             atx.publish_epoch)
        if existing is not None and existing.id != atx.id:
            self.cache.set_malicious(atx.node_id)
            return False
        self.store(atx, ticks=poet.ticks)
        return True

    def _leaf_count(self, poet: PoetProof) -> int:
        return poet_leaf_count(self.db, poet)

    def store(self, atx: ActivationTx, ticks: int) -> None:
        prev_height = 0
        if atx.prev_atx != EMPTY32:
            prev_height = atxstore.tick_height(self.db, atx.prev_atx) or 0
        height = prev_height + ticks
        with self.db.tx():
            # receipt time feeds active-set grading
            # (consensus/activeset.py grade_atx)
            atxstore.add(self.db, atx, tick_height=height,
                         received=self.now())
        self.cache.add(atx.target_epoch(), atx.id, AtxInfo(
            node_id=atx.node_id, weight=atx.num_units * ticks,
            base_height=prev_height, height=height, num_units=atx.num_units,
            vrf_nonce=atx.vrf_nonce, vrf_public_key=atx.vrf_public_key))
        if self.on_atx:
            self.on_atx(atx)


class Builder:
    """One smesher's ATX publication loop (single-shot per epoch; the app
    drives it at epoch boundaries). Multi-identity: one Builder per signer,
    as the reference registers many signers into one builder."""

    def __init__(self, *, signer: EdSigner, db: Database, pubsub: PubSub,
                 poet: PoetService, post_client, golden_atx: bytes,
                 coinbase: bytes, handler: Handler,
                 num_units: int):
        self.signer = signer
        self.db = db
        self.pubsub = pubsub
        self.poet = poet
        self.post_client = post_client   # post.service.PostClient
        self.golden_atx = golden_atx
        self.coinbase = coinbase
        self.handler = handler
        self.num_units = num_units

    async def register_challenge(self, publish_epoch: int) -> None:
        """Phase 0: register the NIPoST challenge at the poet BEFORE the
        round starts (reference nipost.go:349 submitPoetChallenges). Split
        from finish() so a multi-identity node registers every signer
        before any of them executes/awaits the round."""
        node_id = self.signer.node_id
        prev = atxstore.latest_by_node(self.db, node_id)
        prev_id = prev.id if prev is not None else EMPTY32
        challenge = nipost_challenge(prev_id, publish_epoch)
        round_id = str(publish_epoch)
        self._pending = (publish_epoch, prev, prev_id, challenge, round_id)
        # cert-gated poets (reference certifier deposits,
        # activation/certifier.go:246): poet_cert is obtained once from
        # the certifier (App.start_smeshing, poet_certifier config); the
        # registration is bound to this identity by a POET-domain
        # signature over (round_id, challenge)
        cert = getattr(self, "poet_cert", None)
        await self.poet.register(
            round_id, challenge, node_id=node_id,
            signature=self.signer.sign(Domain.POET,
                                       round_id.encode() + challenge),
            cert=cert)

    async def build_and_publish(self, publish_epoch: int,
                                execute_round: bool = False) -> ActivationTx:
        """One NIPoST cycle for ``publish_epoch``.

        Standalone mode sets execute_round=True: this node drives the poet
        round itself (reference launchStandalone runs an in-proc poet).
        """
        await self.register_challenge(publish_epoch)
        return await self.finish(publish_epoch, execute_round)

    async def finish(self, publish_epoch: int,
                     execute_round: bool = False) -> ActivationTx:
        """Phases 1-2: await the poet round, prove POST over its statement,
        assemble + sign + publish the ATX."""
        pending = getattr(self, "_pending", None)
        if pending is None or pending[0] != publish_epoch:
            raise RuntimeError("register_challenge was not called")
        _, prev, prev_id, challenge, round_id = pending
        node_id = self.signer.node_id

        # phase 1: poet round runs (await its result)
        if execute_round:
            result = await self.poet.execute_round(round_id)
        else:
            # result() may do blocking I/O (remote poet) — poll off-loop
            while (result := await asyncio.to_thread(
                    self.poet.result, round_id)) is None:
                # spacecheck: ok=SC001 off-loop poll pacing, not a protocol delay; elapses instantly in virtual time
                await asyncio.sleep(0.05)
        membership = result.membership(challenge)
        if membership is None:
            raise RuntimeError("challenge missing from poet round")
        # persist + gossip the poet proof so every node can validate the
        # ATXs that reference this round (reference gossips poet proofs)
        proof = result.proof
        from ..p2p.pubsub import TOPIC_POET
        from .poet import PoetBlob

        blob = PoetBlob(proof=proof, member_count=len(result.members))
        store_poet_blob(self.db, blob)
        await self.pubsub.publish(TOPIC_POET, blob.to_bytes())

        # phase 2: POST proof over the poet statement
        ch = post_challenge(proof.root, challenge)
        post_proof, meta = await asyncio.to_thread(self.post_client.proof, ch)
        # off-loop: remote clients (JSON-RPC or the gRPC Register stream)
        # block on IO and must never run on the event loop itself
        info = await asyncio.to_thread(self.post_client.info)

        atx = ActivationTx(
            publish_epoch=publish_epoch,
            prev_atx=prev_id,
            pos_atx=prev_id if prev is not None else self.golden_atx,
            commitment_atx=(commitment_of(node_id, self.golden_atx)
                            if prev is None else None),
            initial_post=None,
            nipost=NIPost(
                membership=membership,
                post=Post(nonce=post_proof.nonce,
                          indices=post_proof.indices,
                          pow_nonce=post_proof.pow_nonce),
                post_metadata=PostMetadataWire(
                    challenge=proof.id,
                    labels_per_unit=info.labels_per_unit)),
            num_units=info.num_units,
            vrf_nonce=info.vrf_nonce,
            vrf_public_key=self.signer.vrf_signer().public_key,
            coinbase=self.coinbase,
            node_id=node_id,
            signature=bytes(64))
        atx = dataclasses.replace(
            atx, signature=self.signer.sign(Domain.ATX, atx.signed_bytes()))
        await self.pubsub.publish(TOPIC_ATX, atx.to_bytes())
        return atx
