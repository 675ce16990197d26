"""Block generation + certification (port of
``spacemesh_tpu/consensus/blocks.py``, whole).

Mirrors reference blocks/: the Generator consumes hare ConsensusOutput,
aggregates the agreed proposals into one block (tx union with
deterministic ordering, weight-proportional rewards, generator.go:182),
saves + certifies; the Certifier collects eligibility-weighted signatures
over the hare output block until the threshold and stores/gossips the
Certificate (certifier.go:224, threshold :331).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import codec
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import Block, CertifyMessage, Certificate, Proposal, Reward
from ..p2p.pubsub import TOPIC_CERTIFY, PubSub
from ..storage import misc as miscstore
from ..storage.cache import AtxCache
from ..storage.db import Database
from .hare import ConsensusOutput
from .mesh import Mesh, ProposalStore


class Generator:
    def __init__(self, *, mesh: Mesh, proposals: ProposalStore,
                 cache: AtxCache, layers_per_epoch: int):
        self.mesh = mesh
        self.proposals = proposals
        self.cache = cache
        self.layers_per_epoch = layers_per_epoch

    def generate(self, out: ConsensusOutput) -> Optional[Block]:
        """Build the layer block from the agreed proposal ids."""
        props = [p for pid in out.proposals
                 if (p := self.proposals.get(pid)) is not None]
        if not props:
            return None
        epoch = out.layer // self.layers_per_epoch
        tx_ids: list[bytes] = []
        seen = set()
        rewards: dict[bytes, tuple[bytes, int]] = {}  # atx -> (coinbase, w)
        height = 0
        for p in sorted(props, key=lambda p: p.id):
            for tx in p.tx_ids:
                if tx not in seen:
                    seen.add(tx)
                    tx_ids.append(tx)
            weight = len(p.ballot.eligibilities)
            atx_id = p.ballot.atx_id
            coinbase = self._coinbase_of(epoch, p)
            prev = rewards.get(atx_id, (coinbase, 0))[1]
            rewards[atx_id] = (coinbase, prev + weight)
            info = self.cache.get(epoch, atx_id)
            if info is not None:
                height = max(height, info.height)
        block = Block(
            layer=out.layer, tick_height=height,
            rewards=[Reward(atx_id=a, coinbase=c, weight=w)
                     for a, (c, w) in sorted(rewards.items())],
            tx_ids=tx_ids)
        return block

    def _coinbase_of(self, epoch: int, p: Proposal) -> bytes:
        from ..storage import atxs as atxstore
        # version-independent: v2 (merged) identity rows share the
        # envelope blob but carry the coinbase column directly
        cb = atxstore.coinbase_of(self.mesh.db, p.ballot.atx_id)
        return cb if cb is not None else bytes(24)

    def process_hare_output(self, out: ConsensusOutput) -> Optional[Block]:
        block = self.generate(out)
        self.mesh.process_hare_output(block, out.layer)
        return block


class Certifier:
    """Collects threshold certificates over hare output blocks."""

    def __init__(self, *, db: Database, signer: EdSigner,
                 verifier: EdVerifier, pubsub: PubSub, oracle,
                 committee_size: int, threshold: int,
                 layers_per_epoch: int, beacon_getter, farm=None):
        self.db = db
        self.signer = signer
        self.verifier = verifier
        self.pubsub = pubsub
        self.oracle = oracle
        self.committee = committee_size
        self.threshold = threshold
        self.layers_per_epoch = layers_per_epoch
        self.beacon_getter = beacon_getter
        # verification farm (verify/farm.py); certificates are
        # block-critical, so their checks ride the BLOCK lane — a sync
        # flood must never delay certificate assembly
        self.farm = farm
        self._pending: dict[tuple[int, bytes], list[CertifyMessage]] = {}
        # callback(layer, block_id) on every ASSEMBLED threshold cert
        self.on_certificate = None
        pubsub.register(TOPIC_CERTIFY, self._gossip)

    async def _verify_sig(self, node_id: bytes, msg: bytes,
                          sig: bytes) -> bool:
        if self.farm is not None:
            from ..verify.farm import Lane, SigRequest

            return await self.farm.submit(
                SigRequest(int(Domain.CERTIFY), node_id, msg, sig),
                lane=Lane.BLOCK)
        return self.verifier.verify(Domain.CERTIFY, node_id, msg, sig)

    CERT_ROUND = 250  # distinct VRF round tag for certifier eligibility

    async def certify_if_eligible(self, layer: int, block_id: bytes,
                                  atx_id: bytes | None,
                                  signer: EdSigner | None = None) -> None:
        """Sign a certificate share if this (identity, layer) holds
        committee seats; multi-identity nodes call once per signer."""
        signer = signer or self.signer
        if atx_id is None:
            return
        epoch = layer // self.layers_per_epoch
        beacon = await self.beacon_getter(epoch)
        el = self.oracle.hare_eligibility(
            signer.vrf_signer(), beacon, layer, self.CERT_ROUND, epoch,
            atx_id, self.committee)
        if el is None:
            return
        proof, count = el
        msg = CertifyMessage(layer=layer, block_id=block_id,
                             eligibility_count=count, proof=proof,
                             atx_id=atx_id, node_id=signer.node_id,
                             signature=bytes(64))
        msg.signature = signer.sign(Domain.CERTIFY, msg.signed_bytes())
        await self.pubsub.publish(TOPIC_CERTIFY, msg.to_bytes())

    async def validate_certificate(self, layer: int,
                                   cert: Certificate) -> bool:
        """Verify a full certificate fetched from a peer (sync adoption,
        reference blocks/handler.go + certifier threshold check): every
        share signed, eligibility-validated, distinct, and the summed
        seat count reaching the threshold. A synced certificate is NEVER
        trusted on a peer's word."""
        epoch = layer // self.layers_per_epoch
        beacon = await self.beacon_getter(epoch)
        total = 0
        seen: set[bytes] = set()
        for msg in cert.signatures:
            if msg.layer != layer or msg.block_id != cert.block_id:
                return False
            if msg.node_id in seen:
                return False
            seen.add(msg.node_id)
            if not await self._verify_sig(msg.node_id, msg.signed_bytes(),
                                          msg.signature):
                return False
            info = self.oracle.cache.get(epoch, msg.atx_id)
            if info is None or info.node_id != msg.node_id:
                return False
            if not self.oracle.validate_hare(
                    beacon, msg.layer, self.CERT_ROUND, epoch, msg.atx_id,
                    self.committee, msg.proof, msg.eligibility_count):
                return False
            total += msg.eligibility_count
        return total >= self.threshold

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = CertifyMessage.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        if not await self._verify_sig(msg.node_id, msg.signed_bytes(),
                                      msg.signature):
            return False
        epoch = msg.layer // self.layers_per_epoch
        # the certifier must actually hold the committee seats it claims:
        # VRF-validated against its ATX weight (a bare keypair must not be
        # able to mint certificates)
        from ..storage.cache import AtxInfo  # noqa: F401 (doc anchor)
        info = self.oracle.cache.get(epoch, msg.atx_id)
        if info is None or info.node_id != msg.node_id:
            return False
        beacon = await self.beacon_getter(epoch)
        if not self.oracle.validate_hare(
                beacon, msg.layer, self.CERT_ROUND, epoch, msg.atx_id,
                self.committee, msg.proof, msg.eligibility_count):
            return False
        key = (msg.layer, msg.block_id)
        msgs = self._pending.setdefault(key, [])
        if any(m.node_id == msg.node_id for m in msgs):
            return True
        msgs.append(msg)
        if (sum(m.eligibility_count for m in msgs) >= self.threshold
                and miscstore.certificate(self.db, msg.layer) is None):
            cert = Certificate(block_id=msg.block_id, signatures=list(msgs))
            with self.db.tx():
                miscstore.add_certificate(self.db, msg.layer, cert)
            # a full certificate is the committee's decision for the
            # layer — the node must ADOPT it even if its own hare
            # failed there (App wires this to mesh.adopt_certified)
            if self.on_certificate is not None:
                self.on_certificate(msg.layer, msg.block_id)
        return True
