"""Miner: the proposal builder (port of
``spacemesh_tpu/consensus/miner.py``, whole).

Mirrors reference miner/proposal_builder.go: on each layer tick, for each
registered signer, compute the VRF eligibility slots landing in this layer
(:482 initSignerData), select txs from the conservative state, encode
tortoise votes, assemble + sign + publish the Proposal (:549 build). The
first ballot of an epoch carries EpochData (beacon + active-set root);
later ballots reference it.

Also the proposal gossip handler (reference proposals/handler.go):
validates incoming ballots (signature, slot eligibility via the oracle),
stores the proposal, and feeds the ballot to the tortoise with its
eligibility weight.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils import logging as slog

from ..core import codec
from ..core.hashing import sum256
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import (
    EMPTY32,
    Ballot,
    EpochData,
    Proposal,
    VotingEligibility,
)
from ..p2p.pubsub import TOPIC_PROPOSAL, PubSub
from ..storage import atxs as atxstore
from ..storage import ballots as ballotstore
from ..storage.cache import AtxCache
from ..storage.db import Database
from ..txs import ConservativeState
from .eligibility import Oracle
from .mesh import ProposalStore
from .tortoise import Tortoise

_log = slog.get("miner")

MAX_TXS_PER_PROPOSAL = 700


class _BadBeacon(str):
    """Truthy sentinel: ballot ingested but its beacon mismatches ours."""


BAD_BEACON = _BadBeacon("bad-beacon")


# single definition of the set-commitment hash (consensus/activeset.py);
# re-exported under the historical name
from .activeset import active_set_hash as active_set_root  # noqa: E402


class ProposalBuilder:
    def __init__(self, *, signer: EdSigner, db: Database, cache: AtxCache,
                 oracle: Oracle, tortoise: Tortoise,
                 cstate: ConservativeState, pubsub: PubSub,
                 layers_per_epoch: int, beacon_getter,
                 activeset_gen=None):
        self.signer = signer
        self.db = db
        self.cache = cache
        self.oracle = oracle
        self.tortoise = tortoise
        self.cstate = cstate
        self.pubsub = pubsub
        self.layers_per_epoch = layers_per_epoch
        self.beacon_getter = beacon_getter
        # graded three-path generator (consensus/activeset.py); falls back
        # to the full atxsdata view when it can't produce a set yet
        self.activeset_gen = activeset_gen

    def own_atx(self, epoch: int) -> Optional[bytes]:
        for atx_id, info in self.cache.iter_epoch(epoch):
            if info.node_id == self.signer.node_id:
                return atx_id
        return None

    async def build(self, layer: int) -> Optional[Proposal]:
        epoch = layer // self.layers_per_epoch
        atx_id = self.own_atx(epoch)
        if atx_id is None:
            return None
        # never double-mine a layer: a second (different) ballot in the
        # same layer is self-equivocation (reference proposal builder
        # skips layers it already built for; guards restarts and clock
        # anomalies like --genesis-now replays)
        if ballotstore.by_node_in_layer(self.db, self.signer.node_id, layer):
            return None
        beacon = await self.beacon_getter(epoch)
        vrf = self.signer.vrf_signer()

        # resolve the active set this ballot DECLARES first — slot counts
        # must be computed against that set's weight, matching what
        # validators recompute (activeset.declared_set_weight); otherwise
        # a builder whose local ATX view runs ahead of its declared set
        # would claim slot indices validators reject
        epoch_start = epoch * self.layers_per_epoch
        ref = ballotstore.refballot(self.db, self.signer.node_id,
                                    epoch_start, epoch_start + self.layers_per_epoch)
        epoch_data = None
        ref_id = EMPTY32
        from .activeset import declared_set_weight
        from ..storage import misc as miscstore
        if ref is None:
            active = None
            if self.activeset_gen is not None:
                try:
                    _, _, active = self.activeset_gen.generate(layer, epoch)
                except LookupError:
                    active = None
            if active is None:
                active = [a for a, _ in self.cache.iter_epoch(epoch)]
            root = active_set_root(active)
            miscstore.add_active_set(self.db, root, epoch, sorted(active))
            declared_total = declared_set_weight(
                self.db, self.cache, epoch, root) \
                if self.oracle.trusts_declared(epoch) else None
            epoch_data = EpochData(
                beacon=beacon, active_set_root=root,
                eligibility_count=self.oracle.num_slots(epoch, atx_id,
                                                        declared_total))
        else:
            ref_id = ref.id
            declared_total = None
            if ref.epoch_data is not None \
                    and self.oracle.trusts_declared(epoch):
                declared_total = declared_set_weight(
                    self.db, self.cache, epoch,
                    ref.epoch_data.active_set_root)

        slots = self.oracle.eligible_slots_for_layer(
            vrf, beacon, epoch, atx_id, layer, declared_total)
        if not slots:
            return None

        ballot = Ballot(
            layer=layer, atx_id=atx_id, epoch_data=epoch_data,
            ref_ballot=ref_id,
            eligibilities=[VotingEligibility(j=j, sig=proof)
                           for j, proof in slots],
            opinion=self.tortoise.encode_votes(layer),
            node_id=self.signer.node_id, signature=bytes(64))
        ballot = dataclasses.replace(
            ballot,
            signature=self.signer.sign(Domain.BALLOT, ballot.signed_bytes()))
        proposal = Proposal(
            ballot=ballot,
            tx_ids=self.cstate.select_proposal_txs(MAX_TXS_PER_PROPOSAL),
            mesh_hash=bytes(32), signature=bytes(64))
        proposal = dataclasses.replace(
            proposal, signature=self.signer.sign(Domain.BALLOT,
                                                 proposal.signed_bytes()))
        await self.pubsub.publish(TOPIC_PROPOSAL, proposal.to_bytes())
        return proposal


class ProposalHandler:
    def __init__(self, *, db: Database, cache: AtxCache, oracle: Oracle,
                 tortoise: Tortoise, store: ProposalStore,
                 verifier: EdVerifier, pubsub: PubSub,
                 layers_per_epoch: int, beacon_getter,
                 on_malfeasance=None, farm=None):
        self.db = db
        self.cache = cache
        self.oracle = oracle
        self.tortoise = tortoise
        self.store = store
        self.verifier = verifier
        # verification farm (verify/farm.py); None = inline verification
        self.farm = farm
        self.layers_per_epoch = layers_per_epoch
        self.beacon_getter = beacon_getter
        self.on_malfeasance = on_malfeasance
        # async root -> bool; wired to fetch.get_hashes(HINT_ACTIVESET)
        # once the network starts (app.start_network) — a ballot's
        # declared active set must be FETCHABLE, not just locally
        # resolvable, or validators fall back to their local epoch
        # weight and disagree with the builder
        self.fetch_active_set = None
        # async ballot_id -> bool; wired to HINT_BALLOT fetch — a
        # secondary ballot arriving before its ref ballot must fetch it,
        # not be permanently rejected by delivery order
        self.fetch_ballot = None
        pubsub.register(TOPIC_PROPOSAL, self._gossip)

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            proposal = Proposal.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        return await self.process(proposal)

    async def _declared_set_weight(self, epoch: int, epoch_data
                                   ) -> int | None:
        """Weight of the active set the ballot DECLARES (via its own or
        its ref ballot's EpochData.active_set_root) — see
        activeset.declared_set_weight. On a local miss the set is
        fetched from peers (content-addressed by its root) before
        falling back to the local epoch weight."""
        from .activeset import declared_set_weight

        if epoch_data is None:
            return None
        root = epoch_data.active_set_root
        total = declared_set_weight(self.db, self.cache, epoch, root)
        if total is None and self.fetch_active_set is not None:
            try:
                await self.fetch_active_set(root)
            except Exception:
                return None
            total = declared_set_weight(self.db, self.cache, epoch, root)
        return total

    async def _verify_sig(self, public_key: bytes, msg: bytes, sig: bytes,
                          lane) -> bool:
        """Ballot-domain signature check, farm-batched when a farm runs
        (verify/farm.py), inline otherwise — same verdict either way."""
        if self.farm is not None:
            from ..verify.farm import SigRequest

            return await self.farm.submit(
                SigRequest(int(Domain.BALLOT), public_key, msg, sig),
                lane=lane)
        return self.verifier.verify(Domain.BALLOT, public_key, msg, sig)

    async def ingest_ballot(self, ballot, lane=None) -> bool:
        """Full ballot validation + store + tortoise feed. ONE path for
        gossip proposals and synced ballots — sync must not be a weaker
        copy of the gossip checks (sync callers pass lane=Lane.SYNC so
        backfill floods queue behind live gossip in the farm). Returns
        False (rejected), True (ingested), or BAD_BEACON (ingested,
        truthy, but the ballot's beacon mismatches ours — its proposal
        must not feed hare)."""
        from ..verify.farm import Lane

        lane = Lane.GOSSIP if lane is None else lane
        if not await self._verify_sig(ballot.node_id, ballot.signed_bytes(),
                                      ballot.signature, lane):
            return False
        epoch = ballot.layer // self.layers_per_epoch
        info = self.cache.get(epoch, ballot.atx_id)
        if info is None or info.node_id != ballot.node_id:
            return False
        # eligibility verifies against the ballot's DECLARED beacon (its
        # own EpochData, or its ref ballot's) — reference
        # proposals/handler + miner/oracle semantics. A beacon MISMATCH
        # with our epoch beacon doesn't reject the ballot: it is
        # ingested with bad_beacon=True and its tortoise votes are
        # delayed (tortoise.go BadBeaconVoteDelayLayers), so the
        # majority chain's ballots survive a local beacon divergence
        # while a grinding adversary can't steer margins immediately.
        local_beacon = await self.beacon_getter(epoch)
        trusted = self.oracle.trusts_declared(epoch)
        if ballot.epoch_data is not None:
            # REF ballot: the smesher's first of the epoch. Its
            # eligibility count is computed from the DECLARED active
            # set's weight and checked against the declared count —
            # exactly ONCE per (smesher, epoch); every later ballot
            # reuses the validated number (reference
            # eligibility_validator.go validateReference).
            epoch_data = ballot.epoch_data
            declared_total = await self._declared_set_weight(
                epoch, epoch_data) if trusted else None
            if trusted and declared_total is None:
                # an unresolvable declared set must REJECT, not fall
                # back: skipping the count check would store an
                # attacker-chosen eligibility_count that every later
                # secondary ballot (and restart recovery) trusts as its
                # slot bound (reference
                # validateReference errors when the set can't be
                # resolved — sync redelivers once it is fetchable)
                return False
            bound = self.oracle.num_slots(epoch, ballot.atx_id,
                                          declared_total)
            if trusted and epoch_data.eligibility_count != bound:
                return False
        else:
            # SECONDARY ballot: must share smesher AND atx with its ref
            # ballot, whose validated eligibility count bounds j. A
            # missing ref is fetched (gossip order must not decide
            # validity), then the ballot is dropped if
            # still unresolvable; sync redelivers in layer order.
            ref = ballotstore.get(self.db, ballot.ref_ballot)
            if ref is None and self.fetch_ballot is not None:
                try:
                    await self.fetch_ballot(ballot.ref_ballot)
                except Exception as e:  # noqa: BLE001 — a failed fetch
                    # only delays validation (sync redelivers in layer
                    # order); log it so a systematically failing peer
                    # set is visible (spacecheck SC006)
                    _log.debug("ref-ballot fetch failed for %s: %r",
                               ballot.ref_ballot.hex()[:12], e)
                ref = ballotstore.get(self.db, ballot.ref_ballot)
            epoch_data = ballotstore.resolve_epoch_data(
                self.db, ballot, self.layers_per_epoch)
            if epoch_data is None:
                return False
            bound = epoch_data.eligibility_count if trusted \
                else self.oracle.num_slots(epoch, ballot.atx_id)
        beacon = epoch_data.beacon
        bad_beacon = beacon != local_beacon
        for el in ballot.eligibilities:
            if not self.oracle.validate_slot(beacon, epoch, ballot.atx_id,
                                             ballot.layer, el.j, el.sig,
                                             num_slots_override=bound):
                return False
        # double ballot in one (layer, signer) slot set -> malfeasance
        existing = ballotstore.by_node_in_layer(self.db, ballot.node_id,
                                                ballot.layer)
        for other in existing:
            if other.id != ballot.id:
                self.cache.set_malicious(ballot.node_id)
                if self.on_malfeasance:
                    self.on_malfeasance(ballot.node_id, other, ballot)
                return False
        with self.db.tx():
            ballotstore.add(self.db, ballot)
        unit = info.weight // max(bound, 1)
        self.tortoise.on_ballot(ballot, unit * len(ballot.eligibilities),
                                bad_beacon=bad_beacon)
        return True if not bad_beacon else BAD_BEACON

    async def process(self, proposal: Proposal) -> bool:
        from ..verify.farm import Lane

        ballot = proposal.ballot
        if not await self._verify_sig(ballot.node_id,
                                      proposal.signed_bytes(),
                                      proposal.signature, Lane.GOSSIP):
            return False
        ok = await self.ingest_ballot(ballot)
        if not ok:
            return False
        if ok is not BAD_BEACON:
            # only good-beacon proposals feed hare's candidate pool —
            # a ground beacon must not buy hare influence (reference:
            # hare only counts proposals matching the local beacon)
            self.store.add(proposal)
        return True
