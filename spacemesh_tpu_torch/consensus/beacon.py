"""Beacon: per-epoch shared randomness via proposals + weighted voting
(port of ``spacemesh_tpu/consensus/beacon.py``, whole).

Mirrors the reference beacon protocol (reference beacon/beacon.go:854
runProposalPhase, :934 runConsensusPhase; grading in handlers.go; weak
coin beacon/weakcoin/weak_coin.go; weighted majority votes_calc.go;
fallback beacon.go:239 UpdateBeacon):

  1. PROPOSAL phase: VRF-threshold-eligible smeshers gossip a VRF proof;
     receivers grade arrivals — on time (valid) or slightly late
     (potentially valid).
  2. FIRST VOTING round: participants vote FOR their valid set and
     AGAINST their potentially-valid set, signed, weighted by ATX weight.
  3. FOLLOW-UP rounds (rounds_number): each round tallies the previous
     round's weighted votes per proposal; the next own vote is FOR when
     margin > +theta*W, AGAINST when < -theta*W, and the round's WEAK
     COIN (lowest VRF output's last bit among participants) when the
     margin is inside the theta band.
  4. The final FOR-set hashes to the 4-byte epoch beacon.

Rounds end at their wall-clock deadline or as soon as every active
weight has voted (early completion keeps tests and small nets fast; the
deadline bounds adversarial stalling).

Fallback (bootstrap value) happens ONLY on explicit timeout/empty result
and is recorded with a reason; a protocol-decided beacon is final while
fallbacks may be superseded by a synced majority (storage.misc source).

Genesis epochs 0 and 1 use hash(genesis_id || epoch), as the reference
does (bootstrap beacon).
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct
import time

from ..core import codec
from ..core.codec import fixed, u8, u32, vec
from ..core.hashing import sum256
from ..core.signing import Domain, EdVerifier, VrfVerifier, vrf_output
from ..p2p.pubsub import (
    TOPIC_BEACON_FIRST,
    TOPIC_BEACON_FOLLOW,
    TOPIC_BEACON_PROPOSAL,
    TOPIC_BEACON_WEAK_COIN,
    PubSub,
)
from ..storage import misc as miscstore
from ..storage.db import Database
from ..utils.logging import get as get_logger
from ..core.fixedpoint import ONE as FIXED, frac_from_bytes
from .eligibility import Oracle

BEACON_SIZE = 4

log = get_logger("beacon")


def proposal_alpha(epoch: int) -> bytes:
    return b"BEACON" + struct.pack("<I", epoch)


def weak_coin_alpha(epoch: int, round_: int) -> bytes:
    return b"BWC" + struct.pack("<IH", epoch, round_)


def proposal_id(vrf_proof: bytes) -> bytes:
    return sum256(vrf_output(vrf_proof))


@codec.register
class BeaconProposal:
    epoch: int
    atx_id: bytes
    node_id: bytes
    vrf_proof: bytes

    FIELDS = [("epoch", u32), ("atx_id", fixed(32)), ("node_id", fixed(32)),
              ("vrf_proof", fixed(80))]


@codec.register
class FirstVotes:
    epoch: int
    valid: list[bytes]           # proposal ids graded on-time
    late: list[bytes]            # potentially valid (graded late)
    atx_id: bytes
    node_id: bytes
    signature: bytes

    FIELDS = [("epoch", u32), ("valid", vec(fixed(32), 1 << 10)),
              ("late", vec(fixed(32), 1 << 10)), ("atx_id", fixed(32)),
              ("node_id", fixed(32)), ("signature", fixed(64))]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()


@codec.register
class FollowVotes:
    epoch: int
    round: int
    votes_for: list[bytes]       # current FOR-set; everything else AGAINST
    atx_id: bytes
    node_id: bytes
    signature: bytes

    FIELDS = [("epoch", u32), ("round", u8),
              ("votes_for", vec(fixed(32), 1 << 10)), ("atx_id", fixed(32)),
              ("node_id", fixed(32)), ("signature", fixed(64))]

    def signed_bytes(self) -> bytes:
        return dataclasses.replace(self, signature=bytes(64)).to_bytes()


@codec.register
class WeakCoinMsg:
    epoch: int
    round: int
    atx_id: bytes
    node_id: bytes
    vrf_proof: bytes

    FIELDS = [("epoch", u32), ("round", u8), ("atx_id", fixed(32)),
              ("node_id", fixed(32)), ("vrf_proof", fixed(80))]


@dataclasses.dataclass
class _EpochState:
    started: float | None = None            # proposal phase start (local)
    # node_id -> (pid, grade) — grade 1 on-time, 0 potentially-valid
    proposals: dict = dataclasses.field(default_factory=dict)
    # node_id -> FirstVotes
    first_votes: dict = dataclasses.field(default_factory=dict)
    # round -> node_id -> FollowVotes
    follow_votes: dict = dataclasses.field(default_factory=dict)
    # round -> lowest weak-coin VRF output seen
    coin: dict = dataclasses.field(default_factory=dict)


class ProtocolDriver:
    def __init__(self, *, db: Database, oracle: Oracle, pubsub: PubSub,
                 genesis_id: bytes, verifier: EdVerifier | None = None,
                 proposal_duration: float = 1.0,
                 first_voting_round_duration: float = 2.0,
                 voting_round_duration: float = 1.0,
                 rounds_number: int = 4, grace_period: float = 0.5,
                 kappa: int = 40, theta: float = 0.25,
                 on_fallback_used=None, wall=time.time):
        self.db = db
        self.oracle = oracle
        self.pubsub = pubsub
        self.genesis_id = genesis_id
        self.verifier = verifier or EdVerifier(prefix=genesis_id)
        self.proposal_duration = proposal_duration
        self.first_duration = first_voting_round_duration
        self.round_duration = voting_round_duration
        self.rounds = max(rounds_number, 1)
        self.grace = grace_period
        self.kappa = kappa
        self.theta = theta
        self.on_fallback_used = on_fallback_used
        self.wall = wall
        self._states: dict[int, _EpochState] = {}
        self._ready: dict[int, asyncio.Event] = {}
        self._vrf = VrfVerifier()
        pubsub.register(TOPIC_BEACON_PROPOSAL, self._on_proposal)
        pubsub.register(TOPIC_BEACON_FIRST, self._on_first)
        pubsub.register(TOPIC_BEACON_FOLLOW, self._on_follow)
        pubsub.register(TOPIC_BEACON_WEAK_COIN, self._on_coin)

    # --- timing ------------------------------------------------------

    def protocol_duration(self) -> float:
        return (self.proposal_duration + self.first_duration
                + self.rounds * self.round_duration + self.grace)

    def _state(self, epoch: int) -> _EpochState:
        return self._states.setdefault(epoch, _EpochState())

    def _bootstrap(self, epoch: int) -> bytes:
        return sum256(self.genesis_id, struct.pack("<I", epoch))[:BEACON_SIZE]

    # --- public reads ------------------------------------------------

    async def get(self, epoch: int) -> bytes:
        """The beacon for ``epoch`` (blocks until decided or falls back
        after the full protocol window with a recorded reason)."""
        if epoch <= 1:
            return self._bootstrap(epoch)
        stored = miscstore.get_beacon(self.db, epoch)
        if stored is not None:
            return stored
        ev = self._ready.setdefault(epoch, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(),
                                   timeout=self.protocol_duration() + self.grace)
        except asyncio.TimeoutError:
            pass
        stored = miscstore.get_beacon(self.db, epoch)
        if stored is not None:
            return stored
        self._record_fallback(epoch, "timeout waiting for beacon protocol")
        return miscstore.get_beacon(self.db, epoch) or self._bootstrap(epoch)

    def get_now(self, epoch: int) -> bytes:
        if epoch <= 1:
            return self._bootstrap(epoch)
        stored = miscstore.get_beacon(self.db, epoch)
        return stored if stored is not None else self._bootstrap(epoch)

    def _record_fallback(self, epoch: int, reason: str) -> None:
        log.warning("epoch %d: beacon fallback (%s)", epoch, reason)
        if miscstore.get_beacon(self.db, epoch) is None:
            # GUESS, not FALLBACK: this is a locally-derived provisional
            # value, which the protocol (or any network adoption) may
            # overwrite
            miscstore.set_beacon(self.db, epoch, self._bootstrap(epoch),
                                 source=miscstore.BEACON_GUESS)
        if self.on_fallback_used:
            self.on_fallback_used(epoch, reason)
        self._ready.setdefault(epoch, asyncio.Event()).set()

    # --- gossip handlers ---------------------------------------------

    def _proposal_eligible(self, epoch: int, proof: bytes) -> bool:
        """VRF-threshold eligibility: expect ~kappa proposers per epoch
        (reference beacon proposal checker). Small nets pass trivially."""
        count = max(self.oracle.cache.epoch_count(epoch), 1)
        thresh = min(FIXED, FIXED * self.kappa // count)
        return frac_from_bytes(vrf_output(proof)) < thresh

    async def _on_proposal(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = BeaconProposal.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        key = self.oracle.vrf_key(msg.epoch, msg.atx_id)
        if key is None or key != msg.node_id:
            return False
        if not self._vrf.verify(key, proposal_alpha(msg.epoch), msg.vrf_proof):
            return False
        if not self._proposal_eligible(msg.epoch, msg.vrf_proof):
            return False
        st = self._state(msg.epoch)
        now = self.wall()
        if st.started is None:
            grade = 1  # we haven't started the phase locally; be generous
        elif now <= st.started + self.proposal_duration + self.grace:
            grade = 1
        elif now <= st.started + 2 * (self.proposal_duration + self.grace):
            grade = 0
        else:
            return False  # far too late
        st.proposals.setdefault(msg.node_id,
                                (proposal_id(msg.vrf_proof), grade))
        return True

    def _vote_weight(self, epoch: int, atx_id: bytes,
                     node_id: bytes) -> int | None:
        info = self.oracle.cache.get(epoch, atx_id)
        if info is None or info.malicious or info.node_id != node_id:
            return None
        return info.weight

    async def _on_first(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = FirstVotes.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        if self._vote_weight(msg.epoch, msg.atx_id, msg.node_id) is None:
            return False
        if not self.verifier.verify(Domain.BEACON_FIRST_MSG, msg.node_id,
                                    msg.signed_bytes(), msg.signature):
            return False
        self._state(msg.epoch).first_votes.setdefault(msg.node_id, msg)
        return True

    async def _on_follow(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = FollowVotes.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        if msg.round < 1 or msg.round > self.rounds:
            return False
        if self._vote_weight(msg.epoch, msg.atx_id, msg.node_id) is None:
            return False
        if not self.verifier.verify(Domain.BEACON_FOLLOWUP_MSG, msg.node_id,
                                    msg.signed_bytes(), msg.signature):
            return False
        st = self._state(msg.epoch)
        st.follow_votes.setdefault(msg.round, {}).setdefault(msg.node_id, msg)
        return True

    async def _on_coin(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = WeakCoinMsg.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        key = self.oracle.vrf_key(msg.epoch, msg.atx_id)
        if key is None or key != msg.node_id:
            return False
        if not self._vrf.verify(key, weak_coin_alpha(msg.epoch, msg.round),
                                msg.vrf_proof):
            return False
        out = vrf_output(msg.vrf_proof)
        st = self._state(msg.epoch)
        cur = st.coin.get(msg.round)
        if cur is None or out < cur:
            st.coin[msg.round] = out
        return True

    # --- the per-epoch protocol --------------------------------------

    async def _sleep_until(self, deadline: float,
                           done=None, tick: float = 0.02) -> None:
        """Wait for the wall-clock deadline, or early-complete when
        ``done()`` says every active weight has been heard."""
        while True:
            now = self.wall()
            if now >= deadline:
                return
            if done is not None and done():
                return
            await asyncio.sleep(min(tick, deadline - now))

    def _total_weight(self, epoch: int) -> int:
        return self.oracle.cache.epoch_weight(epoch)

    def _voted_weight(self, epoch: int, votes: dict) -> int:
        total = 0
        for node_id, msg in votes.items():
            w = self._vote_weight(epoch, msg.atx_id, node_id)
            if w:
                total += w
        return total

    async def run_epoch(self, epoch: int, signer, vrf_signer,
                        atx_id: bytes | None,
                        participants: list | None = None) -> bytes:
        """Run the full protocol for ``epoch``. Observers (atx_id=None)
        tally without voting and still converge on the majority value.
        Multi-identity nodes pass ``participants`` as a list of
        (signer, vrf_signer, atx_id) — every identity proposes and votes
        with its own weight (reference beacon iterates registered
        signers)."""
        if epoch <= 1:
            return self._bootstrap(epoch)
        stored = miscstore.get_beacon(self.db, epoch)
        if stored is not None:
            if (miscstore.beacon_source(self.db, epoch)
                    != miscstore.BEACON_GUESS):
                # final, or a NETWORK-adopted fallback (sync majority /
                # checkpoint / bootstrap file): a late joiner re-running
                # the protocol solo would overwrite the network's value
                # with a self-derived one and mark it final
                return stored
            # stored is OUR OWN timeout-guess (an early get() fell back
            # to the local bootstrap derivation): the protocol hasn't
            # actually run — run it and let the decided value overwrite
            # the provisional one
        if participants is None:
            participants = ([(signer, vrf_signer, atx_id)]
                            if atx_id is not None else [])
        st = self._state(epoch)
        start = self.wall()
        if st.started is None:
            st.started = start
        total_w = self._total_weight(epoch)

        # --- phase 1: proposals ---
        for p_signer, p_vrf, p_atx in participants:
            proof = p_vrf.prove(proposal_alpha(epoch))
            if self._proposal_eligible(epoch, proof):
                msg = BeaconProposal(epoch=epoch, atx_id=p_atx,
                                     node_id=p_signer.node_id,
                                     vrf_proof=proof)
                await self.pubsub.publish(TOPIC_BEACON_PROPOSAL,
                                          msg.to_bytes())
        await self._sleep_until(start + self.proposal_duration)

        valid = sorted(p for p, g in st.proposals.values() if g == 1)
        late = sorted(p for p, g in st.proposals.values() if g == 0)

        # --- phase 2: first voting round ---
        for p_signer, _p_vrf, p_atx in participants:
            fv = FirstVotes(epoch=epoch, valid=valid, late=late,
                            atx_id=p_atx, node_id=p_signer.node_id,
                            signature=bytes(64))
            fv.signature = p_signer.sign(Domain.BEACON_FIRST_MSG,
                                         fv.signed_bytes())
            await self.pubsub.publish(TOPIC_BEACON_FIRST, fv.to_bytes())
        first_deadline = start + self.proposal_duration + self.first_duration
        await self._sleep_until(
            first_deadline,
            done=lambda: total_w > 0 and self._voted_weight(
                epoch, st.first_votes) >= total_w)

        # tally first votes: FOR valid, AGAINST late
        candidates: set[bytes] = set(valid) | set(late)
        margins: dict[bytes, int] = {}
        for node_id, msg in st.first_votes.items():
            w = self._vote_weight(epoch, msg.atx_id, node_id) or 0
            for p in msg.valid:
                candidates.add(p)
                margins[p] = margins.get(p, 0) + w
            for p in msg.late:
                candidates.add(p)
                margins[p] = margins.get(p, 0) - w

        # --- phase 3: follow-up rounds with weak coin ---
        theta_w = max(int(self.theta * total_w), 1)
        own: set[bytes] = {p for p in candidates if margins.get(p, 0) > 0}
        for rnd in range(1, self.rounds + 1):
            round_start = first_deadline + (rnd - 1) * self.round_duration
            for p_signer, p_vrf, p_atx in participants:
                # weak coin VRF for this round
                wc = WeakCoinMsg(epoch=epoch, round=rnd, atx_id=p_atx,
                                 node_id=p_signer.node_id,
                                 vrf_proof=p_vrf.prove(
                                     weak_coin_alpha(epoch, rnd)))
                await self.pubsub.publish(TOPIC_BEACON_WEAK_COIN,
                                          wc.to_bytes())
                fw = FollowVotes(epoch=epoch, round=rnd,
                                 votes_for=sorted(own), atx_id=p_atx,
                                 node_id=p_signer.node_id,
                                 signature=bytes(64))
                fw.signature = p_signer.sign(Domain.BEACON_FOLLOWUP_MSG,
                                             fw.signed_bytes())
                await self.pubsub.publish(TOPIC_BEACON_FOLLOW, fw.to_bytes())
            votes = st.follow_votes.setdefault(rnd, {})
            await self._sleep_until(
                round_start + self.round_duration,
                done=lambda v=votes: total_w > 0 and self._voted_weight(
                    epoch, v) >= total_w)
            # weighted tally of this round's votes
            margins = {}
            for node_id, msg in votes.items():
                w = self._vote_weight(epoch, msg.atx_id, node_id) or 0
                fset = set(msg.votes_for)
                for p in candidates:
                    margins[p] = margins.get(p, 0) + (w if p in fset else -w)
            coin_bit = bool(st.coin.get(rnd, b"\0")[-1] & 1)
            nxt: set[bytes] = set()
            for p in candidates:
                m = margins.get(p, 0)
                if m > theta_w:
                    nxt.add(p)
                elif m < -theta_w:
                    continue
                elif coin_bit:
                    # weak coin decides inside the theta band
                    nxt.add(p)
            own = nxt

        if own:
            beacon = sum256(*sorted(own))[:BEACON_SIZE]
            miscstore.set_beacon(self.db, epoch, beacon,
                                 source=miscstore.BEACON_PROTOCOL)
            log.info("epoch %d: beacon %s from %d proposals", epoch,
                     beacon.hex(), len(own))
            self._ready.setdefault(epoch, asyncio.Event()).set()
        else:
            self._record_fallback(epoch, "no proposals survived voting")
            beacon = miscstore.get_beacon(self.db, epoch) or \
                self._bootstrap(epoch)
        self._states.pop(epoch - 2, None)  # bounded memory
        return beacon

    def on_fallback(self, epoch: int, beacon: bytes) -> None:
        """Bootstrap/sync-provided beacon (reference beacon.go:239
        UpdateBeacon). A fallback value may supersede an earlier fallback
        (a later peer majority corrects a poisoned/raced first write) but
        never a protocol-decided beacon."""
        source = miscstore.beacon_source(self.db, epoch)
        if source == miscstore.BEACON_PROTOCOL:
            return
        miscstore.set_beacon(self.db, epoch, beacon,
                             source=miscstore.BEACON_FALLBACK)
        self._ready.setdefault(epoch, asyncio.Event()).set()
