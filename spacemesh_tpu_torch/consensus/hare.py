"""Hare: per-layer BFT agreement on the proposal set (port of
``spacemesh_tpu/consensus/hare.py``, whole).

Mirrors the reference hare's role and message flow (reference hare4/: a
per-layer session of VRF-eligible committee members emitting a
ConsensusOutput of proposal ids consumed by the block generator,
hare4/hare.go:708; equivocation -> malfeasance).  Decisions come from the
PROVEN graded protocol core in ``hare3.py`` (reference hare3/protocol.go,
reused by hare4): graded-gossip, gradecast and thresh-gossip over the
8-round iteration

  preround | hardlock softlock propose wait1 wait2 commit notify | ...

Late or equivocating leaders are handled by GRADES (arrival delay vs. the
propose round, conflict-surfacing delay), not acceptance windows.  On the
WIRE only the four message rounds exist (preround/propose/commit/notify,
same encoding as before — commit/notify carry the full value set; the
protocol's reference hash is the values root).  Rounds are wall-clock
slots (round_duration) measured from the layer start, so honest nodes
move in lockstep like the reference's 25 s mainnet rounds; sessions are
driven concurrently with the layer loop because one session legitimately
outlives its layer (reference runs per-layer goroutines the same way).

On top of the proven core this implementation keeps NOTIFY commit
certificates: a NOTIFY must carry observed COMMIT messages proving the
threshold, so a bare keypair cannot fabricate agreement for gossip
consumers that missed the commits (a deliberate strengthening; the
reference relies on thresh-gossip alone)."""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Awaitable, Callable, Optional

from ..core import codec
from ..core.codec import fixed, u8, u16, u32, vec
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import EMPTY32
from ..p2p.pubsub import TOPIC_HARE, PubSub
from . import hare3
from .eligibility import Oracle

# wire round tags (unchanged encoding); the protocol's internal 8-round
# structure maps onto these four message rounds
PREROUND, PROPOSE, COMMIT, NOTIFY = 0, 1, 2, 3

_WIRE_TO_PROTO = {PREROUND: hare3.PREROUND, PROPOSE: hare3.PROPOSE,
                  COMMIT: hare3.COMMIT, NOTIFY: hare3.NOTIFY}
_PROTO_TO_WIRE = {v: k for k, v in _WIRE_TO_PROTO.items()}


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


def compact_id(full: bytes) -> bytes:
    return full[:COMPACT_ID_SIZE]


def values_root(values: list[bytes]) -> bytes:
    from ..core.hashing import sum256

    return sum256(*values) if values else bytes(32)


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


TOPIC_HARE_COMPACT = "b4"
P_FULL_EXCHANGE = "hf/1"   # (layer, iteration, round, node_id) -> full ids


@dataclasses.dataclass
class ConsensusOutput:
    layer: int
    proposals: list[bytes]       # agreed proposal ids (may be empty)
    # False when the session hit its iteration limit WITHOUT agreement:
    # the layer is undecided and belongs to the tortoise, which is a
    # different thing from hare positively agreeing on "empty"
    # (reference hare reports no output on failure; layerpatrol hands
    # the layer to the syncer/tortoise)
    completed: bool = True
    # weak coin for the layer: LSB of the lowest preround eligibility
    # VRF seen (reference hare weakcoin; tortoise healing tie-break)
    coin: Optional[bool] = None


@dataclasses.dataclass
class Equivocation:
    node_id: bytes
    msg1: bytes
    sig1: bytes
    msg2: bytes
    sig2: bytes


class HareSession:
    """One layer's protocol instance."""

    def __init__(self, hare: "Hare", layer: int, proposals: list[bytes]):
        self.h = hare
        self.layer = layer
        self.my_proposals = sorted(proposals)
        # the proven graded machine makes every decision (hare3.py)
        self.protocol = hare3.Protocol(
            hare.committee_for(layer) // 2 + 1)
        self.commits: dict[bytes, tuple[int, tuple]] = {}
        # (iteration, values) -> node_id -> (raw COMMIT, its own seat
        # count) — kept to assemble the NOTIFY commit certificate; the
        # count MUST come from the stored message, not the node's latest
        # commit (per-round VRF counts differ and receivers sum the raws)
        self.commit_raw: dict[tuple, dict[bytes, tuple[bytes, int]]] = {}
        self.output: Optional[list[bytes]] = None
        self.seen: dict[tuple, tuple[bytes, bytes]] = {}  # equivocation watch
        self.excluded: set[bytes] = set()  # equivocators (reporting dedup)

    # --- message handling ------------------------------------------

    def on_message(self, msg: HareMessage, raw_signed: bytes | None = None,
                   raw_full: bytes | None = None) -> bool:
        """Feed one validated wire message to the graded protocol; returns
        the graded-gossip relay decision.  ``raw_signed``/``raw_full``
        override the wire bytes used for the equivocation report and
        certificate assembly — compact-mode messages keep their COMPACT
        encoding (that's what signatures cover and certificates carry)."""
        from ..core.hashing import sum256
        from ..core.signing import vrf_output

        raw = raw_signed if raw_signed is not None else msg.signed_bytes()
        key = (msg.node_id, msg.iteration, msg.round)
        prev = self.seen.setdefault(key, (raw, msg.signature))
        sorted_values = sorted(msg.values)
        inp = hare3.Input(
            sender=msg.node_id,
            ir=hare3.IterRound(msg.iteration, _WIRE_TO_PROTO[msg.round]),
            eligibility_count=msg.eligibility_count,
            vrf=vrf_output(msg.eligibility_proof),
            msg_hash=sum256(raw),
            values=(sorted_values if msg.round in (PREROUND, PROPOSE)
                    else None),
            reference=(values_root(sorted_values)
                       if msg.round in (COMMIT, NOTIFY) else None))
        relay, equivocation = self.protocol.on_input(inp)
        if equivocation is not None and msg.node_id not in self.excluded:
            self.excluded.add(msg.node_id)  # report once per identity
            self.h._report_equivocation(msg.node_id, prev, raw,
                                        msg.signature)
        if not relay:
            return False
        if msg.round == COMMIT:
            # certificate bookkeeping only — weight DECISIONS live in the
            # graded protocol (hare3.Protocol)
            w = msg.eligibility_count
            self.commits[msg.node_id] = (w, tuple(sorted_values))
            self.commit_raw.setdefault(
                (msg.iteration, tuple(sorted_values)), {})[msg.node_id] = \
                (raw_full if raw_full is not None else msg.to_bytes(), w)
        return True

    def commit_weight(self, values: tuple) -> int:
        return sum(w for n, (w, v) in self.commits.items()
                   if v == values and n not in self.excluded)

    def build_certificate(self, iteration: int, values: tuple,
                          threshold: int) -> list[bytes]:
        """Enough observed COMMIT messages for ``values`` to prove the
        threshold was reached (carried in NOTIFY)."""
        raws = self.commit_raw.get((iteration, values), {})
        out, total = [], 0
        for node_id, (raw, w) in raws.items():
            if node_id in self.excluded:
                continue
            out.append(raw)
            total += w
            if total >= threshold:
                return out
        return out if total >= threshold else []


class Hare:
    def __init__(self, *, signer: EdSigner | None = None,
                 signers: list[EdSigner] | None = None,
                 verifier: EdVerifier,
                 oracle: Oracle, pubsub: PubSub, committee_size: int,
                 round_duration: float, iteration_limit: int,
                 layers_per_epoch: int,
                 beacon_of: Callable[[int], Awaitable[bytes]],
                 atx_for: Callable[[int, bytes], Optional[bytes]],
                 proposals_for: Callable[[int], list[bytes]],
                 on_output: Callable[[ConsensusOutput], Awaitable[None]],
                 on_equivocation=None, preround_delay: float = 0.0,
                 wall=None, compact: bool = False, server=None,
                 committee_upgrade: tuple[int, int] | None = None,
                 compact_enable_layer: int | None = None):
        """Multi-identity: every signer in ``signers`` participates with
        its own eligibility (reference hare iterates registered signers);
        atx_for(epoch, node_id) resolves each signer's ATX.

        ``compact=True`` switches sends to hare4-style 4-byte proposal-id
        prefixes + a values root (topic b4); receivers reconstruct from
        their proposal store and fall back to the hf/1 full exchange on
        ``server`` (reference hare4/hare.go:328 fetchFull)."""
        import time as _time

        self.signers = signers if signers is not None else [signer]
        self.verifier = verifier
        self.oracle = oracle
        self.pubsub = pubsub
        self.committee = committee_size
        self.round_duration = round_duration
        self.iteration_limit = iteration_limit
        self.preround_delay = preround_delay
        self.wall = wall or _time.time
        self.layers_per_epoch = layers_per_epoch
        self.beacon_of = beacon_of
        self.atx_for = atx_for
        self.proposals_for = proposals_for
        self.on_output = on_output
        self.on_equivocation = on_equivocation
        self.sessions: dict[int, HareSession] = {}
        # COMMIT messages already fully validated via gossip: their raw
        # bytes skip the crypto re-check inside NOTIFY certificates
        # (ECVRF verifies are the expensive part of cert validation)
        self._valid_commits: dict[bytes, None] = {}
        # messages for layers whose session hasn't started here yet — peers'
        # clocks are never perfectly aligned (reference buffers early
        # messages the same way)
        self._pending: dict[int, list] = {}  # (msg, raw_signed, raw_full)
        self._pending_cap = 1 << 10
        self.compact = compact
        # (layer, size): from that layer on the committee size switches
        # (reference hare4/hare.go:52 CommitteeUpgrade + :74 CommitteeFor)
        self.committee_upgrade = tuple(committee_upgrade) \
            if committee_upgrade else None
        # layer-gated plain->compact protocol switch (reference
        # node/node.go:915-943: hare3 serves layers below the hare4
        # enable layer, hare4 takes over from it)
        self.compact_enable_layer = compact_enable_layer
        self.server = server
        # full value lists we can serve over hf/1:
        # (layer, iteration, round, node_id) -> list of full ids
        self._full_values: dict[tuple, list[bytes]] = {}
        pubsub.register(TOPIC_HARE, self._gossip)
        if compact or compact_enable_layer is not None:
            pubsub.register(TOPIC_HARE_COMPACT, self._gossip_compact)
        if server is not None:
            server.register(P_FULL_EXCHANGE, self._serve_full)

    # --- per-layer protocol parameters ------------------------------

    def committee_for(self, layer: int) -> int:
        """Committee size for a layer (reference hare4/hare.go:73-78
        CommitteeFor: the upgrade takes effect at its layer)."""
        if self.committee_upgrade and layer >= self.committee_upgrade[0]:
            return self.committee_upgrade[1]
        return self.committee

    def compact_for(self, layer: int) -> bool:
        """Whether this layer speaks the compact (hare4) wire format."""
        if self.compact_enable_layer is not None:
            return layer >= self.compact_enable_layer
        return self.compact

    # --- gossip ingestion ------------------------------------------

    async def _gossip(self, peer: bytes, data: bytes) -> bool:
        try:
            msg = HareMessage.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        if not self.verifier.verify(Domain.HARE, msg.node_id,
                                    msg.signed_bytes(), msg.signature):
            return False
        epoch = msg.layer // self.layers_per_epoch
        beacon = await self.beacon_of(epoch)
        round_tag = msg.iteration * 4 + msg.round
        if not self.oracle.validate_hare(
                beacon, msg.layer, round_tag, epoch, msg.atx_id,
                self.committee_for(msg.layer), msg.eligibility_proof,
                msg.eligibility_count):
            return False
        if msg.round == COMMIT:
            self._remember_valid_commit(data)
        # NOTIFY must PROVE its commit threshold: a valid commit
        # certificate travels with it (reference hare certificates) — a
        # bare keypair cannot fabricate agreement
        if msg.round == NOTIFY and not await self._validate_cert(
                msg.layer, msg.iteration, values_root(sorted(msg.values)),
                msg.cert_msgs):
            return False
        return self._dispatch(msg)

    def _remember_valid_commit(self, raw: bytes) -> None:
        self._valid_commits[raw] = None
        if len(self._valid_commits) > (1 << 12):
            for k in list(self._valid_commits)[:1 << 10]:
                del self._valid_commits[k]

    def _dispatch(self, msg: HareMessage, raw_signed: bytes | None = None,
                  raw_full: bytes | None = None):
        """Graded-gossip relay decision: True = relay, None = accept but
        suppress relay (duplicate / post-equivocation copy) — NEVER False
        here, because the delivering peer did nothing wrong and must not
        be penalized for a duplicate (reference protocol.go:349-376)."""
        session = self.sessions.get(msg.layer)
        if session is not None:
            return True if session.on_message(msg, raw_signed, raw_full) \
                else None
        buf = self._pending.setdefault(msg.layer, [])
        if len(buf) < self._pending_cap:
            buf.append((msg, raw_signed, raw_full))
        return True  # not judged yet: let it propagate

    # --- compaction (reference hare4) -------------------------------

    async def _serve_full(self, peer: bytes, data: bytes) -> bytes:
        """hf/1: (layer u32, iteration u8, round u8, node_id 32) -> the
        full 32-byte proposal ids behind a compact message we hold."""
        import struct

        if len(data) != 4 + 1 + 1 + 32:
            return b""
        layer, iteration, round_ = struct.unpack_from("<IBB", data)
        node_id = data[6:38]
        fulls = self._full_values.get((layer, iteration, round_, node_id))
        return b"".join(fulls) if fulls else b""

    def _remember_full(self, key: tuple, values: list[bytes]) -> None:
        self._full_values[key] = list(values)
        if len(self._full_values) > (1 << 12):
            for k in list(self._full_values)[:1 << 10]:
                del self._full_values[k]

    async def _reconstruct(self, peer: bytes,
                           cm: "CompactHareMessage") -> list[bytes] | None:
        """Recover the full proposal ids behind a compact message: local
        proposal store first (prefix match + root check), then the full
        exchange with the delivering peer (reference hare4
        reconstructProposals + fetchFull)."""
        cached = self._full_values.get(
            (cm.layer, cm.iteration, cm.round, cm.node_id))
        if cached is not None and values_root(cached) == cm.root:
            return cached  # own sends / already reconstructed
        by_prefix = {compact_id(f): f
                     for f in self.proposals_for(cm.layer)}
        fulls = [by_prefix.get(c) for c in cm.compact_ids]
        if all(f is not None for f in fulls):
            candidate = sorted(fulls)
            if values_root(candidate) == cm.root:
                return candidate
        if self.server is None or peer not in self.server.peers():
            return None
        import struct

        try:
            resp = await self.server.request(
                peer, P_FULL_EXCHANGE,
                struct.pack("<IBB", cm.layer, cm.iteration, cm.round)
                + cm.node_id, timeout=5.0)
        except Exception:  # noqa: BLE001 — peer gone: reconstruction fails
            return None
        if len(resp) % 32:
            return None
        candidate = sorted(resp[i:i + 32] for i in range(0, len(resp), 32))
        if values_root(candidate) != cm.root:
            return None
        if [compact_id(f) for f in candidate] != list(cm.compact_ids):
            return None
        return candidate

    async def _gossip_compact(self, peer: bytes, data: bytes) -> bool:
        try:
            cm = CompactHareMessage.from_bytes(data)
        except (codec.DecodeError, ValueError):
            return False
        if not self.verifier.verify(Domain.HARE, cm.node_id,
                                    cm.signed_bytes(), cm.signature):
            return False
        epoch = cm.layer // self.layers_per_epoch
        beacon = await self.beacon_of(epoch)
        round_tag = cm.iteration * 4 + cm.round
        if not self.oracle.validate_hare(
                beacon, cm.layer, round_tag, epoch, cm.atx_id,
                self.committee_for(cm.layer), cm.eligibility_proof,
                cm.eligibility_count):
            return False
        if cm.round == NOTIFY and not await self._validate_cert(
                cm.layer, cm.iteration, cm.root, cm.cert_msgs):
            return False
        values = await self._reconstruct(peer, cm)
        if values is None:
            return False
        key = (cm.layer, cm.iteration, cm.round, cm.node_id)
        self._remember_full(key, values)  # we can now serve hf/1 ourselves
        if cm.round == COMMIT:
            self._remember_valid_commit(data)
        full = HareMessage(
            layer=cm.layer, iteration=cm.iteration, round=cm.round,
            values=values, eligibility_proof=cm.eligibility_proof,
            eligibility_count=cm.eligibility_count, atx_id=cm.atx_id,
            node_id=cm.node_id, cert_msgs=[], signature=cm.signature)
        return self._dispatch(full, raw_signed=cm.signed_bytes(),
                              raw_full=data)

    async def _validate_cert(self, layer: int, iteration: int,
                             expected_root: bytes,
                             cert_msgs: list[bytes]) -> bool:
        """ONE cert validator for both wire formats: every inner COMMIT
        (full or compact encoding) decodes, is signed,
        eligibility-validated for the same (layer, iteration), binds to
        the SAME value set (compared by values root — the canonical form
        both encodings share), senders distinct, summed seats reaching
        the commit threshold. Mixed networks therefore interoperate: a
        full-encoded commit can certify a compact NOTIFY and vice versa."""
        threshold = self.committee_for(layer) // 2 + 1
        epoch = layer // self.layers_per_epoch
        beacon = await self.beacon_of(epoch)
        total = 0
        senders: set[bytes] = set()
        for raw in cert_msgs:
            cm = None
            root = None
            for cls in (HareMessage, CompactHareMessage):
                try:
                    cm = cls.from_bytes(raw)
                    root = (cm.root if cls is CompactHareMessage
                            else values_root(sorted(cm.values)))
                    break
                except (codec.DecodeError, ValueError):
                    continue
            if cm is None:
                return False
            if (cm.round != COMMIT or cm.layer != layer
                    or cm.iteration != iteration
                    or root != expected_root
                    or cm.node_id in senders):
                return False
            if raw not in self._valid_commits:  # gossip-validated skip
                if not self.verifier.verify(Domain.HARE, cm.node_id,
                                            cm.signed_bytes(), cm.signature):
                    return False
                tag = cm.iteration * 4 + COMMIT
                if not self.oracle.validate_hare(
                        beacon, cm.layer, tag, epoch, cm.atx_id,
                        self.committee_for(cm.layer),
                        cm.eligibility_proof, cm.eligibility_count):
                    return False
                self._remember_valid_commit(raw)
            senders.add(cm.node_id)
            total += cm.eligibility_count
        return total >= threshold

    def _report_equivocation(self, node_id: bytes, prev,
                             raw_signed: bytes, signature: bytes) -> None:
        if self.on_equivocation:
            self.on_equivocation(Equivocation(
                node_id=node_id, msg1=prev[0], sig1=prev[1],
                msg2=raw_signed, sig2=signature))

    # --- session driving -------------------------------------------

    async def run_layer(self, layer: int,
                        layer_start: float | None = None) -> ConsensusOutput:
        """Run the full graded session for a layer.

        One protocol round per wall-clock slot, ABSOLUTE from
        ``layer_start`` (reference hare rounds are fixed slots within the
        layer): tick t fires at layer_start + preround_delay +
        t*round_duration, so nodes stay in lockstep however late their
        session code entered.  Sessions legitimately outlive their layer
        (8 rounds/iteration; the reference's mainnet sessions do too) —
        the caller runs them concurrently with the layer loop.
        """
        if layer_start is None:
            layer_start = self.wall()

        async def until_tick(t: int) -> None:
            target = (layer_start + self.preround_delay
                      + t * self.round_duration)
            delay = target - self.wall()
            if delay > 0:
                await asyncio.sleep(delay)

        epoch = layer // self.layers_per_epoch
        beacon = await self.beacon_of(epoch)
        # every local signer with an ATX participates with its own seats
        participants = [
            (s, s.vrf_signer(), atx)
            for s in self.signers
            if s is not None
            and (atx := self.atx_for(epoch, s.node_id)) is not None]
        session = HareSession(self, layer, [])
        self.sessions[layer] = session
        for msg, rs, rf in self._pending.pop(layer, ()):  # early arrivals
            session.on_message(msg, rs, rf)
        for stale in [x for x in self._pending if x < layer]:
            del self._pending[stale]

        # > half the committee seats. Seat counts are weight-derived (the
        # committee's total seats sum to ~committee_size network-wide), so
        # the same constant is safe for any network size — a lone smesher
        # with all the weight holds ~all committee seats itself.
        threshold = self.committee_for(layer) // 2 + 1
        protocol = session.protocol

        async def send(om: hare3.OutMessage) -> None:
            iteration, wire_round = om.ir.iter, _PROTO_TO_WIRE[om.ir.round]
            if om.values is not None:
                values = sorted(om.values)
            else:
                values = protocol.valid_proposals.get(om.reference)
                if values is None:
                    return  # nothing provable to carry on the wire
            cert: list[bytes] | None = None
            if wire_round == NOTIFY:
                # certificate strengthening: prove the commit threshold
                cert = session.build_certificate(iteration, tuple(values),
                                                 threshold)
                if not cert:
                    return  # we saw the threshold via grading but cannot
                    # prove it to cert-checking receivers yet
            round_tag = iteration * 4 + wire_round
            for signer, vrf, atx in participants:
                el = self.oracle.hare_eligibility(
                    vrf, beacon, layer, round_tag, epoch, atx,
                    self.committee_for(layer))
                if el is None:
                    continue
                proof, count = el
                if self.compact_for(layer):
                    cm = CompactHareMessage(
                        layer=layer, iteration=iteration, round=wire_round,
                        compact_ids=[compact_id(v) for v in values],
                        root=values_root(values),
                        eligibility_proof=proof, eligibility_count=count,
                        atx_id=atx, node_id=signer.node_id,
                        cert_msgs=list(cert or []), signature=bytes(64))
                    cm.signature = signer.sign(Domain.HARE,
                                               cm.signed_bytes())
                    self._remember_full(
                        (layer, iteration, wire_round, signer.node_id),
                        list(values))
                    await self.pubsub.publish(TOPIC_HARE_COMPACT,
                                              cm.to_bytes())
                    continue
                msg = HareMessage(
                    layer=layer, iteration=iteration, round=wire_round,
                    values=list(values), eligibility_proof=proof,
                    eligibility_count=count, atx_id=atx,
                    node_id=signer.node_id, cert_msgs=list(cert or []),
                    signature=bytes(64))
                msg.signature = signer.sign(Domain.HARE, msg.signed_bytes())
                await self.pubsub.publish(TOPIC_HARE, msg.to_bytes())

        # preround_delay gives proposals time to build + propagate
        # (reference PreroundDelay); the proposal snapshot happens at the
        # preround SEND, not at session entry.
        await until_tick(0)
        session.my_proposals = sorted(self.proposals_for(layer))
        protocol.on_initial(session.my_proposals)

        result: Optional[list[bytes]] = None
        emitted: Optional[ConsensusOutput] = None
        coin: Optional[bool] = None
        tick = 0
        try:
            while True:
                out = protocol.next()
                if out.coin is not None:
                    coin = out.coin
                if out.result is not None and result is None:
                    result = out.result
                    session.output = list(result)
                    # deliver the moment agreement lands (block generation
                    # must not wait out the helper iteration)
                    emitted = ConsensusOutput(layer=layer, proposals=result,
                                              completed=True, coin=coin)
                    await self.on_output(emitted)
                if out.message is not None:
                    await send(out.message)
                if out.terminated:
                    break  # result emitted + one helper iteration completed
                if protocol.current.iter >= self.iteration_limit \
                        and protocol.current.round > hare3.HARDLOCK:
                    # the hardlock of iteration `limit` was the last chance to
                    # surface a result from the final notify round
                    break
                tick += 1
                await until_tick(tick)

            if emitted is None:
                emitted = ConsensusOutput(layer=layer, proposals=[],
                                          completed=False, coin=coin)
                await self.on_output(emitted)
        finally:
            # exception or cancellation must not leak the session: a dead
            # session left in self.sessions would keep absorbing gossip
            # for this layer forever
            self.sessions.pop(layer, None)
        return emitted
