"""The proven graded hare protocol: graded-gossip, gradecast, thresh-gossip
(port of ``spacemesh_tpu/consensus/hare3.py``, whole).

A faithful re-implementation of the reference's proven protocol core
(reference hare3/protocol.go — the same machine hare4 reuses; round/grade
arithmetic hare3/types.go:43-75; Protocol 1 graded-gossip p.10, Protocol 2
gradecast p.13, Protocol 3 thresh-gossip p.15 of the hare3 paper).  Late
and equivocating leaders are handled by GRADES — how many rounds late a
message arrived and whether a conflicting copy surfaced in time — not by
acceptance windows.

The machine is PURE: no clock, no IO.  A driver advances it one round per
call to ``next()`` and feeds messages through ``on_input`` stamped with
the round they arrived in.  That makes every adversarial timing scenario
(late leader, grade-boundary equivocation) expressible as a deterministic
unit test, mirroring the reference's protocol_test.go.

Round layout per iteration (reference hare3/types.go:17):

  preround | hardlock softlock propose wait1 wait2 commit notify | ...

preround runs once (iteration 0 skips hardlock); wait1/wait2 exist so a
message's arrival delay maps onto meaningful grade boundaries
(grade = max(6 - delay, 0)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# round indices (reference hare3/types.go:25-32)
PREROUND, HARDLOCK, SOFTLOCK, PROPOSE, WAIT1, WAIT2, COMMIT, NOTIFY = \
    range(8)

GRADE0, GRADE1, GRADE2, GRADE3, GRADE4, GRADE5 = range(6)

ROUND_NAMES = ("preround", "hardlock", "softlock", "propose",
               "wait1", "wait2", "commit", "notify")


@dataclasses.dataclass(frozen=True, order=True)
class IterRound:
    iter: int
    round: int

    def absolute(self) -> int:
        # reference types.go:73: iter*notify + round
        return self.iter * NOTIFY + self.round

    def delay(self, since: "IterRound") -> int:
        if self.absolute() <= since.absolute():
            return 0
        d = self.absolute() - since.absolute()
        # iteration 0 skips hardlock (types.go:46-49)
        if since.iter == 0 and since.round == PREROUND and d != 0:
            d -= 1
        return d

    def grade(self, since: "IterRound") -> int:
        return max(6 - self.delay(since), GRADE0)

    def is_message_round(self) -> bool:
        return self.round in (PREROUND, PROPOSE, COMMIT, NOTIFY)

    def __str__(self) -> str:  # pragma: no cover — debug aid
        return f"{self.iter}/{ROUND_NAMES[self.round]}"


def values_ref(values: list[bytes]) -> bytes:
    """Canonical reference hash of a proposal set (reference
    CalcProposalHash32Presorted)."""
    from ..core.hashing import sum256

    return sum256(*sorted(values)) if values else bytes(32)


@dataclasses.dataclass
class Input:
    """One validated message entering the protocol.

    ``values`` for preround/propose; ``reference`` for commit/notify.
    ``atxgrade`` comes from the oracle — the legacy oracle grades every
    eligible message grade5 (reference legacy_oracle.go:25-44); the slot
    exists so the full atx-grading of the paper can plug in.
    """

    sender: bytes
    ir: IterRound
    eligibility_count: int
    vrf: bytes                         # eligibility proof (leader order, coin)
    msg_hash: bytes
    values: Optional[list[bytes]] = None
    reference: Optional[bytes] = None
    malicious: bool = False
    atxgrade: int = GRADE5

    def key(self) -> tuple:
        return (self.ir, self.sender)


@dataclasses.dataclass
class _GossipInput:
    inp: Input
    received: IterRound
    other_received: Optional[IterRound] = None


@dataclasses.dataclass
class Equivocation:
    """Two conflicting messages for one (iter, round, sender) — the raw
    material of a hare malfeasance proof (reference wire.HareProof)."""

    sender: bytes
    first_hash: bytes
    second_hash: bytes


@dataclasses.dataclass
class OutMessage:
    ir: IterRound
    values: Optional[list[bytes]] = None
    reference: Optional[bytes] = None


@dataclasses.dataclass
class Output:
    coin: Optional[bool] = None        # from preround VRFs, after softlock
    result: Optional[list[bytes]] = None
    terminated: bool = False
    message: Optional[OutMessage] = None


@dataclasses.dataclass
class _GSet:
    values: list[bytes]
    grade: int
    smallest: bytes


class GradedGossip:
    """Protocols 1 & 3 state: one slot per (iter, round, sender), with
    equivocation tracking (reference protocol.go:337-376)."""

    def __init__(self, threshold: int):
        self.threshold = threshold
        self.state: dict[tuple, _GossipInput] = {}

    def receive(self, current: IterRound,
                inp: Input) -> tuple[bool, Optional[Equivocation]]:
        other = self.state.get(inp.key())
        if other is not None:
            if other.inp.msg_hash != inp.msg_hash and not other.inp.malicious:
                # conflicting copy: keep the max-atxgrade one, mark
                # malicious, remember when the other surfaced (feeds the
                # gradecast (a)/(b) delay conditions)
                if inp.atxgrade > other.inp.atxgrade:
                    inp.malicious = True
                    self.state[inp.key()] = _GossipInput(
                        inp=inp, received=current,
                        other_received=other.received)
                else:
                    other.inp.malicious = True
                    other.other_received = current
                return True, Equivocation(
                    sender=inp.sender, first_hash=other.inp.msg_hash,
                    second_hash=inp.msg_hash)
            return False, None  # duplicate
        self.state[inp.key()] = _GossipInput(inp=inp, received=current)
        return True, None

    # -- Protocol 2: gradecast (protocol.go:386-421) --

    def gradecast(self, target: IterRound) -> list[_GSet]:
        rst = []
        for key, v in self.state.items():
            if key[0] != target:
                continue
            if v.inp.malicious and v.other_received is None:
                continue
            if (v.inp.atxgrade == GRADE5 and v.received.delay(target) <= 1
                    and (v.other_received is None
                         or v.other_received.delay(target) > 3)):
                rst.append(_GSet(values=list(v.inp.values or []),
                                 grade=GRADE2, smallest=v.inp.vrf))
            elif (v.inp.atxgrade >= GRADE4 and v.received.delay(target) <= 2
                    and (v.other_received is None
                         or v.other_received.delay(target) > 2)):
                rst.append(_GSet(values=list(v.inp.values or []),
                                 grade=GRADE1, smallest=v.inp.vrf))
        # p-Weak leader election: order candidate leaders by VRF so the
        # whole cluster picks the same one (protocol.go:414-419)
        rst.sort(key=lambda g: g.smallest)
        return rst

    # -- Protocol 3: thresh-gossip (protocol.go:424-512) --

    def _tallies(self, target: IterRound, msg_grade: int,
                 by_ref: bool) -> dict:
        # min atxgrade among non-equivocating senders in the window
        # (protocol.go:491-498)
        min_grade = GRADE5
        for key, v in self.state.items():
            if (key[0] == target and not v.inp.malicious
                    and v.received.grade(target) >= msg_grade
                    and v.inp.atxgrade < min_grade):
                min_grade = v.inp.atxgrade
        tallies: dict = {}
        for key, v in self.state.items():
            if key[0] != target or v.inp.atxgrade < min_grade \
                    or v.received.grade(target) < msg_grade:
                continue
            items = ([v.inp.reference] if by_ref
                     else list(v.inp.values or []))
            for item in items:
                if item is None:
                    continue
                total, valid = tallies.get(item, (0, 0))
                total += v.inp.eligibility_count
                if not v.inp.malicious:
                    valid += v.inp.eligibility_count
                tallies[item] = (total, valid)
        return tallies

    def threshold_gossip(self, target: IterRound,
                         msg_grade: int) -> list[bytes]:
        """Values with >= threshold total weight and at least one
        non-equivocating vote, sorted."""
        t = self._tallies(target, msg_grade, by_ref=False)
        return sorted(v for v, (total, valid) in t.items()
                      if total >= self.threshold and valid > 0)

    def threshold_gossip_ref(self, target: IterRound,
                             msg_grade: int) -> list[bytes]:
        t = self._tallies(target, msg_grade, by_ref=True)
        return sorted(r for r, (total, valid) in t.items()
                      if total >= self.threshold and valid > 0)


class Protocol:
    """The per-layer machine (reference protocol.go:92-290)."""

    def __init__(self, threshold: int):
        self.current = IterRound(0, PREROUND)
        self.gossip = GradedGossip(threshold)
        self.initial: list[bytes] = []
        self.result: Optional[bytes] = None
        self.locked: Optional[bytes] = None
        self.hard_locked = False
        self.valid_proposals: dict[bytes, list[bytes]] = {}
        self.coin_vrf: Optional[bytes] = None
        self._coin_out = False

    def on_initial(self, proposals: list[bytes]) -> None:
        self.initial = sorted(proposals)

    def on_input(self, inp: Input) -> tuple[bool, Optional[Equivocation]]:
        """Feed a validated message; returns (relay?, equivocation)."""
        gossip, equivocation = self.gossip.receive(self.current, inp)
        if not gossip:
            return False, equivocation
        if inp.ir.round == PREROUND and inp.values is not None:
            if self.coin_vrf is None or inp.vrf < self.coin_vrf:
                self.coin_vrf = inp.vrf  # smallest preround VRF -> coin
        return gossip, equivocation

    # -- execution helpers (protocol.go:134-151) --

    def _threshold_proposals(self, ir: IterRound,
                             grade: int) -> tuple[Optional[bytes],
                                                  Optional[list[bytes]]]:
        for ref in self.gossip.threshold_gossip_ref(ir, grade):
            if ref in self.valid_proposals:
                return ref, self.valid_proposals[ref]
        return None, None

    def _commit_exists(self, it: int, match: bytes, grade: int) -> bool:
        return match in self.gossip.threshold_gossip_ref(
            IterRound(it, COMMIT), grade)

    # -- one round of execution (protocol.go:152-259) --

    def _execution(self, out: Output) -> None:
        it, rnd = self.current.iter, self.current.round
        if rnd == PREROUND:
            out.message = OutMessage(ir=self.current,
                                     values=list(self.initial))
        elif rnd == HARDLOCK and it > 0:
            if self.result is not None:
                out.terminated = True
            ref, values = self._threshold_proposals(
                IterRound(it - 1, NOTIFY), GRADE5)
            if ref is not None and self.result is None:
                self.result = ref
                out.result = values if values is not None else []
            cref, _ = self._threshold_proposals(
                IterRound(it - 1, COMMIT), GRADE4)
            if cref is not None:
                self.locked, self.hard_locked = cref, True
            else:
                self.locked, self.hard_locked = None, False
        elif rnd == SOFTLOCK and it > 0 and not self.hard_locked:
            cref, _ = self._threshold_proposals(
                IterRound(it - 1, COMMIT), GRADE3)
            self.locked = cref
        elif rnd == PROPOSE:
            values = self.gossip.threshold_gossip(
                IterRound(0, PREROUND), GRADE4)
            if it > 0:
                ref, overwrite = self._threshold_proposals(
                    IterRound(it - 1, COMMIT), GRADE2)
                if ref is not None:
                    values = overwrite
            out.message = OutMessage(ir=self.current, values=values)
        elif rnd == COMMIT:
            proposed = self.gossip.gradecast(IterRound(it, PROPOSE))
            g2 = set(self.gossip.threshold_gossip(
                IterRound(0, PREROUND), GRADE2))
            for graded in proposed:
                # conditions (a),(b): proposal values must be g2-supported
                if not set(graded.values) <= g2:
                    continue
                self.valid_proposals[values_ref(graded.values)] = \
                    sorted(graded.values)
            if self.hard_locked and self.locked is not None:
                out.message = OutMessage(ir=self.current,
                                         reference=self.locked)
            else:
                g3 = set(self.gossip.threshold_gossip(
                    IterRound(0, PREROUND), GRADE3))
                g5 = set(self.gossip.threshold_gossip(
                    IterRound(0, PREROUND), GRADE5))
                for graded in proposed:   # VRF-ordered: weak leader election
                    ref = values_ref(graded.values)
                    if ref not in self.valid_proposals:       # (c)
                        continue
                    if graded.grade != GRADE2:                # (e)
                        continue
                    if not set(graded.values) <= g3:          # (f)
                        continue
                    if not g5 <= set(graded.values) and \
                            not self._commit_exists(it - 1, ref, GRADE1):
                        continue                              # (g)
                    if self.locked is not None and self.locked != ref:
                        continue                              # (h)
                    out.message = OutMessage(ir=self.current, reference=ref)
                    break
        elif rnd == NOTIFY:
            ref = self.result
            if ref is None:
                ref, _ = self._threshold_proposals(
                    IterRound(it, COMMIT), GRADE5)
            if ref is not None:
                out.message = OutMessage(ir=self.current, reference=ref)

    def next(self) -> Output:
        """Advance one round; returns what to emit this round."""
        out = Output()
        self._execution(out)
        if (self.current.round >= SOFTLOCK and self.coin_vrf is not None
                and not self._coin_out):
            out.coin = bool(self.coin_vrf[-1] & 1)
            self._coin_out = True
        cur = self.current
        if cur.round == PREROUND and cur.iter == 0:
            # skip hardlock in iteration 0 (protocol.go:276-279)
            self.current = IterRound(0, SOFTLOCK)
        elif cur.round == NOTIFY:
            self.current = IterRound(cur.iter + 1, HARDLOCK)
        else:
            self.current = IterRound(cur.iter, cur.round + 1)
        return out
