"""Epoch min-weight gating (port of the two pure functions of
``spacemesh_tpu/consensus/activeset.py`` that ``consensus/eligibility.py``
reads).

Mirrors two reference pieces:

- miner/minweight/minweight.go `Select`: a per-epoch table of minimal
  active-set weights; the value for a target epoch is the last entry at
  or below it.
- proposals/util/util.go:29-39 `GetNumEligibleSlots`: proposal slots =
  w * committee * layers_per_epoch / max(min_weight, total_weight). The
  min-weight denominator is what bounds dust amplification on young or
  partitioned networks: with a mainnet-scale floor, a tiny identity's
  quotient is 0 and only the reference's explicit one-slot floor remains
  (util.go:36-38 — kept here for parity; the floor is worth at most one
  ballot whose eligibility WEIGHT is still w/num_slots, so it buys no
  voting power).

The rest of the JAX module (the active-set generator, ATX grading and the
declared-set weight) comes with the mesh and the miner.
"""

from __future__ import annotations


def select_min_weight(epoch: int, weights: list[tuple[int, int]]) -> int:
    """Min active-set weight for ``epoch`` from a sorted (epoch, weight)
    table — the last entry at or below it (minweight/minweight.go:5-20)."""
    rst, prev = 0, 0
    for at, weight in weights:
        if at < prev:
            raise ValueError("min-weight table not sorted by epoch")
        if epoch >= at:
            rst = weight
        prev = at
    return rst


def num_eligible_slots(weight: int, min_weight: int, total_weight: int,
                       committee_size: int, layers_per_epoch: int) -> int:
    """Proposal slots for one epoch (proposals/util/util.go:29-39)."""
    if total_weight == 0:
        return 0
    num = weight * committee_size * layers_per_epoch \
        // max(min_weight, total_weight)
    return max(num, 1)
