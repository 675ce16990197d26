"""Active-set generation + epoch min-weight gating (port of
``spacemesh_tpu/consensus/activeset.py``, whole).

Mirrors three reference pieces:

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
- miner/active_set_generator.go: the three-path generator — trusted
  fallback (bootstrap update), grading by receipt time, or the epoch's
  first applied block — persisted in the node-local DB so a restart
  doesn't redo the work.

ATX grading (active_set_generator.go:269-293, community.spacemesh.io
"Grading ATXs for the active set"): with s = epoch start and d = network
delay,
  good        received < s-4d and no malfeasance proof before s
  acceptable  received < s-3d and no proof before s-d
  evil        otherwise
Only GOOD activations enter the generated set; the set is used only when
good/total clears ``good_atx_percent`` (generator.go:164-176).
"""

from __future__ import annotations

from ..core.hashing import sum256
from ..storage import atxs as atxstore
from ..storage.cache import AtxCache
from ..storage.db import Database

GRADE_EVIL, GRADE_ACCEPTABLE, GRADE_GOOD = 0, 1, 2

# prepared_activeset.kind (reference sql/localsql/activeset kinds)
KIND_TORTOISE = 0


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


_SET_WEIGHT_MEMO_MAX = 256


def declared_set_weight(db: Database, cache: AtxCache, epoch: int,
                        root: bytes) -> int | None:
    """Total weight of the stored active set with this root, when every
    member resolves in the cache. The eligibility denominator must come
    from the set a ballot DECLARES, not the validator's local ATX view —
    nodes with divergent views would otherwise disagree on ballot
    validity (reference proposals/eligibility_validator.go validates
    against the ref ballot's declared set). None → caller
    falls back to the local epoch weight.

    Fully-resolved sums are memoized by (epoch, root) ON THE NODE'S
    cache (per-node state, not module-global — separate nodes in one
    process have separate views): thousands of ref ballots per epoch
    declare the same root, and ATX weight is intrinsic (num_units x
    ticks), so the sum is stable once every member resolved —
    re-summing a mainnet-shape set per ballot is O(smeshers x set_size)
    wasted work."""
    from ..storage import misc as miscstore

    memo = getattr(cache, "_set_weight_memo", None)
    if memo is None:
        memo = cache._set_weight_memo = {}
    hit = memo.get((epoch, root))
    if hit is not None:
        return hit
    ids = miscstore.active_set(db, root)
    if ids is None:
        return None
    total = 0
    for atx_id in ids:
        member = cache.get(epoch, atx_id)
        if member is None:
            return None
        total += member.weight
    if total:
        if len(memo) >= _SET_WEIGHT_MEMO_MAX:
            memo.pop(next(iter(memo)))
        memo[(epoch, root)] = total
    return total or None


def grade_atx(epoch_start: float, network_delay: float,
              atx_received: float, proof_received: float | None) -> int:
    """Grade by receipt time vs epoch start (generator.go:283-293)."""
    if atx_received < epoch_start - 4 * network_delay and (
            proof_received is None or proof_received >= epoch_start):
        return GRADE_GOOD
    if atx_received < epoch_start - 3 * network_delay and (
            proof_received is None
            or proof_received >= epoch_start - network_delay):
        return GRADE_ACCEPTABLE
    return GRADE_EVIL


def active_set_hash(atx_ids: list[bytes]) -> bytes:
    return sum256(*sorted(atx_ids)) if atx_ids else bytes(32)


class ActiveSetGenerator:
    """Three-path generator with local persistence
    (miner/active_set_generator.go:117-216)."""

    def __init__(self, state: Database, local: Database, cache: AtxCache, *,
                 layers_per_epoch: int, layer_duration: float,
                 genesis_time, network_delay: float,
                 good_atx_percent: int = 50):
        self.state = state
        self.local = local
        self.cache = cache
        self.layers_per_epoch = layers_per_epoch
        self.layer_duration = layer_duration
        # float, or a callable returning the EFFECTIVE genesis time — the
        # node's clock may be rebased after wiring (--genesis-now)
        self.genesis_time = genesis_time
        self.network_delay = network_delay
        self.good_atx_percent = good_atx_percent
        self._fallback: dict[int, list[bytes]] = {}

    def update_fallback(self, target_epoch: int, atx_ids: list[bytes]) -> None:
        """Trusted (bootstrap-service) active set for an epoch; first
        update wins (generator.go:78-91)."""
        self._fallback.setdefault(target_epoch, list(atx_ids))

    def _epoch_start(self, epoch: int) -> float:
        genesis = self.genesis_time() if callable(self.genesis_time) \
            else self.genesis_time
        return genesis + epoch * self.layers_per_epoch * self.layer_duration

    def _set_weight(self, target_epoch: int, atx_ids: list[bytes]) -> int:
        total = 0
        for atx_id in atx_ids:
            info = self.cache.get(target_epoch, atx_id)
            if info is None:
                raise LookupError(f"atx {atx_id.hex()[:12]} not in atxsdata")
            total += info.weight
        return total

    def _from_grades(self, target_epoch: int) -> tuple[list[bytes], int, int]:
        """(good set, weight, total counted) over ATXs published in the
        prior epoch (generator.go:223-254)."""
        epoch_start = self._epoch_start(target_epoch)
        good, weight, total = [], 0, 0
        for row in atxstore.rows_for_grading(self.state, target_epoch - 1):
            total += 1
            if grade_atx(epoch_start, self.network_delay, row["received"],
                         row["proof_received"]) == GRADE_GOOD:
                good.append(row["id"])
                info = self.cache.get(target_epoch, row["id"])
                weight += info.weight if info else 0
        return good, weight, total

    def _from_first_block(self, target_epoch: int) -> list[bytes] | None:
        """Union of active sets referenced by the epoch's first applied
        block's rewarded ref ballots (generator.go:296-334)."""
        from ..storage import ballots as ballotstore
        from ..storage import blocks as blockstore
        from ..storage import layers as layerstore
        from ..storage import misc as miscstore

        first = target_epoch * self.layers_per_epoch
        block = None
        for layer in range(first, first + self.layers_per_epoch):
            bid = layerstore.applied_block(self.state, layer)
            if bid:
                block = blockstore.get(self.state, bid)
                break
        if block is None:
            return None
        out: set[bytes] = set()
        epoch_first = target_epoch * self.layers_per_epoch
        for reward in block.rewards:
            out.add(reward.atx_id)
            ref = ballotstore.refballot_by_atx(
                self.state, reward.atx_id, epoch_first,
                epoch_first + self.layers_per_epoch)
            if ref is None or ref.epoch_data is None:
                continue
            stored = miscstore.active_set(
                self.state, ref.epoch_data.active_set_root)
            for atx_id in stored or ():
                out.add(atx_id)
        return sorted(out)

    def get_prepared(self, target_epoch: int
                     ) -> tuple[bytes, int, list[bytes]] | None:
        row = self.local.one(
            "SELECT id, weight, data FROM prepared_activeset"
            " WHERE kind=? AND epoch=?", (KIND_TORTOISE, target_epoch))
        if row is None:
            return None
        data = row["data"]
        ids = [data[i:i + 32] for i in range(0, len(data), 32)]
        return row["id"], row["weight"], ids

    def generate(self, current_layer: int, target_epoch: int
                 ) -> tuple[bytes, int, list[bytes]]:
        """(hash, weight, sorted atx ids). Raises LookupError when no path
        can produce a set yet (caller retries; generator.go:94-115)."""
        prepared = self.get_prepared(target_epoch)
        if prepared is not None:
            return prepared

        set_, weight = None, 0
        fallback = self._fallback.get(target_epoch)
        if fallback is not None:
            weight = self._set_weight(target_epoch, fallback)
            set_ = list(fallback)
        else:
            good, gweight, total = self._from_grades(target_epoch)
            if total and len(good) * 100 // total > self.good_atx_percent:
                set_, weight = good, gweight
        if set_ is None and current_layer > target_epoch * self.layers_per_epoch:
            from_block = self._from_first_block(target_epoch)
            if from_block:
                set_ = from_block
                weight = self._set_weight(target_epoch, set_)
        if not set_ or weight == 0:
            raise LookupError(
                f"cannot generate active set for epoch {target_epoch}")
        set_.sort()
        set_id = active_set_hash(set_)
        self.local.exec(
            "INSERT OR REPLACE INTO prepared_activeset"
            " (kind, epoch, id, weight, data) VALUES (?,?,?,?,?)",
            (KIND_TORTOISE, target_epoch, set_id, weight, b"".join(set_)))
        return set_id, weight, set_
