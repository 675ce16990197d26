"""Tortoise: self-healing vote-counting finality, as array ops (port of
``spacemesh_tpu/consensus/tortoise.py``, whole: numpy on the host).

Mirrors the reference tortoise's contract (reference tortoise/algorithm.go
public facade: OnAtx/OnBallot/OnBlock/OnBeacon/OnHareOutput/TallyVotes/
EncodeVotes/Updates/Results; verifying mode tortoise/verifying.go; full
mode healing recount tortoise/full.go; mode switching on threshold
crossing tortoise/tortoise.go:397; recovery from storage
tortoise/recover.go:20; JSON tracer for offline replay tortoise/tracer.go).

The vote state is a dense int8 matrix V[ballots, blocks] over the active
window — +1 support, -1 against (the default for any block the ballot's
chain covers), 0 abstain/not-covered — plus a weight vector. A layer's
margins are then one masked mat-vec:

    margins = (weights * (ballot_layer > L)) @ V[:, cols(L)]

which is the "turn vote counting into array ops" design SURVEY.md §7
prescribes (the reference walks ballot graphs in Go; this formulation
lets numpy/XLA tile the count — BenchmarkTallyVotes territory).

Decision rule per block (reference semantics):
  margin >  global threshold     -> valid      (verifying mode)
  margin < -global threshold     -> invalid
  within hdist and hare decided  -> hare's opinion   (hare trust)
  older than hdist+zdist         -> full/healing mode:
      |margin| > local threshold -> sign of margin (tortoise/full.go)
      else                       -> weak coin of the latest layer
                                    (tortoise/tortoise.go:287-306
                                    getFullVote reasonCoinflip)
  otherwise                      -> undecided (frontier stops)

Thresholds (reference tortoise/threshold.go): the LOCAL threshold is
one layer's expected weight / 3 (localThresholdFraction); the GLOBAL
threshold is the expected weight in (target, last] / 3
(adversarialWeightFraction) + local.

Ballots whose beacon mismatches the epoch beacon vote at zero weight
until ``bad_beacon_delay`` layers have passed (reference
tortoise/tortoise.go:198 checkBallotAndVotes + BadBeaconVoteDelayLayers,
algorithm config) — a grinding adversary can't steer margins with
wrong-beacon ballots inside the confidence window.

Support votes for blocks not yet known are kept PENDING and resolved when
the block arrives (round-1 advisor fix: they must not silently count as
against while sync delivers data out of order).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np

from ..core.types import Ballot, Opinion
from ..storage.cache import AtxCache

EMPTY = bytes(32)  # "layer is empty" sentinel in hare outputs

VERIFYING, FULL = "verifying", "full"


@dataclasses.dataclass
class BallotInfo:
    id: bytes
    layer: int
    weight: int
    node_id: bytes
    # layer -> set of supported block ids (full, base-resolved)
    supports: dict[int, set[bytes]]
    abstains: set[int]
    malicious: bool = False
    bad_beacon: bool = False


@dataclasses.dataclass
class Update:
    layer: int
    block_id: bytes       # EMPTY for "layer verified empty"
    valid: bool


class Tortoise:
    def __init__(self, cache: AtxCache, layers_per_epoch: int, hdist: int = 10,
                 window: int = 1000, zdist: int = 8,
                 bad_beacon_delay: int | None = None,
                 tracer: Optional[Callable[[str], None]] = None):
        self.cache = cache
        self.layers_per_epoch = layers_per_epoch
        self.hdist = hdist
        self.zdist = zdist
        # reference BadBeaconVoteDelayLayers (tortoise config): how long
        # wrong-beacon ballots stay muted; defaults to zdist
        self.bad_beacon_delay = zdist if bad_beacon_delay is None \
            else bad_beacon_delay
        self.window = window
        self._trace = tracer
        self.verified = 0           # highest fully-decided layer
        self.processed = 0
        self.mode = VERIFYING
        # --- array state (the vote matrix) ---
        self._V = np.zeros((256, 256), np.int8)
        self._weights = np.zeros(256, np.int64)
        self._bad_beacon_row = np.zeros(256, bool)
        self._row_layer = np.zeros(256, np.int32)
        self._col_layer = np.zeros(256, np.int32)
        self._rows = 0
        self._cols = 0
        self._abstain: dict[int, np.ndarray] = {}      # layer -> bool[rowcap]
        self._col_of: dict[bytes, int] = {}            # block id -> col
        self._col_block: list[bytes] = []              # col -> block id
        self._layer_cols: dict[int, list[int]] = {}    # layer -> cols
        self._row_ballot: list[bytes] = []             # row -> ballot id
        self._ballot_row: dict[bytes, int] = {}
        self._node_rows: dict[bytes, list[int]] = {}
        self._pending: dict[bytes, set[bytes]] = {}    # block id -> ballots
        # ballots whose BASE ballot hasn't arrived yet: ingesting them
        # now would lose the base chain's inherited support and count it
        # as against (the reference decodes votes against the base and
        # errors on a missing one, tortoise/state.go decodeVotes) —
        # queue until the base shows up
        self._pending_base: dict[bytes, list[tuple]] = {}
        # --- object state ---
        self._ballots: dict[bytes, BallotInfo] = {}
        self._ballots_by_layer: dict[int, list[bytes]] = {}
        # layers at/below the verified frontier touched by LATE evidence
        # (a block or ballot votes arriving after verification — fork
        # healing): tally must re-examine them, the reference emits
        # validity updates below verified and the mesh reverts
        # (tortoise results/mesh.go:302)
        self._dirty: int | None = None
        self._blocks: dict[int, set[bytes]] = {}
        self._hare: dict[int, bytes] = {}
        self._coin: dict[int, bool] = {}   # layer -> weak coin
        self._validity: dict[bytes, bool] = {}
        self._updates: list[Update] = []
        self._t("init", lpe=layers_per_epoch, hdist=hdist, zdist=zdist,
                window=window)

    # --- tracing -------------------------------------------------------

    def _t(self, kind: str, **kw) -> None:
        if self._trace:
            enc = {k: (v.hex() if isinstance(v, bytes) else v)
                   for k, v in kw.items()}
            self._trace(json.dumps({"ev": kind, **enc}, sort_keys=True))

    # --- array plumbing ------------------------------------------------

    def _grow_rows(self) -> None:
        cap = self._V.shape[0] * 2
        self._V = np.vstack([self._V, np.zeros_like(self._V)])
        self._weights = np.resize(self._weights, cap)
        self._weights[self._rows:] = 0
        self._bad_beacon_row = np.resize(self._bad_beacon_row, cap)
        self._bad_beacon_row[self._rows:] = False
        self._row_layer = np.resize(self._row_layer, cap)
        self._row_layer[self._rows:] = 0
        for lyr, arr in self._abstain.items():
            new = np.zeros(cap, bool)
            new[:len(arr)] = arr
            self._abstain[lyr] = new

    def _grow_cols(self) -> None:
        cap = self._V.shape[1] * 2
        self._V = np.hstack([self._V, np.zeros_like(self._V)])
        self._col_layer = np.resize(self._col_layer, cap)
        self._col_layer[self._cols:] = 0

    def _abstain_arr(self, layer: int) -> np.ndarray:
        arr = self._abstain.get(layer)
        if arr is None:
            arr = np.zeros(self._V.shape[0], bool)
            self._abstain[layer] = arr
        return arr

    # --- inputs --------------------------------------------------------

    def _mark_dirty(self, layer: int) -> None:
        if layer <= self.verified:
            self._dirty = layer if self._dirty is None \
                else min(self._dirty, layer)

    def on_block(self, layer: int, block_id: bytes) -> None:
        if block_id in self._col_of:
            return
        self._t("block", layer=layer, id=block_id)
        self._mark_dirty(layer)
        self._blocks.setdefault(layer, set()).add(block_id)
        if self._cols == self._V.shape[1]:
            self._grow_cols()
        col = self._cols
        self._cols += 1
        self._col_of[block_id] = col
        self._col_block.append(block_id)
        self._col_layer[col] = layer
        self._layer_cols.setdefault(layer, []).append(col)
        # existing ballots vote against by default where their chain covers
        # this layer, except where they abstain
        n = self._rows
        if n:
            covered = self._row_layer[:n] > layer
            ab = self._abstain.get(layer)
            if ab is not None:
                covered = covered & ~ab[:n]
            self._V[:n, col] = np.where(covered, -1, 0).astype(np.int8)
        # resolve pending support votes now that the block's layer is known
        for bid in self._pending.pop(block_id, ()):
            info = self._ballots.get(bid)
            row = self._ballot_row.get(bid)
            if info is None or row is None:
                continue
            if info.layer > layer and layer not in info.abstains:
                # clone-on-write: the layer set may be shared with the
                # base chain (see _ingest_one)
                info.supports[layer] = \
                    set(info.supports.get(layer, ())) | {block_id}
                self._V[row, col] = 1

    def on_hare_output(self, layer: int, block_id: bytes) -> None:
        self._t("hare", layer=layer, id=block_id)
        self._hare[layer] = block_id

    def on_weak_coin(self, layer: int, coin: bool) -> None:
        """Per-layer weak coin from hare's preround VRFs (reference
        tortoise/tortoise.go:303 layer.coinflip; the coin of the LATEST
        layer breaks zero-margin ties during healing)."""
        self._t("coin", layer=layer, coin=coin)
        self._coin[layer] = coin

    def on_malfeasance(self, node_id: bytes) -> None:
        self._t("malfeasance", id=node_id)
        self.cache.set_malicious(node_id)
        for row in self._node_rows.get(node_id, ()):
            self._weights[row] = 0
        had_ballots = False
        for info in self._ballots.values():
            if info.node_id == node_id:
                info.malicious = True
                had_ballots = True
        if had_ballots:
            # the zeroed weight may have been load-bearing anywhere below
            # the frontier (against-votes are implicit, so per-target
            # marking would under-mark): full re-tally of the retained
            # window on the next pass. Malfeasance is rare; the tally is
            # one vectorized mat-vec per layer (reference re-validates
            # on malfeasance too)
            self._mark_dirty(max(self.verified - self.window, 0))

    def on_ballot(self, ballot: Ballot, weight: int,
                  bad_beacon: bool = False) -> None:
        """Resolve the ballot's opinion against its base and store it."""
        self._ingest(ballot.id, ballot.layer, ballot.node_id,
                     ballot.opinion, weight, bad_beacon=bad_beacon)

    def _ingest(self, bid: bytes, layer: int, node_id: bytes,
                opinion: Opinion, weight: int,
                bad_beacon: bool = False) -> None:
        if not self._ingest_one(bid, layer, node_id, opinion, weight,
                                bad_beacon):
            return
        # resolve ballots that were waiting for an ingested ballot as
        # their base — ITERATIVE worklist, one stack frame total: a
        # reverse-ordered chain as long as the queue cap must not
        # recurse (per-link recursion hit Python's limit on ~1000-deep
        # backfills)
        work = self._pending_base.pop(bid, [])
        while work:
            args = work.pop()
            if self._ingest_one(*args[:5], bad_beacon=args[5]):
                winfo = self._ballots.get(args[0])
                if winfo is not None and args[1] > self.verified:
                    # a resolved waiter's whole inherited opinion is new
                    # weight on old layers: late-mark it all
                    for lyr in winfo.supports:
                        self._mark_dirty(lyr)
                    for lyr in winfo.abstains:
                        self._mark_dirty(lyr)
                work.extend(self._pending_base.pop(args[0], []))

    def _ingest_one(self, bid: bytes, layer: int, node_id: bytes,
                    opinion: Opinion, weight: int,
                    bad_beacon: bool = False) -> bool:
        """Ingest ONE ballot; True if it landed (False: duplicate or
        queued behind an unknown base)."""
        if bid in self._ballots:
            return False
        if opinion.base != EMPTY and opinion.base not in self._ballots:
            # base not here yet (sync/gossip reordering): queue — capped
            # so unknown-base spam can't grow memory
            waiters = self._pending_base.setdefault(opinion.base, [])
            if len(waiters) < 64 and len(self._pending_base) < 4096:
                waiters.append((bid, layer, node_id, opinion, weight,
                                bad_beacon))
            return False
        self._t("ballot", id=bid, layer=layer, node=node_id,
                weight=weight, base=opinion.base, bad=bad_beacon,
                support=[b.hex() for b in opinion.support],
                against=[b.hex() for b in opinion.against],
                abstain=list(opinion.abstain))
        base = self._ballots.get(opinion.base)
        supports: dict[int, set[bytes]] = {}
        abstains: set[int] = set()
        if base is not None:
            # copy-on-write: the dict is shallow-copied, the per-layer
            # SETS are shared with the base chain until first mutation
            # (_own below / on_block pending resolution). A deep copy
            # here is O(window) per ballot — at mainnet shape (50
            # ballots/layer, 1000-layer window) that alone dominated the
            # whole tally (docs/TORTOISE_STRESS.md).
            supports = dict(base.supports)
            abstains = set(base.abstains)
        owned: set[int] = set()

        def _own(lyr: int) -> set:
            if lyr not in owned:
                supports[lyr] = set(supports.get(lyr, ()))
                owned.add(lyr)
            return supports[lyr]
        pend: list[bytes] = []
        against = set(opinion.against)
        # pending votes INHERIT through the base chain: if the base ballot
        # is still waiting on a block, this ballot's opinion includes that
        # support too (exception lists are deltas) — unless it explicitly
        # votes against it
        if base is not None:
            for blk, waiters in self._pending.items():
                if opinion.base in waiters and blk not in against:
                    pend.append(blk)
        for b in opinion.support:
            col = self._col_of.get(b)
            if col is not None:
                lyr = int(self._col_layer[col])
                _own(lyr).add(b)
                abstains.discard(lyr)
            else:
                pend.append(b)
        for b in against:
            col = self._col_of.get(b)
            if col is not None:
                lyr = int(self._col_layer[col])
                if lyr in supports:
                    _own(lyr).discard(b)
        for lyr in opinion.abstain:
            abstains.add(lyr)
            supports.pop(lyr, None)
        malicious = self.cache.is_malicious(node_id)
        info = BallotInfo(id=bid, layer=layer, weight=weight,
                          node_id=node_id, supports=supports,
                          abstains=abstains, malicious=malicious,
                          bad_beacon=bad_beacon)
        self._ballots[bid] = info
        self._ballots_by_layer.setdefault(layer, []).append(bid)

        # --- matrix row ---
        if self._rows == self._V.shape[0]:
            self._grow_rows()
        row = self._rows
        self._rows += 1
        self._row_ballot.append(bid)
        self._ballot_row[bid] = row
        self._node_rows.setdefault(node_id, []).append(row)
        self._weights[row] = 0 if malicious else weight
        self._bad_beacon_row[row] = bad_beacon
        self._row_layer[row] = layer
        c = self._cols
        if c:
            self._V[row, :c] = np.where(self._col_layer[:c] < layer,
                                        -1, 0).astype(np.int8)
        for lyr in abstains:
            self._abstain_arr(lyr)[row] = True
            cols = self._layer_cols.get(lyr)
            if cols:
                self._V[row, cols] = 0
        for lyr, blocks in supports.items():
            for b in blocks:
                col = self._col_of.get(b)
                if col is not None:
                    self._V[row, col] = 1
        for b in pend:
            self._pending.setdefault(b, set()).add(bid)
        # late votes on already-verified layers force a re-tally there.
        # A ballot arriving through the NORMAL flow only changes old
        # margins via its explicit exception lists (inherited supports
        # repeat its base's already-counted direction), so only the
        # deltas are dirty-marked; a LATE ballot (backfilled below the
        # frontier, or resolved from the unknown-base queue) contributes
        # its whole inherited opinion as new weight — mark it all
        # (marking inherited supports unconditionally made every tally
        # rescan the full window)
        if layer <= self.verified:
            for lyr in supports:
                self._mark_dirty(lyr)
            for lyr in abstains:
                self._mark_dirty(lyr)
        else:
            for b in opinion.support + opinion.against:
                col = self._col_of.get(b)
                if col is not None:
                    self._mark_dirty(int(self._col_layer[col]))
            for lyr in opinion.abstain:
                self._mark_dirty(lyr)
        return True

    # --- counting ------------------------------------------------------

    def _local_threshold(self, last: int) -> int:
        """One layer's expected weight / 3 (reference
        tortoise/threshold.go localThresholdFraction;
        tortoise.go:311-316 updateLast recomputes it per epoch)."""
        w = self.cache.epoch_weight(last // self.layers_per_epoch)
        if w == 0:
            return 1
        return max(w // self.layers_per_epoch // 3, 1)

    def _threshold(self, target_layer: int, last: int) -> int:
        """GLOBAL threshold: expected ballot weight in (target, last] / 3
        (adversarialWeightFraction) + the local threshold (reference
        tortoise/threshold.go computeGlobalThreshold; the window caps the
        span like computeExpectedWeightInWindow). Summed per EPOCH, not
        per layer — O(epochs-in-span) (a per-layer loop made catch-up
        tallies O(layers*window))."""
        span = min(max(last - target_layer, 1), self.window)
        lpe = self.layers_per_epoch
        lo, hi = target_layer + 1, target_layer + span  # inclusive range
        total = 0
        for epoch in range(lo // lpe, hi // lpe + 1):
            n_layers = (min(hi, (epoch + 1) * lpe - 1)
                        - max(lo, epoch * lpe) + 1)
            if n_layers > 0:
                total += self.cache.epoch_weight(epoch) // lpe * n_layers
        if total == 0:
            return 1
        return max(total // 3, 1) + self._local_threshold(last)

    def _margins(self, layer: int, last: int) -> tuple[list[bytes], np.ndarray]:
        """Margins for every block in ``layer``: one masked mat-vec."""
        cols = self._layer_cols.get(layer, [])
        if not cols:
            return [], np.zeros(0, np.int64)
        n = self._rows
        active = (self._row_layer[:n] > layer) & (self._row_layer[:n] <= last)
        # wrong-beacon ballots stay muted until bad_beacon_delay layers
        # past their own layer (reference BadBeaconVoteDelayLayers)
        muted = self._bad_beacon_row[:n] & \
            (last - self._row_layer[:n] <= self.bad_beacon_delay)
        w = np.where(active & ~muted, self._weights[:n], 0)
        margins = w @ self._V[:n, cols].astype(np.int64)
        return [self._col_block[c] for c in cols], margins

    def tally_votes(self, last: int) -> None:
        """Advance the verified frontier up to ``last`` - 1; re-examine
        verified layers marked dirty by late evidence (fork healing)."""
        self.processed = max(self.processed, last)
        self._t("tally", last=last)
        old_verified = self.verified
        start = old_verified + 1
        if self._dirty is not None:
            start = min(start, self._dirty)
            self._dirty = None
        frontier = start - 1
        flipped_below = False  # validity changed at/below old verified
        healed = False
        for layer in range(start, last):
            decided_all = True
            t = self._threshold(layer, last)
            heal = last - layer > self.hdist + self.zdist
            blocks, margins = self._margins(layer, last)
            for b, margin in zip(blocks, margins):
                margin = int(margin)
                if margin > t:
                    decided = True
                elif margin < -t:
                    decided = False
                elif last - layer < self.hdist and layer in self._hare:
                    decided = self._hare[layer] == b
                elif heal:
                    # full-mode healing: past the confidence window the
                    # count decides (tortoise/full.go); a margin inside
                    # the local threshold is a genuine tie — break it
                    # with the weak coin of the LATEST layer so every
                    # node falls on the same side (tortoise.go:287-306
                    # getFullVote reasonCoinflip)
                    lt = self._local_threshold(last)
                    if margin > lt:
                        decided = True
                    elif margin < -lt:
                        decided = False
                    else:
                        # latest recorded coin at-or-before last-1: in a
                        # quiescent net (no hare running) the newest
                        # shared coin still converges all nodes, where
                        # strict last-1 would deadlock the frontier
                        coin = self._coin.get(last - 1)
                        if coin is None and self._coin:
                            past = [x for x in self._coin if x <= last - 1]
                            if past:
                                coin = self._coin[max(past)]
                        if coin is None:
                            decided_all = False
                            continue
                        decided = coin
                    healed = True
                else:
                    decided_all = False
                    continue
                if self._validity.get(b) != decided:
                    self._validity[b] = decided
                    self._updates.append(Update(layer, b, decided))
                    if layer <= self.verified:
                        flipped_below = True
            if not blocks:
                # empty layer: decided by hare's "empty", by distance, or
                # by healing
                if layer in self._hare and self._hare[layer] == EMPTY:
                    pass
                elif last - layer < self.hdist:
                    decided_all = False
            if decided_all:
                frontier = layer
            else:
                if layer <= old_verified:
                    # dirty re-tally stopped short of the old frontier:
                    # keep the remaining region marked or the late
                    # evidence above this layer is silently forgotten
                    self._dirty = layer
                break
        if healed and self.mode != FULL:
            self.mode = FULL
            self._t("mode", mode=FULL)
        elif not healed and self.mode != VERIFYING and last - frontier <= self.hdist:
            self.mode = VERIFYING
            self._t("mode", mode=VERIFYING)
        if frontier > self.verified or (frontier < self.verified
                                        and flipped_below):
            # regression is real only when a validity actually flipped
            # in the re-examined region; a dirty re-tally that merely
            # found an old layer momentarily undecidable (e.g. no coin
            # recorded yet) must not drag the frontier back
            self.verified = frontier
            self._t("verified", layer=frontier)
        self._evict()

    # --- eviction / compaction ----------------------------------------

    def _evict(self) -> None:
        low = self.verified - self.window
        stale_layers = [x for x in self._ballots_by_layer if x < low]
        stale_blocks = [x for x in self._blocks if x < low]
        if not stale_layers and not stale_blocks:
            return
        # hysteresis: compaction rebuilds the whole matrix (O(rows*cols));
        # once the frontier advances one layer per tally, evicting eagerly
        # would pay that rebuild EVERY tally. Let a chunk of stale layers
        # accumulate so the cost amortizes to O(rebuild / chunk) per layer
        # (the steady-state tally regression docs/TORTOISE_STRESS.md
        # caught: 2.3ms -> 280ms/layer at mainnet shape without this).
        chunk = max(self.window // 10, 16)
        if (len(stale_layers) < chunk and len(stale_blocks) < chunk):
            return
        for lyr in stale_layers:
            for bid in self._ballots_by_layer[lyr]:
                self._ballots.pop(bid, None)
                self._ballot_row.pop(bid, None)
            del self._ballots_by_layer[lyr]  # _compact rebuilds _node_rows
        for lyr in stale_blocks:
            del self._blocks[lyr]
        self._compact(low)

    def _compact(self, low: int) -> None:
        """Rebuild the matrix keeping only rows/cols inside the window."""
        keep_rows = [r for r in range(self._rows)
                     if int(self._row_layer[r]) >= low
                     and self._row_ballot[r] in self._ballots]
        keep_cols = [c for c in range(self._cols)
                     if int(self._col_layer[c]) >= low]
        V = np.zeros_like(self._V)
        V[:len(keep_rows), :len(keep_cols)] = \
            self._V[np.ix_(keep_rows, keep_cols)]
        self._V = V
        self._weights[:len(keep_rows)] = self._weights[keep_rows]
        self._weights[len(keep_rows):] = 0
        self._bad_beacon_row[:len(keep_rows)] = \
            self._bad_beacon_row[keep_rows]
        self._bad_beacon_row[len(keep_rows):] = False
        self._row_layer[:len(keep_rows)] = self._row_layer[keep_rows]
        self._row_layer[len(keep_rows):] = 0
        self._col_layer[:len(keep_cols)] = self._col_layer[keep_cols]
        self._col_layer[len(keep_cols):] = 0
        self._row_ballot = [self._row_ballot[r] for r in keep_rows]
        self._col_block = [self._col_block[c] for c in keep_cols]
        self._ballot_row = {b: i for i, b in enumerate(self._row_ballot)}
        self._col_of = {b: i for i, b in enumerate(self._col_block)}
        self._rows = len(keep_rows)
        self._cols = len(keep_cols)
        self._layer_cols = {}
        for c, b in enumerate(self._col_block):
            self._layer_cols.setdefault(int(self._col_layer[c]), []).append(c)
        self._node_rows = {}
        for i, bid in enumerate(self._row_ballot):
            info = self._ballots.get(bid)
            if info is not None:
                self._node_rows.setdefault(info.node_id, []).append(i)
        for lyr in [x for x in self._abstain if x < low]:
            del self._abstain[lyr]
        for lyr in [x for x in self._coin if x < low]:
            del self._coin[lyr]
        # hare opinions and per-block validity below the window can never
        # be consulted again (margins/encode_votes only span the window;
        # the mesh persists validity to storage) — without eviction these
        # grow without bound over a node's lifetime
        for lyr in [x for x in self._hare if x < low]:
            del self._hare[lyr]
        live_cols = set(self._col_of)
        self._validity = {b: v for b, v in self._validity.items()
                          if b in live_cols}
        # pending votes whose waiters were all evicted can never resolve
        self._pending = {blk: live for blk, ws in self._pending.items()
                         if (live := {b for b in ws if b in self._ballots})}
        # queued unknown-base ballots older than the window are dead
        self._pending_base = {
            base: live for base, ws in self._pending_base.items()
            if (live := [w for w in ws if w[1] >= low])}
        for lyr, arr in list(self._abstain.items()):
            new = np.zeros(self._V.shape[0], bool)
            for i, r in enumerate(keep_rows):
                new[i] = arr[r] if r < len(arr) else False
            self._abstain[lyr] = new

    # --- outputs -------------------------------------------------------

    def updates(self) -> list[Update]:
        out, self._updates = self._updates, []
        return out

    def valid_blocks(self, layer: int) -> list[bytes]:
        return sorted(b for b in self._blocks.get(layer, set())
                      if self._validity.get(b))

    def hare_of(self, layer: int) -> bytes | None:
        """The recorded hare output (or adopted certificate) for the
        layer; EMPTY means hare decided empty, None means undecided."""
        return self._hare.get(layer)

    def is_valid(self, block_id: bytes) -> bool:
        return bool(self._validity.get(block_id))

    def verdict(self, block_id: bytes) -> bool | None:
        """True/False once the tortoise decided; None while undecided —
        callers that treat hare output as provisional need the
        three-way answer (mesh._block_to_apply)."""
        return self._validity.get(block_id)

    # --- vote encoding -------------------------------------------------

    def encode_votes(self, for_layer: int) -> Opinion:
        """Build the opinion for a new ballot in ``for_layer``: pick the
        newest known ballot as base, express the local opinion (hare within
        hdist, validity beyond) as exceptions (reference
        tortoise/algorithm.go:EncodeVotes)."""
        base_id = EMPTY
        base_info = None
        for lyr in sorted(self._ballots_by_layer, reverse=True):
            if lyr >= for_layer:
                continue
            cands = [self._ballots[b] for b in self._ballots_by_layer[lyr]
                     if not self._ballots[b].malicious]
            if cands:
                base_info = max(cands, key=lambda i: (i.weight, i.id))
                base_id = base_info.id
                break
        support, against, abstain = [], [], []
        start = max(1, for_layer - self.window)
        for lyr in range(start, for_layer):
            local: set[bytes] = set()
            if lyr in self._hare and self.processed - lyr < self.hdist:
                if self._hare[lyr] != EMPTY:
                    local = {self._hare[lyr]}
            else:
                local = {b for b in self._blocks.get(lyr, set())
                         if self._validity.get(b)}
                if not local and lyr > self.verified and lyr not in self._hare:
                    abstain.append(lyr)
                    continue
            base_sup = (base_info.supports.get(lyr, set())
                        if base_info else set())
            support += sorted(local - base_sup)
            against += sorted(base_sup - local)
        return Opinion(base=base_id, support=support, against=against,
                       abstain=abstain)

    # --- recovery (reference tortoise/recover.go:20) -------------------

    @classmethod
    def recover(cls, db, cache: AtxCache, oracle, *, layers_per_epoch: int,
                hdist: int, zdist: int, window: int,
                tracer=None) -> "Tortoise":
        """Rebuild tortoise state from storage after a restart: blocks and
        their persisted validity, certified/applied hare outputs, then
        ballots in layer order (so bases resolve, reference recover.go
        replays in the same order)."""
        from ..storage import ballots as ballotstore
        from ..storage import blocks as blockstore
        from ..storage import layers as layerstore
        from ..storage import misc as miscstore

        t = cls(cache, layers_per_epoch, hdist=hdist, zdist=zdist,
                window=window, tracer=tracer)
        processed = layerstore.processed(db)
        if processed < 0:
            return t
        low = max(1, processed - window)
        for layer in range(low, processed + 1):
            for bid in blockstore.ids_in_layer(db, layer):
                t.on_block(layer, bid)
                validity = blockstore.validity(db, bid)
                if validity == blockstore.VALID:
                    t._validity[bid] = True
                elif validity == blockstore.INVALID:
                    t._validity[bid] = False
            cert = miscstore.certified_block(db, layer)
            applied = layerstore.applied_block(db, layer)
            if cert is not None:
                t.on_hare_output(layer, cert)
            elif applied is not None:
                t.on_hare_output(layer, applied)
        # Ballots at or below the 0004 block-id-rewrite boundary carry
        # signed vote lists naming pre-rewrite block ids; replaying them
        # would resolve every support as against and could flip validity
        # of in-window blocks. Persisted per-block verdicts
        # (loaded above) already cover those layers.
        ballot_low = max(low, miscstore.migration_boundary(db) + 1)
        for layer in range(ballot_low, processed + 1):
            for ballot in ballotstore.in_layer(db, layer):
                epoch = layer // layers_per_epoch
                info = cache.get(epoch, ballot.atx_id)
                if info is None:
                    continue
                # shared with live ingest (miner.ingest_ballot) —
                # recover must not flag ballots the live path left
                # unflagged, nor weigh them differently: the stored
                # (already-validated) ref-ballot eligibility count
                # bounds the per-eligibility weight on trusted
                # networks, the local recomputation otherwise
                epoch_data = ballotstore.resolve_epoch_data(
                    db, ballot, layers_per_epoch)
                if epoch_data is not None and oracle.trusts_declared(epoch):
                    num = epoch_data.eligibility_count
                else:
                    num = oracle.num_slots(epoch, ballot.atx_id)
                unit = info.weight // max(num, 1)
                declared = epoch_data.beacon if epoch_data is not None \
                    else None
                local = miscstore.get_beacon(db, epoch)
                bad = (declared is not None and local is not None
                       and declared != local)
                t.on_ballot(ballot, unit * len(ballot.eligibilities),
                            bad_beacon=bad)
        t.processed = processed
        t.verified = max(
            min(layerstore.last_applied(db), processed) - 1, 0)
        return t


# --- trace replay (reference tortoise/tracer.go:79 RunTrace) ---------------


def replay_trace(lines, cache: AtxCache | None = None,
                 tracer=None) -> Tortoise:
    """Rebuild a Tortoise by replaying a recorded JSON trace. The trace is
    self-contained: ballot events carry their full opinion and weight."""
    cache = cache or AtxCache()
    t: Tortoise | None = None
    for line in lines:
        line = line.strip()
        if not line:
            continue
        ev = json.loads(line)
        kind = ev["ev"]
        if kind == "init":
            t = Tortoise(cache, ev["lpe"], hdist=ev["hdist"],
                         zdist=ev.get("zdist", 8), window=ev["window"],
                         tracer=tracer)
        elif t is None:
            raise ValueError("trace does not start with an init event")
        elif kind == "block":
            t.on_block(ev["layer"], bytes.fromhex(ev["id"]))
        elif kind == "hare":
            t.on_hare_output(ev["layer"], bytes.fromhex(ev["id"]))
        elif kind == "coin":
            t.on_weak_coin(ev["layer"], bool(ev["coin"]))
        elif kind == "malfeasance":
            t.on_malfeasance(bytes.fromhex(ev["id"]))
        elif kind == "ballot":
            op = Opinion(
                base=bytes.fromhex(ev["base"]),
                support=[bytes.fromhex(x) for x in ev["support"]],
                against=[bytes.fromhex(x) for x in ev["against"]],
                abstain=list(ev["abstain"]))
            t._ingest(bytes.fromhex(ev["id"]), ev["layer"],
                      bytes.fromhex(ev["node"]), op, ev["weight"],
                      bad_beacon=bool(ev.get("bad", False)))
        elif kind == "tally":
            t.tally_votes(ev["last"])
    if t is None:
        raise ValueError("empty trace")
    return t
