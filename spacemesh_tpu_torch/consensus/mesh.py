"""Mesh: the per-layer DAG bookkeeping + state application (port of
``spacemesh_tpu/consensus/mesh.py``, whole).

Mirrors reference mesh/ (mesh.go:302 ProcessLayer applies tortoise
updates and reverts on reorg; :497 per-hare-output fast path; executor.go
runs the VM optimistically on hare output) and proposals/store (in-RAM
current-epoch proposal store with eviction).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..core.types import Block, Proposal, Reward, Transaction
from ..utils import metrics
from ..storage import blocks as blockstore
from ..storage import layers as layerstore
from ..storage import misc as miscstore
from ..storage import transactions as txstore
from ..storage.cache import AtxCache
from ..storage.db import Database
from ..txs import ConservativeState
from ..vm import VM
from .hare import ConsensusOutput
from .tortoise import EMPTY, Tortoise


class ProposalStore:
    """In-RAM proposals for recent layers (reference proposals/store)."""

    def __init__(self) -> None:
        self._by_layer: dict[int, dict[bytes, Proposal]] = {}
        self._lock = threading.RLock()

    def add(self, p: Proposal) -> None:
        with self._lock:
            self._by_layer.setdefault(p.ballot.layer, {})[p.id] = p

    def get(self, pid: bytes) -> Optional[Proposal]:
        with self._lock:
            for layer in self._by_layer.values():
                if pid in layer:
                    return layer[pid]
        return None

    def in_layer(self, layer: int) -> list[Proposal]:
        with self._lock:
            return list(self._by_layer.get(layer, {}).values())

    def ids_in_layer(self, layer: int) -> list[bytes]:
        with self._lock:
            return sorted(self._by_layer.get(layer, {}))

    def evict(self, before_layer: int) -> None:
        with self._lock:
            for lyr in [x for x in self._by_layer if x < before_layer]:
                del self._by_layer[lyr]


class Executor:
    """Optimistic block execution (reference mesh/executor.go)."""

    def __init__(self, db: Database, vm: VM, cstate: ConservativeState):
        self.db = db
        self.vm = vm
        self.cstate = cstate

    def execute(self, block: Block) -> bytes:
        txs = []
        for tx_id in block.tx_ids:
            tx = self.cstate.get(tx_id)
            if tx is not None:
                txs.append(tx)
        _, root = self.vm.apply(block.layer, block.id, txs,
                                list(block.rewards))
        layerstore.set_applied(self.db, block.layer, block.id, root)
        self._aggregate(block.layer, block.id)
        self.cstate.on_applied()
        return root

    def execute_empty(self, layer: int) -> bytes:
        prev = layerstore.state_hash(self.db, layer - 1) or bytes(32)
        layerstore.set_applied(self.db, layer, EMPTY, prev)
        self._aggregate(layer, EMPTY)
        return prev

    def _aggregate(self, layer: int, block_id: bytes) -> None:
        """Chained per-layer mesh hash (reference aggregated layer hash):
        agg(L) = H(agg(L-1) || applied block id). Peers comparing these
        detect forks and bisect to the divergence point (fork finder)."""
        from ..core.hashing import sum256

        prev = layerstore.aggregated_hash(self.db, layer - 1) or bytes(32)
        layerstore.set_aggregated_hash(self.db, layer,
                                       sum256(prev, block_id))

    def revert(self, to_layer: int) -> None:
        self.vm.revert(to_layer)
        self.db.exec("DELETE FROM layers WHERE id>?", (to_layer,))


class Mesh:
    def __init__(self, *, db: Database, tortoise: Tortoise,
                 executor: Executor, proposals: ProposalStore,
                 cache: AtxCache):
        self.db = db
        self.tortoise = tortoise
        self.executor = executor
        self.proposals = proposals
        self.cache = cache
        # recover the applied frontier from storage on restart (reference
        # mesh.go:123 recoverFromDB)
        self.latest_applied = max(layerstore.last_applied(db), 0)
        # layers applied differently than their (later-arriving)
        # committee certificate — healed by process_layer
        self._cert_dirty: set[int] = set()
        # earliest layer whose reapply was deferred (content in flight):
        # tortoise.updates() is drained once, so the retry intent must
        # survive the pass
        self._pending_reapply: int | None = None

    def add_block(self, block: Block) -> None:
        with self.db.tx():
            blockstore.add(self.db, block)
        self.tortoise.on_block(block.layer, block.id)

    def process_hare_output(self, block: Optional[Block], layer: int) -> None:
        """Fast path: hare agreed -> apply immediately (reference
        mesh.go:497 ProcessLayerPerHareOutput)."""
        if block is None:
            self.tortoise.on_hare_output(layer, EMPTY)
            if self.latest_applied == layer - 1:
                self.executor.execute_empty(layer)
                self.latest_applied = layer
        else:
            self.add_block(block)
            self.tortoise.on_hare_output(layer, block.id)
            if self.latest_applied == layer - 1:
                self.executor.execute(block)
                self.latest_applied = layer
        layerstore.set_processed(self.db, layer)

    def process_layer(self, layer: int) -> None:
        """Tortoise-driven path: tally votes, apply validity updates,
        revert + reapply on opinion change (reference mesh.go:302)."""
        t0 = time.perf_counter()
        try:
            self._process_layer(layer)
        finally:
            # the layer-apply latency SLI (obs/sli.py): observed at the
            # ONE choke point every caller (layer loop, hare drain,
            # sync apply) funnels through
            metrics.layer_apply_seconds.observe(time.perf_counter() - t0)

    def _process_layer(self, layer: int) -> None:
        self.tortoise.tally_votes(layer)
        min_changed = None
        for upd in self.tortoise.updates():
            with self.db.tx():
                if upd.valid:
                    blockstore.set_valid(self.db, upd.block_id)
                else:
                    blockstore.set_invalid(self.db, upd.block_id)
            applied = layerstore.applied_block(self.db, upd.layer)
            should = self._block_to_apply(upd.layer)
            if applied is not None and applied != should:
                if min_changed is None or upd.layer < min_changed:
                    min_changed = upd.layer
        # layers whose COMMITTEE decision (adopted certificate) arrived
        # after we applied them differently — heal them here, where the
        # reapply is prechecked, not in the gossip handler
        for lyr in sorted(self._cert_dirty):
            cert = miscstore.certified_block(self.db, lyr)
            if cert is None or lyr > self.latest_applied:
                self._cert_dirty.discard(lyr)
                continue
            if layerstore.applied_block(self.db, lyr) == cert:
                self._cert_dirty.discard(lyr)
                continue
            if blockstore.get(self.db, cert) is None:
                continue  # block still in flight; keep the mark
            if min_changed is None or lyr < min_changed:
                min_changed = lyr
        if self._pending_reapply is not None:
            if min_changed is None or self._pending_reapply < min_changed:
                min_changed = self._pending_reapply
        if min_changed is not None:
            if self._reapply_from(min_changed):
                self._pending_reapply = None
                # drop only marks the reapply actually SETTLED — a
                # cert-dirty layer whose block is still in flight was
                # applied per fallback and must stay marked
                self._cert_dirty = {
                    x for x in self._cert_dirty
                    if layerstore.applied_block(self.db, x)
                    != miscstore.certified_block(self.db, x)}
            else:
                self._pending_reapply = min_changed
        # advance the applied frontier through tortoise-DECIDED layers:
        # a layer whose hare never concluded stalls the hare fast path
        # forever; once the tortoise verifies it (margins/healing), the
        # mesh must apply it (reference mesh.go:302 ProcessLayer applies
        # up to the verified frontier)
        nxt = self.latest_applied + 1
        while nxt <= self.tortoise.verified:
            bid = self._block_to_apply(nxt)
            if bid == EMPTY:
                self.executor.execute_empty(nxt)
            else:
                block = self._executable(bid)
                if block is None:
                    break  # content/txs not fetched yet: retry next pass
                self.executor.execute(block)
            layerstore.set_processed(self.db, nxt)
            self.latest_applied = nxt
            nxt += 1

    def _block_to_apply(self, layer: int) -> bytes:
        """Positive tortoise verdicts win; otherwise the hare output
        (including an adopted certificate) decides — a thin-margin
        "nothing proven valid" must not override the committee's
        certified agreement (reference mesh.go: applied block follows
        hare output until the tortoise verifies otherwise)."""
        valid = self.tortoise.valid_blocks(layer)
        if valid:
            return valid[0]
        hare = self.tortoise.hare_of(layer)
        if hare is not None and hare != EMPTY \
                and self.tortoise.verdict(hare) is not False \
                and blockstore.get(self.db, hare) is not None:
            # hare/cert output holds only while the tortoise has not
            # verified OTHERWISE (an explicitly invalidated block must
            # not stay applied)
            return hare
        return EMPTY

    def adopt_certified(self, layer: int, block_id: bytes) -> None:
        """A VALIDATED threshold certificate IS the network's hare
        output for the layer — adopt it even when our own hare failed
        or we already applied the layer differently (e.g. this node
        raced ahead on a skewed clock and settled on empty; round-5
        chaos test). Without this, a node whose local hare missed a
        layer diverges PERMANENTLY whenever the tortoise margin never
        crosses (small committees). Reference: certificate adoption in
        syncer/state_syncer.go + mesh.go:497 ProcessLayerPerHareOutput.

        Only RECORDS the adoption (hare output + dirty mark): the
        revert/reapply runs inside the next process_layer pass, which
        prechecks that the whole affected span is executable — a
        mid-gossip partial revert would leave holes in the applied
        chain. The certified BLOCK may not be local yet (the cert can
        assemble before the block gossip lands); the dirty mark
        persists until the block arrives and the reapply succeeds."""
        self.tortoise.on_hare_output(layer, block_id)
        applied = layerstore.applied_block(self.db, layer)
        if applied is not None and applied != block_id:
            self._cert_dirty.add(layer)

    def _executable(self, bid: bytes) -> Optional[Block]:
        """The block, if its content AND all its txs are local. Executing
        with missing txs silently diverges the state root (Executor
        skips unknown txs); callers must defer instead — the sync path
        refetches and retries."""
        block = blockstore.get(self.db, bid)
        if block is None:
            return None
        for tx_id in block.tx_ids:
            if self.executor.cstate.get(tx_id) is None:
                return None
        return block

    def _reapply_from(self, layer: int) -> bool:
        """Revert to ``layer``-1 and re-execute forward. PRECHECKS that
        every affected layer is executable before reverting: a revert
        that cannot be fully reapplied leaves holes in the applied
        chain — every later state root diverges and the sync frontier
        skips the gap (round-5 chaos debugging). Returns True when the
        reapply ran to the old frontier."""
        for lyr in range(layer, self.latest_applied + 1):
            bid = self._block_to_apply(lyr)
            if bid != EMPTY and self._executable(bid) is None:
                return False  # content/txs in flight; retry next pass
        self.executor.revert(layer - 1)
        target = self.latest_applied
        self.latest_applied = layer - 1
        for lyr in range(layer, target + 1):
            bid = self._block_to_apply(lyr)
            if bid == EMPTY:
                self.executor.execute_empty(lyr)
            else:
                block = self._executable(bid)
                if block is None:  # pragma: no cover - precheck holds
                    return False
                self.executor.execute(block)
            # revert dropped the layer rows; the re-executed layers are
            # processed again (keeps the processed frontier monotone)
            layerstore.set_processed(self.db, lyr)
            self.latest_applied = lyr
        return True
