"""Syncer: the catch-up state machine (port of
``spacemesh_tpu/p2p/sync.py``).

Mirrors the reference syncer (reference syncer/syncer.go:60-80 states
notSynced -> gossipSync -> synced; :474 per-epoch ATX sync via
atxsync.Download; :372 per-layer data sync; state_syncer.go:34
processLayers applies certificates/tortoise opinions). A late-joining node
pulls: poet proofs + epoch ATXs for every epoch up to now, then per-layer
ballots/blocks/certificates, feeding everything through the SAME gossip
validators the live path uses — sync and gossip share ingestion, as in the
reference.
"""

from __future__ import annotations

import asyncio
import enum
import logging
from typing import Awaitable, Callable

_log = logging.getLogger("sync")

from .fetch import (
    Fetch,
    HINT_ATX,
    HINT_BALLOT,
    HINT_BLOCK,
    HINT_POET,
    HINT_TX,
    LayerData,
    P_LAYER,
)


class SyncState(enum.Enum):
    NOT_SYNCED = "notSynced"
    GOSSIP = "gossipSync"
    SYNCED = "synced"


class Syncer:
    def __init__(self, *, fetch: Fetch, current_layer: Callable[[], int],
                 processed_layer: Callable[[], int],
                 process_layer: Callable[[int, "LayerData | None"],
                                         Awaitable[None]],
                 layers_per_epoch: int,
                 store_beacon: Callable[[int, bytes], None] | None = None,
                 layer_hash: Callable[[int], bytes | None] | None = None,
                 on_fork: Callable[[int], None] | None = None,
                 derive_beacon=None, rangesync_sets=None):
        self.store_beacon = store_beacon
        # derive_beacon(epoch, ballot_ids): adopt the epoch beacon from
        # synced ballots' signed EpochData (weight-majority) when peer
        # answers alone can't settle it
        self.derive_beacon = derive_beacon
        # rangesync_sets(name) -> rangesync.OrderedSet | None resolves
        # the LOCAL set for fingerprint reconciliation ("atx/<epoch>",
        # "malfeasance"); None disables the rangesync backfill pass
        self.rangesync_sets = rangesync_sets
        self.fetch = fetch
        self.current_layer = current_layer
        self.processed_layer = processed_layer
        self.process_layer = process_layer
        self.layers_per_epoch = layers_per_epoch
        self.layer_hash = layer_hash      # local aggregated mesh hash
        self.on_fork = on_fork
        self.state = SyncState.NOT_SYNCED
        self._stop = False
        # one pass at a time: the background run() loop and an external
        # driver (the sim scenario engine's convergence wait, a test's
        # heal loop) may both call synchronize(); interleaved passes
        # would double-process layers mid-flight
        self._busy = asyncio.Lock()

    def is_synced(self) -> bool:
        return self.state == SyncState.SYNCED

    async def synchronize(self) -> bool:
        """One sync pass; returns True when caught up to the tip."""
        async with self._busy:
            return await self._synchronize()

    async def _synchronize(self) -> bool:
        tip = self.current_layer()
        cur_epoch = tip // self.layers_per_epoch
        # 1) per epoch: beacon, poet proofs, then ATXs (validation order)
        for epoch in range(0, cur_epoch + 2):
            await self._sync_beacon(epoch)
            refs = await self._peer_poet_refs(epoch)
            if refs:
                await self.fetch.get_hashes(HINT_POET, refs)
            await self.fetch.get_epoch_atxs(epoch)
            # fingerprint reconciliation mops up whatever the bulk pull
            # missed (a peer's epoch index answered before a late ATX
            # landed): one rs/1 roundtrip per peer when the sets already
            # match, O(diff * log n) otherwise. Fetched blobs ingest
            # through the same validators, i.e. the verification farm's
            # SYNC lane.
            await self._rangesync_backfill(f"atx/{epoch}", HINT_ATX)
        # 1b) malfeasance proofs (reference syncer/malsync): a node must
        # learn who is malicious before counting their weight
        await self._sync_malfeasance()
        # 2) per-layer data up to the tip
        start = self.processed_layer() + 1
        deferred = False
        for layer in range(start, tip + 1):
            if self._stop:
                return False
            data = await self.fetch.get_layer_data(layer)
            # recent layers may still be under hare on the peers: without a
            # certificate, defer them to the next pass instead of wrongly
            # settling on "empty" (the reference's layerpatrol keeps
            # hare-owned layers away from the syncer, layerpatrol/patrol.go)
            recent = layer > tip - 2
            has_cert = data is not None and (
                data.certified != bytes(32)
                or getattr(data, "cert_candidates", []))
            if recent and not has_cert:
                deferred = True
                break
            if data is not None:
                # beacon first: ballot eligibility and certificate shares
                # verify against the epoch beacon — when peer answers
                # couldn't settle it (tie from a lying peer), derive it
                # from the ballots' own signed, ATX-weighted EpochData
                if self.derive_beacon is not None and data.ballots:
                    await self.derive_beacon(
                        layer // self.layers_per_epoch, data.ballots)
                # blocks BEFORE ballots: tortoise.on_ballot must be able to
                # resolve every support vote against a known block, else the
                # votes count as AGAINST and a fresh node invalidates layers
                # the network holds valid
                await self.fetch.get_hashes(HINT_BLOCK, data.blocks)
                await self.fetch.get_hashes(HINT_BALLOT, data.ballots)
            await self.process_layer(layer, data)
        behind = self.current_layer() - self.processed_layer()
        # a recent-layer deferral means we are as caught up as the
        # network allows (peers have no certificate yet either): still
        # SYNCED, or in a quiescent net the node would sit at behind==2
        # forever in gossipSync and the fork check below would never run
        if behind <= 1 or (deferred and behind <= 3):
            self.state = SyncState.SYNCED
        elif behind <= 2:
            self.state = SyncState.GOSSIP
        else:
            self.state = SyncState.NOT_SYNCED
        # 3) fork detection once caught up: our aggregated mesh hash at
        # the frontier must match the network's
        if self.state == SyncState.SYNCED and await self._check_fork():
            self.state = SyncState.NOT_SYNCED
            return False
        return self.state == SyncState.SYNCED

    async def _rangesync_backfill(self, name: str, hint: str,
                                  peers: int = 2) -> None:
        """Reconcile one named id set (p2p/rangesync.py) against a few
        peers and fetch what they have that we lack. Failures are
        tolerated — the bulk pull remains the primary mechanism and the
        next pass retries."""
        if self.rangesync_sets is None:
            return
        try:
            local = self.rangesync_sets(name)
        except Exception:  # noqa: BLE001 — a bad epoch name must not kill sync
            return
        if local is None:
            return
        from .rangesync import RangeSyncClient

        missing: set[bytes] = set()
        for peer in self.fetch.peers()[:peers]:
            try:
                client = RangeSyncClient(self.fetch.server, peer, name)
                missing.update(await client.reconcile(local))
            except Exception:  # noqa: BLE001 — peer gone / no rs/1 support
                continue
        if missing:
            await self.fetch.get_hashes(hint, sorted(missing))

    async def _sync_malfeasance(self) -> None:
        from .fetch import HINT_MALFEASANCE
        from .server import RequestError

        ids: set[bytes] = set()
        for peer in self.fetch.peers()[:3]:
            try:
                resp = await self.fetch.server.request(peer, "ml/1", b"")
            except (RequestError, asyncio.TimeoutError):
                continue
            for k in range(0, len(resp), 32):
                nid = resp[k:k + 32]
                if len(nid) == 32:  # ragged tail from a bad peer
                    ids.add(nid)
        if ids:
            await self.fetch.get_hashes(HINT_MALFEASANCE, sorted(ids))

    async def _check_fork(self) -> bool:
        """Compare aggregated layer hashes with peers at the frontier;
        on mismatch bisect to the FIRST divergent layer, FETCH the
        dissenting chain's blocks/ballots, and hand the layer to
        on_fork for arbitration (reference syncer/find_fork.go). Fork
        CHOICE is not made here: the tortoise's vote weight decides —
        which also kills the rollback-DoS vector: a lying
        peer can waste fetch bandwidth but cannot move applied state
        without real ballot weight behind its chain."""
        import struct

        from .server import RequestError

        if self.layer_hash is None or self.on_fork is None:
            return False
        frontier = self.processed_layer() - 1
        if frontier < 1:
            return False
        local = self.layer_hash(frontier)
        if local is None:
            return False

        async def peer_hash(peer, layer) -> bytes | None:
            try:
                resp = await self.fetch.server.request(
                    peer, "lh/1", struct.pack("<I", layer))
            except (RequestError, asyncio.TimeoutError):
                return None
            return resp if len(resp) == 32 else None

        async def peer_tip(peer) -> int | None:
            try:
                resp = await self.fetch.server.request(
                    peer, "lh/1", struct.pack("<I", 0xFFFFFFFF))
            except (RequestError, asyncio.TimeoutError):
                return None
            if len(resp) != 36:
                return None
            return struct.unpack_from("<I", resp)[0]

        # anchor at the COMMON frontier: our tip may be ahead of a peer's
        # (e.g. we applied empty layers while it idled) — comparing where
        # the peer has no hash would blind the fork finder entirely
        peers = self.fetch.peers()[:3]
        tips = [t for t in [await peer_tip(p) for p in peers]
                if t is not None]
        if tips:
            frontier = min(frontier, max(tips))
        if frontier < 1:
            return False
        local = self.layer_hash(frontier)
        if local is None:
            return False

        frontier_hashes = [(p, await peer_hash(p, frontier)) for p in peers]
        answered = [(p, h) for p, h in frontier_hashes if h is not None]
        if not answered:
            return False
        disagree = [(p, h) for p, h in answered if h != local]
        acted = False
        for peer, h in disagree:
            # stability re-confirm: a transient lie or a peer racing its
            # own apply must not trigger the (bounded) refetch work
            if await peer_hash(peer, frontier) != h:
                continue
            # bisect [1, frontier] for the first layer where we diverge;
            # a peer that stops answering mid-bisect yields NO divergence
            # point — never act on a guess
            lo, hi = 1, frontier
            aborted = False
            while lo < hi:
                mid = (lo + hi) // 2
                rm = await peer_hash(peer, mid)
                lm = self.layer_hash(mid)
                if rm is None or lm is None:
                    aborted = True
                    break
                if rm == lm:
                    lo = mid + 1
                else:
                    hi = mid
            if aborted:
                continue
            # ingest the dissenting chain's data over the divergent span
            # (bounded per pass) so the tortoise can weigh it: the
            # dissenter's own layer opinion first, then the union view
            _log.info("fork: divergence at layer %d (frontier %d), "
                      "ingesting dissenting span", lo, frontier)
            await self._ingest_span(peer, lo, frontier)
            self.on_fork(lo)
            acted = True
        return acted

    async def _ingest_span(self, peer, lo: int, hi: int,
                           span_cap: int = 32) -> None:
        """Fetch blocks + ballots for layers [lo, hi] — the dissenting
        peer's view plus the usual cross-peer union — through the same
        validated ingestion path sync uses. Failures are tolerated: the
        next pass retries."""
        import struct

        from .server import RequestError

        for layer in range(lo, min(hi, lo + span_cap) + 1):
            datas = []
            try:
                resp = await self.fetch.server.request(
                    peer, P_LAYER, struct.pack("<I", layer))
                datas.append(LayerData.from_bytes(resp))
            except Exception:  # noqa: BLE001 — dissenter may be gone
                pass
            union = await self.fetch.get_layer_data(layer)
            if union is not None:
                datas.append(union)
            blocks: list[bytes] = []
            ballots: list[bytes] = []
            for d in datas:
                blocks += [b for b in d.blocks if b not in blocks]
                ballots += [b for b in d.ballots if b not in ballots]
            if blocks:
                await self.fetch.get_hashes(HINT_BLOCK, blocks)
            if ballots:
                await self.fetch.get_hashes(HINT_BALLOT, ballots)
            # the divergent span's CERTIFICATES too: a layer this node
            # applied differently (e.g. empty, on a skewed clock) heals
            # through validated cert adoption, not just ballot weight —
            # the same processor the normal sync path uses
            for d in datas:
                if d.certified != bytes(32) \
                        or getattr(d, "cert_candidates", []):
                    try:
                        await self.process_layer(layer, d)
                        break  # adopted from this view
                    except Exception:  # noqa: BLE001 — try the next view
                        continue

    async def _sync_beacon(self, epoch: int) -> None:
        """Adopt peers' beacon for the epoch (late joiners never ran the
        beacon protocol; gossip validation needs the value)."""
        import struct

        from .server import RequestError

        if self.store_beacon is None:
            return
        # quorum: adopt only a value reported by a strict majority of the
        # peers that answered — one lying peer must not poison the beacon
        # (reference accepts fallback beacons only from a
        # verified bootstrap source)
        async def ask(peer):
            try:
                return await self.fetch.server.request(
                    peer, "bk/1", struct.pack("<I", epoch))
            except (RequestError, asyncio.TimeoutError):
                return None

        responses = await asyncio.gather(
            *(ask(p) for p in self.fetch.peers()))
        votes: dict[bytes, int] = {}
        answered = 0
        for resp in responses:
            if resp is not None and len(resp) == 4:
                answered += 1
                votes[resp] = votes.get(resp, 0) + 1
        if not votes:
            return
        best, count = max(votes.items(), key=lambda kv: kv[1])
        if count * 2 > answered:
            self.store_beacon(epoch, best)

    async def _peer_poet_refs(self, epoch: int) -> list[bytes]:
        """Poet proof refs peers hold for the epoch's round."""
        import struct

        from .server import RequestError

        refs: list[bytes] = []
        for peer in self.fetch.peers():
            try:
                resp = await self.fetch.server.request(
                    peer, "pt/1", struct.pack("<I", epoch))
            except (RequestError, asyncio.TimeoutError):
                continue
            for k in range(0, len(resp), 32):
                r = resp[k:k + 32]
                if r not in refs:
                    refs.append(r)
        return refs

    async def run(self, interval: float = 1.0) -> None:
        """Background loop (reference syncer.Start)."""
        while not self._stop:
            try:
                await self.synchronize()
            except Exception:  # noqa: BLE001 — sync must survive bad peers
                self.state = SyncState.NOT_SYNCED
            await asyncio.sleep(interval)

    def stop(self) -> None:
        self._stop = True
