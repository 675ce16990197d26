"""Fetch: hash -> data resolution across peers, with batching (port of
``spacemesh_tpu/p2p/fetch.py``).

Mirrors the reference fetch layer (reference fetch/fetch.go: requests are
coalesced per peer into hash batches, responses stream back blobs which are
dispatched to per-kind validator callbacks wired at node startup
node/node.go:1166-1211; server-side handlers expose the local database by
hint; epoch/layer index endpoints live beside them, fetch/mesh_data.go).

Hints name the store a hash lives in (reference datastore.BlobStore):
  atx ballot block tx poet active_set malfeasance
Protocols:
  hs/1  hashes -> blobs        (reference fetch.go hashProtocol)
  ep/1  epoch  -> atx id list  (reference "ax/1"-family epoch info)
  ld/1  layer  -> ballot/block/cert ids (reference layer data)
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
from typing import Awaitable, Callable

from ..core import codec
from ..core.codec import fixed, u8, u32, var_bytes, vec
from .server import RequestError, Server

P_HASH = "hs/1"
P_EPOCH = "ep/1"
P_LAYER = "ld/1"

HINT_ATX = 0
HINT_BALLOT = 1
HINT_BLOCK = 2
HINT_TX = 3
HINT_POET = 4
HINT_ACTIVESET = 5
HINT_MALFEASANCE = 6


@codec.register
class HashRequest:
    hint: int
    hashes: list[bytes]
    FIELDS = [("hint", u8), ("hashes", vec(fixed(32), 1 << 12))]


@codec.register
class HashResponse:
    blobs: list[bytes]           # parallel to request; empty = missing
    FIELDS = [("blobs", vec(var_bytes, 1 << 12))]


@codec.register
class LayerData:
    ballots: list[bytes]
    blocks: list[bytes]
    certified: bytes             # EMPTY32 if none
    FIELDS = [("ballots", vec(fixed(32))), ("blocks", vec(fixed(32))),
              ("certified", fixed(32))]


# blob readers: hint -> (db, id) -> bytes|None; writers: validator callbacks
Reader = Callable[[bytes], bytes | None]
Validator = Callable[[bytes, bytes], Awaitable[bool]]  # (id, blob) -> ok


class Fetch:
    def __init__(self, server: Server, batch_size: int = 128,
                 bad_peer_threshold: int = 10, *,
                 retry_rounds: int = 3, backoff_base: float = 0.05,
                 backoff_cap: float = 2.0, penalty_base: float = 0.5,
                 penalty_cap: float = 30.0,
                 rng: random.Random | None = None):
        self.server = server
        self.batch = batch_size
        self.bad_peer_threshold = bad_peer_threshold
        # failed-chunk retry policy: bounded rounds with capped
        # exponential backoff + jitter between them, and a per-peer
        # penalty WINDOW after a transport-level chunk failure — the
        # old behavior (retry the whole chunk elsewhere immediately,
        # then hammer the same flapping peer set on the next call)
        # turned one flaky peer into synchronized retry storms
        self.retry_rounds = max(int(retry_rounds), 1)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.penalty_base = penalty_base
        self.penalty_cap = penalty_cap
        self._rng = rng or random.Random(0x5EED5)
        self._readers: dict[int, Reader] = {}
        self._validators: dict[int, Validator] = {}
        # peer scoring (reference fetch/peers/peers.go): failures — bad
        # blobs, short answers, timeouts — push a peer down the selection
        # order and eventually out of it; successes slowly rehabilitate
        self._peer_score: dict[bytes, int] = {}
        self._penalty_until: dict[bytes, float] = {}
        self._consec_fail: dict[bytes, int] = {}
        server.register(P_HASH, self._serve_hashes)

    # --- peer selection ---------------------------------------------

    @staticmethod
    def _now() -> float:
        """Loop clock when one is running (virtual-clock-aware: penalty
        windows expire in SIM time under a VirtualClockLoop), wall
        monotonic otherwise."""
        try:
            return asyncio.get_running_loop().time()
        except RuntimeError:
            # spacecheck: ok=SC001 loop-less fallback of this module's declared time source (_now)
            return time.monotonic()

    def report_failure(self, peer: bytes, weight: int = 1) -> None:
        self._peer_score[peer] = self._peer_score.get(peer, 0) + weight

    def report_success(self, peer: bytes) -> None:
        s = self._peer_score.get(peer, 0)
        if s > 0:
            self._peer_score[peer] = s - 1
        self._consec_fail.pop(peer, None)
        self._penalty_until.pop(peer, None)

    def _chunk_failure(self, peer: bytes) -> None:
        """Transport-level chunk failure (timeout / error / short
        answer): score it AND open an escalating penalty window during
        which the peer is skipped by selection."""
        self.report_failure(peer)
        n = self._consec_fail.get(peer, 0) + 1
        self._consec_fail[peer] = n
        window = min(self.penalty_cap,
                     self.penalty_base * (2 ** (n - 1)))
        self._penalty_until[peer] = self._now() + window

    def failure_score(self, peer: bytes) -> int:
        """Accumulated failure score — HIGHER is WORSE; peers at or above
        bad_peer_threshold are dropped from selection."""
        return self._peer_score.get(peer, 0)

    def penalized(self, peer: bytes) -> bool:
        return self._penalty_until.get(peer, 0.0) > self._now()

    def peers(self) -> list[bytes]:
        """Connected peers, best score first: chronically bad ones are
        dropped from selection entirely and peers inside a penalty
        window are skipped while anyone else is available."""
        ranked = sorted(self.server.peers(),
                        key=lambda p: self._peer_score.get(p, 0))
        good = [p for p in ranked
                if self._peer_score.get(p, 0) < self.bad_peer_threshold]
        usable = [p for p in good if not self.penalized(p)]
        if usable:
            return usable
        # if everyone looks bad/penalized, fall back to the least-bad
        # peers rather than stalling sync forever
        return good or ranked[:2]

    async def _backoff(self, round_no: int) -> None:
        """Jittered capped exponential delay between retry rounds (the
        jitter de-synchronizes many nodes retrying the same flap)."""
        delay = min(self.backoff_cap,
                    self.backoff_base * (2 ** round_no))
        await asyncio.sleep(delay * (0.5 + self._rng.random() * 0.5))

    # --- wiring -----------------------------------------------------

    def set_reader(self, hint: int, reader: Reader) -> None:
        self._readers[hint] = reader

    def set_validator(self, hint: int, validator: Validator) -> None:
        """Per-kind ingestion callback (reference fetch.SetValidators)."""
        self._validators[hint] = validator

    # --- server side ------------------------------------------------

    async def _serve_hashes(self, peer: bytes, data: bytes) -> bytes:
        req = HashRequest.from_bytes(data)
        reader = self._readers.get(req.hint)
        blobs = []
        for h in req.hashes:
            blob = reader(h) if reader else None
            blobs.append(blob if blob is not None else b"")
        return HashResponse(blobs=blobs).to_bytes()

    # --- client side ------------------------------------------------

    async def get_hashes(self, hint: int, ids: list[bytes]) -> dict[bytes, bool]:
        """Resolve ids across peers in batches; each retrieved blob goes
        through the hint's validator. Ids already present locally (the
        hint's reader answers) are skipped. Returns id -> success.

        Retry shape: one pass over the (penalty-filtered) peer set per
        round; a round is re-run — after a capped, jittered exponential
        backoff — only while ids remain AND some chunk failed at the
        TRANSPORT level (timeout/error/short answer). Peers that simply
        don't hold an id answer definitively (empty blob) and never
        trigger a retry round."""
        result = {i: False for i in ids}
        reader = self._readers.get(hint)
        missing = []
        for i in dict.fromkeys(ids):
            if reader is not None and reader(i) is not None:
                result[i] = True  # already stored locally
            else:
                missing.append(i)
        validator = self._validators.get(hint)
        for round_no in range(self.retry_rounds):
            if not missing:
                break
            if round_no:
                await self._backoff(round_no - 1)
            peers = self.peers()
            if not peers:
                break
            transient = False
            for peer in peers:
                if not missing:
                    break
                still = []
                for k in range(0, len(missing), self.batch):
                    chunk = missing[k:k + self.batch]
                    try:
                        resp = HashResponse.from_bytes(
                            await self.server.request(
                                peer, P_HASH,
                                HashRequest(hint=hint,
                                            hashes=chunk).to_bytes()))
                    except (RequestError, asyncio.TimeoutError,
                            codec.DecodeError):
                        self._chunk_failure(peer)
                        transient = True
                        still.extend(chunk)
                        continue
                    if len(resp.blobs) != len(chunk):
                        # short answer: nothing in it is trustworthy-
                        # complete; retry the whole chunk elsewhere
                        self._chunk_failure(peer)
                        transient = True
                        still.extend(chunk)
                        continue
                    for h, blob in zip(chunk, resp.blobs):
                        if not blob:
                            still.append(h)
                            continue
                        ok = await validator(h, blob) if validator else True
                        result[h] = bool(ok)
                        if ok:
                            self.report_success(peer)
                        else:
                            # an invalid blob for a requested id is strong
                            # evidence of a bad peer (content-addressed)
                            self.report_failure(peer, weight=3)
                            still.append(h)
                missing = still
            if not transient:
                break
        return result

    async def get_epoch_atxs(self, epoch: int) -> list[bytes]:
        """Union of peers' ATX id lists for the epoch, fetched + validated."""
        ids: list[bytes] = []
        seen: set[bytes] = set()
        for peer in self.peers():
            try:
                resp = await self.server.request(
                    peer, P_EPOCH, struct.pack("<I", epoch))
            except (RequestError, asyncio.TimeoutError):
                self.report_failure(peer)
                continue
            for k in range(0, len(resp), 32):
                i = resp[k:k + 32]
                if i not in seen:
                    seen.add(i)
                    ids.append(i)
        await self.get_hashes(HINT_ATX, ids)
        return ids

    async def get_layer_data(self, layer: int,
                             max_peers: int = 5) -> LayerData | None:
        """Cross-peer layer opinion (reference syncer/data_fetch.go polls
        several peers): UNION of ballot/block ids — one lying peer cannot
        hide data the rest of the network has (fabricated ids fail the
        content-hash validators and cost the liar its score) — and the
        MAJORITY certified block id (a single peer cannot steer a late
        joiner onto a fake hare output)."""
        ballots: list[bytes] = []
        blocks: list[bytes] = []
        cert_votes: dict[bytes, int] = {}
        answered = 0
        for peer in self.peers()[:max_peers]:
            try:
                resp = await self.server.request(
                    peer, P_LAYER, struct.pack("<I", layer))
                data = LayerData.from_bytes(resp)
            except (RequestError, asyncio.TimeoutError, codec.DecodeError):
                self.report_failure(peer)
                continue
            answered += 1
            for b in data.ballots:
                if b not in ballots:
                    ballots.append(b)
            for b in data.blocks:
                if b not in blocks:
                    blocks.append(b)
            if data.certified != bytes(32):
                cert_votes[data.certified] = \
                    cert_votes.get(data.certified, 0) + 1
        if answered == 0:
            return None
        # majority certified id if one exists; ALL reported candidates ride
        # along (vote-ordered) so the caller can let certificate
        # VALIDATION arbitrate ties — with one honest and one lying peer
        # the vote is 1-1, but only the honest certificate verifies
        candidates = [c for c, _ in sorted(cert_votes.items(),
                                           key=lambda kv: -kv[1])]
        certified = bytes(32)
        if candidates and (cert_votes[candidates[0]] * 2 > answered
                           or answered == 1):
            certified = candidates[0]
        data = LayerData(ballots=ballots, blocks=blocks, certified=certified)
        data.cert_candidates = candidates  # non-wire, local-only attribute
        return data
