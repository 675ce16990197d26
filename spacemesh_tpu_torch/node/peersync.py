"""Peersync: clock-drift detection against peers (port of
``spacemesh_tpu/node/peersync.py``).

Mirrors the reference timesync/peersync (sync.go, round.go): sample
peers' wall clocks over a request/response round, estimate the local
offset as ``server_time - (t_send + rtt/2)``, take the median across
peers, and raise when it exceeds the tolerance — a node whose clock
drifts silently misses every hare round and proposal slot, so loud
failure beats quiet divergence (the reference errors the node out).
"""

from __future__ import annotations

import asyncio
import statistics
import struct
import time
from typing import Callable, Optional

from ..utils.logging import get as get_logger

PROTOCOL = "ts/1"

log = get_logger("peersync")


class PeerSync:
    def __init__(self, server, fetch, *, wall=time.time,
                 max_drift: float = 10.0, interval: float = 60.0,
                 min_peers: int = 3,
                 on_drift: Optional[Callable[[float], None]] = None):
        """``min_peers`` is a QUORUM: one skewed/malicious peer must not
        dictate the 'median' (reference peersync requires 3 responses)."""
        self.server = server
        self.fetch = fetch
        self.wall = wall
        self.max_drift = max_drift
        self.interval = interval
        self.min_peers = min_peers
        self.on_drift = on_drift
        # last measured median offset (None before the first quorum) —
        # the clock-drift health probe (obs/health.py via node/app.py)
        # reads this instead of re-sampling the network per scrape
        self.last_offset: float | None = None
        self._stop = False
        server.register(PROTOCOL, self._serve)

    async def _serve(self, peer: bytes, data: bytes) -> bytes:
        return struct.pack("<d", self.wall())

    async def sample(self, peer: bytes) -> float | None:
        """One peer's estimated clock offset relative to ours (seconds;
        positive = the peer's clock is ahead)."""
        t0 = self.wall()
        try:
            resp = await self.server.request(peer, PROTOCOL, b"", timeout=5.0)
        except Exception:  # noqa: BLE001 — unreachable peer: no sample
            return None
        t1 = self.wall()
        if len(resp) != 8:
            return None
        (server_time,) = struct.unpack("<d", resp)
        return server_time - (t0 + (t1 - t0) / 2)

    async def check(self) -> float | None:
        """Median offset across peers, or None without enough samples."""
        peers = self.fetch.peers() if self.fetch else self.server.peers()
        samples = [s for s in await asyncio.gather(
            *(self.sample(p) for p in peers[:8])) if s is not None]
        if len(samples) < self.min_peers:
            return None
        return statistics.median(samples)

    async def run(self) -> None:
        while not self._stop:
            offset = await self.check()
            if offset is not None:
                self.last_offset = offset
            if offset is not None and abs(offset) > self.max_drift:
                log.error("clock drift %.2fs exceeds tolerance %.2fs — "
                          "fix the system clock", offset, self.max_drift)
                if self.on_drift:
                    self.on_drift(offset)
            await asyncio.sleep(self.interval)

    def stop(self) -> None:
        self._stop = True
