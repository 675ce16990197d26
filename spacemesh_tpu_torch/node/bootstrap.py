"""Bootstrap fallback updater + prune loop (the operational shell) (port of
``spacemesh_tpu/node/bootstrap.py``).

Reference parity:
- bootstrap/updater.go:114-159: polls a URL for per-epoch JSON carrying a
  fallback beacon and/or activeset; verified, cached on disk, and pushed
  to subscribers (beacon fallback + miner/hare activeset). Here the
  source is a file path or http(s)/file URL (urllib); the epoch document
  shape mirrors bootstrap/schema.json:
      {"epoch": N, "beacon": "hex8", "activeset": ["hex64", ...]}
- prune/prune.go: periodic deletion of stale data outside the retention
  window (old proposals are in-RAM here, so prune covers certificates,
  active sets, and poet proofs).
"""

from __future__ import annotations

import asyncio
import json
import urllib.request
from pathlib import Path
from typing import Callable

from ..utils.logging import get as get_logger

log = get_logger("bootstrap")


class BootstrapUpdater:
    """Poll a local path or URL for epoch fallback documents."""

    def __init__(self, source: str, *,
                 on_beacon: Callable[[int, bytes], None] | None = None,
                 on_activeset: Callable[[int, list[bytes]], None] | None = None,
                 interval: float = 30.0, cache_dir: str | Path | None = None):
        self.source = source
        self.on_beacon = on_beacon
        self.on_activeset = on_activeset
        self.interval = interval
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self._seen: set[int] = set()
        self._stop = False

    def _read(self) -> list[dict]:
        if "://" in self.source:
            with urllib.request.urlopen(self.source, timeout=10) as r:
                raw = r.read()
        else:
            path = Path(self.source)
            if not path.exists():
                return []
            raw = path.read_bytes()
        doc = json.loads(raw)
        return doc if isinstance(doc, list) else [doc]

    def poll_once(self) -> int:
        """Fetch + apply any new epoch documents; returns how many."""
        try:
            docs = self._read()
        except (OSError, ValueError) as e:
            log.warning("bootstrap source unavailable: %s", e)
            return 0
        applied = 0
        for doc in docs:
            try:
                epoch = int(doc["epoch"])
                if epoch in self._seen:
                    continue
                beacon = (bytes.fromhex(doc["beacon"])
                          if doc.get("beacon") else None)
                activeset = [bytes.fromhex(a)
                             for a in doc.get("activeset", [])]
                if beacon is not None and len(beacon) != 4:
                    raise ValueError("beacon must be 4 bytes")
                if any(len(a) != 32 for a in activeset):
                    raise ValueError("activeset ids must be 32 bytes")
            except (KeyError, ValueError, TypeError) as e:
                log.warning("bad bootstrap document: %s", e)
                continue
            self._seen.add(epoch)
            if self.cache_dir is not None:
                self.cache_dir.mkdir(parents=True, exist_ok=True)
                (self.cache_dir / f"epoch-{epoch}.json").write_text(
                    json.dumps(doc))
            if beacon is not None and self.on_beacon:
                self.on_beacon(epoch, beacon)
            if activeset and self.on_activeset:
                self.on_activeset(epoch, activeset)
            applied += 1
            log.info("bootstrap epoch %d applied (beacon=%s, activeset=%d)",
                     epoch, beacon.hex() if beacon else "-", len(activeset))
        return applied

    async def run(self) -> None:
        while not self._stop:
            # poll_once does blocking I/O (urllib) — keep it off the loop
            await asyncio.to_thread(self.poll_once)
            await asyncio.sleep(self.interval)

    def stop(self) -> None:
        self._stop = True


class Pruner:
    """Periodic retention cleanup (reference prune/prune.go)."""

    def __init__(self, db, *, retention_layers: int,
                 current_layer: Callable[[], int],
                 layers_per_epoch: int, interval: float = 60.0):
        self.db = db
        self.retention = retention_layers
        self.current_layer = current_layer
        self.layers_per_epoch = layers_per_epoch
        self.interval = interval
        self._stop = False

    def prune_once(self) -> dict:
        horizon = self.current_layer() - self.retention
        if horizon <= 0:
            return {"certificates": 0, "active_sets": 0, "poet_proofs": 0}
        epoch_horizon = max(horizon // self.layers_per_epoch - 1, 0)
        with self.db.tx():
            certs = self.db.exec(
                "DELETE FROM certificates WHERE layer<?",
                (horizon,)).rowcount
            sets_ = self.db.exec(
                "DELETE FROM active_sets WHERE epoch>=0 AND epoch<?",
                (epoch_horizon,)).rowcount
            poets = self.db.exec(
                "DELETE FROM poet_proofs WHERE CAST(round_id AS INT)<?"
                " AND round_id GLOB '[0-9]*'",
                (epoch_horizon,)).rowcount
        out = {"certificates": certs, "active_sets": sets_,
               "poet_proofs": poets}
        if any(out.values()):
            log.info("pruned %s below layer %d", out, horizon)
        return out

    async def run(self) -> None:
        while not self._stop:
            # maintenance failures (a transient "database is locked"
            # from a slow reader, a full disk) must not kill the
            # retention loop for the life of the node — log and retry
            # next tick
            try:
                await asyncio.to_thread(self.prune_once)
                # retention deletes leave free pages; reclaim them when
                # the freelist crosses the threshold (reference
                # sql/vacuum.go — scheduled maintenance alongside
                # pruning, not per-write)
                await asyncio.to_thread(self.db.maybe_vacuum)
            except Exception:
                log.exception("prune/vacuum tick failed; will retry")
            await asyncio.sleep(self.interval)

    def stop(self) -> None:
        self._stop = True
