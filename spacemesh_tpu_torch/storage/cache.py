"""In-RAM ATX cache for hot consensus paths (port of
``spacemesh_tpu/storage/cache.py``; reference atxsdata/data.go:
per-epoch maps of ATX weight/height/nonce/malicious, fed on ATX ingestion,
evicted per epoch; used by tortoise, eligibility oracle, and the miner
without touching SQLite)."""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class AtxInfo:
    node_id: bytes
    weight: int           # num_units * tick_count
    base_height: int
    height: int
    num_units: int
    vrf_nonce: int
    vrf_public_key: bytes = b""
    malicious: bool = False


class AtxCache:
    def __init__(self) -> None:
        self._epochs: dict[int, dict[bytes, AtxInfo]] = {}
        self._malicious: set[bytes] = set()
        self._lock = threading.RLock()

    def add(self, target_epoch: int, atx_id: bytes, info: AtxInfo) -> None:
        with self._lock:
            info.malicious = info.malicious or info.node_id in self._malicious
            self._epochs.setdefault(target_epoch, {})[atx_id] = info

    def get(self, target_epoch: int, atx_id: bytes) -> AtxInfo | None:
        with self._lock:
            return self._epochs.get(target_epoch, {}).get(atx_id)

    def iter_epoch(self, target_epoch: int):
        with self._lock:
            return list(self._epochs.get(target_epoch, {}).items())

    def epoch_weight(self, target_epoch: int) -> int:
        with self._lock:
            return sum(i.weight for i in
                       self._epochs.get(target_epoch, {}).values()
                       if not i.malicious)

    def epoch_count(self, target_epoch: int) -> int:
        """Number of non-malicious ATXs targeting the epoch."""
        with self._lock:
            return sum(1 for i in self._epochs.get(target_epoch, {}).values()
                       if not i.malicious)

    def weight_for_set(self, target_epoch: int, atx_ids: list[bytes]) -> int:
        with self._lock:
            e = self._epochs.get(target_epoch, {})
            return sum(e[a].weight for a in atx_ids if a in e)

    def set_malicious(self, node_id: bytes) -> None:
        with self._lock:
            self._malicious.add(node_id)
            for epoch in self._epochs.values():
                for info in epoch.values():
                    if info.node_id == node_id:
                        info.malicious = True

    def is_malicious(self, node_id: bytes) -> bool:
        with self._lock:
            return node_id in self._malicious

    def evict(self, before_epoch: int) -> None:
        with self._lock:
            for e in [e for e in self._epochs if e < before_epoch]:
                del self._epochs[e]
