"""The device-job loop: a bounded dispatch -> retire window.

Port of ``spacemesh_tpu/runtime/engine.py`` without its metrics, circuit
breaker, sanitizer and span hooks. A host thread enqueues up to
``inflight`` batches of device work (``dispatch``), then pops the oldest
and blocks on its results (``retire``), so device compute, copies and host
work overlap.

``dispatch(item) -> ticket``
    Enqueue device work for one item and return at once.

``retire(ticket) -> result | None``
    Block on the oldest in-flight ticket and consume it. A non-None return
    is an early exit: the pipeline stops pulling items, abandons the
    in-flight tickets and returns that value.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional


@dataclasses.dataclass
class PipelineStats:
    batches: int = 0
    dispatch_s: float = 0.0   # host time enqueueing device work
    first_dispatch_s: float = 0.0  # the first batch's share of dispatch_s
    retire_s: float = 0.0     # blocked consuming results
    early_exited: bool = False
    stopped: bool = False


class Pipeline:
    """Bounded in-flight dispatch -> retire executor for one device job.

    ``inflight``  device batches in flight before the oldest retires.
    ``stop``      checked before each dispatch and each drain step; True
                  discards the in-flight work (stop latency is one retire,
                  not a drain).
    """

    def __init__(self, *, inflight: int = 3,
                 stop: Optional[Callable[[], bool]] = None):
        self.inflight = max(int(inflight), 1)
        self._stop = stop
        self.stats = PipelineStats()

    def _retire(self, retire, ticket):
        t0 = time.perf_counter()
        try:
            return retire(ticket)
        finally:
            self.stats.retire_s += time.perf_counter() - t0

    def run(self, items: Iterable[Any], dispatch, retire):
        """Drive ``items`` through the window. Returns the first non-None
        retire result, or None when every item retired or the stop
        predicate ended the run (``stats.stopped`` tells them apart)."""
        stats = self.stats
        pending: deque = deque()
        for item in items:
            if self._stop is not None and self._stop():
                stats.stopped = True
                return None
            t0 = time.perf_counter()
            pending.append(dispatch(item))
            dt = time.perf_counter() - t0
            stats.dispatch_s += dt
            if not stats.batches:
                stats.first_dispatch_s = dt
            stats.batches += 1
            if len(pending) >= self.inflight:
                result = self._retire(retire, pending.popleft())
                if result is not None:
                    stats.early_exited = True
                    return result
        while pending:
            if self._stop is not None and self._stop():
                stats.stopped = True
                return None
            result = self._retire(retire, pending.popleft())
            if result is not None:
                stats.early_exited = True
                return result
        return None
