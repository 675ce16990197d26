"""Layer clock: wall time -> LayerID ticker with awaitable layers (port of
``spacemesh_tpu/node/clock.py``).

Mirrors the reference's NodeClock (reference timesync/clock.go:25-44:
genesis time + layer duration drive a ticker; consumers AwaitLayer(n)).
asyncio-native; tests inject a fake time source and step it manually
(the reference injects clockwork fake clocks — SURVEY.md §4.3).
"""

from __future__ import annotations

import asyncio
import time as _time
from typing import Callable

from ..core.types import LayerID


class LayerClock:
    def __init__(self, genesis_time: float, layer_duration: float,
                 time_source: Callable[[], float] = _time.time,
                 poll_interval: float = 0.05):
        if layer_duration <= 0:
            raise ValueError("layer_duration must be positive")
        self.genesis_time = genesis_time
        self.layer_duration = layer_duration
        self._now = time_source
        self._poll = poll_interval
        # current wake generation: notify_time_changed() fires it so
        # every await_layer re-checks the (jumped) time source NOW
        self._jump: asyncio.Event | None = None

    def current_layer(self) -> LayerID:
        dt = self._now() - self.genesis_time
        if dt < 0:
            return LayerID(0)
        return LayerID(int(dt // self.layer_duration))

    def time_of(self, layer: int) -> float:
        return self.genesis_time + layer * self.layer_duration

    def genesis_reached(self) -> bool:
        return self._now() >= self.genesis_time

    def notify_time_changed(self) -> None:
        """Wake every await_layer waiter immediately: an injected time
        source jumped (chaos timeskew, a test stepping FakeTime) and
        waiters must observe the new time now, not at their next poll."""
        ev, self._jump = self._jump, None
        if ev is not None:
            ev.set()

    async def await_layer(self, layer: int) -> LayerID:
        """Sleep until ``layer`` begins (returns immediately if begun)."""
        while True:
            cur = self.current_layer()
            if self.genesis_reached() and cur >= layer:
                return cur
            delay = max(self.time_of(layer) - self._now(), 0.0)
            if self._jump is None:
                self._jump = asyncio.Event()
            ev = self._jump
            # fake clocks jump: poll with a bounded sleep so manual time
            # steps are observed promptly in tests, real time sleeps
            # long; notify_time_changed() short-circuits the poll
            try:
                await asyncio.wait_for(
                    ev.wait(), min(delay, self._poll) if delay else 0.01)
            except asyncio.TimeoutError:
                pass

    async def ticks(self):
        """Async iterator of layer starts, from the next layer onward."""
        nxt = self.current_layer() + 1 if self.genesis_reached() else 0
        while True:
            cur = await self.await_layer(nxt)
            for lyr in range(nxt, cur + 1):
                yield LayerID(lyr)
            nxt = cur + 1


class FakeTime:
    """Manually stepped time source for tests."""

    def __init__(self, start: float = 0.0):
        self.t = start

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt
