"""Priority-lane admission primitives for async device-job queues.

Port of ``spacemesh_tpu/runtime/queue.py``. The verification farm
(``verify/farm.py``) consumes these, so the per-lane backpressure waiter
logic (a waiter cancelled after ``release`` resolved it hands the freed
slot on instead of losing it) lives in one place.

Two pieces:

* :class:`LaneGroup` — the per-lane global accounting one admission
  domain shares across request kinds: counts, bounds, backpressure
  waiters (with the cancellation slot-handoff), in-flight dedup map,
  and fail-all on close.  Bound to one event loop; rebinding drops
  state (the embedder-runs-asyncio.run()-twice contract).
* :class:`KindLanes` — one request kind's per-lane FIFO deques with
  highest-priority-first draining, earliest-deadline lookup, and
  promote-on-dedup removal.

The lane state is loop-only by contract (no lock); the race sanitizer's
owner-write ``SharedField`` checks that no other thread mutates it.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Optional

from ..utils import sanitize


class QueueClosed(RuntimeError):
    """The admission queue was shut down while the request was pending."""


class LaneGroup:
    """Shared per-lane admission accounting for one queue domain.

    ``lanes``    the IntEnum lane type (drained in ascending order).
    ``bounds``   per-lane queued-request caps; a full lane blocks its
                 own submitters in :meth:`acquire`.
    ``make_exc`` exception factory for closed-queue failures (the farm
                 raises its own FarmClosed subtype).
    ``on_depth`` ``(lane, depth)`` hook for the owner's queue gauges.
    """

    def __init__(self, lanes, bounds: dict,
                 make_exc: Callable[[], Exception] = QueueClosed,
                 on_depth: Optional[Callable] = None):
        self.lanes = lanes
        self.bounds = dict(bounds)
        self._make_exc = make_exc
        self._on_depth = on_depth
        self.closed = False
        self._loop: asyncio.AbstractEventLoop | None = None
        # lane counts/waiters/dedup are loop-affine BY CONTRACT (no
        # lock anywhere in this class); the owner-write declaration is
        # the runtime check that no worker thread ever mutates them
        self._shared = sanitize.SharedField("runtime.queue.lanegroup",
                                            mode="owner-write")
        self._count: dict = {lane: 0 for lane in lanes}
        self._waiters: dict = {lane: deque() for lane in lanes}
        self.dedup: dict = {}

    # -- lifecycle -----------------------------------------------------

    def bind(self, loop: asyncio.AbstractEventLoop) -> bool:
        """Bind to ``loop``; returns True when state was (re)created —
        pending entries from a dead loop are unrecoverable and dropped,
        and the owner must drop its per-kind deques too."""
        if self._loop is loop:
            return False
        self._loop = loop
        self._count = {lane: 0 for lane in self.lanes}
        self._waiters = {lane: deque() for lane in self.lanes}
        self.dedup = {}
        # a rebind is a sanctioned ownership handoff: the new loop may run
        # on a different thread
        self._shared.reset()
        return True

    def fail_waiters(self) -> None:
        """Fail every backpressure waiter with the closed exception (the
        bound loop must still be alive)."""
        for waiters in self._waiters.values():
            while waiters:
                w = waiters.popleft()
                if not w.done():
                    w.set_exception(self._make_exc())

    # -- accounting ----------------------------------------------------

    def count(self, lane) -> int:
        return self._count[lane]

    def total(self) -> int:
        return sum(self._count.values())

    def add(self, lane) -> int:
        """Unconditional occupancy increment (post-acquire, or a dedup
        promote that already holds a slot elsewhere)."""
        self._shared.touch()
        self._count[lane] += 1
        depth = self._count[lane]
        if self._on_depth is not None:
            self._on_depth(lane, depth)
        return depth

    def release(self, lane) -> None:
        """Free one slot and hand it to the next live waiter."""
        self._shared.touch()
        self._count[lane] -= 1
        if self._on_depth is not None:
            self._on_depth(lane, self._count[lane])
        self.wake_next(lane)

    def wake_next(self, lane) -> None:
        """Grant a freed lane slot to the next live backpressure waiter
        (woken submitters re-check the bound in acquire's while loop)."""
        waiters = self._waiters[lane]
        while waiters and self._count[lane] < self.bounds[lane]:
            w = waiters.popleft()
            if not w.done():
                w.set_result(None)
                return

    async def acquire(self, lane) -> None:
        """Wait until ``lane`` has room (its bound blocks only its own
        submitters).  Cancellation is slot-safe: a waiter cancelled
        after :meth:`release` resolved it hands the freed slot to the
        next waiter instead of silently losing it — the semantics this
        module exists to keep in ONE place."""
        while self._count[lane] >= self.bounds[lane]:
            waiter = self._loop.create_future()
            self._waiters[lane].append(waiter)
            try:
                await waiter
            except asyncio.CancelledError:
                try:
                    self._waiters[lane].remove(waiter)
                except ValueError:
                    # already popped by release(): it granted us a slot
                    # we will never use — hand the wakeup to the next
                    # waiter, or the freed slot is silently lost and
                    # survivors can park forever on a drained lane
                    if waiter.done() and not waiter.cancelled():
                        self.wake_next(lane)
                raise
            if self.closed:
                raise self._make_exc()


class KindLanes:
    """One request kind's per-lane FIFO deques over a :class:`LaneGroup`.

    Entries are opaque; they only need ``lane`` and ``deadline``
    attributes (the farm's pending-request records).  Draining order is
    ascending lane value — highest priority first.
    """

    def __init__(self, group: LaneGroup):
        self.group = group
        self.lanes: dict = {lane: deque() for lane in group.lanes}

    def append(self, entry) -> int:
        """Queue ``entry`` on its lane; returns the lane depth (the
        caller already holds an acquired slot)."""
        self.lanes[entry.lane].append(entry)
        return self.group.add(entry.lane)

    def remove(self, entry) -> bool:
        """Remove a still-queued entry (dedup promote); False once it
        was already taken into a batch.  Releases its lane slot."""
        try:
            self.lanes[entry.lane].remove(entry)
        except ValueError:
            return False
        self.group.release(entry.lane)
        return True

    def count(self) -> int:
        return sum(len(q) for q in self.lanes.values())

    def earliest_deadline(self) -> float:
        return min(q[0].deadline for q in self.lanes.values() if q)

    def take(self, limit: int) -> list:
        """Drain up to ``limit`` entries, highest-priority lanes first.
        Lane slots are NOT released here — the owner releases them as it
        accounts queue-wait per entry (farm._on_taken)."""
        batch: list = []
        for lane in self.group.lanes:
            q = self.lanes[lane]
            while q and len(batch) < limit:
                batch.append(q.popleft())
        return batch

    def drain_all(self) -> list:
        """Empty every lane (close path); slots are not released."""
        out: list = []
        for q in self.lanes.values():
            while q:
                out.append(q.popleft())
        return out
