"""In-process event bus with buffered fan-out subscriptions (port of
``spacemesh_tpu/node/events.py``).

Mirrors the reference's events package (reference events/reporter.go:
global reporter, typed Emit*/Subscribe*, buffered subscriptions with an
overflow signal streamed to the API event service). asyncio-native: each
subscription is a bounded queue; on overflow the subscription is marked
lossy (consumers resync from storage, as the reference does).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
import weakref
from collections import defaultdict, deque
from typing import Any, Type

from ..utils import metrics, sanitize


@dataclasses.dataclass
class LayerUpdate:
    layer: int
    status: str          # "tick" | "hare_done" | "applied"


@dataclasses.dataclass
class AtxEvent:
    atx_id: bytes
    node_id: bytes
    epoch: int


@dataclasses.dataclass
class BeaconEvent:
    epoch: int
    beacon: bytes


@dataclasses.dataclass
class BeaconFallback:
    """Beacon protocol could not decide; a fallback value was recorded."""

    epoch: int
    reason: str


@dataclasses.dataclass
class TxEvent:
    tx_id: bytes
    valid: bool


@dataclasses.dataclass
class PostEvent:
    node_id: bytes
    kind: str            # "init_start" | "init_complete" | "post_start" | "post_complete"
    detail: str = ""


@dataclasses.dataclass
class AtxPublished:
    atx_id: bytes
    node_id: bytes
    epoch: int


@dataclasses.dataclass
class ClockDrift:
    """Local clock drift vs the peer median exceeds tolerance."""

    offset: float


@dataclasses.dataclass
class Malfeasance:
    node_id: bytes


@dataclasses.dataclass
class SloBreach:
    """A declarative SLO's burn exceeded its budget (obs/health.py)."""

    slo: str
    sli: str
    value: float
    target: float
    burn: float


@dataclasses.dataclass
class ComponentHealth:
    """A component liveness probe changed verdict (obs/health.py)."""

    component: str
    healthy: bool
    reason: str


@dataclasses.dataclass
class RemediationAction:
    """The remediation engine decided a recovery action
    (obs/remediate.py): ``outcome`` is ok/error/no_hook/rate_limited/
    escalated/quarantined — every decision is an event, including the
    refusals, so an operator can replay WHY a component was (not)
    restarted."""

    component: str
    action: str
    outcome: str
    detail: str = ""


class Subscription:
    def __init__(self, bus: "EventBus", types: tuple, size: int):
        self._bus = bus
        self.types = types
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=size)
        self.overflowed = False

    def _offer(self, ev) -> None:
        try:
            self.queue.put_nowait(ev)
        except asyncio.QueueFull:
            # the boolean marks the subscription lossy for its consumer;
            # the counter makes the loss visible to OPERATORS before any
            # consumer notices a gap in its stream
            self.overflowed = True
            metrics.events_overflows.inc(type=type(ev).__name__)

    async def next(self):
        return await self.queue.get()

    def close(self) -> None:
        self._bus._drop(self)


class EventBus:
    # a bounded ring of the last emissions, for the flight recorder: a
    # diagnostic bundle wants "what just happened" without any consumer
    # having subscribed in advance
    RECENT = 256

    def __init__(self) -> None:
        self._subs: dict[type, list[Subscription]] = defaultdict(list)
        self.recent: deque = deque(maxlen=self.RECENT)
        # the deepest_queue race class, runtime-checked: subscriber
        # lists are loop-affine for MUTATION (owner-write; the runtime
        # twin of `# spacecheck: loop-only`); other threads may only
        # snapshot-read (deepest_queue, flight dumps)
        self._shared = sanitize.SharedField("events.bus.subs",
                                            mode="owner-write")
        _BUSES.add(self)

    def subscribe(self, *types: Type, size: int = 256) -> Subscription:
        self._shared.touch()
        sub = Subscription(self, types, size)
        for t in types:
            self._subs[t].append(sub)
        return sub

    def emit(self, ev: Any) -> None:
        self._shared.touch()
        # display timestamp for flight-bundle event dumps, never used
        # in logic or digests
        self.recent.append((time.time(), type(ev).__name__, ev))  # spacecheck: ok=SC001 wall display timestamp only
        for sub in list(self._subs.get(type(ev), ())):
            sub._offer(ev)

    def deepest_queue(self) -> int:
        """Deepest subscription queue right now (scrape-time truth).
        Snapshots the dict/lists first: collectors run from flight-dump
        worker threads while the loop thread subscribes (GIL makes the
        list() copies atomic; plain iteration would race a dict
        resize)."""
        deepest = 0
        seen: set[int] = set()
        self._shared.touch(write=False)
        for subs in list(self._subs.values()):
            for sub in list(subs):
                if id(sub) in seen:
                    continue  # multi-type subscriptions appear once
                seen.add(id(sub))
                deepest = max(deepest, sub.queue.qsize())
        return deepest

    def _drop(self, sub: Subscription) -> None:
        self._shared.touch()
        for t in sub.types:
            if sub in self._subs.get(t, ()):
                self._subs[t].remove(sub)


# The queue-depth gauge is recomputed at SCRAPE time over every live
# bus: the old emit-time write never decayed as consumers drained (or
# when the deepest subscriber closed), so /metrics reported the
# high-water mark of the last emission forever.
_BUSES: "weakref.WeakSet[EventBus]" = weakref.WeakSet()


def _collect_queue_depth() -> None:
    metrics.events_queue_depth.set(
        max((bus.deepest_queue() for bus in list(_BUSES)), default=0))


metrics.REGISTRY.add_collector(_collect_queue_depth)
