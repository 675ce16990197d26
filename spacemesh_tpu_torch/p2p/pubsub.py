"""Publish/subscribe seam + in-proc loopback hub (port of
``spacemesh_tpu/p2p/pubsub.py``, whole, with its ``gossip.deliver`` and
``gossip.handler`` spans).

Mirrors the reference's gossip topic registration (reference
p2p/pubsub/pubsub.go: topics `ax1 pp1 tx1 b1 bo1 mp1 bc1 ...` with
validator handlers; handlers return accept/reject and rejection can drop
the peer). Topic names are kept. The LoopbackHub wires N in-proc nodes
fully connected — the TestNetwork equivalent (reference
node/test_network.go) — delivering to every OTHER node's handlers and,
like gossipsub, not echoing to the publisher (publishers handle their own
messages locally, as the reference does via pubsub self-delivery... which
IS echoed there; here `deliver_self` controls it, default True to match).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable

from ..utils import metrics, tracing

_log = logging.getLogger("pubsub")

# reference topic names (p2p/pubsub/pubsub.go:54-81)
TOPIC_ATX = "ax1"
TOPIC_PROPOSAL = "pp1"
TOPIC_TX = "tx1"
TOPIC_BEACON_PROPOSAL = "bp1"
TOPIC_BEACON_FIRST = "bf1"
TOPIC_BEACON_FOLLOW = "bo1"
TOPIC_BEACON_WEAK_COIN = "bw1"
TOPIC_HARE = "b1"
TOPIC_MALFEASANCE = "mp1"
TOPIC_CERTIFY = "bc1"
TOPIC_POET = "pt1"

# (peer, data) -> True: accept + relay; None: accept but do NOT relay
# (graded-gossip duplicate/suppressed); False: reject (penalize sender).
Handler = Callable[[bytes, bytes], Awaitable[bool]]


class PubSub:
    """One node's view: register validators, publish bytes."""

    def __init__(self, node_name: bytes = b"local",
                 deliver_self: bool = True):
        self.name = node_name
        self.deliver_self = deliver_self
        self._handlers: dict[str, list[Handler]] = {}
        self._hub: "LoopbackHub | None" = None

    def register(self, topic: str, handler: Handler) -> None:
        self._handlers.setdefault(topic, []).append(handler)

    async def publish(self, topic: str, data: bytes) -> None:
        if self.deliver_self:
            await self.deliver(topic, self.name, data)
        if self._hub is not None:
            await self._hub.broadcast(self, topic, data)

    async def deliver(self, topic: str, peer: bytes, data: bytes):
        """Tri-state aggregate over the topic's handlers: False if any
        rejected, else None if any suppressed relay, else True.

        One raising handler must not abort delivery to the REMAINING
        subscribers (nor kill the bus): the exception is counted as a
        reject, logged, and surfaced in pubsub_handler_drops_total so a
        silently-crashing validator is visible to operators.

        Under a span-trace capture (utils/tracing.py) each delivery is
        the ROOT of a causal timeline: the per-handler validator spans —
        and everything they await, verify-farm submits included —
        parent into it, so one gossip message's whole processing path
        reads as a single tree in the Perfetto export."""
        ok = True
        dsp = tracing.span("gossip.deliver",
                           {"topic": topic, "peer": peer.hex()[:16],
                            "bytes": len(data)}
                           if tracing.is_enabled() else None)
        async with dsp:
            for h in self._handlers.get(topic, ()):
                t0 = time.perf_counter()
                try:
                    async with tracing.span(
                            "gossip.handler",
                            {"topic": topic,
                             "handler": getattr(h, "__qualname__", str(h))}
                            if tracing.is_enabled() else None):
                        r = await h(peer, data)
                except asyncio.CancelledError:
                    raise  # shutdown must still propagate
                except Exception as exc:  # noqa: BLE001 — bad message ≠ dead bus
                    metrics.pubsub_handler_drops.inc(topic=topic)
                    _log.warning("handler %r dropped message on topic %s: %r",
                                 getattr(h, "__qualname__", h), topic, exc)
                    r = False
                finally:
                    # handler wall time INCLUDING farm queue wait — the
                    # gossip-latency SLI an admission decision keys off
                    metrics.gossip_handler_seconds.observe(
                        time.perf_counter() - t0, topic=topic)
                if r is False:
                    ok = False
                elif r is None and ok is True:
                    ok = None
            if dsp is not tracing._NOP:
                dsp.set(result={True: "accept", False: "reject",
                                None: "no-relay"}[ok])
        return ok


class LoopbackHub:
    """Fully-connected in-proc network of PubSub endpoints.

    Delivery is fire-and-forget with a per-receiver ordered inbox, like
    real gossipsub: a publisher never waits on other nodes' validators
    (a slow or stuck receiver must not be able to stall the sender's
    consensus rounds), while each receiver still processes messages in
    arrival order.
    """

    def __init__(self) -> None:
        self._nodes: list[PubSub] = []
        self._inboxes: dict[int, asyncio.Queue] = {}
        self._consumers: dict[int, asyncio.Task] = {}

    def join(self, ps: PubSub) -> None:
        ps._hub = self
        self._nodes.append(ps)

    def leave(self, ps: PubSub) -> None:
        ps._hub = None
        self._nodes.remove(ps)
        task = self._consumers.pop(id(ps), None)
        if task is not None:
            task.cancel()
        self._inboxes.pop(id(ps), None)

    def _inbox(self, ps: PubSub) -> asyncio.Queue:
        key = id(ps)
        if key not in self._inboxes:
            self._inboxes[key] = asyncio.Queue()

            async def consume(node=ps, q=self._inboxes[key]):
                while True:
                    topic, peer, data = await q.get()
                    try:
                        await node.deliver(topic, peer, data)
                    except Exception:  # noqa: BLE001 — deliver() already
                        # counts + logs per-handler failures
                        # (pubsub_handler_drops_total); this guard only
                        # keeps the hub consumer task alive
                        pass
                    finally:
                        q.task_done()

            self._consumers[key] = asyncio.ensure_future(consume())
        return self._inboxes[key]

    async def broadcast(self, sender: PubSub, topic: str, data: bytes) -> None:
        for n in self._nodes:
            if n is not sender:
                self._inbox(n).put_nowait((topic, sender.name, data))

    async def drain(self) -> None:
        """Wait until every queued message is fully DELIVERED (join(), not
        emptiness: the last message may still be mid-handler)."""
        await asyncio.gather(*(q.join() for q in self._inboxes.values()))
