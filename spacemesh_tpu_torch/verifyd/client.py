"""verifyd client library (port of ``spacemesh_tpu/verifyd/client.py``;
wire-compatible with the JAX package's server, and the JAX client with
this package's server).

:class:`VerifydClient` talks JSON-over-HTTP to a verifyd server
(aiohttp, imported when the first session opens; one session reused
across calls), re-raising the server's
typed shed docs as :class:`~.service.Shed` so an embedding node can
react to ``reason``/``retry_after_s`` instead of parsing bodies.  The
gRPC transport carries the identical docs — ``grpc_verify`` (which
imports grpc when called) shows the two-line difference for callers who
prefer HTTP/2 framing.

``serial_verify`` is the one-item-at-a-time driver: the honest baseline
an open-loop load is compared against (every remote check pays a full
round trip and a solo batch), and the simplest integration example.
"""

from __future__ import annotations

import asyncio
import dataclasses

from ..obs.remediate import backoff_delay
from . import protocol
from .service import Shed

# shed reasons worth retrying: the condition clears on its own (tokens
# refill, the queue drains). A config/lifecycle shed (unregistered,
# registry_full, shutting_down) never clears by waiting — re-raise it
# immediately, whatever the retry policy says.
RETRYABLE_SHEDS = frozenset({protocol.SHED_RATE, protocol.SHED_OVERLOAD,
                             protocol.SHED_QUEUE_FULL,
                             protocol.SHED_DEADLINE})

# lifecycle sheds that never clear by waiting on THIS replica but may
# clear instantly on ANOTHER: the server attaches a ``replica_hint``
# (Retry-After in space) and a fleet-aware client
# hops to it instead of backing off against the dead replica.
HOP_SHEDS = frozenset({protocol.SHED_REGISTRY_FULL,
                       protocol.SHED_SHUTTING_DOWN})


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded shed-retry budget with capped, seeded-jitter backoff.

    The wait for attempt ``k`` is :func:`~..obs.remediate.backoff_delay`
    — the SAME rule that times the failover breaker's half-open probes,
    so the cookbook client and the breaker cannot drift — floored at
    the server's ``retry_after_s`` hint.  A hint beyond ``cap_s`` means
    the condition will not clear within this client's patience: the
    shed re-raises immediately instead of sleeping toward a foregone
    conclusion.  ``max_attempts`` counts verify attempts, not waits
    (``max_attempts=1`` disables retrying).
    """

    max_attempts: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    seed: int = 0

    def should_retry(self, exc: Shed, attempt: int) -> bool:
        if attempt + 1 >= max(int(self.max_attempts), 1):
            return False
        if exc.reason not in RETRYABLE_SHEDS:
            return False
        return not (exc.retry_after_s is not None
                    and exc.retry_after_s > self.cap_s)

    def delay(self, exc: Shed, attempt: int) -> float:
        return backoff_delay(attempt, base_s=self.base_s,
                             cap_s=self.cap_s,
                             retry_after_s=exc.retry_after_s,
                             seed=self.seed)


class VerifydClient:
    """HTTP client for one verifyd endpoint.

    Lifecycle: construct -> ``register()`` -> ``verify(...)`` ->
    ``aclose()`` in a ``finally`` (unregisters by default, so the
    server's per-client series and tenant state go away with us).

    ``retry`` honors the server's typed-shed ``retry_after_s``: a
    retryable shed waits out a capped seeded-jitter backoff (floored at
    the hint) and re-verifies, up to the policy's attempt budget; pass
    ``retry=None`` for the raw one-shot behavior.  ``sleep`` injects
    the wait primitive so tests assert the exact delays with zero real
    sleeping.
    """

    def __init__(self, base_url: str, client_id: str, *,
                 session=None, unregister_on_close: bool = True,
                 retry: RetryPolicy | None = RetryPolicy(),
                 fallback_urls=(), sleep=asyncio.sleep):
        self.base_url = base_url.rstrip("/")
        self.client_id = str(client_id)
        self._session = session
        self._own_session = session is None
        self._unregister_on_close = unregister_on_close
        self._registered = False
        self.retry = retry
        self.fallback_urls = tuple(u.rstrip("/") for u in fallback_urls)
        self._register_kwargs: dict = {}
        self._sleep = sleep

    async def _sess(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def _post(self, path: str, body: dict) -> tuple[int, dict]:
        sess = await self._sess()
        async with sess.post(self.base_url + path, json=body) as resp:
            if resp.content_type == "application/json":
                return resp.status, await resp.json()
            return resp.status, {"status": "ERROR",
                                 "error": await resp.text()}

    @staticmethod
    def _raise_typed(doc: dict) -> None:
        if doc.get("status") == "SHED":
            raise Shed(doc.get("reason", "unknown"),
                       doc.get("detail", ""), doc.get("retry_after_s"),
                       replica_hint=doc.get("replica_hint"))
        if doc.get("status") == "ERROR":
            raise protocol.ProtocolError(doc.get("error", "bad request"))

    async def register(self, **kwargs) -> dict:
        """Register this client id (weight/rate/burst/max_queued/
        max_inflight keywords forward to the server)."""
        self._register_kwargs = dict(kwargs)
        status, doc = await self._post(
            "/v1/client/register", {"client": self.client_id, **kwargs})
        self._raise_typed(doc)
        if status != 200:
            raise protocol.ProtocolError(f"register failed: {doc}")
        self._registered = True
        return doc

    async def unregister(self) -> None:
        self._registered = False
        await self._post("/v1/client/unregister",
                         {"client": self.client_id})

    def _next_replica(self, hint: str | None,
                      tried: set[str]) -> str | None:
        """Next untried replica URL: the server's hint first, then this
        client's configured ring of fallbacks, each at most once."""
        candidates = ([hint] if hint else []) + list(self.fallback_urls)
        for url in candidates:
            url = str(url).rstrip("/")
            if url and url not in tried:
                return url
        return None

    async def _hop(self, url: str) -> None:
        """Re-home to ``url``: re-register there (same knobs as the
        original registration) so the next verify lands registered."""
        self.base_url = url
        self._registered = False
        await self.register(**self._register_kwargs)

    async def verify(self, reqs: list, *, lane: str = "gossip",
                     deadline_s: float | None = None) -> list[bool]:
        """Verify a batch of farm request objects; raises the server's
        typed Shed on rejection (after the retry policy's budget of
        ``retry_after_s``-honoring backoff waits, when one is set).

        A ``registry_full``/``shutting_down`` shed carrying a
        ``replica_hint`` (or arriving when ``fallback_urls`` names other
        fleet replicas) does NOT back off: the client re-registers on
        the hinted/next replica and retries immediately — waiting out a
        replica that is full or dying is time spent toward a foregone
        conclusion.  Each replica is hopped to at most once per call.
        """
        attempt = 0
        tried = {self.base_url}
        while True:
            try:
                return await self._verify_once(reqs, lane=lane,
                                               deadline_s=deadline_s)
            except Shed as e:
                exc = e
                if exc.reason in HOP_SHEDS:
                    hopped = False
                    nxt = self._next_replica(exc.replica_hint, tried)
                    while nxt is not None:
                        tried.add(nxt)
                        try:
                            await self._hop(nxt)
                            hopped = True
                            break
                        except Shed as e2:  # hop target shed us too:
                            exc = e2        # chase ITS hint next
                            nxt = self._next_replica(
                                e2.replica_hint, tried)
                    if hopped:
                        continue    # no sleep, no attempt consumed
                if self.retry is None \
                        or not self.retry.should_retry(exc, attempt):
                    raise exc
                await self._sleep(self.retry.delay(exc, attempt))
                attempt += 1

    async def _verify_once(self, reqs: list, *, lane: str,
                           deadline_s: float | None) -> list[bool]:
        body = {"client": self.client_id, "lane": lane,
                "items": [protocol.request_to_doc(r) for r in reqs]}
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        _status, doc = await self._post("/v1/verify", body)
        self._raise_typed(doc)
        verdicts = doc.get("verdicts")
        if doc.get("status") != "OK" or not isinstance(verdicts, list):
            raise protocol.ProtocolError(f"verify failed: {doc}")
        return [bool(v) for v in verdicts]

    async def serial_verify(self, reqs: list, *,
                            lane: str = "gossip") -> list[bool]:
        """One item per request, awaited one at a time — the serial
        baseline shape."""
        out: list[bool] = []
        for r in reqs:
            out.extend(await self.verify([r], lane=lane))
        return out

    async def stats(self) -> dict:
        sess = await self._sess()
        async with sess.get(self.base_url + "/v1/stats") as resp:
            return await resp.json()

    async def aclose(self) -> None:
        try:
            if self._registered and self._unregister_on_close:
                try:
                    await self.unregister()
                except Exception:  # noqa: BLE001 — best-effort: a client
                    # closing BECAUSE the server died must not raise out
                    # of the caller's finally; the server's own client
                    # registry bound (max_clients) is the backstop
                    pass
        finally:
            if self._own_session and self._session is not None:
                await self._session.close()
                self._session = None


async def grpc_verify(target: str, client_id: str, reqs: list, *,
                      lane: str = "gossip",
                      deadline_s: float | None = None) -> list[bool]:
    """One verify call over the gRPC surface (same docs as HTTP; see
    server.py).  ``target`` is "host:port" of the gRPC listener."""
    import json

    import grpc

    body = {"client": str(client_id), "lane": lane,
            "items": [protocol.request_to_doc(r) for r in reqs]}
    if deadline_s is not None:
        body["deadline_s"] = deadline_s
    async with grpc.aio.insecure_channel(target) as channel:
        call = channel.unary_unary(
            "/spacemesh.verifyd.Verifyd/Verify",
            request_serializer=lambda d: json.dumps(d).encode(),
            response_deserializer=lambda b: json.loads(b or b"{}"))
        doc = await call(body)
    VerifydClient._raise_typed(doc)
    if doc.get("status") != "OK":
        raise protocol.ProtocolError(f"verify failed: {doc}")
    return [bool(v) for v in doc.get("verdicts", [])]


def run_serial_baseline(base_url: str, client_id: str, reqs: list,
                        *, lane: str = "gossip") -> list[bool]:
    """Synchronous convenience wrapper: register, verify one item at a
    time, unregister."""

    async def go():
        client = VerifydClient(base_url, client_id)
        try:
            await client.register()
            return await client.serial_verify(reqs, lane=lane)
        finally:
            await client.aclose()

    return asyncio.run(go())
