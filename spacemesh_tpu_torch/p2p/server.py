"""Request/response protocols between peers (port of
``spacemesh_tpu/p2p/server.py``).

Mirrors the reference's p2p/server (libp2p streams with varint-framed
SCALE messages, per-protocol handlers, rate limits; used by fetch, hare4
compaction, peersync). The transport here is pluggable: the in-proc
`LoopbackNet` connects Server endpoints directly (the mocknet equivalent,
reference p2p/pubsub tests + node/test_network.go), and the QUIC transport
can slot in underneath with the same Server surface.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

Handler = Callable[[bytes, bytes], Awaitable[bytes]]  # (peer, req) -> resp


class RequestError(Exception):
    pass


class Server:
    """One node's protocol endpoint."""

    def __init__(self, node_id: bytes):
        self.node_id = node_id
        self._protocols: dict[str, Handler] = {}
        self._net: "LoopbackNet | None" = None

    def register(self, protocol: str, handler: Handler) -> None:
        self._protocols[protocol] = handler

    async def handle(self, protocol: str, peer: bytes, data: bytes) -> bytes:
        h = self._protocols.get(protocol)
        if h is None:
            raise RequestError(f"unknown protocol {protocol}")
        return await h(peer, data)

    async def request(self, peer: bytes, protocol: str, data: bytes,
                      timeout: float = 10.0) -> bytes:
        if self._net is None:
            raise RequestError("not connected")
        return await asyncio.wait_for(
            self._net.route(self.node_id, peer, protocol, data), timeout)

    def peers(self) -> list[bytes]:
        if self._net is None:
            return []
        return [n for n in self._net.nodes if n != self.node_id]


class LoopbackNet:
    """Fully-connected in-proc transport for Servers."""

    def __init__(self) -> None:
        self.nodes: dict[bytes, Server] = {}

    def join(self, server: Server) -> None:
        server._net = self
        self.nodes[server.node_id] = server

    def leave(self, server: Server) -> None:
        server._net = None
        self.nodes.pop(server.node_id, None)

    async def route(self, src: bytes, dst: bytes, protocol: str,
                    data: bytes) -> bytes:
        target = self.nodes.get(dst)
        if target is None:
            raise RequestError(f"peer {dst.hex()[:8]} not reachable")
        return await target.handle(protocol, src, data)
