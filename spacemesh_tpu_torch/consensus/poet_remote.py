"""External poet service: remote client, server CLI, and multi-poet (port
of ``spacemesh_tpu/consensus/poet_remote.py``, whole).

The reference talks HTTP to external poet servers, registers every
identity's challenge at ALL of them before the round, then picks the
best proof by tick count (reference activation/poet.go client,
activation/nipost.go:349 submitPoetChallenges / getBestProof;
activation/poetdb.go stores+validates proofs). This module is that
capability for the framework, using the same length-prefixed JSON
transport as the POST worker (one framing for every auxiliary service):

  RemotePoetClient   — PoetService surface over TCP (register /
                       execute_round / result + membership fetch)
  PoetServerDaemon   — wraps an in-proc PoetService behind a listener
                       (`python -m spacemesh_tpu_torch.tools.poet_server`)
  MultiPoet          — fan-out registration to several poets; the round
                       result is the BEST proof by ticks among the poets
                       that included our challenge (a dead poet costs
                       nothing; reference nipost.go multi-poet phase 0)
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
from typing import Optional

from ..core.types import MerkleProof, PoetProof
from .poet import PoetService, RoundResult

MAX_MSG = 16 << 20


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> dict:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            raise ConnectionError("connection closed")
        head += chunk
    (length,) = struct.unpack("<I", head)
    if length > MAX_MSG:
        raise ConnectionError("oversized message")
    buf = b""
    while len(buf) < length:
        chunk = sock.recv(length - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return json.loads(buf)


def _result_to_dict(result: RoundResult) -> dict:
    return {
        "proof": {
            "poet_id": result.proof.poet_id.hex(),
            "round_id": result.proof.round_id,
            "root": result.proof.root.hex(),
            "ticks": result.proof.ticks,
        },
        "members": [m.hex() for m in result.members],
    }


def _result_from_dict(d: dict) -> RoundResult:
    p = d["proof"]
    return RoundResult(
        proof=PoetProof(poet_id=bytes.fromhex(p["poet_id"]),
                        round_id=p["round_id"],
                        root=bytes.fromhex(p["root"]),
                        ticks=p["ticks"]),
        members=[bytes.fromhex(m) for m in d["members"]])


class PoetServerDaemon:
    """Serves one in-proc PoetService over TCP."""

    def __init__(self, service: PoetService, listen: str = "127.0.0.1:0"):
        self.service = service
        self.listen = listen
        self.address: tuple[str, int] | None = None
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> tuple[str, int]:
        host, _, port = self.listen.rpartition(":")
        self._server = await asyncio.start_server(
            self._client, host or "127.0.0.1", int(port or 0))
        self.address = self._server.sockets[0].getsockname()[:2]
        return self.address

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                head = await reader.readexactly(4)
                (length,) = struct.unpack("<I", head)
                if length > MAX_MSG:
                    break
                req = json.loads(await reader.readexactly(length))
                resp = await self._dispatch(req)
                data = json.dumps(resp).encode()
                writer.write(struct.pack("<I", len(data)) + data)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, req: dict) -> dict:
        try:
            method = req.get("method")
            if method == "info":
                return {"ok": True,
                        "poet_id": self.service.poet_id.hex(),
                        "ticks": self.service.ticks}
            if method == "register":
                cert = None
                if req.get("cert") is not None:
                    from .certifier import PoetCert

                    cert = PoetCert.from_dict(req["cert"])
                await self.service.register(
                    req["round_id"], bytes.fromhex(req["challenge"]),
                    node_id=(bytes.fromhex(req["node_id"])
                             if req.get("node_id") else None),
                    signature=(bytes.fromhex(req["signature"])
                               if req.get("signature") else None),
                    cert=cert)
                return {"ok": True}
            if method == "execute_round":
                result = await self.service.execute_round(req["round_id"])
                return {"ok": True, "result": _result_to_dict(result)}
            if method == "result":
                result = self.service.result(req["round_id"])
                if result is None:
                    return {"ok": True, "result": None}
                return {"ok": True, "result": _result_to_dict(result)}
            return {"ok": False, "error": f"unknown method {method!r}"}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


class RemotePoetClient:
    """PoetService surface backed by a remote poet daemon. Registrations
    are remembered locally so a crashed node can resubmit idempotently
    (the daemon dedups; reference localsql poet_registrations)."""

    def __init__(self, address: tuple[str, int], timeout: float = 120.0):
        self.address = tuple(address)
        self.timeout = timeout
        self._info_cache: dict | None = None

    @property
    def poet_id(self) -> bytes:
        """Lazy: a node must be able to START while its poet daemon is
        momentarily down — id resolves (and caches) on first contact."""
        try:
            return self._info()["poet_id_bytes"]
        except (OSError, RuntimeError):
            return bytes(32)

    @property
    def ticks(self) -> int:
        try:
            return self._info()["ticks"]
        except (OSError, RuntimeError):
            return 0

    def _call(self, req: dict) -> dict:
        with socket.create_connection(self.address,
                                      timeout=self.timeout) as s:
            _send_msg(s, req)
            resp = _recv_msg(s)
        if not resp.get("ok"):
            raise RuntimeError(f"poet: {resp.get('error')}")
        return resp

    def _info(self) -> dict:
        if self._info_cache is None:
            d = self._call({"method": "info"})
            self._info_cache = {"poet_id_bytes": bytes.fromhex(d["poet_id"]),
                                "ticks": d["ticks"]}
        return self._info_cache

    async def register(self, round_id: str, challenge: bytes,
                       node_id: bytes | None = None,
                       signature: bytes | None = None,
                       cert=None) -> None:
        req = {"method": "register", "round_id": round_id,
               "challenge": challenge.hex()}
        if cert is not None:
            req["cert"] = cert.to_dict()
        if node_id is not None:
            req["node_id"] = node_id.hex()
        if signature is not None:
            req["signature"] = signature.hex()
        await asyncio.to_thread(self._call, req)

    async def execute_round(self, round_id: str) -> RoundResult:
        d = await asyncio.to_thread(
            self._call, {"method": "execute_round", "round_id": round_id})
        return _result_from_dict(d["result"])

    def result(self, round_id: str) -> Optional[RoundResult]:
        try:
            d = self._call({"method": "result", "round_id": round_id})
        except (OSError, RuntimeError):
            return None
        if d.get("result") is None:
            return None
        return _result_from_dict(d["result"])


class MultiPoet:
    """Register everywhere, take the best proof by ticks (reference
    nipost.go getBestProof). Implements the PoetService seam the ATX
    Builder uses, so multi-poet is transparent to the pipeline."""

    def __init__(self, poets: list):
        if not poets:
            raise ValueError("need at least one poet")
        self.poets = poets
        self.poet_id = poets[0].poet_id  # nominal; results carry their own

    async def register(self, round_id: str, challenge: bytes,
                       node_id: bytes | None = None,
                       signature: bytes | None = None,
                       cert=None) -> None:
        results = await asyncio.gather(
            *(p.register(round_id, challenge, node_id=node_id,
                         signature=signature, cert=cert)
              for p in self.poets),
            return_exceptions=True)
        if all(isinstance(r, Exception) for r in results):
            raise RuntimeError(f"all poets failed: {results[0]}")

    async def execute_round(self, round_id: str) -> RoundResult:
        results = await asyncio.gather(
            *(p.execute_round(round_id) for p in self.poets),
            return_exceptions=True)
        ok = [r for r in results if isinstance(r, RoundResult)]
        if not ok:
            raise RuntimeError(f"all poets failed: {results[0]}")
        return max(ok, key=lambda r: r.proof.ticks)

    def result(self, round_id: str) -> Optional[RoundResult]:
        best: RoundResult | None = None
        for p in self.poets:
            r = p.result(round_id)
            if r is not None and (best is None
                                  or r.proof.ticks > best.proof.ticks):
                best = r
        return best
