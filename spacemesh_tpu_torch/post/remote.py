"""Out-of-process PoST worker transport: length-prefixed JSON-RPC.

Port of ``spacemesh_tpu/post/remote.py``, byte-compatible on the wire in
both directions: the JAX package's client talks to this server and the
reverse. The worker listens and the node dials:

  node  --"info"/"proof"-->  worker (owns the PoST data + the card)

Frames: u32 LE length + JSON object. Requests carry {"method", ...};
responses {"ok": true, ...} or {"ok": false, "error"}. Proof generation
runs in a worker thread, so one slow prove does not block the event loop.

The node-side RemotePostClient has the PostClient surface
(info()/proof()) over blocking sockets. One method is the port's own:
"metrics" returns the worker process's metrics registry in the text
exposition format (the post_store_* counters, the ENOSPC degraded gauge).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import struct
from pathlib import Path

from ..utils import metrics
from .data import PostMetadata
from .prover import Proof
from .service import PostInfo, PostService

MAX_MSG = 16 << 20


# --- framing ---------------------------------------------------------------


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> dict:
    head = _recv_exact(sock, 4)
    (length,) = struct.unpack("<I", head)
    if length > MAX_MSG:
        raise ConnectionError(f"oversized message ({length})")
    return json.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf += chunk
    return buf


# --- worker side -----------------------------------------------------------


class WorkerServer:
    """Serves a PostService registry over TCP (the worker process)."""

    def __init__(self, service: PostService, listen: str = "127.0.0.1:0"):
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
            if method == "registered":
                return {"ok": True,
                        "node_ids": [n.hex() for n in
                                     self.service.registered()]}
            if method == "metrics":
                return {"ok": True, "text": metrics.REGISTRY.expose()}
            node_id = bytes.fromhex(req["node_id"])
            client = self.service.client(node_id)
            if client is None:
                return {"ok": False, "error": "identity not registered"}
            if method == "info":
                info = client.info()
                return {"ok": True, "info": dataclasses.asdict(info) | {
                    "node_id": info.node_id.hex(),
                    "commitment": info.commitment.hex()}}
            if method == "proof":
                challenge = bytes.fromhex(req["challenge"])
                # prove in a thread: scrypt recompute + nonce search is slow
                proof, meta = await asyncio.to_thread(client.proof, challenge)
                return {"ok": True, "proof": proof.to_dict(),
                        "meta": dataclasses.asdict(meta)}
            return {"ok": False, "error": f"unknown method {method!r}"}
        except Exception as e:  # noqa: BLE001 — error travels to the node
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


# --- node side -------------------------------------------------------------


class RemotePostClient:
    """PostClient surface over the wire: the node's view of one identity
    served by an out-of-process worker."""

    def __init__(self, address: tuple[str, int], node_id: bytes,
                 timeout: float = 600.0):
        self.address = tuple(address)
        self.node_id = node_id
        self.timeout = timeout

    def _call(self, req: dict) -> dict:
        with socket.create_connection(self.address, timeout=self.timeout) as s:
            _send_msg(s, req)
            resp = _recv_msg(s)
        if not resp.get("ok"):
            raise RuntimeError(f"post worker: {resp.get('error')}")
        return resp

    def info(self) -> PostInfo:
        d = self._call({"method": "info", "node_id": self.node_id.hex()})
        i = d["info"]
        return PostInfo(
            node_id=bytes.fromhex(i["node_id"]),
            commitment=bytes.fromhex(i["commitment"]),
            num_units=i["num_units"], labels_per_unit=i["labels_per_unit"],
            scrypt_n=i["scrypt_n"], vrf_nonce=i["vrf_nonce"],
            labels_written=i.get("labels_written", 0))

    def proof(self, challenge: bytes) -> tuple[Proof, PostMetadata]:
        d = self._call({"method": "proof", "node_id": self.node_id.hex(),
                        "challenge": challenge.hex()})
        return Proof.from_dict(d["proof"]), PostMetadata(**d["meta"])

    def metrics(self) -> str:
        """The worker process's metrics in the text exposition format."""
        return self._call({"method": "metrics"})["text"]

    def ping(self) -> list[bytes]:
        d = self._call({"method": "registered"})
        return [bytes.fromhex(x) for x in d["node_ids"]]


def discover_identities(base_dir: str | Path, params=None,
                        device="cuda") -> PostService:
    """Build a PostService from a directory of per-identity PoST data dirs
    (what the worker CLI serves). ``device`` (default ``"cuda"``) passes
    through to every identity's PostClient; the prover's knobs come from
    the ``SPACEMESH_PROVE_*`` environment."""
    from .service import PostClient

    service = PostService()
    base = Path(base_dir)
    candidates = [base] + [p for p in base.iterdir() if p.is_dir()] \
        if base.is_dir() else []
    for p in candidates:
        if (p / "postdata_metadata.json").exists():
            meta = PostMetadata.load(p)
            service.register(bytes.fromhex(meta.node_id),
                             PostClient(p, params, device=device))
    return service
