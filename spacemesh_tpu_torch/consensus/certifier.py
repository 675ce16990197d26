"""Poet certifier: POST-backed certificates gating poet registration.

Port of ``spacemesh_tpu/consensus/certifier.py``, whole. The service
verifies on ``device`` (default ``"cuda"``).

The reference poet deployments front registration with a certifier
service: the node submits its POST proof ONCE to the certifier
(reference activation/certifier.go:246 Certify -> POST /certify with
proof + metadata), receives a signed certificate, and registers at poets
with the lightweight cert instead of a full proof per round (anti-DoS:
the poet only needs to verify one ed25519 signature).  Here:

* ``CertifierService``     verifies the submitted proof against the
                           node's claimed commitment and signs the cert
* ``CertifierDaemon``      serves it over framed JSON (tools CLI)
* ``CertifierClient``      the node side; caches the cert per identity
* ``PoetService.register`` (consensus/poet.py) verifies certs when the
                           poet is configured with a trusted certifier
                           pubkey
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import struct
import time

from ..core.signing import Domain, EdSigner, EdVerifier
from ..device import resolve
from ..post.prover import Proof, ProofParams
from ..post.verifier import VerifyItem, verify

MAX_MSG = 4 << 20


@dataclasses.dataclass
class PoetCert:
    """What a poet accepts in lieu of a full proof (reference
    certifier/PoetCert: data + signature)."""

    node_id: bytes
    expiry: float          # unix seconds; 0 = no expiry
    signature: bytes       # certifier key over signed_bytes()

    def signed_bytes(self) -> bytes:
        return b"poet-cert" + self.node_id + struct.pack(
            "<Q", int(self.expiry))

    def to_dict(self) -> dict:
        return {"node_id": self.node_id.hex(), "expiry": self.expiry,
                "signature": self.signature.hex()}

    @classmethod
    def from_dict(cls, d: dict) -> "PoetCert":
        return cls(node_id=bytes.fromhex(d["node_id"]),
                   expiry=float(d["expiry"]),
                   signature=bytes.fromhex(d["signature"]))


def verify_cert(cert: PoetCert, certifier_pubkey: bytes,
                verifier: EdVerifier, now: float | None = None) -> bool:
    if cert.expiry and (now if now is not None else time.time()) > cert.expiry:
        return False
    return verifier.verify(Domain.POET_CERT, certifier_pubkey,
                           cert.signed_bytes(), cert.signature)


class CertifierService:
    """Verify a POST proof, sign a certificate (certifier.go:246 flow)."""

    def __init__(self, signer: EdSigner, params: ProofParams,
                 scrypt_n: int, validity: float = 0.0,
                 time_source=time.time, device="cuda"):
        self.signer = signer
        self.device = resolve(device)
        self.params = params
        self.scrypt_n = scrypt_n
        self.validity = validity  # seconds; 0 = certs never expire
        # injected so sim/chaos scenarios can skew cert expiries along
        # with the rest of the node (SC001 clock discipline)
        self._now = time_source

    @property
    def pubkey(self) -> bytes:
        return self.signer.public_key

    def certify(self, *, proof: Proof, challenge: bytes, node_id: bytes,
                commitment: bytes, num_units: int,
                labels_per_unit: int) -> PoetCert:
        ok = verify(VerifyItem(
            proof=proof, challenge=challenge, node_id=node_id,
            commitment=commitment, scrypt_n=self.scrypt_n,
            total_labels=num_units * labels_per_unit), self.params,
            device=self.device)
        if not ok:
            raise ValueError("POST proof failed verification")
        cert = PoetCert(
            node_id=node_id,
            expiry=self._now() + self.validity if self.validity else 0.0,
            signature=b"")
        cert.signature = self.signer.sign(Domain.POET_CERT,
                                          cert.signed_bytes())
        return cert


# --- framed-JSON daemon + client (the pattern poet_remote.py rides) -------


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> dict:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            raise ConnectionError("closed")
        head += chunk
    (length,) = struct.unpack("<I", head)
    if length > MAX_MSG:
        raise ConnectionError("oversized")
    buf = b""
    while len(buf) < length:
        chunk = sock.recv(length - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return json.loads(buf)


class CertifierDaemon:
    def __init__(self, service: CertifierService,
                 listen: str = "127.0.0.1:0"):
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

    async def _client(self, reader, writer) -> None:
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
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                json.JSONDecodeError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, req: dict) -> dict:
        try:
            method = req.get("method")
            if method == "pubkey":
                return {"ok": True, "pubkey": self.service.pubkey.hex()}
            if method == "certify":
                # verification recomputes K3 labels — off the loop
                cert = await asyncio.to_thread(
                    self.service.certify,
                    proof=Proof.from_dict(req["proof"]),
                    challenge=bytes.fromhex(req["challenge"]),
                    node_id=bytes.fromhex(req["node_id"]),
                    commitment=bytes.fromhex(req["commitment"]),
                    num_units=int(req["num_units"]),
                    labels_per_unit=int(req["labels_per_unit"]))
                return {"ok": True, "certificate": cert.to_dict()}
            return {"ok": False, "error": f"unknown method {method!r}"}
        except Exception as e:  # noqa: BLE001 — error travels to the node
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}


class CertifierClient:
    """Node side: obtain + cache one cert per identity (reference
    Certifier.Certificate caches in the local DB)."""

    def __init__(self, address: tuple[str, int], timeout: float = 120.0,
                 time_source=time.time):
        self.address = tuple(address)
        self.timeout = timeout
        self._now = time_source  # cert-expiry checks follow the node clock
        self._certs: dict[bytes, PoetCert] = {}

    def _call(self, req: dict) -> dict:
        with socket.create_connection(self.address,
                                      timeout=self.timeout) as s:
            _send_msg(s, req)
            resp = _recv_msg(s)
        if not resp.get("ok"):
            raise RuntimeError(f"certifier: {resp.get('error')}")
        return resp

    def pubkey(self) -> bytes:
        return bytes.fromhex(self._call({"method": "pubkey"})["pubkey"])

    def certificate(self, *, proof: Proof, challenge: bytes, node_id: bytes,
                    commitment: bytes, num_units: int,
                    labels_per_unit: int) -> PoetCert:
        cached = self._certs.get(node_id)
        if cached is not None and (not cached.expiry
                                   or cached.expiry > self._now()):
            return cached
        d = self._call({
            "method": "certify", "proof": proof.to_dict(),
            "challenge": challenge.hex(), "node_id": node_id.hex(),
            "commitment": commitment.hex(), "num_units": num_units,
            "labels_per_unit": labels_per_unit})
        cert = PoetCert.from_dict(d["certificate"])
        self._certs[node_id] = cert
        return cert


__all__ = ["PoetCert", "CertifierService", "CertifierDaemon",
           "CertifierClient", "verify_cert"]
