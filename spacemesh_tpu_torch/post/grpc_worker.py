"""Worker-side gRPC client: dial the node, Register, answer requests.

Port of ``spacemesh_tpu/post/grpc_worker.py``. The PoST worker dials the
node's ``spacemesh.v1.PostService`` and keeps one ``Register`` stream open
per identity (:class:`RegisterSession`), answering

  MetadataRequest  -> MetadataResponse (identity geometry)
  GenProofRequest  -> GenProofResponse (OK without a proof while it is
                      being made; the node asks again on its interval)

Proving runs off the stream, so the stream stays responsive while a
proof is in flight: through the multi-tenant runtime scheduler when one is
attached (one tenant per identity, fair share across identities,
gang-scheduled windows; ``runtime/scheduler.py``), else in a plain
thread. Sessions reconnect with backoff when the node restarts.

This module and ``api/gen/post_pb2.py`` are the port's only importers of
``grpc`` and ``google.protobuf``; they are imported only when the worker
is served with ``--node-address``.
"""

from __future__ import annotations

import asyncio
import contextlib

import grpc

from ..api import POST_REGISTER, pack_indices
from ..api.gen import post_pb2 as ppb
from ..utils import metrics
from .service import PostClient, PostService


class _ProofJob:
    """One in-flight proving task per identity (a second concurrent
    challenge for an identity is refused).

    Tracks the session in ``post_prove_inflight``: the label-free total,
    plus a per-``tenant`` series naming the identities mid-prove."""

    live = 0
    live_by_tenant: dict[str, int] = {}

    def __init__(self, challenge: bytes, task: asyncio.Task,
                 tenant: str = "-"):
        self.challenge = challenge
        self.task = task
        self.tenant = tenant
        _ProofJob.live += 1
        by = _ProofJob.live_by_tenant
        by[tenant] = by.get(tenant, 0) + 1
        metrics.post_prove_inflight.set(_ProofJob.live)
        metrics.post_prove_inflight.set(by[tenant], tenant=tenant)
        task.add_done_callback(self._done)

    def _done(self, _task) -> None:
        _ProofJob.live = max(_ProofJob.live - 1, 0)
        by = _ProofJob.live_by_tenant
        by[self.tenant] = max(by.get(self.tenant, 1) - 1, 0)
        metrics.post_prove_inflight.set(_ProofJob.live)
        metrics.post_prove_inflight.set(by[self.tenant],
                                        tenant=self.tenant)

    @staticmethod
    def forget_tenant(tenant: str) -> None:
        """Drop a gone identity's series and tracking entry, so a worker
        cycling identities does not grow one dead series per identity."""
        _ProofJob.live_by_tenant.pop(tenant, None)
        metrics.post_prove_inflight.remove(tenant=tenant)


class RegisterSession:
    """One identity's Register stream to the node.

    With a runtime ``scheduler`` attached, proofs run as jobs of tenant
    ``tenant`` (the identity's hex prefix) instead of in a thread of their
    own, so many identities' proves share one device fairly."""

    def __init__(self, node_address: str, node_id: bytes, client: PostClient,
                 reconnect_backoff: float = 1.0, scheduler=None):
        self.node_address = node_address
        self.node_id = node_id
        self.client = client
        self.backoff = reconnect_backoff
        self.scheduler = scheduler
        self.tenant = node_id.hex()[:16]
        self._job: _ProofJob | None = None
        self._stop = asyncio.Event()
        self.connected = asyncio.Event()  # set while a stream is live

    async def run(self) -> None:
        """Dial-register-serve loop; reconnects until stopped."""
        while not self._stop.is_set():
            try:
                await self._serve_once()
            except (grpc.aio.AioRpcError, ConnectionError, OSError):
                pass
            finally:
                self.connected.clear()
            if self._stop.is_set():
                return
            # node down or stream dropped: retry after the backoff
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._stop.wait(), self.backoff)

    def stop(self) -> None:
        self._stop.set()

    async def _serve_once(self) -> None:
        async with grpc.aio.insecure_channel(self.node_address) as channel:
            stub = channel.stream_stream(
                POST_REGISTER,
                request_serializer=ppb.ServiceResponse.SerializeToString,
                response_deserializer=ppb.NodeRequest.FromString)
            call = stub()
            self.connected.set()
            try:
                while True:
                    req = await call.read()
                    if req == grpc.aio.EOF:
                        return
                    await call.write(await self._answer(req))
            finally:
                self.connected.clear()
                with contextlib.suppress(Exception):
                    call.cancel()

    async def _answer(self, req: ppb.NodeRequest) -> ppb.ServiceResponse:
        kind = req.WhichOneof("kind")
        if kind == "metadata":
            return ppb.ServiceResponse(
                metadata=ppb.MetadataResponse(meta=self._meta()))
        if kind == "gen_proof":
            return await self._gen_proof(bytes(req.gen_proof.challenge))
        # an unknown request kind: the node is newer than this worker
        return ppb.ServiceResponse(gen_proof=ppb.GenProofResponse(
            status=ppb.GEN_PROOF_STATUS_ERROR))

    @staticmethod
    async def _scheduled(handle) -> tuple:
        """Await a scheduler prove job from the event loop, in the shape of
        ``PostClient.proof``'s result (the stream answer ignores the
        metadata half)."""
        proof = await asyncio.wrap_future(handle.future)
        return proof, None

    def _meta(self) -> ppb.Metadata:
        info = self.client.info()
        meta = ppb.Metadata(
            node_id=info.node_id, commitment_atx_id=info.commitment,
            num_units=info.num_units, labels_per_unit=info.labels_per_unit)
        if info.vrf_nonce >= 0:
            meta.nonce = info.vrf_nonce
        return meta

    async def _gen_proof(self, challenge: bytes) -> ppb.ServiceResponse:
        job = self._job
        if job is not None and job.challenge != challenge:
            if not job.task.done():
                # one proof at a time per identity
                return ppb.ServiceResponse(gen_proof=ppb.GenProofResponse(
                    status=ppb.GEN_PROOF_STATUS_ERROR))
            self._job = job = None
        if job is None:
            if self.scheduler is not None:
                handle = self.client.submit_proof(self.scheduler,
                                                  self.tenant, challenge)
                task = asyncio.ensure_future(self._scheduled(handle))
            else:
                task = asyncio.ensure_future(
                    asyncio.to_thread(self.client.proof, challenge))
            self._job = job = _ProofJob(challenge, task, tenant=self.tenant)
        if not job.task.done():
            # still being made: OK without a proof, the node asks again
            return ppb.ServiceResponse(gen_proof=ppb.GenProofResponse(
                status=ppb.GEN_PROOF_STATUS_OK))
        self._job = None  # consumed (success or failure)
        try:
            proof, _meta = job.task.result()  # spacecheck: ok=SC002 guarded by the task.done() early-return above — never blocks
        except Exception:  # noqa: BLE001 — reported to the node as ERROR
            return ppb.ServiceResponse(gen_proof=ppb.GenProofResponse(
                status=ppb.GEN_PROOF_STATUS_ERROR))
        return ppb.ServiceResponse(gen_proof=ppb.GenProofResponse(
            status=ppb.GEN_PROOF_STATUS_OK,
            proof=ppb.Proof(nonce=proof.nonce,
                            indices=pack_indices(proof.indices),
                            pow=proof.pow_nonce),
            metadata=ppb.ProofMetadata(challenge=challenge,
                                       meta=self._meta())))


class GrpcWorker:
    """All discovered identities, each with its own Register session.

    With ``scheduler`` (a runtime ``TenantScheduler``) every identity is a
    registered tenant and its proofs run as fair-share jobs on the shared
    device. The scheduler is borrowed: its owner closes it; this worker
    only registers and unregisters its identities."""

    def __init__(self, service: PostService, node_address: str,
                 reconnect_backoff: float = 1.0, scheduler=None):
        self.service = service
        self.node_address = node_address
        self.backoff = reconnect_backoff
        self.scheduler = scheduler
        self.sessions: list[RegisterSession] = []
        self._tasks: list[asyncio.Task] = []
        self._tenants: list[str] = []

    async def start(self) -> None:
        for node_id in self.service.registered():
            client = self.service.client(node_id)
            s = RegisterSession(self.node_address, node_id, client,
                                reconnect_backoff=self.backoff,
                                scheduler=self.scheduler)
            if self.scheduler is not None:
                self.scheduler.register_tenant(s.tenant)
                self._tenants.append(s.tenant)
            self.sessions.append(s)
            self._tasks.append(asyncio.ensure_future(s.run()))

    async def wait_connected(self, timeout: float = 30.0) -> None:
        await asyncio.wait_for(
            asyncio.gather(*(s.connected.wait() for s in self.sessions)),
            timeout)

    async def stop(self) -> None:
        try:
            for s in self.sessions:
                s.stop()
            for t in self._tasks:
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
        finally:
            for s in self.sessions:
                _ProofJob.forget_tenant(s.tenant)
            if self.scheduler is not None:
                for tenant in self._tenants:
                    self.scheduler.unregister_tenant(tenant)
                self._tenants.clear()
