"""gRPC API server (port of ``spacemesh_tpu/api/rpc.py``): the
reference's grpcserver surface on grpc.aio.

Two halves:

* ``PostGrpcService`` — the node<->post-service seam served field-for-field
  per the public spacemesh.v1 contract (reference
  api/grpcserver/post_service.go:24-174).  The post worker DIALS the node
  and calls ``Register``; the node then drives the bidirectional stream:
  MetadataRequest first (identity handshake), GenProofRequest on demand,
  polled until the proof is ready (reference post_client.go:70-146).
  A registered identity is exposed to the activation builder as a
  ``GrpcPostClient`` with the same blocking ``info()``/``proof()`` surface
  as the in-proc and JSON-RPC clients. The worker that dials in
  (``post/grpc_worker.py``) proves on its own device; nothing here touches
  one.

* ``GrpcApiServer`` — Node/Mesh/GlobalState/Transaction/Smesher/Admin
  services (reference api/grpcserver/{node,mesh,globalstate,transaction,
  smesher,admin}_service.go) over real gRPC, sharing the app internals the
  JSON gateway (api/http.py) reads.  Hand-wired with
  ``grpc.method_handlers_generic_handler`` (no generated stubs; the wire
  format is identical).

The wire helpers (``POST_REGISTER``, ``pack_indices``, ``unpack_indices``)
and ``API_VERSION`` live in the grpc-free ``api/__init__.py`` and are
re-exported here under the JAX package's names, so the worker side imports
them without this module.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import time

import grpc

from ..core.types import Address, Transaction
from ..node import checkpoint as checkpoint_mod
from ..node import events as events_mod
from ..storage import atxs as atxstore
from ..storage import blocks as blockstore
from ..storage import layers as layerstore
from ..storage import misc as miscstore
from ..storage import transactions as txstore
from ..vm.vm import TxValidity
from . import API_VERSION, POST_REGISTER, pack_indices, unpack_indices
from .gen import core_pb2 as cpb
from .gen import post_pb2 as ppb

__all__ = ["API_VERSION", "POST_REGISTER", "GrpcApiServer",
           "GrpcPostClient", "PostGrpcService", "pack_indices",
           "unpack_indices"]


# --- PostService (the seam) ------------------------------------------------


class GrpcPostClient:
    """The node's view of one identity registered over a Register stream.

    Blocking ``info()``/``proof()`` (the activation builder calls these via
    ``asyncio.to_thread``); each call round-trips one NodeRequest over the
    stream via the service's command queue, mirroring the reference
    postClient (post_client.go:37-146 incl. the GenProof poll loop).
    """

    def __init__(self, service: "PostGrpcService", node_id: bytes,
                 queue: asyncio.Queue, query_interval: float = 2.0,
                 timeout: float = 600.0):
        self._service = service
        self.node_id = node_id
        self._queue = queue
        self.query_interval = query_interval
        self.timeout = timeout

    async def _roundtrip_async(self, req: ppb.NodeRequest) -> ppb.ServiceResponse:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((req, fut))
        return await fut

    def _roundtrip(self, req: ppb.NodeRequest) -> ppb.ServiceResponse:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._service.loop:
            # blocking on our own event loop would deadlock the stream —
            # callers must use asyncio.to_thread (activation does)
            raise RuntimeError(
                "GrpcPostClient called from the node's event loop")
        cfut = asyncio.run_coroutine_threadsafe(
            self._roundtrip_async(req), self._service.loop)
        try:
            return cfut.result(self.timeout)
        except concurrent.futures.TimeoutError:
            cfut.cancel()
            raise TimeoutError("post service did not answer") from None

    def info(self):
        from ..post.service import PostInfo

        resp = self._roundtrip(
            ppb.NodeRequest(metadata=ppb.MetadataRequest()))
        if resp.WhichOneof("kind") != "metadata":
            raise RuntimeError("post service: expected metadata response")
        return _info_from_meta(resp.metadata.meta, PostInfo)

    def proof(self, challenge: bytes):
        from ..post.data import PostMetadata
        from ..post.prover import Proof
        from ..post.service import PostInfo

        req = ppb.NodeRequest(
            gen_proof=ppb.GenProofRequest(challenge=challenge))
        deadline = time.monotonic() + self.timeout
        while True:
            resp = self._roundtrip(req)
            gp = resp.gen_proof
            if resp.WhichOneof("kind") != "gen_proof":
                raise RuntimeError("post service: expected gen_proof response")
            if gp.status != ppb.GEN_PROOF_STATUS_OK:
                raise RuntimeError(
                    f"post service: proof generation failed (status {gp.status})")
            if gp.HasField("proof"):
                break
            if time.monotonic() > deadline:
                raise TimeoutError("proof generation timed out")
            time.sleep(self.query_interval)  # reference queryInterval poll
        meta = gp.metadata.meta
        if gp.metadata.challenge != challenge:
            raise RuntimeError("post service: challenge mismatch")
        info = _info_from_meta(meta, PostInfo)
        # scrypt_n / max_file_size aren't part of the public seam — the node
        # knows them from its post config; the builder only reads
        # num_units/labels_per_unit/vrf_nonce (consensus/activation.py:266-272)
        pm = PostMetadata(
            node_id=info.node_id.hex(), commitment=info.commitment.hex(),
            num_units=info.num_units, labels_per_unit=info.labels_per_unit,
            scrypt_n=0, max_file_size=0, vrf_nonce=info.vrf_nonce)
        indices = unpack_indices(gp.proof.indices)
        return Proof(nonce=gp.proof.nonce, indices=indices,
                     pow_nonce=gp.proof.pow, k2=len(indices)), pm


def _info_from_meta(meta: ppb.Metadata, PostInfo):
    return PostInfo(
        node_id=bytes(meta.node_id),
        commitment=bytes(meta.commitment_atx_id),
        num_units=meta.num_units,
        labels_per_unit=meta.labels_per_unit,
        scrypt_n=0,  # not part of the public seam; verifier reads it from the ATX
        vrf_nonce=meta.nonce if meta.HasField("nonce") else -1)


class PostGrpcService:
    """Node-side PostService: accepts Register streams from post workers
    (reference post_service.go:91-174)."""

    def __init__(self, query_interval: float = 2.0):
        self.loop: asyncio.AbstractEventLoop | None = None
        self.query_interval = query_interval
        self.clients: dict[bytes, GrpcPostClient] = {}
        self._allow = True
        self._registered_ev: asyncio.Event | None = None

    def allow_connections(self, allow: bool) -> None:
        self._allow = allow

    def registered(self) -> list[bytes]:
        return list(self.clients)

    def client(self, node_id: bytes) -> GrpcPostClient | None:
        return self.clients.get(node_id)

    async def wait_registered(self, node_ids: list[bytes],
                              timeout: float = 60.0) -> None:
        """Block until every expected identity has a live Register stream."""
        deadline = time.monotonic() + timeout
        while not all(n in self.clients for n in node_ids):
            if time.monotonic() > deadline:
                missing = [n.hex()[:12] for n in node_ids
                           if n not in self.clients]
                raise TimeoutError(f"post identities never registered: {missing}")
            ev = self._registered_ev = asyncio.Event()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(ev.wait(), 1.0)

    async def register(self, request_iterator, context) -> None:
        """The bidirectional stream handler (reader/writer style)."""
        if not self._allow:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                "connection not allowed")
        self.loop = asyncio.get_running_loop()
        # identity handshake: ask for metadata before anything else
        await context.write(ppb.NodeRequest(metadata=ppb.MetadataRequest()))
        resp = await context.read()
        if resp == grpc.aio.EOF or resp.WhichOneof("kind") != "metadata":
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "expected metadata response")
        meta = resp.metadata.meta
        node_id = bytes(meta.node_id)
        if len(node_id) != 32:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                "node id must be 32 bytes")
        if node_id in self.clients:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS,
                                "identity already registered")
        queue: asyncio.Queue = asyncio.Queue()
        self.clients[node_id] = GrpcPostClient(
            self, node_id, queue, query_interval=self.query_interval)
        if self._registered_ev is not None:
            self._registered_ev.set()
        try:
            while True:
                req, fut = await queue.get()
                try:
                    await context.write(req)
                    answer = await context.read()
                except Exception as e:  # stream died mid-command
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError(f"post stream failed: {e}"))
                    raise
                if answer == grpc.aio.EOF:
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError("post service disconnected"))
                    return
                if not fut.done():
                    fut.set_result(answer)
        finally:
            self.clients.pop(node_id, None)
            # fail queued commands so callers don't hang on a dead stream
            while not queue.empty():
                _, fut = queue.get_nowait()
                if not fut.done():
                    fut.set_exception(
                        ConnectionError("post service disconnected"))

    def handler(self) -> grpc.GenericRpcHandler:
        return grpc.method_handlers_generic_handler(
            "spacemesh.v1.PostService", {
                "Register": grpc.stream_stream_rpc_method_handler(
                    self.register,
                    request_deserializer=ppb.ServiceResponse.FromString,
                    response_serializer=ppb.NodeRequest.SerializeToString),
            })


# --- query services --------------------------------------------------------


def _unary(fn, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


def _server_stream(fn, req_cls, resp_cls):
    return grpc.unary_stream_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


class GrpcApiServer:
    """All spacemesh.v1 services on one grpc.aio server (the reference
    splits them across public/private/post/json listeners —
    api/grpcserver/config.go:31-57; one listener suffices here, the
    public/private split is a config matter, not a protocol one)."""

    def __init__(self, app, listen: str = "127.0.0.1:0",
                 post_query_interval: float = 2.0,
                 public_only: bool = False):
        self.node = app
        self.listen = listen
        # public_only serves just the query surface — no Admin (Recover
        # wipes state), no Smesher, no PostService Register seam. The
        # reference splits listeners by audience for exactly this reason
        # (api/grpcserver/config.go:31-57: public vs private vs post).
        self.public_only = public_only
        # the Register seam only exists on the private listener — a public
        # server never even constructs it, so auditing the public attack
        # surface starts and ends here
        self.post_service = None if public_only else PostGrpcService(
            query_interval=post_query_interval)
        self.server: grpc.aio.Server | None = None
        self.actual_port: int | None = None

    # -- lifecycle --

    async def start(self) -> int:
        from .rpc_v2 import V2AlphaServices

        self.server = grpc.aio.server()
        handlers = (
            self._node_handler(), self._mesh_handler(),
            self._globalstate_handler(), self._transaction_handler(),
            *V2AlphaServices(self.node).handlers())
        if not self.public_only:
            handlers = (self.post_service.handler(),
                        self._smesher_handler(), self._admin_handler(),
                        *handlers)
        self.server.add_generic_rpc_handlers(handlers)
        self.actual_port = self.server.add_insecure_port(self.listen)
        await self.server.start()
        return self.actual_port

    async def stop(self) -> None:
        if self.server is not None:
            await self.server.stop(grace=0.5)

    # -- NodeService (reference node_service.go) --

    def _node_handler(self):
        return grpc.method_handlers_generic_handler("spacemesh.v1.NodeService", {
            "Echo": _unary(self._echo, cpb.EchoRequest, cpb.EchoResponse),
            "Version": _unary(self._version, cpb.EchoRequest, cpb.VersionResponse),
            "Build": _unary(self._build, cpb.EchoRequest, cpb.BuildResponse),
            "Status": _unary(self._status, cpb.StatusRequest, cpb.StatusResponse),
            "StatusStream": _server_stream(
                self._status_stream, cpb.StatusRequest, cpb.StatusResponse),
        })

    async def _echo(self, req, ctx):
        return cpb.EchoResponse(msg=req.msg)

    async def _version(self, req, ctx):
        return cpb.VersionResponse(version=API_VERSION)

    async def _build(self, req, ctx):
        return cpb.BuildResponse(build="spacemesh-tpu")

    def _status_msg(self) -> cpb.StatusResponse:
        n = self.node
        return cpb.StatusResponse(status=cpb.NodeStatus(
            connected_peers=len(n.server.peers()) if n.server else 0,
            is_synced=n.syncer.is_synced() if n.syncer else True,
            synced_layer=max(0, layerstore.processed(n.state)),
            top_layer=max(0, int(n.clock.current_layer())),
            verified_layer=max(0, n.tortoise.verified)))  # -1 pre-genesis

    async def _status(self, req, ctx):
        return self._status_msg()

    async def _status_stream(self, req, ctx):
        sub = self.node.events.subscribe(events_mod.LayerUpdate, size=64)
        try:
            yield self._status_msg()
            while True:
                await sub.next()
                yield self._status_msg()
        finally:
            sub.close()

    # -- MeshService (reference mesh_service.go) --

    def _mesh_handler(self):
        return grpc.method_handlers_generic_handler("spacemesh.v1.MeshService", {
            "GenesisTime": _unary(self._genesis_time, cpb.GenesisTimeRequest,
                                  cpb.GenesisTimeResponse),
            "GenesisID": _unary(self._genesis_id, cpb.GenesisIDRequest,
                                cpb.GenesisIDResponse),
            "CurrentLayer": _unary(self._current_layer, cpb.CurrentLayerRequest,
                                   cpb.CurrentLayerResponse),
            "CurrentEpoch": _unary(self._current_epoch, cpb.CurrentEpochRequest,
                                   cpb.CurrentEpochResponse),
            "EpochNumLayers": _unary(self._epoch_num_layers,
                                     cpb.EpochNumLayersRequest,
                                     cpb.EpochNumLayersResponse),
            "LayerDuration": _unary(self._layer_duration,
                                    cpb.LayerDurationRequest,
                                    cpb.LayerDurationResponse),
            "LayersQuery": _unary(self._layers_query, cpb.LayersQueryRequest,
                                  cpb.LayersQueryResponse),
            "LayerStream": _server_stream(self._layer_stream,
                                          cpb.LayerStreamRequest,
                                          cpb.LayerStreamResponse),
            "EpochStream": _server_stream(self._epoch_stream,
                                          cpb.EpochStreamRequest,
                                          cpb.EpochStreamResponse),
            "MalfeasanceQuery": _unary(self._malfeasance_query,
                                       cpb.MalfeasanceQueryRequest,
                                       cpb.MalfeasanceQueryResponse),
        })

    async def _genesis_time(self, req, ctx):
        return cpb.GenesisTimeResponse(unixtime=int(self.node.cfg.genesis.time))

    async def _genesis_id(self, req, ctx):
        return cpb.GenesisIDResponse(genesis_id=self.node.cfg.genesis.genesis_id)

    async def _current_layer(self, req, ctx):
        return cpb.CurrentLayerResponse(
            layernum=int(self.node.clock.current_layer()))

    async def _current_epoch(self, req, ctx):
        n = self.node
        return cpb.CurrentEpochResponse(
            epochnum=int(n.clock.current_layer()) // n.cfg.layers_per_epoch)

    async def _epoch_num_layers(self, req, ctx):
        return cpb.EpochNumLayersResponse(
            numlayers=self.node.cfg.layers_per_epoch)

    async def _layer_duration(self, req, ctx):
        return cpb.LayerDurationResponse(
            duration=int(self.node.cfg.layer_duration))

    def _layer_msg(self, layer: int) -> cpb.Layer:
        n = self.node
        applied = layerstore.applied_block(n.state, layer)
        last_applied = layerstore.last_applied(n.state)
        if layer <= last_applied:
            status = cpb.Layer.LAYER_STATUS_APPLIED
        elif layer <= n.tortoise.verified:
            status = cpb.Layer.LAYER_STATUS_CONFIRMED
        elif applied is not None or miscstore.certified_block(n.state, layer):
            status = cpb.Layer.LAYER_STATUS_APPROVED
        else:
            status = cpb.Layer.LAYER_STATUS_UNSPECIFIED
        blocks = []
        for b in blockstore.in_layer(n.state, layer):
            txs = []
            for tid in b.tx_ids:
                tx = txstore.get_tx(n.state, tid)
                txs.append(cpb.Transaction(
                    id=tid, raw=tx.raw if tx else b""))
            blocks.append(cpb.Block(id=b.id, layer=layer, transactions=txs))
        return cpb.Layer(
            number=layer, status=status,
            hash=layerstore.state_hash(n.state, layer) or b"",
            aggregated_hash=layerstore.aggregated_hash(n.state, layer) or b"",
            blocks=blocks)

    async def _layers_query(self, req, ctx):
        last = layerstore.processed(self.node.state)
        start = req.start_layer
        end = min(req.end_layer, last) if req.HasField("end_layer") else last
        if end - start > 1000:
            await ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                            "layer range too wide (max 1000)")
        return cpb.LayersQueryResponse(
            layer=[self._layer_msg(i) for i in range(start, end + 1)])

    async def _layer_stream(self, req, ctx):
        sub = self.node.events.subscribe(events_mod.LayerUpdate, size=256)
        try:
            while True:
                ev = await sub.next()
                yield cpb.LayerStreamResponse(layer=self._layer_msg(ev.layer))
        finally:
            sub.close()

    async def _epoch_stream(self, req, ctx):
        # reference mesh_service.go:563: stream the ATX ids targeting an epoch
        for atx_id in atxstore.ids_in_epoch(self.node.state, req.epoch - 1):
            yield cpb.EpochStreamResponse(id=atx_id)

    async def _malfeasance_query(self, req, ctx):
        n = self.node
        smesher = bytes(req.smesher_id)
        proof = miscstore.malfeasance_proof(n.state, smesher)
        if proof is None:
            await ctx.abort(grpc.StatusCode.NOT_FOUND, "no proof for identity")
        return cpb.MalfeasanceQueryResponse(proof=cpb.MalfeasanceProof(
            smesher_id=smesher, kind=str(proof.domain),
            proof=proof.to_bytes()))

    # -- GlobalStateService (reference globalstate_service.go) --

    def _globalstate_handler(self):
        return grpc.method_handlers_generic_handler(
            "spacemesh.v1.GlobalStateService", {
                "GlobalStateHash": _unary(self._global_state_hash,
                                          cpb.GlobalStateHashRequest,
                                          cpb.GlobalStateHashResponse),
                "Account": _unary(self._account, cpb.AccountRequest,
                                  cpb.AccountResponse),
                "AccountDataQuery": _unary(self._account_data_query,
                                           cpb.AccountDataQueryRequest,
                                           cpb.AccountDataQueryResponse),
            })

    async def _global_state_hash(self, req, ctx):
        layer = layerstore.last_applied(self.node.state)
        return cpb.GlobalStateHashResponse(response=cpb.GlobalStateHash(
            root_hash=layerstore.state_hash(self.node.state, layer) or b"",
            layer=layer))

    def _parse_addr(self, text: str, ctx):
        try:
            if text.startswith("0x"):
                return Address(bytes.fromhex(text[2:])).raw
            return Address.decode(text).raw
        except ValueError:
            return None

    def _account_msg(self, addr: bytes) -> cpb.Account:
        row = txstore.account(self.node.state, addr)
        bal = row["balance"] if row else 0
        nonce = row["next_nonce"] if row else 0
        projected = self.node.cstate.projected(addr) \
            if hasattr(self.node.cstate, "projected") else None
        return cpb.Account(
            address=Address(addr).encode(),
            state_current=cpb.AccountState(balance=bal, counter=nonce),
            state_projected=cpb.AccountState(
                balance=projected[0] if projected else bal,
                counter=projected[1] if projected else nonce),
            template=(row["template"].hex() if row and row["template"]
                      else ""))

    async def _account(self, req, ctx):
        addr = self._parse_addr(req.address, ctx)
        if addr is None:
            await ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, "bad address")
        return cpb.AccountResponse(account_wrapper=self._account_msg(addr))

    async def _account_data_query(self, req, ctx):
        addr = self._parse_addr(req.address, ctx)
        if addr is None:
            await ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, "bad address")
        items = [cpb.AccountData(account_wrapper=self._account_msg(addr))]
        for lyr, total in miscstore.rewards_for(self.node.state, addr):
            items.append(cpb.AccountData(reward=cpb.Reward(
                layer=lyr, total=total, coinbase=Address(addr).encode())))
        total_results = len(items)
        off = req.offset
        if req.max_results:
            items = items[off:off + req.max_results]
        else:
            items = items[off:]
        return cpb.AccountDataQueryResponse(
            total_results=total_results, account_item=items)

    # -- TransactionService (reference transaction_service.go) --

    def _transaction_handler(self):
        return grpc.method_handlers_generic_handler(
            "spacemesh.v1.TransactionService", {
                "SubmitTransaction": _unary(self._submit_tx,
                                            cpb.SubmitTransactionRequest,
                                            cpb.SubmitTransactionResponse),
                "TransactionsState": _unary(self._txs_state,
                                            cpb.TransactionsStateRequest,
                                            cpb.TransactionsStateResponse),
            })

    async def _submit_tx(self, req, ctx):
        tx = Transaction(raw=bytes(req.transaction))
        validity = self.node.cstate.add(tx)
        if validity == TxValidity.VALID:
            from ..p2p.pubsub import TOPIC_TX

            await self.node.pubsub.publish(TOPIC_TX, tx.raw)
            state = cpb.TransactionState.TRANSACTION_STATE_MEMPOOL
        else:
            state = cpb.TransactionState.TRANSACTION_STATE_REJECTED
        return cpb.SubmitTransactionResponse(
            status_code=0 if validity == TxValidity.VALID else 3,
            txstate=cpb.TransactionState(id=tx.id, state=state))

    async def _txs_state(self, req, ctx):
        states, txs = [], []
        for tid in req.transaction_id:
            tid = bytes(tid)
            tx = txstore.get_tx(self.node.state, tid)
            if tx is None:
                states.append(cpb.TransactionState(
                    id=tid,
                    state=cpb.TransactionState.TRANSACTION_STATE_UNSPECIFIED))
                continue
            res = txstore.result(self.node.state, tid)
            states.append(cpb.TransactionState(
                id=tid,
                state=(cpb.TransactionState.TRANSACTION_STATE_PROCESSED
                       if res is not None else
                       cpb.TransactionState.TRANSACTION_STATE_MEMPOOL)))
            if req.include_transactions:
                txs.append(cpb.Transaction(id=tid, raw=tx.raw))
        return cpb.TransactionsStateResponse(
            transactions_state=states, transactions=txs)

    # -- SmesherService (reference smesher_service.go) --

    def _smesher_handler(self):
        return grpc.method_handlers_generic_handler(
            "spacemesh.v1.SmesherService", {
                "IsSmeshing": _unary(self._is_smeshing, cpb.IsSmeshingRequest,
                                     cpb.IsSmeshingResponse),
                "SmesherIDs": _unary(self._smesher_ids, cpb.SmesherIDsRequest,
                                     cpb.SmesherIDsResponse),
                "PostSetupStatus": _unary(self._post_setup_status,
                                          cpb.PostSetupStatusRequest,
                                          cpb.PostSetupStatusResponse),
            })

    async def _is_smeshing(self, req, ctx):
        return cpb.IsSmeshingResponse(
            is_smeshing=self.node.atx_builder is not None)

    async def _smesher_ids(self, req, ctx):
        return cpb.SmesherIDsResponse(
            ids=[s.node_id for s in self.node.signers])

    async def _post_setup_status(self, req, ctx):
        n = self.node
        registered = (n.post_service.registered()
                      if n.post_service is not None else [])
        state = (cpb.PostSetupStatus.STATE_COMPLETE if registered
                 else cpb.PostSetupStatus.STATE_NOT_STARTED)
        return cpb.PostSetupStatusResponse(
            status=cpb.PostSetupStatus(state=state))

    # -- AdminService (reference admin_service.go) --

    def _admin_handler(self):
        return grpc.method_handlers_generic_handler(
            "spacemesh.v1.AdminService", {
                "CheckpointStream": _server_stream(self._checkpoint_stream,
                                                   cpb.CheckpointStreamRequest,
                                                   cpb.CheckpointStreamResponse),
                "Recover": _unary(self._recover, cpb.RecoverRequest,
                                  cpb.RecoverResponse),
                "EventsStream": _server_stream(self._events_stream,
                                               cpb.EventStreamRequest,
                                               cpb.Event),
                "PeerInfoStream": _server_stream(self._peer_info_stream,
                                                 cpb.PeerInfoRequest,
                                                 cpb.PeerInfo),
            })

    async def _checkpoint_stream(self, req, ctx):
        # reference admin_service.go:73: write the checkpoint, stream it in
        # chunks
        import os
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
            path = f.name
        try:
            await asyncio.to_thread(checkpoint_mod.write, self.node.state, path)
            # open + chunk reads off the loop: a mainnet-shape checkpoint
            # is large and every sync 64KiB read stalled the event loop
            # between yielded chunks
            f = await asyncio.to_thread(open, path, "rb")
            try:
                while chunk := await asyncio.to_thread(f.read, 64 << 10):
                    yield cpb.CheckpointStreamResponse(data=chunk)
            finally:
                f.close()
        finally:
            # unlinking a multi-GB checkpoint can take hundreds of ms
            # in the kernel — off the loop like the reads
            await asyncio.to_thread(os.unlink, path)

    async def _recover(self, req, ctx):
        await asyncio.to_thread(
            checkpoint_mod.recover_file, self.node.state, req.uri,
            self.node.signer.node_id)
        return cpb.RecoverResponse()

    _EVENT_TYPES = (events_mod.LayerUpdate, events_mod.AtxEvent,
                    events_mod.TxEvent, events_mod.BeaconEvent,
                    events_mod.PostEvent, events_mod.AtxPublished,
                    events_mod.Malfeasance)

    async def _events_stream(self, req, ctx):
        import json

        sub = self.node.events.subscribe(*self._EVENT_TYPES, size=1024)
        try:
            while True:
                ev = await sub.next()
                detail = {k: (v.hex() if isinstance(v, bytes) else v)
                          for k, v in ev.__dict__.items()}
                yield cpb.Event(timestamp=int(time.time()),
                                kind=type(ev).__name__,
                                detail=json.dumps(detail))
        finally:
            sub.close()

    async def _peer_info_stream(self, req, ctx):
        n = self.node
        if n.server is None:
            return
        for pid in n.server.peers():
            connections = []
            host = getattr(n, "host", None)
            if host is not None and pid in host.nodes:
                conn = host.nodes[pid]
                if conn.listen_addr:
                    connections.append(
                        f"{conn.listen_addr[0]}:{conn.listen_addr[1]}")
            yield cpb.PeerInfo(id=pid.hex(), connections=connections)
