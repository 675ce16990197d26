"""spacemesh.v2alpha1 services: the reference's paginated query API (port
of ``spacemesh_tpu/api/rpc_v2.py``).

Reference api/grpcserver/v2alpha1/{activation,account,layer,malfeasance,
network,node,reward,transaction}.go — eight unary services with the
limit-capped-at-100 pagination contract, plus the five Stream services
(stored rows matching the filter first; with ``watch=true`` the stream
then follows live events until the client cancels — activation.go:51-160
Stream).

Registered as generic handlers on the same grpc.aio server as the v1
surface (api/rpc.py GrpcApiServer)."""

from __future__ import annotations

import grpc

from ..core.types import Address
from ..node import events as events_mod
from ..storage import atxs as atxstore
from ..storage import layers as layerstore
from ..storage import misc as miscstore
from .gen import v2alpha1_pb2 as v2
from .rpc import _server_stream, _unary

_DOMAINS = {1: "multiple_atxs", 2: "multiple_ballots", 3: "hare_equivocation",
            4: "invalid_post_index", 5: "invalid_prev_atx"}


class _RecentSet:
    """Bounded membership window for stream dedup: ids only ever repeat
    within the drain/subscribe overlap, so a sliding window gives the
    same dedup as an unbounded set without growing for the lifetime of a
    long-lived watch stream."""

    def __init__(self, cap: int = 8192):
        from collections import deque

        self._cap = cap
        self._set: set = set()
        self._order = deque()

    def add(self, item) -> None:
        if item in self._set:
            return
        self._set.add(item)
        self._order.append(item)
        if len(self._order) > self._cap:
            self._set.discard(self._order.popleft())

    def __contains__(self, item) -> bool:
        return item in self._set


async def _check_limit(req, ctx) -> bool:
    """The reference's pagination contract (activation.go:193-199)."""
    if req.limit > 100:
        await ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                        "limit is capped at 100")
    if req.limit == 0:
        await ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                        "limit must be set to <= 100")
    return True


class V2AlphaServices:
    """All v2alpha1 handlers over one App (the db handles + event bus)."""

    def __init__(self, app):
        self.node = app

    def handlers(self) -> tuple:
        h = grpc.method_handlers_generic_handler
        return (
            h("spacemesh.v2alpha1.ActivationService", {
                "List": _unary(self._atx_list, v2.ActivationRequest,
                               v2.ActivationList),
                "ActivationsCount": _unary(
                    self._atx_count, v2.ActivationsCountRequest,
                    v2.ActivationsCountResponse),
            }),
            h("spacemesh.v2alpha1.ActivationStreamService", {
                "Stream": _server_stream(
                    self._atx_stream, v2.ActivationStreamRequest,
                    v2.Activation),
            }),
            h("spacemesh.v2alpha1.RewardService", {
                "List": _unary(self._reward_list, v2.RewardRequest,
                               v2.RewardList),
            }),
            h("spacemesh.v2alpha1.RewardStreamService", {
                "Stream": _server_stream(
                    self._reward_stream, v2.RewardStreamRequest, v2.Reward),
            }),
            h("spacemesh.v2alpha1.LayerService", {
                "List": _unary(self._layer_list, v2.LayerRequest,
                               v2.LayerList),
            }),
            h("spacemesh.v2alpha1.LayerStreamService", {
                "Stream": _server_stream(
                    self._layer_stream, v2.LayerStreamRequest, v2.Layer),
            }),
            h("spacemesh.v2alpha1.MalfeasanceService", {
                "List": _unary(self._malfeasance_list, v2.MalfeasanceRequest,
                               v2.MalfeasanceList),
            }),
            h("spacemesh.v2alpha1.MalfeasanceStreamService", {
                "Stream": _server_stream(
                    self._malfeasance_stream, v2.MalfeasanceStreamRequest,
                    v2.MalfeasanceProof),
            }),
            h("spacemesh.v2alpha1.NetworkService", {
                "Info": _unary(self._network_info, v2.NetworkInfoRequest,
                               v2.NetworkInfoResponse),
            }),
            h("spacemesh.v2alpha1.NodeService", {
                "Status": _unary(self._node_status, v2.NodeStatusRequest,
                                 v2.NodeStatusResponse),
            }),
            h("spacemesh.v2alpha1.AccountService", {
                "List": _unary(self._account_list, v2.AccountRequest,
                               v2.AccountList),
            }),
            h("spacemesh.v2alpha1.TransactionService", {
                "List": _unary(self._tx_list, v2.TransactionRequest,
                               v2.TransactionList),
            }),
            h("spacemesh.v2alpha1.TransactionStreamService", {
                "Stream": _server_stream(
                    self._tx_stream, v2.TransactionStreamRequest,
                    v2.TransactionV2),
            }),
        )

    # --- activations ---------------------------------------------------

    def _atx_msg_from_row(self, row) -> v2.Activation:
        view = atxstore._view(row)
        target = view.publish_epoch + 1
        info = self.node.cache.get(target, view.id)
        return v2.Activation(
            id=view.id, smesher_id=view.node_id,
            publish_epoch=view.publish_epoch,
            coinbase=row["coinbase"] or b"",
            num_units=view.num_units,
            weight=info.weight if info else 0,
            height=info.height if info else 0)

    async def _atx_list(self, req, ctx):
        await _check_limit(req, ctx)
        rows = atxstore.list_rows(
            self.node.state, limit=req.limit, offset=req.offset,
            epoch=req.epoch if req.HasField("epoch") else None,
            smesher=req.smesher_id or None, coinbase=req.coinbase or None)
        return v2.ActivationList(
            activations=[self._atx_msg_from_row(r) for r in rows])

    async def _atx_count(self, req, ctx):
        n = atxstore.count(
            self.node.state,
            epoch=req.epoch if req.HasField("epoch") else None)
        return v2.ActivationsCountResponse(count=n)

    async def _atx_stream(self, req, ctx):
        sub = None
        if req.watch:
            sub = self.node.events.subscribe(events_mod.AtxEvent, size=256)
        try:
            # stored first (reference Stream: db chan drains before events)
            seen = _RecentSet()
            offset = 0
            while True:
                rows = atxstore.list_rows(
                    self.node.state, limit=100, offset=offset,
                    epoch=req.epoch if req.HasField("epoch") else None,
                    smesher=req.smesher_id or None)
                for row in rows:
                    msg = self._atx_msg_from_row(row)
                    if msg.publish_epoch + 1 >= req.start_epoch:
                        seen.add(msg.id)
                        yield msg
                if len(rows) < 100:
                    break
                offset += 100
            if sub is None:
                return
            while True:
                ev = await sub.next()
                if sub.overflowed:
                    await ctx.abort(grpc.StatusCode.CANCELLED,
                                    "event buffer overflow")
                if req.smesher_id and ev.node_id != req.smesher_id:
                    continue
                # AtxEvent.epoch is the PUBLISH epoch (app._on_atx), the
                # same axis the stored drain filters on
                if req.HasField("epoch") and ev.epoch != req.epoch:
                    continue
                if ev.epoch + 1 < req.start_epoch or ev.atx_id in seen:
                    continue
                seen.add(ev.atx_id)
                row = self.node.state.one(
                    "SELECT * FROM atxs WHERE id=?", (ev.atx_id,))
                if row is not None:
                    yield self._atx_msg_from_row(row)
        finally:
            if sub is not None:
                sub.close()

    # --- rewards -------------------------------------------------------

    def _reward_rows(self, coinbase: bytes | None, start_layer: int,
                     limit: int, offset: int):
        where = "WHERE layer >= ?"
        args: list = [start_layer]
        if coinbase:
            where += " AND coinbase = ?"
            args.append(coinbase)
        return self.node.state.all(
            f"SELECT * FROM rewards {where} ORDER BY layer, coinbase"
            " LIMIT ? OFFSET ?", (*args, limit, offset))

    @staticmethod
    def _reward_msg(row) -> v2.Reward:
        return v2.Reward(layer=row["layer"], total=row["total_reward"],
                         layer_reward=row["layer_reward"],
                         coinbase=row["coinbase"])

    async def _reward_list(self, req, ctx):
        await _check_limit(req, ctx)
        rows = self._reward_rows(req.coinbase or None, req.start_layer,
                                 req.limit, req.offset)
        return v2.RewardList(rewards=[self._reward_msg(r) for r in rows])

    def _reward_pages(self, coinbase, start_layer: int):
        """Reward rows from ``start_layer`` in 100-row pages — a scan
        over a long range must not materialize it in one query. The start
        layer stays FIXED across pages (offset
        paging): advancing it per page would skip rows when several
        coinbases share the page-boundary layer."""
        offset = 0
        while True:
            page = self._reward_rows(coinbase, start_layer, 100, offset)
            yield from page
            if len(page) < 100:
                return
            offset += 100

    async def _reward_stream(self, req, ctx):
        sub = None
        if req.watch:
            sub = self.node.events.subscribe(events_mod.LayerUpdate, size=256)
        try:
            last = req.start_layer - 1
            for row in self._reward_pages(req.coinbase or None,
                                          req.start_layer):
                last = max(last, row["layer"])
                yield self._reward_msg(row)
            if sub is None:
                return
            while True:
                ev = await sub.next()
                # an overflowed queue is safe here: the next event
                # triggers a DB re-scan from `last`, nothing is lost
                if ev.status != "applied" or ev.layer <= last:
                    continue
                for row in self._reward_pages(req.coinbase or None,
                                              last + 1):
                    last = max(last, row["layer"])
                    yield self._reward_msg(row)
        finally:
            if sub is not None:
                sub.close()

    # --- layers --------------------------------------------------------

    def _layer_msg(self, layer: int) -> v2.Layer:
        return v2.Layer(
            number=layer,
            applied_block=layerstore.applied_block(self.node.state, layer)
            or b"",
            state_hash=layerstore.state_hash(self.node.state, layer) or b"",
            aggregated_hash=layerstore.aggregated_hash(
                self.node.state, layer) or b"")

    async def _layer_list(self, req, ctx):
        await _check_limit(req, ctx)
        # exclusive upper bound; processed() is -1 on a fresh db so an
        # empty node yields an empty list, not a fabricated layer 0
        end = req.end_layer + 1 if req.HasField("end_layer") \
            else layerstore.processed(self.node.state) + 1
        first = req.start_layer + req.offset
        layers = range(first, min(first + req.limit, end))
        return v2.LayerList(layers=[self._layer_msg(x) for x in layers])

    async def _layer_stream(self, req, ctx):
        sub = None
        if req.watch:
            sub = self.node.events.subscribe(events_mod.LayerUpdate, size=256)
        try:
            last = req.start_layer - 1
            for layer in range(
                    req.start_layer,
                    layerstore.processed(self.node.state) + 1):
                last = layer
                yield self._layer_msg(layer)
            if sub is None:
                return
            while True:
                ev = await sub.next()
                # overflow-safe: the range below re-reads the DB gap
                if ev.status != "applied" or ev.layer <= last:
                    continue
                for layer in range(last + 1, ev.layer + 1):
                    yield self._layer_msg(layer)
                last = ev.layer
        finally:
            if sub is not None:
                sub.close()

    # --- malfeasance ---------------------------------------------------

    def _malfeasance_msg(self, node_id: bytes) -> v2.MalfeasanceProof | None:
        proof = miscstore.malfeasance_proof(self.node.state, node_id)
        if proof is None:
            return None
        return v2.MalfeasanceProof(
            smesher_id=node_id,
            domain=_DOMAINS.get(proof.domain, str(proof.domain)),
            proof=proof.to_bytes())

    async def _malfeasance_list(self, req, ctx):
        await _check_limit(req, ctx)
        ids = list(req.smesher_id) or miscstore.all_malicious(self.node.state)
        out = []
        for nid in ids[req.offset:req.offset + req.limit]:
            msg = self._malfeasance_msg(nid)
            if msg is not None:
                out.append(msg)
        return v2.MalfeasanceList(proofs=out)

    async def _malfeasance_stream(self, req, ctx):
        sub = None
        if req.watch:
            sub = self.node.events.subscribe(events_mod.Malfeasance, size=256)
        try:
            wanted = set(req.smesher_id)
            sent = _RecentSet()
            for nid in miscstore.all_malicious(self.node.state):
                if wanted and nid not in wanted:
                    continue
                msg = self._malfeasance_msg(nid)
                if msg is not None:
                    sent.add(nid)
                    yield msg
            if sub is None:
                return
            while True:
                ev = await sub.next()
                if sub.overflowed:
                    await ctx.abort(grpc.StatusCode.CANCELLED,
                                    "event buffer overflow")
                if (wanted and ev.node_id not in wanted) \
                        or ev.node_id in sent:
                    continue
                msg = self._malfeasance_msg(ev.node_id)
                if msg is not None:
                    sent.add(ev.node_id)
                    yield msg
        finally:
            if sub is not None:
                sub.close()

    # --- network / node ------------------------------------------------

    async def _network_info(self, req, ctx):
        cfg = self.node.cfg
        return v2.NetworkInfoResponse(
            genesis_time=self.node.clock.genesis_time,
            layer_duration=cfg.layer_duration,
            genesis_id=cfg.genesis.genesis_id,
            hrp=Address.HRP,
            effective_genesis_layer=0,
            layers_per_epoch=cfg.layers_per_epoch,
            labels_per_unit=cfg.post.labels_per_unit)

    async def _node_status(self, req, ctx):
        n = self.node
        synced = n.syncer.is_synced() if n.syncer else True
        return v2.NodeStatusResponse(
            connected_peers=len(n.server.peers()) if n.server else 0,
            status=(v2.NodeStatusResponse.SYNC_STATUS_SYNCED if synced
                    else v2.NodeStatusResponse.SYNC_STATUS_SYNCING),
            latest_layer=max(layerstore.processed(n.state), 0),
            applied_layer=max(layerstore.last_applied(n.state), 0),
            processed_layer=max(layerstore.processed(n.state), 0),
            current_layer=max(int(n.clock.current_layer()), 0))

    # --- accounts ------------------------------------------------------

    async def _account_list(self, req, ctx):
        await _check_limit(req, ctx)
        from ..storage import transactions as txstore

        state = self.node.state
        if req.addresses:
            addrs = list(req.addresses)[req.offset:req.offset + req.limit]
        else:
            rows = state.all(
                "SELECT DISTINCT address FROM accounts ORDER BY address"
                " LIMIT ? OFFSET ?", (req.limit, req.offset))
            addrs = [r["address"] for r in rows]
        out = []
        for addr in addrs:
            acct = txstore.account(state, addr)
            cur = v2.AccountState(
                balance=acct["balance"] if acct else 0,
                counter=acct["next_nonce"] if acct else 0,
                layer=acct["layer"] if acct else 0)
            nonce_p, balance_p = self.node.cstate.projected(addr)
            out.append(v2.Account(
                address=addr, current=cur,
                projected=v2.AccountState(balance=balance_p, counter=nonce_p),
                template=(acct["template"] or b"").hex() if acct else ""))
        return v2.AccountList(accounts=out)

    # --- transactions --------------------------------------------------

    def _tx_msg(self, row) -> v2.TransactionV2:
        from ..core.types import TransactionResult

        res = row["result"]
        layer, block, status = 0, b"", 0
        if res:
            tr = TransactionResult.from_bytes(res)
            layer, block, status = tr.layer, tr.block, tr.status
        return v2.TransactionV2(
            id=row["id"], principal=row["principal"] or b"",
            nonce=row["nonce"] or 0, raw=row["raw"],
            layer=layer, block=block, status=status)

    def _tx_rows(self, *, principal=None, txids=(), start_layer=None,
                 end_layer=None, limit: int, offset: int):
        """Layer bounds are part of the WHERE clause — filtering after
        LIMIT/OFFSET would break the pagination contract (a full page of
        out-of-range rows reads as end-of-data)."""
        where, args = [], []
        if principal:
            where.append("principal=?")
            args.append(principal)
        if txids:
            where.append("id IN (%s)" % ",".join("?" * len(txids)))
            args.extend(txids)
        if start_layer is not None:
            where.append("layer>=?")
            args.append(start_layer)
        if end_layer is not None:
            where.append("layer<=?")
            args.append(end_layer)
        clause = (" WHERE " + " AND ".join(where)) if where else ""
        return self.node.state.all(
            f"SELECT * FROM transactions{clause} ORDER BY layer, id"
            " LIMIT ? OFFSET ?", (*args, limit, offset))

    async def _tx_list(self, req, ctx):
        await _check_limit(req, ctx)
        rows = self._tx_rows(
            principal=req.principal or None, txids=list(req.txid),
            start_layer=req.start_layer if req.HasField("start_layer")
            else None,
            end_layer=req.end_layer if req.HasField("end_layer") else None,
            limit=req.limit, offset=req.offset)
        return v2.TransactionList(transactions=[self._tx_msg(r)
                                                for r in rows])

    async def _tx_stream(self, req, ctx):
        sub = None
        if req.watch:
            sub = self.node.events.subscribe(events_mod.TxEvent, size=256)
        try:
            sent = _RecentSet()
            offset = 0
            while True:
                rows = self._tx_rows(principal=req.principal or None,
                                     limit=100, offset=offset)
                for row in rows:
                    sent.add(row["id"])
                    yield self._tx_msg(row)
                if len(rows) < 100:
                    break
                offset += 100
            if sub is None:
                return
            while True:
                ev = await sub.next()
                if sub.overflowed:
                    await ctx.abort(grpc.StatusCode.CANCELLED,
                                    "event buffer overflow")
                if ev.tx_id in sent:
                    continue
                row = self.node.state.one(
                    "SELECT * FROM transactions WHERE id=?", (ev.tx_id,))
                if row is None:
                    continue
                if req.principal and row["principal"] != req.principal:
                    continue
                sent.add(ev.tx_id)
                yield self._tx_msg(row)
        finally:
            if sub is not None:
                sub.close()
