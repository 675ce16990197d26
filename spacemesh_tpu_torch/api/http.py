"""JSON-over-HTTP API server (port of ``spacemesh_tpu/api/http.py``).

Service -> route map (reference api/grpcserver; JSON gateway semantics):

  NodeService        GET  /v1/node/status, /v1/node/version
  MeshService        GET  /v1/mesh/genesis, /v1/mesh/layer/{n},
                          /v1/mesh/epoch/{e}/atxs
  GlobalState        GET  /v1/account/{bech32}, /v1/account/{bech32}/rewards,
                          /v1/globalstate/root
  TransactionService POST /v1/tx/submit {"raw": hex}; GET /v1/tx/{id}
  ActivationService  GET  /v1/atx/{id}
  SmesherService     GET  /v1/smesher/status
  DebugService       GET  /v1/debug/state
  AdminService       POST /v1/admin/checkpoint {"path": ...},
                     POST /v1/admin/recover {"path": ...}
  EventsService      GET  /v1/events?timeout=s  (long-poll drain)

Every route of the JAX server, with the same bodies. One deliberate
difference: ``/debug/trace/start`` takes ``?torch=1`` (not ``?jax=1``) and
bridges spans into ``torch.profiler`` ranges; its answer reports
``torch_bridge``. The server touches no device: POST init, proving and
verification run where the node put them.
"""

from __future__ import annotations

import asyncio
import json

from aiohttp import web

from ..core.types import Address, Transaction
from ..node import checkpoint as checkpoint_mod
from ..node import events as events_mod
from ..storage import atxs as atxstore
from ..storage import ballots as ballotstore
from ..storage import blocks as blockstore
from ..storage import layers as layerstore
from ..storage import misc as miscstore
from ..storage import transactions as txstore
from ..vm.vm import TxValidity
from . import API_VERSION

__all__ = ["API_VERSION", "ApiServer"]


def _hex(b: bytes | None) -> str | None:
    return b.hex() if b is not None else None


class ApiServer:
    def __init__(self, app, listen: str = "127.0.0.1:0"):
        self.node = app
        host, _, port = listen.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 0)
        self.web_app = web.Application()
        self._routes()
        self.runner: web.AppRunner | None = None
        self.actual_port: int | None = None

    def _routes(self) -> None:
        r = self.web_app.router
        r.add_get("/v1/node/status", self.node_status)
        r.add_get("/v1/node/version", self.node_version)
        r.add_get("/v1/node/peers", self.node_peers)
        r.add_get("/v1/mesh/genesis", self.mesh_genesis)
        r.add_get("/v1/mesh/layer/{layer}", self.mesh_layer)
        r.add_get("/v1/mesh/epoch/{epoch}/atxs", self.epoch_atxs)
        r.add_get("/v1/account/{address}", self.account)
        r.add_get("/v1/account/{address}/rewards", self.account_rewards)
        r.add_get("/v1/globalstate/root", self.state_root)
        r.add_post("/v1/tx/submit", self.tx_submit)
        r.add_get("/v1/tx/{tx_id}", self.tx_get)
        r.add_get("/v1/atx/{atx_id}", self.atx_get)
        r.add_get("/v1/smesher/status", self.smesher_status)
        r.add_get("/v1/debug/state", self.debug_state)
        r.add_post("/v1/admin/checkpoint", self.admin_checkpoint)
        r.add_post("/v1/admin/recover", self.admin_recover)
        r.add_post("/v1/admin/chaos/block", self.admin_chaos_block)
        r.add_post("/v1/admin/chaos/clear", self.admin_chaos_clear)
        r.add_post("/v1/admin/chaos/link", self.admin_chaos_link)
        r.add_post("/v1/admin/chaos/timeskew", self.admin_chaos_timeskew)
        r.add_get("/v1/events", self.events)
        r.add_get("/metrics", self.metrics)
        # pprof-analogue debug surface (reference node/node.go:2121-2151
        # mounts net/http/pprof): stack dumps and an on-demand CPU
        # profile, the two handles operators actually pull on a wedged
        # or hot node
        r.add_get("/debug/stacks", self.debug_stacks)
        r.add_get("/debug/profile", self.debug_profile)
        # span-trace capture (utils/tracing.py): start/stop a bounded
        # ring capture and export it as Perfetto-compatible JSON. GET
        # and POST both accepted — operators drive these with curl
        for route in ("/debug/trace/start", "/debug/trace/stop"):
            handler = (self.trace_start if route.endswith("start")
                       else self.trace_stop)
            r.add_get(route, handler)
            r.add_post(route, handler)
        r.add_get("/debug/trace/export", self.trace_export)
        # health & SLO engine surface (obs/health.py):
        # /healthz is liveness (the tick loop runs), /readyz is per-
        # component readiness with reasons, /debug/flight spools a
        # diagnostic bundle on demand
        r.add_get("/healthz", self.healthz)
        r.add_get("/readyz", self.readyz)
        r.add_get("/debug/flight", self.debug_flight)
        r.add_post("/debug/flight", self.debug_flight)
        # self-healing surface (obs/remediate.py):
        # breaker states, recovery-action history, budgets
        r.add_get("/debug/remediation", self.debug_remediation)

    # --- lifecycle ---------------------------------------------------

    async def start(self) -> int:
        self.runner = web.AppRunner(self.web_app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, self.host, self.port)
        await site.start()
        self.actual_port = site._server.sockets[0].getsockname()[1]
        return self.actual_port

    async def stop(self) -> None:
        await self.stop_event_pump()
        if self.runner is not None:
            await self.runner.cleanup()

    # --- NodeService -------------------------------------------------

    async def node_status(self, req) -> web.Response:
        n = self.node
        synced = n.syncer.is_synced() if n.syncer else True
        return web.json_response({
            "status": {
                "connected_peers": len(n.server.peers()) if n.server else 0,
                "is_synced": synced,
                "synced_layer": layerstore.processed(n.state),
                "top_layer": int(n.clock.current_layer()),
                "verified_layer": n.tortoise.verified,
            }})

    async def node_version(self, req) -> web.Response:
        return web.json_response({"version": API_VERSION})

    # --- MeshService -------------------------------------------------

    async def mesh_genesis(self, req) -> web.Response:
        g = self.node.cfg.genesis
        return web.json_response({
            "genesis_time": g.time,
            "genesis_id": g.genesis_id.hex(),
            "layer_duration": self.node.cfg.layer_duration,
            "layers_per_epoch": self.node.cfg.layers_per_epoch,
        })

    async def mesh_layer(self, req) -> web.Response:
        try:
            layer = int(req.match_info["layer"])
        except ValueError:
            raise web.HTTPBadRequest(text="layer must be an integer")
        blocks = blockstore.in_layer(self.node.state, layer)
        return web.json_response({
            "layer": layer,
            "blocks": [{
                "id": b.id.hex(),
                "tx_ids": [t.hex() for t in b.tx_ids],
                "rewards": [{"coinbase": Address(r.coinbase).encode(),
                             "weight": r.weight} for r in b.rewards],
            } for b in blocks],
            "ballots": [b.hex() for b in
                        ballotstore.ids_in_layer(self.node.state, layer)],
            "applied_block": _hex(layerstore.applied_block(self.node.state,
                                                           layer)),
            "state_hash": _hex(layerstore.state_hash(self.node.state, layer)),
            "certified": _hex(miscstore.certified_block(self.node.state,
                                                        layer)),
        })

    async def epoch_atxs(self, req) -> web.Response:
        try:
            epoch = int(req.match_info["epoch"])
        except ValueError:
            raise web.HTTPBadRequest(text="epoch must be an integer")
        ids = atxstore.ids_in_epoch(self.node.state, epoch)
        return web.json_response({"epoch": epoch,
                                  "atxs": [i.hex() for i in ids]})

    # --- GlobalState -------------------------------------------------

    def _addr(self, req) -> bytes:
        raw = req.match_info["address"]
        try:
            if raw.startswith("0x"):
                return Address(bytes.fromhex(raw[2:])).raw  # length-checked
            return Address.decode(raw).raw
        except ValueError as e:
            raise web.HTTPBadRequest(text=f"bad address: {e}")

    async def account(self, req) -> web.Response:
        addr = self._addr(req)
        row = txstore.account(self.node.state, addr)
        return web.json_response({
            "address": Address(addr).encode(),
            "balance": row["balance"] if row else 0,
            "next_nonce": row["next_nonce"] if row else 0,
            "template": _hex(row["template"]) if row else None,
        })

    async def account_rewards(self, req) -> web.Response:
        addr = self._addr(req)
        rewards = miscstore.rewards_for(self.node.state, addr)
        return web.json_response({
            "rewards": [{"layer": lyr, "total": total}
                        for lyr, total in rewards]})

    async def state_root(self, req) -> web.Response:
        layer = layerstore.last_applied(self.node.state)
        return web.json_response({
            "layer": layer,
            "root": _hex(layerstore.state_hash(self.node.state, layer))})

    # --- Transactions ------------------------------------------------

    async def tx_submit(self, req) -> web.Response:
        try:
            body = await req.json()
            raw = bytes.fromhex(body["raw"])
        except (json.JSONDecodeError, KeyError, ValueError, TypeError):
            raise web.HTTPBadRequest(text='expected {"raw": "<hex>"}')
        tx = Transaction(raw=raw)
        validity = self.node.cstate.add(tx)
        if validity == TxValidity.VALID:
            from ..p2p.pubsub import TOPIC_TX

            await self.node.pubsub.publish(TOPIC_TX, raw)
        return web.json_response({
            "tx_id": tx.id.hex(),
            "status": validity.name,
            "accepted": validity == TxValidity.VALID,
        }, status=200 if validity == TxValidity.VALID else 422)

    async def tx_get(self, req) -> web.Response:
        try:
            tx_id = bytes.fromhex(req.match_info["tx_id"])
        except ValueError:
            raise web.HTTPBadRequest(text="tx id must be hex")
        tx = txstore.get_tx(self.node.state, tx_id)
        if tx is None:
            raise web.HTTPNotFound(text="unknown transaction")
        res = txstore.result(self.node.state, tx_id)
        return web.json_response({
            "tx_id": tx_id.hex(),
            "raw": tx.raw.hex(),
            "result": None if res is None else {
                "status": res.status, "message": res.message,
                "gas_consumed": res.gas_consumed, "fee": res.fee,
                "layer": res.layer,
            }})

    # --- Activation / Smesher ----------------------------------------

    async def atx_get(self, req) -> web.Response:
        try:
            atx_id = bytes.fromhex(req.match_info["atx_id"])
        except ValueError:
            raise web.HTTPBadRequest(text="atx id must be hex")
        atx = atxstore.get(self.node.state, atx_id)
        if atx is None:
            raise web.HTTPNotFound(text="unknown atx")
        return web.json_response({
            "id": atx_id.hex(),
            "node_id": atx.node_id.hex(),
            "publish_epoch": atx.publish_epoch,
            "num_units": atx.num_units,
            "coinbase": Address(atx.coinbase).encode(),
            "prev_atx": atx.prev_atx.hex(),
            "tick_height": atxstore.tick_height(self.node.state, atx_id),
        })

    async def smesher_status(self, req) -> web.Response:
        n = self.node
        registered = (n.post_service.registered()
                      if n.post_service is not None else [])
        return web.json_response({
            "smeshing": n.atx_builder is not None,
            "node_id": n.signer.node_id.hex(),
            "registered_post_identities": [i.hex() for i in registered],
        })

    # --- Debug / Admin -----------------------------------------------

    async def debug_state(self, req) -> web.Response:
        n = self.node
        return web.json_response({
            "verified_layer": n.tortoise.verified,
            "processed_layer": layerstore.processed(n.state),
            "last_applied": layerstore.last_applied(n.state),
            "tortoise_mode": n.tortoise.mode,
            "sync_state": n.syncer.state.value if n.syncer else None,
            "identities": [s.node_id.hex() for s in n.signers],
            "mempool": n.cstate.pending_count(),
            "malicious_identities":
                [i.hex() for i in miscstore.all_malicious(n.state)],
        })

    async def node_peers(self, req) -> web.Response:
        """Connected peers with fetch scores (reference admin/debug peer
        listings)."""
        n = self.node
        peers = []
        if n.server is not None:
            for pid in n.server.peers():
                entry = {"node_id": pid.hex(),
                         "failure_score": (n.fetch.failure_score(pid)
                                           if n.fetch else 0)}
                host = getattr(n, "host", None)
                if host is not None and pid in host.nodes:
                    conn = host.nodes[pid]
                    if conn.listen_addr:
                        entry["address"] = (f"{conn.listen_addr[0]}:"
                                            f"{conn.listen_addr[1]}")
                    entry["outbound"] = conn.outbound
                peers.append(entry)
        return web.json_response({"peers": peers})

    async def admin_checkpoint(self, req) -> web.Response:
        try:
            body = await req.json()
            path = body["path"]
        except (json.JSONDecodeError, KeyError, TypeError):
            raise web.HTTPBadRequest(text='expected {"path": ...}')
        # off the event loop: a large snapshot must not stall consensus
        snap = await asyncio.to_thread(checkpoint_mod.write,
                                       self.node.state, path)
        return web.json_response({"layer": snap["layer"],
                                  "accounts": len(snap["accounts"]),
                                  "atxs": len(snap["atxs"])})

    async def admin_recover(self, req) -> web.Response:
        try:
            body = await req.json()
            path = body["path"]
        except (json.JSONDecodeError, KeyError, TypeError):
            raise web.HTTPBadRequest(text='expected {"path": ...}')
        snap = await asyncio.to_thread(
            checkpoint_mod.recover_file, self.node.state, path,
            self.node.signer.node_id)
        return web.json_response({"recovered_layer": snap["layer"]})

    # --- debug/profiling (reference node/node.go:2121-2151 pprof) -----

    async def debug_stacks(self, req) -> web.Response:
        """Every thread's stack plus every asyncio task — the
        goroutine-dump equivalent for diagnosing a wedged node."""
        import io
        import sys
        import traceback

        buf = io.StringIO()
        frames = sys._current_frames()
        for tid, frame in frames.items():
            buf.write(f"--- thread {tid} ---\n")
            traceback.print_stack(frame, file=buf)
        buf.write(f"\n=== asyncio tasks "
                  f"({len(asyncio.all_tasks())}) ===\n")
        for task in asyncio.all_tasks():
            buf.write(f"--- {task.get_name()}"
                      f"{' (current)' if task == asyncio.current_task() else ''}\n")
            stack = task.get_stack(limit=8)
            for frame in stack:
                buf.write("".join(traceback.format_stack(frame, limit=1)))
        return web.Response(text=buf.getvalue(),
                            content_type="text/plain")

    async def debug_profile(self, req) -> web.Response:
        """CPU-profile the node for ?seconds=N (default 5, max 60) and
        return cProfile stats ordered by cumulative time — the
        /debug/pprof/profile analogue."""
        import cProfile
        import io
        import pstats

        try:
            seconds = min(float(req.query.get("seconds", 5)), 60.0)
        except ValueError:
            raise web.HTTPBadRequest(text="seconds must be a number")
        prof = cProfile.Profile()
        try:
            prof.enable()
        except ValueError:
            # another profiler is live: the node's --profile whole-run
            # profiler (node/__main__.py), or a concurrent request —
            # only one cProfile may be active per interpreter
            raise web.HTTPConflict(
                text="another profiler is already active")
        try:
            await asyncio.sleep(seconds)
        finally:
            prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
            .print_stats(40)
        return web.Response(text=buf.getvalue(),
                            content_type="text/plain")

    # --- health & SLO engine (obs/health.py) --------------------------

    def _engine(self):
        return getattr(self.node, "health_engine", None)

    async def healthz(self, req) -> web.Response:
        """Liveness: 200 while the health engine's tick loop is not
        wedged (or when no engine is attached — a serving process with
        nothing registered is alive by definition)."""
        engine = self._engine()
        if engine is None:
            return web.json_response({"status": "ok", "engine": False})
        if not engine.live():
            return web.json_response(
                {"status": "wedged",
                 "detail": "health tick loop missed 3+ intervals"},
                status=503)
        return web.json_response({"status": "ok", "engine": True})

    async def readyz(self, req) -> web.Response:
        """Per-component readiness with reasons + SLO state. 503 while
        any registered component probe fails."""
        engine = self._engine()
        if engine is not None:
            # serves the background loop's cached report when fresh; a
            # loop-less embedder evaluates inline with the flight dump
            # deferred, and the dump (trace-ring serialization + disk
            # writes) is flushed off the loop so a readiness poll can't
            # stall gossip exactly when the node is unhealthy
            report = engine.current_report()
            if engine._pending_dump is not None:
                await asyncio.to_thread(engine.flush_dump)
        else:
            # no engine (stub embedders): probes from the global health
            # registry still answer, without SLI/SLO evaluation
            from ..obs import health as health_mod

            components = health_mod.HEALTH.report()
            report = {"ready": all(e["healthy"]
                                   for e in components.values()),
                      "components": components, "slos": {}, "slis": {}}
        from ..obs import remediate as remediate_mod

        breakers = remediate_mod.BREAKERS.states()
        if breakers:
            # breaker states ride the readiness report (a COPY — the
            # engine's cached report must not accrete keys): an open
            # breaker is not unreadiness (the fallback is carrying the
            # load), but it is the first thing an operator should see
            report = {**report, "breakers": breakers}
        return web.json_response(
            report, status=200 if report["ready"] else 503)

    async def debug_remediation(self, req) -> web.Response:
        """Breaker states, action history, and budgets — the
        self-healing node's introspection surface."""
        from ..obs import remediate as remediate_mod

        engine = getattr(self.node, "remediation", None)
        if engine is not None:
            doc = engine.snapshot()
        else:
            doc = {"breakers": remediate_mod.BREAKERS.snapshot(),
                   "actions": [], "budgets": {}, "quarantined": []}
        fv = getattr(self.node, "failover_verifier", None)
        if fv is not None:
            doc["failover"] = fv.state_doc()
        return web.json_response(doc)

    async def debug_flight(self, req) -> web.Response:
        """Spool a flight bundle NOW (manual trigger; bypasses the
        breach rate limit)."""
        engine = self._engine()
        if engine is None:
            raise web.HTTPConflict(text="no health engine attached")
        reason = req.query.get("reason", "manual")
        path = await asyncio.to_thread(engine.dump_flight, reason)
        if path is None:
            raise web.HTTPConflict(
                text="no flight spool dir configured on the engine")
        return web.json_response({"bundle": path, "reason": reason})

    # --- span-trace capture (utils/tracing.py) -----------------------

    async def trace_start(self, req) -> web.Response:
        """Begin (or restart) a span capture. ?capacity=N bounds the
        ring; ?torch=1 bridges spans into torch.profiler ranges."""
        from ..utils import metrics, tracing

        try:
            capacity = req.query.get("capacity")
            capacity = int(capacity) if capacity else None
            torch_q = req.query.get("torch")
            torch_bridge = (torch_q not in ("", "0", "off", None)
                            if torch_q is not None else None)
        except ValueError:
            raise web.HTTPBadRequest(text="capacity must be an integer")
        tracing.start(capacity=capacity, torch_bridge=torch_bridge)
        metrics.trace_enabled_gauge.set(1)
        metrics.trace_spans_gauge.set(0)
        return web.json_response({
            "enabled": True,
            "capacity": tracing.TRACER.capacity,
            "torch_bridge": tracing.TRACER.torch_bridge,
        })

    async def trace_stop(self, req) -> web.Response:
        from ..utils import metrics, tracing

        retained = tracing.stop()
        metrics.trace_enabled_gauge.set(0)
        metrics.trace_spans_gauge.set(tracing.TRACER.recorded())
        return web.json_response({
            "enabled": False,
            "spans_retained": retained,
            "spans_recorded": tracing.TRACER.recorded(),
        })

    async def trace_export(self, req) -> web.Response:
        """The capture as Chrome trace-event JSON — save the body and
        open it at https://ui.perfetto.dev. Exporting does not stop the
        capture; a live capture exports its current ring."""
        from ..utils import metrics, tracing

        metrics.trace_spans_gauge.set(tracing.TRACER.recorded())
        # a big ring materializes AND serializes slowly; do both off the
        # loop (export() tolerates concurrent recording)
        body = await asyncio.to_thread(
            lambda: json.dumps(tracing.export()))
        return web.Response(text=body, content_type="application/json")

    # --- chaos fault injection (systest harness; reference
    # systest/chaos/{partition,timeskew}.go) ---------------------------

    async def admin_chaos_block(self, req) -> web.Response:
        """Sever + refuse peers by listen address: the partition lever
        the cluster harness pulls (transport Host.chaos_block)."""
        host = getattr(self.node, "host", None)
        if host is None:
            raise web.HTTPConflict(text="no transport host")
        try:
            body = await req.json()
            addrs = []
            for spec in body.get("addrs", []):
                h, _, p = spec.rpartition(":")
                addrs.append((h, int(p)))
        except (json.JSONDecodeError, ValueError, TypeError, AttributeError):
            raise web.HTTPBadRequest(text='expected {"addrs": ["ip:port"]}')
        host.chaos_block(addrs=addrs)
        return web.json_response({"blocked": len(addrs)})

    async def admin_chaos_clear(self, req) -> web.Response:
        host = getattr(self.node, "host", None)
        if host is None:
            raise web.HTTPConflict(text="no transport host")
        host.chaos_clear()
        return web.json_response({"ok": True})

    async def admin_chaos_link(self, req) -> web.Response:
        """Degrade this node's gossip relays (loss/delay/jitter/dup):
        the link-quality lever for scripted scenarios over real
        transports (Host.chaos_link; sim/faults.py link_policy is the
        in-proc twin). Empty body = clean links."""
        host = getattr(self.node, "host", None)
        if host is None:
            raise web.HTTPConflict(text="no transport host")
        try:
            body = await req.json() if req.can_read_body else {}
            # AttributeError below: valid JSON that isn't an object
            # ('[1]', 'null') must be a 400, not an unhandled 500
            kwargs = {k: float(body.get(k, 0.0))
                      for k in ("loss", "delay", "jitter", "dup")}
            kwargs["seed"] = int(body.get("seed", 0))
        except (json.JSONDecodeError, ValueError, TypeError,
                AttributeError):
            raise web.HTTPBadRequest(
                text='expected {"loss": p, "delay": s, "jitter": s, '
                     '"dup": p, "seed": n}')
        host.chaos_link(**kwargs)
        return web.json_response({"ok": True, **{
            k: v for k, v in kwargs.items() if k != "seed"}})

    async def admin_chaos_timeskew(self, req) -> web.Response:
        """Shift this node's clock by offset seconds (0 heals)."""
        try:
            body = await req.json()
            offset = float(body["offset"])
        except (json.JSONDecodeError, KeyError, ValueError, TypeError):
            raise web.HTTPBadRequest(text='expected {"offset": seconds}')
        self.node.time_offset = offset
        return web.json_response({"offset": offset})

    async def metrics(self, req) -> web.Response:
        from ..consensus.tortoise import FULL
        from ..utils.metrics import (
            REGISTRY,
            applied_gauge,
            layer_gauge,
            peers_gauge,
            sync_state_gauge,
            tortoise_mode_gauge,
            verified_gauge,
        )

        n = self.node
        layer_gauge.set(int(n.clock.current_layer()))
        verified_gauge.set(n.tortoise.verified)
        applied_gauge.set(layerstore.last_applied(n.state))
        peers_gauge.set(len(n.server.peers()) if n.server else 0)
        tortoise_mode_gauge.set(1 if n.tortoise.mode == FULL else 0)
        if n.syncer is not None:
            from ..p2p.sync import SyncState

            sync_state_gauge.set({SyncState.NOT_SYNCED: 0,
                                  SyncState.GOSSIP: 1,
                                  SyncState.SYNCED: 2}[n.syncer.state])
        from ..obs.federate import FEDERATION

        # local registry, then every federated child's proc= series
        return web.Response(text=REGISTRY.expose() + FEDERATION.expose(),
                            content_type="text/plain")

    # --- Events ------------------------------------------------------

    _EVENT_TYPES = (events_mod.LayerUpdate, events_mod.AtxEvent,
                    events_mod.TxEvent, events_mod.BeaconEvent,
                    events_mod.PostEvent, events_mod.AtxPublished,
                    events_mod.Malfeasance)
    _RING = 1024

    def _ensure_event_pump(self) -> None:
        """ONE persistent subscription feeding a seq-numbered ring buffer:
        long-poll clients resume from ?since=<seq> and never lose events
        that fired between two polls (the reference's streaming services
        are persistent for the same reason)."""
        if getattr(self, "_event_pump", None) is not None:
            return
        self._event_ring: list = []
        self._event_seq = 0
        self._event_waiters: list[asyncio.Event] = []
        sub = self.node.events.subscribe(*self._EVENT_TYPES,
                                         size=self._RING)

        async def pump():
            while True:
                ev = await sub.next()
                self._event_seq += 1
                self._event_ring.append((self._event_seq, ev))
                del self._event_ring[:-self._RING]
                for w in self._event_waiters:
                    w.set()

        self._event_pump = asyncio.ensure_future(pump())

    async def events(self, req) -> web.Response:
        self._ensure_event_pump()
        try:
            timeout = min(max(float(req.query.get("timeout", "1.0")), 0.0),
                          60.0)
            since = int(req.query.get("since", "0"))
        except ValueError:
            raise web.HTTPBadRequest(text="timeout/since must be numeric")

        def collect():
            return [(seq, ev) for seq, ev in self._event_ring if seq > since]

        got = collect()
        if not got and timeout > 0:
            waiter = asyncio.Event()
            self._event_waiters.append(waiter)
            try:
                await asyncio.wait_for(waiter.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            finally:
                self._event_waiters.remove(waiter)
            got = collect()
        out = [{"seq": seq, "type": type(ev).__name__,
                **{k: (v.hex() if isinstance(v, bytes) else v)
                   for k, v in ev.__dict__.items()}} for seq, ev in got]
        return web.json_response({"events": out,
                                  "next_since": got[-1][0] if got else since})

    async def stop_event_pump(self) -> None:
        pump = getattr(self, "_event_pump", None)
        if pump is not None:
            pump.cancel()
