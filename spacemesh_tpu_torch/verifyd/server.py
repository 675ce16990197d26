"""verifyd network front-end: JSON-over-HTTP + gRPC admission surface
(port of ``spacemesh_tpu/verifyd/server.py``, the same routes and docs).

aiohttp routes (hex-encoded bytes, typed 4xx bodies, /metrics +
/healthz + /readyz) and a hand-wired grpc.aio service: the four methods
are registered with ``method_handlers_generic_handler`` and carry the
SAME JSON docs as message bytes — one codec, two transports
(verifyd/protocol.py). aiohttp is imported here and only here; grpc only
when the gRPC surface starts, so nothing else of the port needs either.

Routes:

  POST /v1/client/register    {"client", "weight"?, "rate"?, "burst"?,
                               "max_queued"?, "max_inflight"?}
  POST /v1/client/unregister  {"client"}
  POST /v1/verify             {"client", "lane"?, "deadline_s"?,
                               "items": [request docs]}
                              -> {"status": "OK", "verdicts": [bool]}
                              |  429/503 {"status": "SHED", ...}
  GET  /v1/stats              service + farm + tuner counters
  GET  /v1/tune               measured batch-rate model rows
  GET  /metrics               Prometheus exposition
  GET  /healthz, /readyz      liveness / readiness: the health engine's
                              report (SLOs + the HEALTH registry's probes)
  GET  /debug/trace/start     ?capacity=&role=  start a span capture
  GET  /debug/trace/stop      stop it (the ring stays exportable)
  GET  /debug/trace/export    the capture as trace-event JSON

Shed mapping: admission rejections are HTTP 429 (overload family) or
503 (``shutting_down``) with the typed doc — a client always learns WHY
and when to retry.  gRPC returns the same doc with 200-style status
(the doc's ``status`` field discriminates), so both transports shed
loudly and identically.

``/metrics`` appends the federated series (``obs/federate.py``) after the
local registry's. A service that is one fleet replica (``shard=``) names
its ``replica_hint`` in every ``shutting_down`` shed this front-end
makes. A verify body's ``trace_parent`` (a caller's
``tracing.link_token()``) rides into the ``verifyd.request`` span; the
``/debug/trace/*`` routes are what ``FleetRouter.pull_captures`` scrapes
to build the merged fleet timeline. ``/readyz`` serves the
``HealthEngine`` (``obs/health.py``) over verifyd's SLIs and SLOs on the
service's clock, and every probe of ``obs.health.HEALTH``.
"""

from __future__ import annotations

import asyncio
import json

from aiohttp import web

from ..obs.federate import FEDERATION
from ..utils.metrics import REGISTRY
from . import protocol
from .service import Shed, VerifydClosed, VerifydService

_GRPC_SERVICE = "spacemesh.verifyd.Verifyd"

# HTTP status per shed reason: 503 only for a terminal condition the
# client should fail over from; everything else is retryable 429
_SHED_STATUS = {
    protocol.SHED_SHUTTING_DOWN: 503,
    protocol.SHED_UNREGISTERED: 403,
    protocol.SHED_REGISTRY_FULL: 429,
}


def _shed_response(exc: Shed) -> web.Response:
    return web.json_response(exc.to_doc(),
                             status=_SHED_STATUS.get(exc.reason, 429))


class VerifydServer:
    """Sockets around a :class:`VerifydService`.

    ``listen`` is the HTTP bind ("host:port", port 0 picks); pass
    ``grpc_listen`` to also serve the gRPC surface (None disables, and
    a missing grpcio disables it with a log line rather than an import
    error).  Always close in a ``finally`` — ``close()`` drains the
    service before the sockets go away.
    """

    def __init__(self, service: VerifydService | None = None,
                 listen: str = "127.0.0.1:0",
                 grpc_listen: str | None = None, **service_kw):
        from ..obs import health as health_mod
        from ..obs import sli as sli_mod

        self.service = service if service is not None \
            else VerifydService(**service_kw)
        # the engine ticks the verifyd SLI window and evaluates the
        # service SLOs on the clock admission runs on, so readiness
        # reflects windowed truth, not instantaneous luck
        self.health_engine = health_mod.HealthEngine(
            slis=sli_mod.verifyd_slis(), slos=health_mod.verifyd_slos(),
            time_source=self.service._now)
        host, _, port = listen.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 0)
        self.grpc_listen = grpc_listen
        self.web_app = web.Application()
        self._routes()
        self.runner: web.AppRunner | None = None
        self._site: web.TCPSite | None = None
        self.actual_port: int | None = None
        self.grpc_port: int | None = None
        self._grpc_server = None
        self._closed = False

    def _routes(self) -> None:
        r = self.web_app.router
        r.add_post("/v1/client/register", self.client_register)
        r.add_post("/v1/client/unregister", self.client_unregister)
        r.add_post("/v1/verify", self.verify)
        r.add_get("/v1/stats", self.stats)
        r.add_get("/v1/tune", self.tune)
        r.add_get("/metrics", self.metrics)
        r.add_get("/healthz", self.healthz)
        r.add_get("/readyz", self.readyz)
        r.add_get("/debug/trace/start", self.trace_start)
        r.add_get("/debug/trace/stop", self.trace_stop)
        r.add_get("/debug/trace/export", self.trace_export)

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> int:
        """Start the service and both listeners; returns the HTTP port
        (``grpc_port`` is set when gRPC is enabled)."""
        await self.service.start()
        self.health_engine.ensure_running()
        self.runner = web.AppRunner(self.web_app)
        await self.runner.setup()
        self._site = web.TCPSite(self.runner, self.host, self.port,
                                 reuse_address=True)
        await self._site.start()
        self.actual_port = self._site._server.sockets[0].getsockname()[1]
        if self.grpc_listen is not None:
            await self._start_grpc()
        return self.actual_port

    async def stop_listening(self) -> None:
        """Close the HTTP listener and its open connections (requests
        still running after 0.1 s are cancelled) while the service,
        its clients' registrations and its farm keep running: to a
        caller the replica is gone until :meth:`resume_listening` binds
        the same port again."""
        if self._site is None:
            return
        await self._site.stop()
        self._site = None
        await self.runner.server.shutdown(0.1)

    async def resume_listening(self) -> int:
        """Bind the HTTP listener again on the port it had."""
        if self._site is None:
            self._site = web.TCPSite(self.runner, self.host,
                                     self.actual_port, reuse_address=True)
            await self._site.start()
        return self.actual_port

    async def _start_grpc(self) -> None:
        try:
            import grpc
        except ImportError:
            import sys

            print("verifyd: grpcio unavailable; gRPC surface disabled",
                  file=sys.stderr)
            return

        def handler(method):
            async def unary(request_doc, context):
                del context
                return await method(request_doc)

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=lambda b: json.loads(b or b"{}"),
                response_serializer=lambda d: json.dumps(d).encode())

        generic = grpc.method_handlers_generic_handler(_GRPC_SERVICE, {
            "Register": handler(self._grpc_register),
            "Unregister": handler(self._grpc_unregister),
            "Verify": handler(self._grpc_verify),
            "Stats": handler(self._grpc_stats),
        })
        server = grpc.aio.server()
        server.add_generic_rpc_handlers((generic,))
        self.grpc_port = server.add_insecure_port(self.grpc_listen)
        await server.start()
        self._grpc_server = server

    async def close(self) -> None:
        """Drain the service, then tear the sockets down. Idempotent."""
        if self._closed:
            return
        self._closed = True
        await self.service.aclose()
        self.health_engine.close()
        if self._grpc_server is not None:
            await self._grpc_server.stop(grace=1.0)
            self._grpc_server = None
        if self.runner is not None:
            await self.runner.cleanup()
            self.runner = None
            self._site = None

    # -- shared handler bodies ------------------------------------------

    def _closed_shed(self, exc: VerifydClosed) -> dict:
        return Shed(protocol.SHED_SHUTTING_DOWN, str(exc),
                    replica_hint=self.service.replica_hint).to_doc()

    def _do_register(self, body: dict) -> dict:
        if not isinstance(body, dict) or "client" not in body:
            raise protocol.ProtocolError('expected {"client": id, ...}')
        kwargs = {}
        for field, conv in (("weight", float), ("rate", float),
                            ("burst", float), ("max_queued", int),
                            ("max_inflight", int)):
            if body.get(field) is not None:
                try:
                    kwargs[field] = conv(body[field])
                except (TypeError, ValueError):
                    raise protocol.ProtocolError(
                        f"{field}: expected a number") from None
        return self.service.register_client(str(body["client"]), **kwargs)

    async def _do_verify(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise protocol.ProtocolError("expected a JSON object")
        cid = body.get("client")
        if cid is None:
            raise protocol.ProtocolError('expected {"client": id, ...}')
        items = body.get("items")
        if not isinstance(items, list):
            raise protocol.ProtocolError('items: expected a list')
        reqs = [protocol.request_from_doc(doc) for doc in items]
        lane = protocol.parse_lane(body.get("lane"))
        deadline = body.get("deadline_s")
        if deadline is not None:
            try:
                deadline = float(deadline)
            except (TypeError, ValueError):
                raise protocol.ProtocolError(
                    "deadline_s: expected a number") from None
        trace_parent = body.get("trace_parent")
        verdicts = await self.service.verify(
            str(cid), reqs, lane=lane, deadline_s=deadline,
            trace_parent=(str(trace_parent) if trace_parent else None))
        return {"status": "OK", "verdicts": [bool(v) for v in verdicts]}

    # -- HTTP handlers --------------------------------------------------

    @staticmethod
    async def _body(req) -> dict:
        try:
            return await req.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(text="body must be JSON")

    async def client_register(self, req) -> web.Response:
        body = await self._body(req)
        try:
            return web.json_response(self._do_register(body))
        except protocol.ProtocolError as e:
            raise web.HTTPBadRequest(text=str(e))
        except Shed as e:
            return _shed_response(e)
        except VerifydClosed as e:
            return web.json_response(
                self._closed_shed(e),
                status=503)

    async def client_unregister(self, req) -> web.Response:
        body = await self._body(req)
        if not isinstance(body, dict) or "client" not in body:
            raise web.HTTPBadRequest(text='expected {"client": id}')
        gone = self.service.unregister_client(str(body["client"]))
        return web.json_response({"client": str(body["client"]),
                                  "unregistered": bool(gone)})

    async def verify(self, req) -> web.Response:
        body = await self._body(req)
        try:
            return web.json_response(await self._do_verify(body))
        except protocol.ProtocolError as e:
            raise web.HTTPBadRequest(text=str(e))
        except Shed as e:
            return _shed_response(e)
        except VerifydClosed as e:
            return web.json_response(
                self._closed_shed(e),
                status=503)

    async def stats(self, req) -> web.Response:
        del req
        return web.json_response(self.service.stats_doc())

    async def tune(self, req) -> web.Response:
        del req
        tuner = self.service.tuner
        kinds = ("sig", "vrf", "membership", "post", "pow")
        return web.json_response({
            "targets": {k: tuner.target_batch(k) for k in kinds},
            "rates": {k: {str(b): round(r, 1)
                          for b, r in tuner.rates(k).items()}
                      for k in kinds},
            "stats": dict(tuner.stats),
        })

    async def metrics(self, req) -> web.Response:
        del req
        return web.Response(text=REGISTRY.expose() + FEDERATION.expose(),
                            content_type="text/plain")

    # -- span-trace capture (the fleet pull plane's scrape surface) ----

    async def trace_start(self, req) -> web.Response:
        from ..utils import metrics, tracing

        try:
            capacity = req.query.get("capacity")
            capacity = int(capacity) if capacity else None
        except ValueError:
            raise web.HTTPBadRequest(text="capacity must be an integer")
        role = req.query.get("role")
        if role:
            tracing.set_process_identity(role)
        tracing.start(capacity=capacity, torch_bridge=False)
        metrics.trace_enabled_gauge.set(1)
        metrics.trace_spans_gauge.set(0)
        return web.json_response({
            "enabled": True,
            "capacity": tracing.TRACER.capacity,
            "role": tracing.process_identity()["role"],
        })

    async def trace_stop(self, req) -> web.Response:
        del req
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
        del req
        from ..utils import metrics, tracing

        metrics.trace_spans_gauge.set(tracing.TRACER.recorded())
        # a big ring materializes AND serializes slowly: both off the loop
        # (export() tolerates concurrent recording)
        body = await asyncio.to_thread(
            lambda: json.dumps(tracing.export()))
        return web.Response(text=body, content_type="application/json")

    async def healthz(self, req) -> web.Response:
        del req
        # liveness: the process serves; stalls are /readyz's job
        return web.json_response({"status": "ok",
                                  "closed": self.service._closed})

    async def readyz(self, req) -> web.Response:
        del req
        report = dict(self.health_engine.current_report())
        report["ready"] = bool(report["ready"]) and not self.service._closed
        report["service"] = self.service.stats_doc()
        return web.json_response(
            report, status=200 if report["ready"] else 503)

    # -- gRPC handlers (same docs, same semantics) ----------------------

    async def _grpc_register(self, doc: dict) -> dict:
        try:
            return {"status": "OK", **self._do_register(doc)}
        except protocol.ProtocolError as e:
            return {"status": "ERROR", "error": str(e)}
        except Shed as e:
            return e.to_doc()
        except VerifydClosed as e:
            return self._closed_shed(e)

    async def _grpc_unregister(self, doc: dict) -> dict:
        cid = doc.get("client")
        if cid is None:
            return {"status": "ERROR", "error": 'expected {"client": id}'}
        return {"status": "OK", "client": str(cid),
                "unregistered": self.service.unregister_client(str(cid))}

    async def _grpc_verify(self, doc: dict) -> dict:
        try:
            return await self._do_verify(doc)
        except protocol.ProtocolError as e:
            return {"status": "ERROR", "error": str(e)}
        except Shed as e:
            return e.to_doc()
        except VerifydClosed as e:
            return self._closed_shed(e)

    async def _grpc_stats(self, doc: dict) -> dict:
        del doc
        return {"status": "OK", **self.service.stats_doc()}
