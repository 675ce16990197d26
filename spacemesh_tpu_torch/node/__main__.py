"""Node CLI (port of ``spacemesh_tpu/node/__main__.py``; reference
cmd/node + node.go:142 GetCommand).

  python -m spacemesh_tpu_torch.node --preset standalone [--data-dir D]
      [--config FILE.json] [--until-layer N] [--genesis-now]
      [--api] [--grpc] [--listen HOST:PORT] [--bootnode HOST:PORT ...]
      [--device cuda|cpu]

The JAX CLI's flags plus ``--device`` (default ``cuda``). Without a card
and without ``--device cpu`` it exits 2 with the device error. ``--api``
serves the JSON API on ``api.private_listener``, ``--grpc`` the public
gRPC listener on ``api.public_listener``, ``--listen`` opens the TCP (or,
with ``p2p.transport`` "quic", QUIC-lite) transport and dials each
``--bootnode``; each prints its bound port as one JSON line
(``ApiStarted``, ``GrpcStarted``, ``P2PStarted``) before the node
prepares.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spacemesh_tpu_torch.node")
    p.add_argument("--preset", default="standalone",
                   choices=["mainnet", "fastnet", "standalone"])
    p.add_argument("--config", help="JSON config file merged over the preset")
    p.add_argument("--data-dir")
    p.add_argument("--until-layer", type=int,
                   help="stop after this layer (default: run forever)")
    p.add_argument("--genesis-now", action="store_true",
                   help="set genesis time to now + one layer")
    p.add_argument("--api", action="store_true",
                   help="serve the JSON API on api.private_listener")
    p.add_argument("--grpc", action="store_true",
                   help="serve the gRPC API (spacemesh.v1 + v2alpha1) on "
                        "api.public_listener")
    p.add_argument("--listen", help="p2p listen addr (host:port; enables "
                   "the TCP transport)")
    p.add_argument("--bootnode", action="append", default=[],
                   help="bootstrap peer host:port (repeatable)")
    p.add_argument("--profile", metavar="OUT.pstats",
                   help="profile the node and dump cProfile stats on exit "
                        "(the reference's pprof analogue, node.go:2121)")
    p.add_argument("--device", default="cuda",
                   help="device for POST init, proving and verification "
                        "(cuda or cpu)")
    a = p.parse_args(argv)

    from .app import App
    from .config import load
    from . import events as events_mod
    from ..utils import logging as slog

    # SPACEMESH_LOG_JSON=1 flips this to trace-correlated JSON lines
    # (utils/logging.py JsonFormatter)
    slog.configure()

    overrides = {}
    if a.data_dir:
        overrides["data_dir"] = a.data_dir
    if a.listen:
        overrides["p2p"] = {"listen": a.listen, "bootnodes": a.bootnode}
    cfg = load(a.preset, file=a.config, overrides=overrides)
    try:
        app = App(cfg, device=a.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    async def go():
        sub = app.events.subscribe(events_mod.LayerUpdate,
                                   events_mod.AtxPublished,
                                   events_mod.PostEvent)

        async def report():
            while True:
                ev = await sub.next()
                print(json.dumps({"event": type(ev).__name__,
                                  **{k: (v.hex() if isinstance(v, bytes) else v)
                                     for k, v in ev.__dict__.items()}}),
                      flush=True)

        reporter = asyncio.ensure_future(report())
        api_started = False
        net_started = False
        try:
            if a.api:
                port = await app.start_api()
                api_started = True
                print(json.dumps({"event": "ApiStarted", "port": port}),
                      flush=True)
            if a.grpc:
                port = await app.start_public_grpc_api()
                print(json.dumps({"event": "GrpcStarted", "port": port}),
                      flush=True)
            if a.listen or cfg.p2p.bootnodes:
                addr = await app.start_network()
                net_started = True
                print(json.dumps({"event": "P2PStarted", "host": addr[0],
                                  "port": addr[1]}), flush=True)
            app.start_ops()
            await app.prepare()
            if a.genesis_now:
                # rebase the CLOCK only, after the slow prepare (POST
                # init) — the network id stays the configured one
                from . import clock as clock_mod

                app.clock = clock_mod.LayerClock(
                    # spacecheck: ok=SC001 real node boot: genesis anchors to actual wall time
                    time.time() + cfg.layer_duration, cfg.layer_duration)
            await app.run(until_layer=a.until_layer)
        finally:
            reporter.cancel()
            if net_started:
                await app.stop_network()
            if api_started:
                await app.api.stop()  # stop accepting before the DB closes
            await app.stop_grpc_api()  # may have started via worker_grpc
            app.close()

    profiler = None
    if a.profile:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()
    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    finally:
        if profiler is not None:
            profiler.disable()
            profiler.dump_stats(a.profile)
            print(json.dumps({"event": "ProfileWritten",
                              "path": a.profile}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
