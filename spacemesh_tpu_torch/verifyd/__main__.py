"""CLI: boot a verifyd server (port of ``spacemesh_tpu/verifyd/__main__.py``).

    python -m spacemesh_tpu_torch.verifyd [--listen 127.0.0.1:0]
        [--grpc-listen 127.0.0.1:0] [--max-clients N]
        [--max-pending N] [--rate R] [--burst B] [--workers N]
        [--max-batch N] [--device cuda]

The JAX CLI's flags plus ``--device`` (default ``cuda``). Without a card
and without ``--device cpu`` it exits 2 with the device error, as the
PoST worker's CLI does. Needs aiohttp (the HTTP surface).

Prints one JSON line with the bound ports on stdout once serving, then
runs until SIGINT/SIGTERM; shutdown drains admitted work before the
sockets close.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys



def _post_params(args):
    """POST proof params are CONSENSUS parameters: the server must
    verify with the same k1/k2/k3/pow-difficulty its clients prove
    under, or honest proofs fail. None = the mainnet defaults."""
    from ..post.prover import ProofParams

    defaults = ProofParams()
    if (args.post_k1 is None and args.post_k2 is None
            and args.post_k3 is None
            and args.post_pow_difficulty is None):
        return None
    return ProofParams(
        k1=args.post_k1 if args.post_k1 is not None else defaults.k1,
        k2=args.post_k2 if args.post_k2 is not None else defaults.k2,
        k3=args.post_k3 if args.post_k3 is not None else defaults.k3,
        pow_difficulty=(bytes.fromhex(args.post_pow_difficulty)
                        if args.post_pow_difficulty is not None
                        else defaults.pow_difficulty))


async def serve(args) -> int:
    from .server import VerifydServer

    server = VerifydServer(
        listen=args.listen, grpc_listen=args.grpc_listen,
        max_clients=args.max_clients,
        max_pending_items=args.max_pending,
        default_rate=args.rate, default_burst=args.burst,
        workers=args.workers, max_batch=args.max_batch,
        post_params=_post_params(args),
        genesis_id=(bytes.fromhex(args.genesis_id)
                    if args.genesis_id is not None else None),
        device=args.device)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # non-unix embedders
            pass
    try:
        port = await server.start()
        print(json.dumps({"listening": f"{server.host}:{port}",
                          "grpc": server.grpc_port}), flush=True)
        await stop.wait()
    finally:
        await server.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spacemesh_tpu_torch.verifyd",
        description="verification-as-a-service front-end")
    ap.add_argument("--listen", default="127.0.0.1:0",
                    help="HTTP bind host:port (port 0 picks)")
    ap.add_argument("--grpc-listen", default=None,
                    help="also serve gRPC on host:port (default: off)")
    ap.add_argument("--max-clients", type=int, default=64)
    ap.add_argument("--max-pending", type=int, default=1 << 15,
                    help="global admitted-items bound")
    ap.add_argument("--rate", type=float, default=5000.0,
                    help="default per-client weighted items/s")
    ap.add_argument("--burst", type=float, default=10000.0,
                    help="default per-client token-bucket depth")
    ap.add_argument("--workers", type=int, default=4,
                    help="scheduler worker threads")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="farm device batch cap")
    ap.add_argument("--post-k1", type=int, default=None,
                    help="POST k1 (default: mainnet)")
    ap.add_argument("--post-k2", type=int, default=None,
                    help="POST k2 (default: mainnet)")
    ap.add_argument("--post-k3", type=int, default=None,
                    help="POST k3 spot-check count (default: mainnet)")
    ap.add_argument("--post-pow-difficulty", default=None,
                    help="POST k2pow difficulty, 64 hex chars "
                         "(default: mainnet)")
    ap.add_argument("--genesis-id", default=None,
                    help="network genesis id, hex: signatures are made "
                         "over genesis_id||domain||msg, so a replica "
                         "must verify under its clients' network "
                         "prefix (default: empty prefix)")
    ap.add_argument("--device", default="cuda",
                    help="where the POST and k2pow kinds run "
                         "(default: cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    from ..device import resolve

    try:
        resolve(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"verifyd: {e}", file=sys.stderr)
        return 2
    try:
        return asyncio.run(serve(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
