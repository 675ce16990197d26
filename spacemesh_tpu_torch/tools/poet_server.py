"""Standalone poet daemon (the reference's external poet service; port of
``spacemesh_tpu/tools/poet_server.py``).

  python -m spacemesh_tpu_torch.tools.poet_server --listen 127.0.0.1:9500 \
      [--ticks 64] [--id-seed poet-1] [--round-every SECONDS]

Collects member challenges per round, performs the sequential hash-chain
work, serves proofs + membership (reference: spacemeshos/poet service;
client side activation/poet.go). With --round-every it closes the open
round on a cadence; otherwise the node drives rounds explicitly.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spacemesh_tpu_torch.tools.poet_server")
    p.add_argument("--listen", default="127.0.0.1:0")
    p.add_argument("--ticks", type=int, default=64)
    p.add_argument("--id-seed", default="poet")
    p.add_argument("--round-every", type=float, default=0.0,
                   help="close the open round every N seconds (0 = only "
                        "on explicit execute_round)")
    a = p.parse_args(argv)

    from ..consensus.poet import PoetService
    from ..consensus.poet_remote import PoetServerDaemon
    from ..core.hashing import sum256

    # the poet's sequential hash chain is pure hashlib: this process
    # touches no device
    service = PoetService(poet_id=sum256(a.id_seed.encode()),
                          ticks=a.ticks)

    async def go():
        daemon = PoetServerDaemon(service, listen=a.listen)
        host, port = await daemon.start()
        print(json.dumps({"event": "Serving", "host": host, "port": port,
                          "poet_id": service.poet_id.hex()}), flush=True)

        async def round_driver():
            n = 0
            while True:
                await asyncio.sleep(a.round_every)
                open_rounds = list(service._open)
                for rid in open_rounds:
                    result = await service.execute_round(rid)
                    print(json.dumps({
                        "event": "RoundDone", "round": rid,
                        "members": len(result.members)}), flush=True)
                n += 1

        driver = (asyncio.ensure_future(round_driver())
                  if a.round_every > 0 else None)
        try:
            await asyncio.Event().wait()
        finally:
            if driver:
                driver.cancel()
            await daemon.stop()

    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
