"""certifier daemon CLI: issue poet certificates against POST proofs
(port of ``spacemesh_tpu/tools/certifier_server.py``; the proofs verify on
``--device``, the card by default).

The reference poet deployments front registration with a certifier
service (reference activation/certifier.go:246 Certify); this serves
consensus/certifier.py's CertifierService standalone:

  python -m spacemesh_tpu_torch.tools.certifier_server --listen 127.0.0.1:0 \
      --scrypt-n 8192 --k1 26 --k2 37 --k3 37
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="spacemesh_tpu_torch.tools.certifier_server")
    p.add_argument("--listen", default="127.0.0.1:0")
    p.add_argument("--scrypt-n", type=int, default=8192)
    p.add_argument("--k1", type=int, default=26)
    p.add_argument("--k2", type=int, default=37)
    p.add_argument("--k3", type=int, default=37)
    p.add_argument("--pow-difficulty", default="00ff" + "ff" * 30)
    p.add_argument("--validity", type=float, default=0.0,
                   help="cert lifetime seconds (0 = no expiry)")
    p.add_argument("--key-seed", default=None,
                   help="hex seed for a deterministic certifier key "
                   "(default: fresh key)")
    p.add_argument("--device", default="cuda",
                   help="where proofs verify (cpu runs the plain twins)")
    a = p.parse_args(argv)

    from ..consensus.certifier import CertifierDaemon, CertifierService
    from ..core.signing import EdSigner
    from ..post.prover import ProofParams

    signer = EdSigner(seed=bytes.fromhex(a.key_seed) if a.key_seed else None)
    service = CertifierService(
        signer,
        ProofParams(k1=a.k1, k2=a.k2, k3=a.k3,
                    pow_difficulty=bytes.fromhex(a.pow_difficulty)),
        scrypt_n=a.scrypt_n, validity=a.validity, device=a.device)

    async def go():
        daemon = CertifierDaemon(service, listen=a.listen)
        host, port = await daemon.start()
        print(json.dumps({"event": "Serving", "host": host, "port": port,
                          "pubkey": service.pubkey.hex()}), flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await daemon.stop()

    try:
        asyncio.run(go())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
