"""verifyd — standalone verification-as-a-service (port of
``spacemesh_tpu/verifyd/``).

The in-process farm (``verify/``) promoted to a network service: a gRPC +
HTTP admission front-end that verifies signatures, VRF proofs, NIPoST
proofs, poet memberships, and k2pow witnesses for REMOTE nodes —
per-client token-bucket admission with typed load shedding, stride fair
share + EDF deadlines through the device runtime (one tenant per client),
and continuous batching with speculative batch sizing (batchtune.py)
into the farm's device batchers, on one card.

    python -m spacemesh_tpu_torch.verifyd --listen 127.0.0.1:9443

Layout: service.py (admission core), server.py (sockets; the only
module that imports aiohttp), client.py (client library), batchtune.py
(measured batch-size model), protocol.py (wire codec). ``VerifydServer``
is imported on first use, so importing this package needs no aiohttp.
Not ported yet: the multi-replica fleet (routing.py, fleet.py,
failover.py).
"""

from .batchtune import BatchTuner
from .client import RetryPolicy, VerifydClient
from .protocol import ProtocolError, request_from_doc, request_to_doc
from .service import Shed, VerifydClosed, VerifydService

__all__ = [
    "BatchTuner",
    "ProtocolError",
    "RetryPolicy",
    "Shed",
    "VerifydClient",
    "VerifydClosed",
    "VerifydServer",
    "VerifydService",
    "request_from_doc",
    "request_to_doc",
]


def __getattr__(name):
    if name == "VerifydServer":
        from .server import VerifydServer

        return VerifydServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
