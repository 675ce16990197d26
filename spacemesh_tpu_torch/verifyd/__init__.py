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
module that imports aiohttp at module level), client.py (client
library), batchtune.py (measured batch-size model), protocol.py (wire
codec), routing.py (consistent-hash placement), fleet.py (multi-replica
router/verifier), failover.py (remote→local). ``VerifydServer`` is
imported on first use, so importing this package needs no aiohttp.
"""

from .batchtune import BatchTuner
from .client import RetryPolicy, VerifydClient
from .failover import FailoverVerifier
from .fleet import (FleetRouter, FleetVerifier, HttpReplicaEndpoint,
                    fleet_from_urls)
from .protocol import ProtocolError, request_from_doc, request_to_doc
from .routing import HashRing, Placement
from .service import Shed, VerifydClosed, VerifydService

__all__ = [
    "BatchTuner",
    "FailoverVerifier",
    "FleetRouter",
    "FleetVerifier",
    "HashRing",
    "HttpReplicaEndpoint",
    "Placement",
    "ProtocolError",
    "RetryPolicy",
    "Shed",
    "VerifydClient",
    "VerifydClosed",
    "VerifydServer",
    "VerifydService",
    "fleet_from_urls",
    "request_from_doc",
    "request_to_doc",
]


def __getattr__(name):
    if name == "VerifydServer":
        from .server import VerifydServer

        return VerifydServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
