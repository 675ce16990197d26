"""Node API: the operator/client surface (port of ``spacemesh_tpu/api/``).

Mirrors the reference api/grpcserver service set (reference
api/grpcserver/config.go: Node, Mesh, GlobalState, Transaction, Smesher,
Debug, Admin, Activation services + the grpc-gateway JSON endpoint
http_server.go). Served as JSON-over-HTTP (``http.py``, aiohttp) and over
gRPC (``rpc.py`` and ``rpc_v2.py``, grpc.aio) with the same public/private
listener split.

This package itself imports neither aiohttp, grpc nor protobuf: it holds
the wire helpers the PoST worker needs (``POST_REGISTER``,
``pack_indices``, ``unpack_indices``) and ``API_VERSION``, and exports
``ApiServer`` on first use, so a worker that dials the node never loads
aiohttp.
"""

from __future__ import annotations

import struct

API_VERSION = "v0.1.0"

POST_REGISTER = "/spacemesh.v1.PostService/Register"

__all__ = ["API_VERSION", "POST_REGISTER", "ApiServer", "pack_indices",
           "unpack_indices"]


def pack_indices(indices: list[int]) -> bytes:
    """K2 label indices on the wire: fixed 8-byte LE each (the reference
    bit-packs to ceil(log2(num_labels)) bits; fixed width keeps the codec
    branch-free)."""
    return b"".join(struct.pack("<Q", i) for i in indices)


def unpack_indices(blob: bytes) -> list[int]:
    return [struct.unpack_from("<Q", blob, o)[0]
            for o in range(0, len(blob), 8)]


def __getattr__(name):
    if name == "ApiServer":
        from .http import ApiServer

        return ApiServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
