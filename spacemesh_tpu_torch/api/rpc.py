"""The PostService wire helpers (port of the part of
``spacemesh_tpu/api/rpc.py`` the worker needs).

The node serves ``spacemesh.v1.PostService/Register``; the PoST worker
dials it (``post/grpc_worker.py``). K2 label indices travel as fixed
8-byte little-endian words. Imports neither grpc nor protobuf.
"""

from __future__ import annotations

import struct

POST_REGISTER = "/spacemesh.v1.PostService/Register"


def pack_indices(indices: list[int]) -> bytes:
    """K2 label indices on the wire: fixed 8-byte LE each."""
    return b"".join(struct.pack("<Q", i) for i in indices)
