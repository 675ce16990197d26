"""The PostService seam: the node <-> PoST worker contract.

Port of ``spacemesh_tpu/post/service.py``. The contract is a small
interface with an in-process implementation; the transports
(``post/remote.py`` JSON-RPC, ``post/grpc_worker.py`` gRPC) wrap the same
interface when the worker runs out of process, so the node side is the
same either way.

Left out against the JAX package: ``PostClient.submit_proof``, which
routes a prove through the multi-tenant runtime scheduler; the port has
no scheduler yet.
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

from ..device import resolve
from .data import PostMetadata
from .prover import Proof, ProofParams, Prover


@dataclasses.dataclass
class PostInfo:
    node_id: bytes
    commitment: bytes
    num_units: int
    labels_per_unit: int
    scrypt_n: int
    vrf_nonce: int
    # durable labels on disk; < num_units * labels_per_unit while an init
    # is still in flight
    labels_written: int = 0


class PostClient:
    """What the node sees for one registered identity: ``info()`` and
    ``proof()``.

    ``device`` (default ``"cuda"``; resolved here, so a client cannot be
    made without a card unless ``"cpu"`` is asked for) and ``prove_opts``
    (the prover's knobs: pipelined, window_groups, inflight, readers,
    reader_queue; ``post/prover.py``) pass through to every Prover. Unset
    knobs fall back to the ``SPACEMESH_PROVE_*`` overrides, then the
    defaults.
    """

    def __init__(self, data_dir: str | Path, params: ProofParams | None = None,
                 batch_labels: int = 1 << 14, device="cuda", **prove_opts):
        self.data_dir = Path(data_dir)
        self.params = params or ProofParams()
        self.device = resolve(device)
        self._batch = batch_labels
        self._prove_opts = prove_opts
        self._lock = threading.Lock()

    def info(self) -> PostInfo:
        meta = PostMetadata.load(self.data_dir)
        return PostInfo(
            node_id=bytes.fromhex(meta.node_id),
            commitment=bytes.fromhex(meta.commitment),
            num_units=meta.num_units,
            labels_per_unit=meta.labels_per_unit,
            scrypt_n=meta.scrypt_n,
            vrf_nonce=meta.vrf_nonce if meta.vrf_nonce is not None else -1,
            labels_written=meta.labels_written,
        )

    def proof(self, challenge: bytes) -> tuple[Proof, PostMetadata]:
        with self._lock:  # one proving session per identity at a time
            prover = Prover(self.data_dir, self.params,
                            batch_labels=self._batch, device=self.device,
                            **self._prove_opts)
            return prover.prove(challenge), prover.meta


class PostService:
    """Worker-side registry of identities -> clients (the ``Register``
    stream's equivalent). The node looks clients up by node_id."""

    def __init__(self) -> None:
        self._clients: dict[bytes, PostClient] = {}
        self._lock = threading.Lock()

    def register(self, node_id: bytes, client: PostClient) -> None:
        with self._lock:
            self._clients[node_id] = client

    def deregister(self, node_id: bytes) -> None:
        with self._lock:
            self._clients.pop(node_id, None)

    def client(self, node_id: bytes) -> PostClient | None:
        with self._lock:
            return self._clients.get(node_id)

    def registered(self) -> list[bytes]:
        with self._lock:
            return list(self._clients)
