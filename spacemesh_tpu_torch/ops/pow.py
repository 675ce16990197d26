"""k2pow: the proof-gating proof of work, batched in PyTorch (port of
``ops/pow.py``).

    pow_hash(challenge, node_id, nonce) = SHA256(challenge || node_id
                                                 || le64(nonce))
    valid <=> pow_hash < difficulty     (32-byte big-endian compare)

The search runs batches of nonces on the device through the bounded
dispatch/retire window of ``runtime/engine.py``, each batch one launch of
the search kernel on the card (``ops/pow_cuda.py``); batched verification
is one launch of the verify kernel per batch. On the CPU both run the
plain twins. A device error raises: the JAX package's host re-hash on a
failed dispatch is not carried over. The single :func:`verify` and batches
below ``min_device`` items use hashlib, as in the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import HostCopy, resolve
from . import pow_cuda, u32
# the plain twins, under the JAX package's names
from .pow_cuda import below_targets, pow_hash_batch  # noqa: F401
from .pow_cuda import split_nonces as _split
from .sha256 import IV, sha256_compress


def _words_be(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def prefix_state(challenge: bytes, node_id: bytes) -> np.ndarray:
    """Midstate after absorbing challenge||node_id (the first block)."""
    if len(challenge) != 32 or len(node_id) != 32:
        raise ValueError("challenge and node_id must be 32 bytes")
    block = u32.from_numpy(_words_be(challenge + node_id))[:, None]
    return u32.to_numpy(sha256_compress(u32.from_numpy(IV), block)[:, 0])


def pow_hash(challenge: bytes, node_id: bytes, nonce: int) -> bytes:
    """Single hash on the host (the verification path)."""
    if len(challenge) != 32 or len(node_id) != 32:
        raise ValueError("challenge and node_id must be 32 bytes")
    return hashlib.sha256(
        challenge + node_id + int(nonce).to_bytes(8, "little")).digest()


def search(challenge: bytes, node_id: bytes, difficulty: bytes,
           *, batch: int = 1 << 16, start: int = 0,
           max_batches: int = 1 << 16, inflight: int = 2,
           tenant: str = "-", device="cuda") -> int | None:
    """Smallest nonce >= ``start`` whose pow_hash is below ``difficulty``
    (32-byte BE target), scanning ``batch`` nonces per device pass with
    ``inflight`` passes enqueued; None when exhausted. ``tenant`` labels
    the runtime metrics (``runtime/engine.py``)."""
    from ..runtime import engine

    if len(difficulty) != 32:
        raise ValueError("difficulty must be 32 bytes")
    dev = resolve(device)
    st = prefix_state(challenge, node_id)
    tgt = _words_be(difficulty)

    def dispatch(base):
        # enqueue only: the (B,) hit mask is awaited at retire
        return base, HostCopy(pow_cuda.search_batch(st, tgt, base, batch,
                                                    dev))

    def retire(ticket):
        # 0 is a valid winning nonce: the engine's early exit tests
        # `is not None`, not truthiness
        base, ok = ticket
        hits = np.nonzero(ok.get().numpy())[0]
        return int(base + int(hits[0])) if hits.size else None

    pipe = engine.Pipeline(kind="k2pow", tenant=tenant, inflight=inflight)
    return pipe.run((start + i * batch for i in range(max_batches)),
                    dispatch, retire)


def verify(challenge: bytes, node_id: bytes, difficulty: bytes,
           nonce: int) -> bool:
    return pow_hash(challenge, node_id, nonce) < difficulty


def pow_verify_batch(block1: torch.Tensor, nonce_lo: torch.Tensor,
                     nonce_hi: torch.Tensor, target_words: torch.Tensor
                     ) -> torch.Tensor:
    """Verify a (B,) batch of witnesses in one two-block SHA-256 pass.
    ``block1``: (16, B) challenge||node_id words; ``target_words``: (8, B)
    per-item difficulty. Returns (B,) bool: the verify kernel on CUDA
    tensors, its plain twin on CPU ones (``ops/pow_cuda.py:verify_batch``).
    """
    return pow_cuda.verify_batch(block1, nonce_lo, nonce_hi, target_words)


def _verify_host(items: list) -> list[bool]:
    return [hashlib.sha256(c + nid + int(nonce).to_bytes(8, "little"))
            .digest() < d for c, nid, d, nonce in items]


def verify_many(items: list, *, batch: int = 1 << 12, inflight: int = 2,
                min_device: int = 8, tenant: str = "-",
                device="cuda") -> list[bool]:
    """Batched k2pow verification of (challenge, node_id, difficulty,
    nonce) tuples; bit-identical to :func:`verify` on every item. Batches
    below ``min_device`` items skip the device (two hashlib blocks are
    cheaper than a launch sequence)."""
    n = len(items)
    if n == 0:
        return []
    for challenge, node_id, difficulty, nonce in items:
        if len(challenge) != 32 or len(node_id) != 32:
            raise ValueError("challenge and node_id must be 32 bytes")
        if len(difficulty) != 32:
            raise ValueError("difficulty must be 32 bytes")
        if not 0 <= int(nonce) < 1 << 64:
            raise ValueError("nonce must be an unsigned 64-bit integer")
    if n < min_device:
        return _verify_host(items)
    from ..runtime import engine

    dev = resolve(device)
    results = np.zeros(n, dtype=bool)

    def dispatch(rng):
        lo_i, hi_i = rng
        chunk = items[lo_i:hi_i]
        block1 = np.stack([_words_be(c + nid) for c, nid, _d, _n in chunk],
                          axis=1)
        targets = np.stack([_words_be(d) for _c, _nid, d, _n in chunk],
                           axis=1)
        lo, hi = _split(np.array([x[3] for x in chunk], dtype=np.uint64),
                        dev)
        return rng, HostCopy(pow_verify_batch(
            u32.from_numpy(block1, dev), lo, hi,
            u32.from_numpy(targets, dev)))

    def retire(ticket):
        (lo_i, hi_i), ok = ticket
        results[lo_i:hi_i] = ok.get().numpy()
        return None

    pipe = engine.Pipeline(kind="k2pow_verify", tenant=tenant,
                           inflight=inflight)
    pipe.run(((i, min(i + batch, n)) for i in range(0, n, batch)),
             dispatch, retire)
    return results.tolist()
