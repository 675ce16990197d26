"""k2pow: the proof-gating proof of work, batched in PyTorch (port of
``ops/pow.py``).

    pow_hash(challenge, node_id, nonce) = SHA256(challenge || node_id
                                                 || le64(nonce))
    valid <=> pow_hash < difficulty     (32-byte big-endian compare)

The search runs windows of nonces through the bounded dispatch/retire
window of ``runtime/engine.py``: each window is one launch of the window
kernel on the card (``ops/pow_cuda.py:search_window``), which hashes block
1 itself and lowers a (1,) cell shared by the search's windows to the
smallest winner; retire reads that 8-byte cell. Batched verification is
one launch of the verify kernel per batch. On the CPU both run the plain
twins. A device error raises: the JAX package's host re-hash on a failed
dispatch (its engine ``fallback=``) is not carried over, on purpose: on
the card it would hide a failing kernel behind the plain twin. Each
launch runs inside the engine's ``pow.dispatch`` / ``pow_verify.dispatch``
span. The single :func:`verify` and batches below
``min_device`` items use hashlib, as in the JAX package.
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
    """Midstate after absorbing challenge||node_id (the first block), on
    the host through the plain twin: for the mask search and the tests;
    :func:`search` leaves block 1 to the window kernel."""
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


# Nonces per window: a window with no winner is about 1 ms of kernel time
# at full width on an H100, so a scheduler quantum stays short; a window is
# a whole number of the caller's batches.
WINDOW_NONCES = 1 << 24


def search(challenge: bytes, node_id: bytes, difficulty: bytes,
           *, batch: int = 1 << 16, start: int = 0,
           max_batches: int = 1 << 16, inflight: int = 2,
           tenant: str = "-", device="cuda") -> int | None:
    """Smallest nonce >= ``start`` whose pow_hash is below ``difficulty``
    (32-byte BE target) among ``batch * max_batches`` nonces; None when
    exhausted. ``batch`` is the JAX package's nonces per device pass; a
    window of whole batches (about :data:`WINDOW_NONCES`) is one launch,
    ``inflight`` windows enqueued. ``tenant`` labels the runtime metrics
    (``runtime/engine.py``)."""
    from ..runtime import engine

    if len(challenge) != 32 or len(node_id) != 32:
        raise ValueError("challenge and node_id must be 32 bytes")
    if len(difficulty) != 32:
        raise ValueError("difficulty must be 32 bytes")
    dev = resolve(device)
    block1 = _words_be(challenge + node_id)
    tgt = _words_be(difficulty)
    found = pow_cuda.new_cell(dev)
    per = max(WINDOW_NONCES // batch, 1)

    def windows():
        for first in range(0, max_batches, per):
            yield (start + first * batch,
                   min(per, max_batches - first) * batch)

    def dispatch(window):
        # enqueue only: the cell's copy right behind this window (and
        # before the next one) holds the winner of the windows up to it
        lo, n = window
        pow_cuda.search_window(block1, tgt, lo, n, found, dev)
        return lo, n, HostCopy(found)

    def retire(ticket):
        # 0 is a valid winning nonce: the engine's early exit tests
        # `is not None`, not truthiness. A value past this window is a
        # later window's winner (the CPU twin shares the cell itself).
        lo, n, cell = ticket
        best = pow_cuda.cell_value(cell.get())
        return best if lo <= best < lo + n else None

    pipe = engine.Pipeline(kind="k2pow", tenant=tenant, inflight=inflight,
                           span="pow")
    return pipe.run(windows(), dispatch, retire)


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
                           inflight=inflight, span="pow_verify")
    pipe.run(((i, min(i + batch, n)) for i in range(0, n, batch)),
             dispatch, retire)
    return results.tolist()
