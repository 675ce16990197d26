"""The proving hash, the threshold and the winning nonce, in plain PyTorch.

For challenge ``ch`` and nonce ``n``, label ``i`` qualifies when

    salsa20_8(ch(8 LE words) || n || lo32(i) || hi32(i) || 0
              || label(4 LE words))[0]  <  k1 * 2^32 // total_labels

(unsigned). A proof is the lowest nonce with at least k2 qualifying labels
and the first k2 of them in ascending order. Words are kept as int64
values below 2^32, so every add is masked explicitly. The tensors live on
whatever device the caller names; nothing here launches a kernel of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
NONCE_GROUP = 16
MAX_GROUPS = 1025  # the search gives up past this many groups of 16


def threshold(k1: int, total_labels: int) -> int:
    """Qualifying bound: on average k1 labels of the store qualify."""
    return min((k1 << 32) // total_labels, MASK)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def salsa20_8(block: torch.Tensor) -> torch.Tensor:
    """Salsa20/8 core with its final feed-forward add; ``block`` is (16, B)
    int64 words below 2^32."""
    x = [block[i].clone() for i in range(16)]

    def quarter(a: int, b: int, c: int, d: int) -> None:
        x[b] ^= _rotl((x[a] + x[d]) & MASK, 7)
        x[c] ^= _rotl((x[b] + x[a]) & MASK, 9)
        x[d] ^= _rotl((x[c] + x[b]) & MASK, 13)
        x[a] ^= _rotl((x[d] + x[c]) & MASK, 18)

    for _ in range(4):
        quarter(0, 4, 8, 12)
        quarter(5, 9, 13, 1)
        quarter(10, 14, 2, 6)
        quarter(15, 3, 7, 11)
        quarter(0, 1, 2, 3)
        quarter(5, 6, 7, 4)
        quarter(10, 11, 8, 9)
        quarter(15, 12, 13, 14)
    return (torch.stack(x) + block) & MASK


def _words_le(data: np.ndarray) -> np.ndarray:
    """(B, 4k) uint8 -> (k, B) int64 little-endian words."""
    return np.ascontiguousarray(data).view("<u4").astype(np.int64).T


def qualifying_counts(challenge: bytes, nonce0: int, count: int,
                      labels: np.ndarray, thr: int, device
                      ) -> torch.Tensor:
    """(count, B) bool: which of ``labels`` (B, 16) qualify under each of
    the ``count`` nonces from ``nonce0``."""
    b = labels.shape[0]
    dev = torch.device(device)
    ch = torch.as_tensor(_words_le(np.frombuffer(challenge, np.uint8)[None])
                         [:, 0], device=dev)
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    lab = torch.as_tensor(_words_le(labels), device=dev)
    nonces = torch.arange(nonce0, nonce0 + count, dtype=torch.int64,
                          device=dev)
    lanes = count * b
    state = torch.empty((16, lanes), dtype=torch.int64, device=dev)
    state[:8] = ch[:, None]
    state[8] = nonces.repeat_interleave(b)
    state[9] = (idx & MASK).repeat(count)
    state[10] = (idx >> 32).repeat(count)
    state[11] = 0
    state[12:] = lab.repeat(1, count)
    return (salsa20_8(state)[0] < thr).reshape(count, b)


def prove(challenge: bytes, labels: np.ndarray, k1: int, k2: int,
          device="cpu", max_nonce: int | None = None):
    """(nonce, first k2 indices) of the proof over ``labels``, the whole
    store from index 0, or None when no nonce below ``max_nonce`` (the
    program's give-up bound by default) has k2 qualifying labels."""
    thr = threshold(k1, labels.shape[0])
    stop = MAX_GROUPS * NONCE_GROUP if max_nonce is None else max_nonce
    for n0 in range(0, stop, NONCE_GROUP):
        q = qualifying_counts(challenge, n0, min(NONCE_GROUP, stop - n0),
                              labels, thr, device)
        hits = q.sum(1)
        won = torch.nonzero(hits >= k2)
        if won.numel():
            row = int(won[0, 0])
            idx = torch.nonzero(q[row])[:k2, 0]
            return n0 + row, [int(i) for i in idx.cpu()]
    return None
