"""scrypt (N, r=1, p=1) labels in PyTorch: the PoST labeling function.

Port of ``spacemesh_tpu/ops/scrypt.py``. A label is

    label(commitment, i) = scrypt(password=commitment, salt=le64(i),
                                  N=n, r=1, p=1, dklen=16)

bit-exact against ``hashlib.scrypt``. The pipeline is three kernels on
the card, each with its plain twin on the CPU: PBKDF2-HMAC-SHA256 expand
(``ops/pbkdf2_cuda.py``) -> ROMix (``ops/romix_cuda.py``) -> PBKDF2 finish
(``ops/pbkdf2_cuda.py``), then optionally the VRF min-scan
(:func:`_minscan`, tensor code). The verifier's recompute
(:func:`scrypt_labels_hash`) ends in finish with the proving hash as its
epilogue instead.
Block state is (32, B) int32 bit patterns, lanes trailing, as in the JAX
package. Each label entry point takes the autotuned decision for its
batch (``ops/autotune.py:decide``, at the batch's own size: the JAX
package's ``shape_bucket`` is not ported, and ragged batches run at their
own size, so the sanitizer's ``jit-shape`` hook has no call site here);
the decision's lane chunk is ROMix's ``max_lanes``. A caller that has
decided already (the striped entry points of ``parallel/mesh.py``) passes
``chunk`` itself. The JAX package's row-major ROMix variant and its
Pallas fallback exist for XLA and the TPU; the port has one kernel.

Each batch's launches run inside a ``romix.dispatch`` span (the enqueue;
the kernels' device time shows in a ``torch.profiler`` capture, which the
``SPACEMESH_TRACE_TORCH`` bridge lines the spans up against).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing
from . import pbkdf2_cuda, romix_cuda, u32
from .romix_cuda import check_n as _check_n
from .romix_cuda import romix_r1  # noqa: F401  (the plain ROMix, re-exported)
from .salsa import blockmix_r1, salsa20_8  # noqa: F401  (re-exported)
from .sha256 import byteswap32
from .u32 import flip, s32

LABEL_BYTES = 16  # reference: 16-byte labels, 2^32 per 64 GiB unit


def _dispatch_span(n: int, idx_lo, **attrs):
    return tracing.span("romix.dispatch",
                        {"n": n, "batch": int(idx_lo.shape[0]), **attrs}
                        if tracing.is_enabled() else None)


TUNED = "tuned"  # ``chunk=TUNED``: take the autotuned decision


def _chunk(chunk, n: int, idx_lo) -> int | None:
    """ROMix's ``max_lanes`` for one batch: the caller's, or the autotuned
    decision's lane chunk (None: the wrapper's memory cap)."""
    if chunk != TUNED:
        return chunk
    from . import autotune

    return autotune.decide(n, int(idx_lo.shape[0]),
                           platform=idx_lo.device.type).chunk


def scrypt_labels_words(commitment_words, idx_lo, idx_hi, *, n: int,
                        chunk=TUNED) -> torch.Tensor:
    """Labels for (B,) index halves -> (4, B) int32 BE words (batch minor);
    the port of ``scrypt_labels_jit``. Runs on the inputs' device: on the
    card, as three kernel launches (ROMix as one launch per ``chunk``
    lanes)."""
    with _dispatch_span(n, idx_lo):
        max_lanes = _chunk(chunk, n, idx_lo)
        blk = pbkdf2_cuda.expand(commitment_words, idx_lo, idx_hi)
        blk = romix_cuda.romix(blk, n, max_lanes=max_lanes)
        return pbkdf2_cuda.finish(commitment_words, blk)


def scrypt_labels_hash(commitment_words, idx_lo, idx_hi, challenge_words,
                       nonce, *, n: int, words_out: bool = False,
                       chunk=TUNED):
    """Labels for (B,) index halves and the proving hash of each: the
    verifier's recompute. Returns the (B,) int32 hash values and, with
    ``words_out``, the (4, B) int32 BE label words (else None). On the
    card three launches: PBKDF2 expand, ROMix, then PBKDF2 finish with the
    hash as its epilogue (``ops/pbkdf2_cuda.py:finish_hash``).
    ``challenge_words`` and ``nonce`` as ``ops/proving_cuda.py``'s
    proving hash takes them."""
    with _dispatch_span(n, idx_lo, hash=True):
        max_lanes = _chunk(chunk, n, idx_lo)
        blk = pbkdf2_cuda.expand(commitment_words, idx_lo, idx_hi)
        blk = romix_cuda.romix(blk, n, max_lanes=max_lanes)
        return pbkdf2_cuda.finish_hash(commitment_words, blk,
                                       challenge_words, nonce, idx_lo,
                                       idx_hi, words_out=words_out)


def scrypt_labels_packed(commitment_words, idx_lo, idx_hi, *,
                         n: int, chunk=TUNED) -> torch.Tensor:
    """Labels of a multi-tenant pack: (8, B) per-lane commitment words and
    (B,) index halves -> (4, B) int32 BE words, with no VRF min-scan (the
    scheduler folds each tenant's minimum on the host). On the card: PBKDF2
    expand with midstates per lane, ROMix, PBKDF2 finish."""
    b = idx_lo.shape[0]
    if tuple(commitment_words.shape) != (8, b):
        raise ValueError(f"packed labels take (8, {b}) per-lane commitment "
                         f"words, got {tuple(commitment_words.shape)}")
    return scrypt_labels_words(commitment_words, idx_lo, idx_hi, n=n,
                               chunk=chunk)


# --- VRF-nonce scan ---------------------------------------------------------
#
# The VRF nonce is the index of the numerically smallest LE-u128 label seen
# during init, folded batch by batch into a (6,) carry that stays on the
# device:
#
#   carry = [k3, k2, k1, k0, idx_hi, idx_lo]
#
# k3..k0 are the u32 limbs of the LE-u128 label key, most significant first
# (so a lexicographic limb compare is the u128 compare), and idx is the u64
# global label index of that minimum. Ties keep the earlier index.

VRF_CARRY_WORDS = 6
_U32_MAX = 0xFFFFFFFF


def vrf_carry_init(best: tuple[int, int] | None = None,
                   index: int = 0) -> np.ndarray:
    """Fresh (or resumed) host-side carry. ``best`` is the (hi, lo) u64
    halves of the current minimum label value, as stored in metadata."""
    c = np.full((VRF_CARRY_WORDS,), _U32_MAX, dtype=np.uint32)
    if best is not None:
        hi, lo = best
        c[0] = hi >> 32
        c[1] = hi & _U32_MAX
        c[2] = lo >> 32
        c[3] = lo & _U32_MAX
        c[4] = index >> 32
        c[5] = index & _U32_MAX
    return c


def vrf_carry_decode(carry) -> tuple[int, tuple[int, int]] | None:
    """Carry (numpy u32 or int32 tensor) -> (index, (hi, lo)) or None when
    no label has been scanned."""
    c = u32.to_numpy(carry) if isinstance(carry, torch.Tensor) \
        else np.asarray(carry)
    hi = int(c[0]) << 32 | int(c[1])
    lo = int(c[2]) << 32 | int(c[3])
    if hi == (_U32_MAX << 32 | _U32_MAX) and lo == hi:
        return None
    return int(c[4]) << 32 | int(c[5]), (hi, lo)


def _minscan(words, idx_lo, idx_hi, carry):
    """Fold one (4, B) BE label batch into the carry. Returns
    ``(new_carry, snapshot)``; the snapshot is an independent buffer.

    Limbs are compared through :func:`u32.flip`, which maps u32 order onto
    int32 order; the limb values themselves are stored unflipped."""
    # LE-u128 key limbs: byteswap gives the LE u32 limbs of the BE word
    # groups (word 3 the most significant), flipped for the compares; one
    # op each over all four limbs, since each op is a host dispatch
    f0, f1, f2, f3 = flip(byteswap32(words)).unbind(0)
    top = s32(_U32_MAX ^ 0x80000000)  # flip(0xFFFFFFFF)
    m3 = f3.min()
    eq = f3 == m3
    m2 = torch.where(eq, f2, top).min()
    eq = eq & (f2 == m2)
    m1 = torch.where(eq, f1, top).min()
    eq = eq & (f1 == m1)
    m0 = torch.where(eq, f0, top).min()
    eq = eq & (f0 == m0)
    b = f3.shape[0]
    lanes = torch.arange(b, device=words.device)
    # a (1,) index: indexing with a 0-d tensor would sync with the host
    lane = torch.where(eq, lanes, b).min().view(1)
    best = torch.stack([m3, m2, m1, m0])
    batch = torch.cat([flip(best), idx_hi.index_select(0, lane),
                       idx_lo.index_select(0, lane)])
    c3, c2, c1, c0 = flip(carry[:4]).unbind(0)
    lt = ((m3 < c3)
          | ((m3 == c3) & ((m2 < c2)
             | ((m2 == c2) & ((m1 < c1)
                | ((m1 == c1) & (m0 < c0)))))))
    new = torch.where(lt, batch, carry)
    return new, new.clone()


def scrypt_labels_with_min(commitment_words, idx_lo, idx_hi, carry, *,
                           n: int, chunk=TUNED):
    """Label batch + running VRF minimum, all on the inputs' device.

    Returns ``(words, new_carry, snapshot)``: (4, B) BE label words, the
    next carry, and an independent copy of it that a caller may keep
    while the carry rolls on to later batches."""
    words = scrypt_labels_words(commitment_words, idx_lo, idx_hi, n=n,
                                chunk=chunk)
    new_carry, snapshot = _minscan(words, idx_lo, idx_hi, carry)
    return words, new_carry, snapshot


# --- host helpers -------------------------------------------------------------


def commitment_to_words(commitment: bytes) -> np.ndarray:
    if len(commitment) != 32:
        raise ValueError("commitment must be 32 bytes")
    return np.frombuffer(commitment, dtype=">u4").astype(np.uint32)


def split_indices(indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    indices = np.asarray(indices, dtype=np.uint64)
    lo = (indices & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (indices >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def labels_to_bytes(words) -> bytes:
    """(4, B) u32 BE word batch (numpy or int32 tensor) -> concatenated
    16-byte labels."""
    if isinstance(words, torch.Tensor):
        words = u32.to_numpy(words)
    return np.asarray(words, dtype=np.uint32).T.astype(">u4").tobytes()


def labels_to_words(labels: np.ndarray) -> np.ndarray:
    """(B, 16) uint8 labels -> (4, B) u32 LE words (proving-hash input)."""
    return (np.ascontiguousarray(labels).view("<u4").reshape(-1, 4).T
            .astype(np.uint32))


def _run(cw: np.ndarray, indices: np.ndarray, n: int, device) -> np.ndarray:
    """Shared tail: split indices, run the pipeline, pack (B, 16) bytes."""
    from ..device import resolve

    dev = resolve(device)
    if indices.size == 0:
        return np.zeros((0, LABEL_BYTES), dtype=np.uint8)
    lo, hi = split_indices(indices)
    words = scrypt_labels_words(u32.from_numpy(cw, dev),
                                u32.from_numpy(lo, dev),
                                u32.from_numpy(hi, dev), n=n)
    out = np.frombuffer(labels_to_bytes(words), dtype=np.uint8)
    return out.reshape(-1, LABEL_BYTES)


def scrypt_labels_multi(commitments: np.ndarray, indices, *, n: int = 8192,
                        device="cuda") -> np.ndarray:
    """Labels for (commitment[i], index[i]) pairs in one pass.

    ``commitments``: (B, 32) uint8. The batched verifier recomputes labels
    of many smeshers at once through this."""
    _check_n(n)
    commitments = np.ascontiguousarray(np.asarray(commitments,
                                                  dtype=np.uint8))
    if commitments.ndim != 2 or commitments.shape[1] != 32:
        raise ValueError("commitments must be (B, 32) bytes")
    indices = np.atleast_1d(np.asarray(indices)).ravel()
    if indices.shape[0] != commitments.shape[0]:
        raise ValueError("commitments and indices must have equal batch size")
    cw = commitments.view(">u4").astype(np.uint32).T  # (8, B)
    return _run(cw, indices, n, device)


def scrypt_labels(commitment: bytes, indices, *, n: int = 8192,
                  device="cuda") -> np.ndarray:
    """Labels for ``indices`` (any u64 array). Returns (B, 16) uint8."""
    _check_n(n)
    indices = np.atleast_1d(np.asarray(indices)).ravel()
    return _run(commitment_to_words(commitment), indices, n, device)
