"""PBKDF2-HMAC-SHA256 around ROMix: the CUDA kernel on the card, its plain
twins on the CPU.

scrypt (N, r=1, p=1) wraps ROMix in two PBKDF2-HMAC-SHA256 calls with the
commitment as the password: :func:`expand` turns a label index into the
(32, B) block ROMix takes, and :func:`finish` turns ROMix's output into
the (4, B) label words. The kernel is ``csrc/pbkdf2.cu``, one source with
one entry point for each (the SHA-256 rounds in ``csrc/sha256.cuh``).
Each derives the HMAC midstates from the raw commitment words itself, so
only the block and the label words pass through device memory: once per
block, into shared memory, for a shared commitment; per lane otherwise,
split over a pair of threads in expand. Expand runs four threads per lane,
one for each of its independent output blocks; finish, a serial chain,
one.

It replaces no Pallas kernel: the JAX package compiles this envelope into
one XLA program around its ROMix kernel
(``spacemesh_tpu/ops/scrypt.py::_labels_fused``, :440-450). What bounds it
on an H100: 8 SHA-256 compressions per lane in expand and 4 in finish,
plus the 2 of the HMAC midstates once per batch for a shared commitment
or once per lane for per-lane ones (:data:`COMPRESS_OPS` integer
operations each, :func:`int_ops`), against at most 176 bytes per lane
(:func:`io_bytes`). So the operations bound it, about 0.015 ms for both
at 32768 lanes with one commitment.

:func:`finish_hash` is finish with the PoST proving hash as its epilogue,
the verifier's recompute: each lane's thread hashes the label words it
holds in registers (challenge, nonce, index, label: one Salsa20/8) and
writes the (B,) values, the label words only when asked. It replaces the
verifier's separate proving-hash launch (``ops/proving_cuda.py``,
``spacemesh_tpu/ops/proving.py::proving_hash_jit`` in the JAX package);
the hash adds :func:`~.proving_cuda.hash_int_ops` operations and 36 bytes
read per lane to finish's bound.

:func:`expand`, :func:`finish` and :func:`finish_hash` take the kernel for
CUDA tensors and the plain twins (:func:`_expand`, :func:`_pbkdf2_second`,
ported from the JAX package, and ``proving_hash_plain``) only for CPU
tensors; a kernel that fails to build or launch raises.
``expand_launches``, ``finish_launches`` and ``finish_hash_launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, u32
from .proving_cuda import hash_int_ops, hash_operands, proving_hash_plain
from .sha256 import byteswap32, hmac_midstates, sha256_compress
from .u32 import DTYPE

expand_launches = 0
finish_launches = 0
finish_hash_launches = 0

# integer operations of one SHA-256 compression on sm_90. Counted by hand,
# with LOP3 doing any three-input logic (a three-way xor, Ch, Maj) and
# IADD3 adding three values: 48 schedule words of 10 (two sigmas of 2
# rotates, a shift and a LOP3; 2 IADD3), 64 rounds of 14 (two Sigmas of 3
# rotates and a LOP3, Ch 1, Maj 1, 4 IADD3) and 8 feed-forward adds, 1384.
# The built kernel spends fewer where message words are constant padding:
# finish's 6 compressions take 7860 SASS instructions besides its loads,
# byteswaps, addressing and control, 1310 each (tools/romix_probe.py on
# sm_90a). The bound takes the smaller.
COMPRESS_OPS = 1310
MIDSTATE_COMPRESSIONS = 2         # HMAC inner and outer key blocks
LANE_COMPRESSIONS = {"expand": 4 * 2,   # 4 x (inner, outer)
                     "finish": 3 + 1,   # 3 inner blocks, outer
                     "finish_hash": 3 + 1}


def int_ops(lanes: int, entry: str, per_lane_commitment: bool) -> int:
    """Integer operations of ``entry`` ("expand", "finish" or
    "finish_hash") over ``lanes`` lanes: its compressions, the midstates'
    once per commitment (once for the batch when it shares one), and for
    finish_hash one proving hash per lane."""
    keys = lanes if per_lane_commitment else 1
    hashes = hash_int_ops(lanes) if entry == "finish_hash" else 0
    return (lanes * LANE_COMPRESSIONS[entry]
            + keys * MIDSTATE_COMPRESSIONS) * COMPRESS_OPS + hashes


def io_bytes(lanes: int, entry: str, per_lane_commitment: bool) -> int:
    """Bytes ``entry`` must move: the commitment (once, or once per lane),
    then expand reads two index words and writes 32 block words per lane,
    finish reads 32 block words and writes 4 label words per lane, and
    finish_hash reads the block, two index words and the challenge and
    nonce (per lane with per-lane commitments, else once) and writes one
    value per lane (the label words only when asked for)."""
    per = lanes if per_lane_commitment else 1
    if entry == "finish_hash":
        return 32 * per + 36 * per + lanes * (128 + 8 + 4)
    return 32 * per + lanes * {"expand": 8 + 128, "finish": 128 + 16}[entry]


# --- plain twins (spacemesh_tpu/ops/scrypt.py) --------------------------------


def _const(rows: dict[int, int], height: int, b: int, device) -> torch.Tensor:
    """A (height, b) int32 block of constant words (``rows``: index -> u32)."""
    col = np.zeros((height, 1), dtype=np.uint32)
    for i, v in rows.items():
        col[i, 0] = v
    return u32.from_numpy(col, device).expand(height, b)


def _hmac_finish(outer_mid, inner_digest):
    """Outer HMAC compression over a 32-byte inner digest batch (8, B)."""
    b = inner_digest.shape[1]
    tail = _const({0: 0x80000000, 7: (64 + 32) * 8}, 8, b,
                  inner_digest.device)
    return sha256_compress(outer_mid, torch.cat([inner_digest, tail]))


def _pbkdf2_first(inner_mid, outer_mid, idx_lo, idx_hi):
    """PBKDF2(pw, salt=le64(index), c=1, dklen=128) -> (32, B) LE words."""
    b = idx_lo.shape[0]
    salt = torch.stack([byteswap32(idx_lo), byteswap32(idx_hi)])
    out = []
    for i in (1, 2, 3, 4):
        # message = salt le64(index) || be32(i), then SHA padding
        tail = _const({0: i, 1: 0x80000000, 13: (64 + 12) * 8}, 14, b,
                      idx_lo.device)
        block = torch.cat([salt, tail])
        out.append(_hmac_finish(outer_mid, sha256_compress(inner_mid, block)))
    return byteswap32(torch.cat(out))  # repack BE digests as LE words


def _pbkdf2_second(inner_mid, outer_mid, b_le):
    """PBKDF2(pw, salt=B'||be32(1), c=1) -> 32-byte digests, (8, B) BE."""
    b = b_le.shape[1]
    st = sha256_compress(inner_mid, byteswap32(b_le[0:16]))
    st = sha256_compress(st, byteswap32(b_le[16:32]))
    tail = _const({0: 1, 1: 0x80000000, 15: (64 + 132) * 8}, 16, b,
                  b_le.device)
    st = sha256_compress(st, tail)
    return _hmac_finish(outer_mid, st)


def _midstates(commitment_words):
    """HMAC midstates of (8,) or (8, B) key words, as (8, 1) or (8, B)."""
    inner_mid, outer_mid = hmac_midstates(commitment_words)
    if inner_mid.dim() == 1:
        inner_mid = inner_mid[:, None]
        outer_mid = outer_mid[:, None]
    return inner_mid, outer_mid


def _expand(commitment_words, idx_lo, idx_hi):
    # commitment_words: (8,) shared across the batch, or (8, B) per lane
    inner_mid, outer_mid = _midstates(commitment_words)
    return inner_mid, outer_mid, _pbkdf2_first(inner_mid, outer_mid,
                                               idx_lo, idx_hi)


# --- the kernel -----------------------------------------------------------------


def _check(cw: torch.Tensor, b: int, *lane_tensors) -> tuple:
    """Validate the key words against a batch of ``b`` lanes; returns
    (device, (word stride, lane stride) of the contiguous key words).
    Each tensor attribute is read once: on the card path every read is a
    host-side torch call per batch."""
    dev, shape, dtype = cw.device, cw.shape, cw.dtype
    if dtype != DTYPE or shape not in ((8,), (8, b)):
        raise ValueError(f"commitment_words must be (8,) or (8, {b}) int32, "
                         f"got {tuple(shape)} {dtype}")
    for t in lane_tensors:
        if t.dtype != DTYPE or t.device != dev:
            raise ValueError("PBKDF2 inputs must be int32 on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"PBKDF2: unsupported device {dev}")
    return dev, ((1, 0) if len(shape) == 1 else (b, 1))


def _lib(entry: str):
    fn = getattr(_build.load("pbkdf2"), f"pbkdf2_{entry}_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        key = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        if entry == "finish_hash":
            fn.argtypes = (key + [ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_void_p]
                           + [ctypes.c_longlong] * 2
                           + [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_uint32] + [ctypes.c_void_p] * 4)
        else:
            ptrs = 3 if entry == "expand" else 2  # data pointers after cw
            fn.argtypes = (key + [ctypes.c_void_p] * ptrs
                           + [ctypes.c_longlong, ctypes.c_void_p])
    return fn


def expand(commitment_words: torch.Tensor, idx_lo: torch.Tensor,
           idx_hi: torch.Tensor) -> torch.Tensor:
    """PBKDF2-HMAC-SHA256(commitment, le64(index), 1, 128) for (B,) index
    halves: the (32, B) int32 LE block ROMix takes. ``commitment_words``
    is (8,) shared or (8, B) per lane, BE words."""
    global expand_launches
    shape = idx_lo.shape
    if len(shape) != 1 or idx_hi.shape != shape:
        raise ValueError("idx_lo and idx_hi must be (B,)")
    b = shape[0]
    dev, strides = _check(commitment_words, b, idx_lo, idx_hi)
    if dev.type == "cpu":
        return _expand(commitment_words, idx_lo, idx_hi)[2]
    cw = commitment_words.contiguous()
    idx_lo, idx_hi = idx_lo.contiguous(), idx_hi.contiguous()
    out = torch.empty((32, b), dtype=DTYPE, device=dev)
    if b == 0:
        return out
    fn = _lib("expand")
    with torch.cuda.device(dev):
        err = fn(cw.data_ptr(), *strides, idx_lo.data_ptr(),
                 idx_hi.data_ptr(), out.data_ptr(), b,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            expand_launches += 1
        _build.check(err, "pbkdf2_expand_launch")
    return out


def finish(commitment_words: torch.Tensor, blk: torch.Tensor
           ) -> torch.Tensor:
    """PBKDF2-HMAC-SHA256(commitment, B', 1, 32) over a (32, B) int32 LE
    ROMix output: the first 16 bytes, as (4, B) int32 BE label words."""
    global finish_launches
    shape = blk.shape
    if len(shape) != 2 or shape[0] != 32:
        raise ValueError(f"blk must be (32, B), got {tuple(shape)}")
    b = shape[1]
    dev, strides = _check(commitment_words, b, blk)
    if dev.type == "cpu":
        inner_mid, outer_mid = _midstates(commitment_words)
        return _pbkdf2_second(inner_mid, outer_mid, blk)[:4]
    cw = commitment_words.contiguous()
    blk = blk.contiguous()
    out = torch.empty((4, b), dtype=DTYPE, device=dev)
    if b == 0:
        return out
    fn = _lib("finish")
    with torch.cuda.device(dev):
        err = fn(cw.data_ptr(), *strides, blk.data_ptr(), out.data_ptr(), b,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            finish_launches += 1
        _build.check(err, "pbkdf2_finish_launch")
    return out


def finish_hash(commitment_words: torch.Tensor, blk: torch.Tensor,
                challenge_words: torch.Tensor, nonce, idx_lo: torch.Tensor,
                idx_hi: torch.Tensor, *, words_out: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`finish` over a (32, B) int32 LE ROMix output, then the
    proving hash of each lane's label: ``challenge_words`` (8,) shared or
    (8, B) per lane, ``nonce`` a u32 int or a (B,) or one-element tensor,
    ``idx_lo``/``idx_hi`` the (B,) index halves. Returns the (B,) int32
    hash values and, with ``words_out``, the (4, B) BE label words (else
    None). One kernel launch on CUDA tensors; on CPU tensors the plain
    finish, then ``proving_hash_plain`` over its big-endian words."""
    global finish_hash_launches
    shape = blk.shape
    if len(shape) != 2 or shape[0] != 32:
        raise ValueError(f"blk must be (32, B), got {tuple(shape)}")
    b = shape[1]
    if idx_lo.shape != (b,):
        raise ValueError(f"idx_lo must be ({b},)")
    dev, strides = _check(commitment_words, b, blk, idx_lo, idx_hi)
    if dev.type == "cpu":
        words = _pbkdf2_second(*_midstates(commitment_words), blk)[:4]
        values = proving_hash_plain(challenge_words, nonce, idx_lo, idx_hi,
                                    words, big_endian=True)
        return values, (words if words_out else None)
    ch, ch_strides, (nv, nls, nval) = hash_operands(
        challenge_words, nonce, idx_lo, idx_hi, blk)
    cw = commitment_words.contiguous()
    blk = blk.contiguous()
    idx_lo, idx_hi = idx_lo.contiguous(), idx_hi.contiguous()
    values = torch.empty(b, dtype=DTYPE, device=dev)
    words = (torch.empty((4, b), dtype=DTYPE, device=dev) if words_out
             else None)
    if b == 0:
        return values, words
    fn = _lib("finish_hash")
    with torch.cuda.device(dev):
        err = fn(cw.data_ptr(), *strides, blk.data_ptr(),
                 None if words is None else words.data_ptr(), b,
                 ch.data_ptr(), *ch_strides,
                 None if nv is None else nv.data_ptr(), nls, nval,
                 idx_lo.data_ptr(), idx_hi.data_ptr(), values.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            finish_hash_launches += 1
        _build.check(err, "pbkdf2_finish_hash_launch")
    return values, words
