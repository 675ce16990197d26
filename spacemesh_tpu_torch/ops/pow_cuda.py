"""k2pow hashing: the CUDA kernels on the card, their plain twins on the CPU.

Two entry points of ``csrc/k2pow.cu``, one thread per nonce or witness:

- :func:`search_batch`: the prover's nonce scan. ``count`` nonces from a
  u64 ``base`` against one (challenge, node_id) prefix midstate and one
  target, each one SHA-256 compression over the second block built in
  registers and the big-endian 256-bit compare: the (count,) hit mask,
  ``below_targets(pow_hash_batch(...))``. It replaces the XLA programs of
  ``spacemesh_tpu/ops/pow.py::pow_hash_batch_jit`` (:39) and
  ``below_target_jit``, which have no Pallas kernel.
- :func:`verify_batch`: the verification farm's batch of witnesses, each
  with its own block 1, nonce and target: two compressions and the compare
  per item, ``pow_verify_batch``. It replaces
  ``spacemesh_tpu/ops/pow.py::pow_verify_batch_jit`` (:190; XLA, no
  Pallas kernel).

What bounds them on an H100: :data:`~.pbkdf2_cuda.COMPRESS_OPS` integer
operations per compression (:func:`int_ops`) against one byte written per
nonce, or 105 bytes moved per witness (:func:`io_bytes`): the instruction
rate.

Both take the kernel for CUDA tensors (the search: for a CUDA ``device``,
since its inputs are host words) and the plain twins (:func:`search_plain`,
:func:`verify_plain`, built from :func:`pow_hash_batch` and
:func:`below_targets`, ported from the JAX package) only on the CPU; a
kernel that fails to build or launch raises. ``search_launches`` and
``verify_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, u32
from .pbkdf2_cuda import COMPRESS_OPS
from .sha256 import byteswap32, iv_tensor, sha256_compress
from .u32 import DTYPE, flip

search_launches = 0
verify_launches = 0

# Message layout: challenge(32) || node_id(32) || le64(nonce) = 72 bytes
# -> two 64-byte blocks with FIPS padding in the second.
_BIT_LEN = 72 * 8
COMPARE_OPS = 16  # the 8-word compare: a compare and a select per word


def int_ops(items: int, entry: str) -> int:
    """Integer operations of ``entry`` ("search" or "verify") over
    ``items`` nonces or witnesses: its compressions and the compare."""
    compressions = {"search": 1, "verify": 2}[entry]
    return items * (compressions * COMPRESS_OPS + COMPARE_OPS)


def io_bytes(items: int, entry: str) -> int:
    """Bytes ``entry`` must move: the search writes one mask byte per nonce
    (its midstate and target are kernel arguments); the verify reads 16
    block words, 2 nonce words and 8 target words and writes one byte per
    witness."""
    return items * {"search": 1, "verify": (16 + 2 + 8) * 4 + 1}[entry]


def split_nonces(nonces: np.ndarray, dev) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(B,) u64 nonces -> their (lo, hi) u32 halves as int32 tensors."""
    lo = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (nonces >> np.uint64(32)).astype(np.uint32)
    return u32.from_numpy(lo, dev), u32.from_numpy(hi, dev)


# --- plain twins (spacemesh_tpu/ops/pow.py) -----------------------------------


def _second_block(nonce_lo: torch.Tensor, nonce_hi: torch.Tensor):
    """le64(nonce) || 0x80 || zeros || be64(bit length), (16, B)."""
    b = nonce_lo.shape[0]
    tail = torch.zeros((14, b), dtype=DTYPE, device=nonce_lo.device)
    tail[0] = u32.s32(0x80000000)
    tail[13] = _BIT_LEN
    return torch.cat([byteswap32(nonce_lo)[None], byteswap32(nonce_hi)[None],
                      tail])


def pow_hash_batch(prefix_state: torch.Tensor, nonce_lo: torch.Tensor,
                   nonce_hi: torch.Tensor) -> torch.Tensor:
    """SHA-256 over the second block for a (B,) batch of nonces.
    ``prefix_state``: (8,) midstate after challenge || node_id. Returns
    (8, B) BE digest words."""
    return sha256_compress(prefix_state, _second_block(nonce_lo, nonce_hi))


def below_targets(digest_words: torch.Tensor, target_words: torch.Tensor
                  ) -> torch.Tensor:
    """Big-endian 256-bit unsigned compare, digest < target, per lane.
    digest_words: (8, B); target_words: (8,) shared or (8, B)."""
    if target_words.dim() == 1:
        target_words = target_words[:, None]
    d, t = flip(digest_words), flip(target_words)
    lt, eq = d < t, d == t
    out = lt[7]
    for i in range(6, -1, -1):
        out = lt[i] | (eq[i] & out)
    return out


def search_plain(prefix: np.ndarray, target: np.ndarray, base: int,
                 count: int, device) -> torch.Tensor:
    """Plain twin of the search kernel: the (count,) bool hit mask of
    nonces ``base``.. on ``device``."""
    dev = torch.device(device)
    lo, hi = split_nonces(np.arange(base, base + count, dtype=np.uint64),
                          dev)
    return below_targets(pow_hash_batch(u32.from_numpy(prefix, dev), lo, hi),
                         u32.from_numpy(target, dev))


def verify_plain(block1: torch.Tensor, nonce_lo: torch.Tensor,
                 nonce_hi: torch.Tensor, target_words: torch.Tensor
                 ) -> torch.Tensor:
    """Plain twin of the verify kernel: a (B,) batch of witnesses in one
    two-block SHA-256 pass. ``block1``: (16, B) challenge||node_id words;
    ``target_words``: (8, B) per-item difficulty. Returns (B,) bool."""
    st = sha256_compress(iv_tensor(block1.device), block1)
    return below_targets(sha256_compress(st, _second_block(nonce_lo,
                                                           nonce_hi)),
                         target_words)


# --- the kernels --------------------------------------------------------------


def _lib(entry: str):
    fn = getattr(_build.load("k2pow"), f"k2pow_{entry}_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                       if entry == "search" else
                       [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return fn


def _words8(words) -> ctypes.Array:
    w = np.asarray(words, dtype=np.uint32)
    if w.shape != (8,):
        raise ValueError(f"expected 8 u32 words, got shape {w.shape}")
    return (ctypes.c_uint32 * 8)(*(int(x) for x in w))


def search_batch(prefix: np.ndarray, target: np.ndarray, base: int,
                 count: int, device) -> torch.Tensor:
    """Hit mask (count,) bool on ``device`` of nonces ``base`` ..
    ``base + count - 1``: pow_hash below ``target``. ``prefix`` is the (8,)
    u32 midstate after challenge || node_id, ``target`` the (8,) u32 BE
    difficulty words (host arrays). The kernel on a CUDA device, the plain
    twin on the CPU."""
    global search_launches
    dev = torch.device(device)
    if dev.type == "cpu":
        return search_plain(prefix, target, base, count, dev)
    if dev.type != "cuda":
        raise ValueError(f"k2pow search: unsupported device {dev}")
    if base < 0 or base + count > 1 << 64:
        raise ValueError("nonces must stay unsigned 64-bit")
    p, t = _words8(prefix), _words8(target)
    out = torch.empty(count, dtype=torch.bool, device=dev)
    if count == 0:
        return out
    fn = _lib("search")
    with torch.cuda.device(dev):
        err = fn(p, t, base, out.data_ptr(), count,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            search_launches += 1
        _build.check(err, "k2pow_search_launch")
    return out


def verify_batch(block1: torch.Tensor, nonce_lo: torch.Tensor,
                 nonce_hi: torch.Tensor, target_words: torch.Tensor
                 ) -> torch.Tensor:
    """Verdicts (B,) bool of a batch of witnesses: (16, B) block-1 words
    (challenge || node_id), (B,) nonce halves and (8, B) BE targets. The
    kernel on CUDA tensors, :func:`verify_plain` on CPU tensors."""
    global verify_launches
    dev = nonce_lo.device
    if dev.type == "cpu":
        return verify_plain(block1, nonce_lo, nonce_hi, target_words)
    if dev.type != "cuda":
        raise ValueError(f"k2pow verify: unsupported device {dev}")
    b = nonce_lo.shape[0]
    if (block1.shape != (16, b) or nonce_hi.shape != (b,)
            or target_words.shape != (8, b)):
        raise ValueError("k2pow verify takes (16, B) blocks, (B,) nonce "
                         "halves and (8, B) targets")
    for x in (block1, nonce_lo, nonce_hi, target_words):
        if x.dtype != DTYPE or x.device != dev:
            raise ValueError("k2pow verify inputs must be int32 on one "
                             "device")
    args = [x.contiguous() for x in (block1, nonce_lo, nonce_hi,
                                     target_words)]
    out = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out
    fn = _lib("verify")
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in args), out.data_ptr(), b,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            verify_launches += 1
        _build.check(err, "k2pow_verify_launch")
    return out
