"""k2pow hashing: the CUDA kernels on the card, their plain twins on the CPU.

Three entry points of ``csrc/k2pow.cu``:

- :func:`search_window`: the prover's search, one launch per window of
  nonces ``start .. start + count - 1`` of one search. From the 16 words of
  ``challenge || node_id`` (compressed once per block on the card) and one
  target, it folds the smallest winning nonce into ``found``, a (1,) u64
  cell on the device that every window of the search shares (all ones: no
  winner yet). A persistent grid fills the SMs, each thread walking its
  nonces and stopping once its next nonce is above ``found``, so a window
  launched behind a winner exits at once. It replaces the XLA programs of
  ``spacemesh_tpu/ops/pow.py::pow_hash_batch_jit`` (:39) and
  ``below_target_jit``, which have no Pallas kernel.
- :func:`search_batch`: ``count`` nonces from a u64 ``base`` against one
  prefix midstate, one thread each: the (count,) hit mask,
  ``below_targets(pow_hash_batch(...))``. No path of the port launches it;
  it serves callers that want every hit of a range.
- :func:`verify_batch`: the verification farm's batch of witnesses, each
  with its own block 1, nonce and target: two compressions and the compare
  per item, ``pow_verify_batch``. It replaces
  ``spacemesh_tpu/ops/pow.py::pow_verify_batch_jit`` (:190; XLA, no
  Pallas kernel).

What bounds them on an H100: :data:`~.pbkdf2_cuda.COMPRESS_OPS` integer
operations per compression (:func:`int_ops`) against a few bytes per
window, one byte written per nonce, or 105 bytes moved per witness
(:func:`io_bytes`): the instruction rate.

The searches take the kernel for a CUDA ``device`` (their inputs are host
words), the verify for CUDA tensors; the plain twins
(:func:`search_window_plain`, :func:`search_plain`, :func:`verify_plain`,
built from :func:`pow_hash_batch` and :func:`below_targets`, ported from
the JAX package) run only on the CPU; a kernel that fails to build or
launch raises. ``search_launches`` counts window launches,
``mask_launches`` the mask kernel's and ``verify_launches`` the verify
kernel's.
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
mask_launches = 0
verify_launches = 0

NO_WINNER = (1 << 64) - 1  # the window cell before any winner

# Message layout: challenge(32) || node_id(32) || le64(nonce) = 72 bytes
# -> two 64-byte blocks with FIPS padding in the second.
_BIT_LEN = 72 * 8
COMPARE_OPS = 16  # the 8-word compare: a compare and a select per word


def int_ops(items: int, entry: str, blocks: int = 0) -> int:
    """Integer operations of ``entry`` ("window", "search" or "verify")
    over ``items`` nonces or witnesses: its compressions and the compare,
    and ``blocks`` block-1 compressions (a window's blocks each make one).
    For a window that ends early, count what its input needs: the
    winner's offset in the window plus one nonces, block 1 once."""
    compressions = {"window": 1, "search": 1, "verify": 2}[entry]
    return (items * (compressions * COMPRESS_OPS + COMPARE_OPS)
            + blocks * COMPRESS_OPS)


def io_bytes(items: int, entry: str) -> int:
    """Bytes ``entry`` must move: the window reads and writes the 8-byte
    cell (block 1 and the target are kernel arguments); the search writes
    one mask byte per nonce; the verify reads 16 block words, 2 nonce
    words and 8 target words and writes one byte per witness."""
    if entry == "window":
        return 16
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


def new_cell(device) -> torch.Tensor:
    """A window cell on ``device``: (1,) int64 holding the u64 bit pattern
    of the smallest winner so far, :data:`NO_WINNER` at first."""
    return torch.full((1,), -1, dtype=torch.int64, device=device)


def cell_value(cell: torch.Tensor) -> int:
    """The u64 nonce a (CPU) window cell holds."""
    return int(cell[0]) & NO_WINNER


def search_window_plain(block1: np.ndarray, target: np.ndarray, start: int,
                        count: int, found: torch.Tensor, *,
                        chunk: int = 1 << 12) -> None:
    """Plain twin of the window kernel on ``found``'s device: lowers
    ``found`` to the smallest nonce of ``start .. start + count - 1`` whose
    pow_hash is below ``target``, hashing ``chunk`` nonces at a time in
    order and stopping at the first chunk past ``found`` or holding a
    hit, so a window behind a winner hashes nothing (block 1 included)."""
    dev = found.device
    best = cell_value(found.cpu())
    if best < start:
        return
    mid = sha256_compress(iv_tensor(dev),
                          u32.from_numpy(block1, dev)[:, None])[:, 0]
    tgt = u32.from_numpy(target, dev)
    for s in range(start, start + count, chunk):
        if s > best:
            break
        n = min(chunk, start + count - s)
        lo, hi = split_nonces(np.uint64(s) + np.arange(n, dtype=np.uint64),
                              dev)
        hits = torch.nonzero(below_targets(pow_hash_batch(mid, lo, hi), tgt))
        if hits.numel():
            best = min(best, s + int(hits[0, 0]))
            break
    found.fill_(best - (1 << 64) if best >= 1 << 63 else best)


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


_ARGTYPES = {
    "window": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
               ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p],
    "search": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "verify": [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p],
    "empty": [ctypes.c_void_p]}


def _lib(entry: str):
    fn = getattr(_build.load("k2pow"), f"k2pow_{entry}_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[entry]
    return fn


def _words(words, n: int) -> ctypes.Array:
    w = np.asarray(words, dtype=np.uint32)
    if w.shape != (n,):
        raise ValueError(f"expected {n} u32 words, got shape {w.shape}")
    return (ctypes.c_uint32 * n)(*(int(x) for x in w))


def search_window(block1_words: np.ndarray, target: np.ndarray, start: int,
                  count: int, found: torch.Tensor, device, *,
                  imad: bool = True) -> None:
    """Fold the smallest nonce of ``start .. start + count - 1`` whose
    pow_hash is below ``target`` into ``found``, one (1,) int64 cell on
    ``device`` (:func:`new_cell`) that every window of one search shares.
    ``block1_words`` is the (16,) u32 BE words of challenge || node_id,
    ``target`` the (8,) u32 BE difficulty words (host arrays). One kernel
    launch on a CUDA device (``imad``: the rounds' adds on the FMA pipe,
    else the plain form); the plain twin on the CPU. Enqueues only."""
    global search_launches
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"k2pow search: unsupported device {dev}")
    if (found.shape != (1,) or found.dtype != torch.int64
            or found.device.type != dev.type
            or dev.index not in (None, found.device.index)):
        raise ValueError(f"found must be a (1,) int64 cell on {dev}")
    dev = found.device
    if start < 0 or count < 0 or start + count > 1 << 64:
        raise ValueError("nonces must stay unsigned 64-bit")
    m, t = _words(block1_words, 16), _words(target, 8)
    if dev.type == "cpu":
        return search_window_plain(block1_words, target, start, count, found)
    if count == 0:
        return None
    fn = _lib("window")
    with torch.cuda.device(dev):
        err = fn(m, t, start, count, found.data_ptr(), int(imad),
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            search_launches += 1
        _build.check(err, "k2pow_window_launch")
    return None


def window_blocks(count: int, imad: bool = True) -> int:
    """Blocks a window of ``count`` nonces launches on the current card:
    the persistent grid, or fewer for a short window. Each compresses
    block 1 once."""
    fn = _build.load("k2pow").k2pow_window_blocks
    fn.restype, fn.argtypes = ctypes.c_uint, [ctypes.c_ulonglong, ctypes.c_int]
    return int(fn(count, int(imad)))


def empty_launch(device) -> None:
    """One launch of an empty kernel on ``device``: the floor a launch
    costs, for measurements only (uncounted)."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        _build.check(_lib("empty")(torch.cuda.current_stream(dev).cuda_stream),
                     "k2pow_empty_launch")


def search_batch(prefix: np.ndarray, target: np.ndarray, base: int,
                 count: int, device) -> torch.Tensor:
    """Hit mask (count,) bool on ``device`` of nonces ``base`` ..
    ``base + count - 1``: pow_hash below ``target``. ``prefix`` is the (8,)
    u32 midstate after challenge || node_id, ``target`` the (8,) u32 BE
    difficulty words (host arrays). The kernel on a CUDA device, the plain
    twin on the CPU."""
    global mask_launches
    dev = torch.device(device)
    if dev.type == "cpu":
        return search_plain(prefix, target, base, count, dev)
    if dev.type != "cuda":
        raise ValueError(f"k2pow search: unsupported device {dev}")
    if base < 0 or base + count > 1 << 64:
        raise ValueError("nonces must stay unsigned 64-bit")
    p, t = _words(prefix, 8), _words(target, 8)
    out = torch.empty(count, dtype=torch.bool, device=dev)
    if count == 0:
        return out
    fn = _lib("search")
    with torch.cuda.device(dev):
        err = fn(p, t, base, out.data_ptr(), count,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            mask_launches += 1
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
