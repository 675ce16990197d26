"""Proving scan and proving hash: the CUDA kernels on the card, their
plain twins on the CPU.

:func:`scan` replaces ``spacemesh_tpu/ops/proving_pallas.py::_kernel``
(the ``pallas_call`` at :124), reached through ``_scan_pallas``. The kernel
is ``csrc/proving_scan.cu``: one thread per label lane, the label words and
index in registers, a loop over the nonce group writing one int8 mask row
per nonce, and per-64-lane segment hit counts from warp ballots.

What bounds it on an H100: about 400 integer instructions per (label,
nonce) pair (:func:`int_ops`) against 24 bytes read per label and
n_nonces * (1 + 4/64) bytes written (:func:`io_bytes`), so the
warp-instruction rate bounds it (132 SMs x 128 lanes per clock).

:func:`proving_hash` is the proving hash, one Salsa20/8 per lane with the
challenge and nonce shared or per lane. It replaces the XLA program of
``spacemesh_tpu/ops/proving.py::proving_hash_jit`` (no Pallas kernel) with
``hash_kernel`` of the same source, one thread per lane at any batch size,
which takes the label words little-endian or, with ``big_endian=True``,
as ``ops/pbkdf2_cuda.py:finish`` leaves them. It serves labels that come
from the host (:func:`~.proving.proving_hashes`); the verifier's recompute
runs the same hash as PBKDF2 finish's epilogue
(``ops/pbkdf2_cuda.py:finish_hash``) and launches no hash of its own.
Bound: about 390 integer instructions per lane (:func:`hash_int_ops`)
against at most 64 bytes (:func:`hash_io_bytes`).

:func:`scan` and :func:`proving_hash` take the kernel for CUDA tensors and
their plain twins (:func:`scan_plain`, :func:`proving_hash_plain`) only
for CPU tensors; a kernel that fails to build or launch raises.
``launches`` and ``hash_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .salsa import salsa20_8
from .u32 import DTYPE, byteswap32, from_numpy, s32, to_numpy, ult

HIT_SEGMENT = 64  # lanes per compaction segment; batches divide by this

launches = 0
hash_launches = 0


def int_ops(lanes: int, n_nonces: int) -> int:
    """Integer instructions of the scan: one Salsa20/8 (8 rounds of 16
    add/rotate/xor triples), the final add and the compare per pair."""
    return lanes * n_nonces * (8 * 16 * 3 + 2)


def io_bytes(lanes: int, n_nonces: int) -> int:
    """Bytes the scan must move: idx_lo, idx_hi and 4 label words in, one
    mask byte per nonce and one i32 per 64 lanes per nonce out."""
    return lanes * 24 + n_nonces * (lanes + 4 * (lanes // HIT_SEGMENT))


def hash_int_ops(lanes: int) -> int:
    """Integer instructions of the proving hash: one Salsa20/8 and the
    feed-forward add per lane."""
    return lanes * (8 * 16 * 3 + 1)


def hash_io_bytes(lanes: int, per_lane: bool) -> int:
    """Bytes the proving hash must move: the challenge and nonce (once, or
    per lane), idx_lo, idx_hi and 4 label words in, one value out per
    lane."""
    return (36 * (lanes if per_lane else 1)
            + lanes * (8 + 16 + 4))


def proving_hash_plain(challenge_words: torch.Tensor, nonce,
                       idx_lo: torch.Tensor, idx_hi: torch.Tensor,
                       label_words: torch.Tensor, *,
                       big_endian: bool = False) -> torch.Tensor:
    """Proving-hash values, plain PyTorch (the JAX package's
    ``ops/proving.py:proving_hash_jit``).

    challenge_words: (8,) shared or (8, B) per lane; nonce: a u32 int, or a
    (B,) tensor per lane; idx_lo/idx_hi: (B,); label_words: (4, B) LE, or
    BE with ``big_endian``. Returns (B,) int32 bit patterns of the u32
    values."""
    b = idx_lo.shape[0]
    dev = idx_lo.device
    ch = challenge_words
    if ch.dim() == 1:
        ch = ch[:, None]
    ch = ch.expand(8, b)
    if isinstance(nonce, int):
        nv = torch.full((b,), s32(nonce), dtype=DTYPE, device=dev)
    else:
        nv = nonce.reshape(-1).expand(b)
    if big_endian:
        label_words = byteswap32(label_words)
    state = torch.cat([ch, nv[None], idx_lo[None], idx_hi[None],
                       torch.zeros((1, b), dtype=DTYPE, device=dev),
                       label_words])
    return salsa20_8(state)[0]


def _hash_lib():
    fn = _build.load("proving_scan").proving_hash_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
    return fn


def proving_hash(challenge_words: torch.Tensor, nonce, idx_lo: torch.Tensor,
                 idx_hi: torch.Tensor, label_words: torch.Tensor, *,
                 big_endian: bool = False) -> torch.Tensor:
    """Proving-hash values of a (B,) batch, any B: ``hash_kernel`` on CUDA
    tensors, :func:`proving_hash_plain` on CPU tensors. Arguments as
    there; a tensor nonce is (B,) or a single element."""
    global hash_launches
    dev = idx_lo.device
    if dev.type == "cpu":
        return proving_hash_plain(challenge_words, nonce, idx_lo, idx_hi,
                                  label_words, big_endian=big_endian)
    if dev.type != "cuda":
        raise ValueError(f"proving_hash: unsupported device {dev}")
    b = idx_lo.shape[0]
    if label_words.shape != (4, b):
        raise ValueError("idx_lo/idx_hi must be (B,) and label_words (4, B)")
    ch, strides, (nv, nls, nval) = hash_operands(
        challenge_words, nonce, idx_lo, idx_hi, label_words)
    idx_lo, idx_hi = idx_lo.contiguous(), idx_hi.contiguous()
    label_words = label_words.contiguous()
    out = torch.empty(b, dtype=DTYPE, device=dev)
    if b == 0:
        return out
    fn = _hash_lib()
    with torch.cuda.device(dev):
        err = fn(ch.data_ptr(), *strides,
                 None if nv is None else nv.data_ptr(), nls, nval,
                 idx_lo.data_ptr(), idx_hi.data_ptr(), label_words.data_ptr(),
                 int(big_endian), out.data_ptr(), b,
                 torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            hash_launches += 1
        _build.check(err, "proving_hash_launch")
    return out


def hash_operands(challenge_words: torch.Tensor, nonce, idx_lo: torch.Tensor,
                  idx_hi: torch.Tensor, *lane_tensors) -> tuple:
    """The proving hash's challenge and nonce as a kernel takes them, for a
    batch of ``idx_lo.shape[0]`` lanes on one device: (contiguous challenge
    words, their (word, lane) strides, (contiguous nonce tensor or None,
    nonce lane stride, nonce value)). Checks the shapes of these and of
    ``idx_hi``, and that they and ``lane_tensors`` are int32 on one
    device."""
    b, dev = idx_lo.shape[0], idx_lo.device
    ch = challenge_words
    if tuple(ch.shape) not in ((8,), (8, b)):
        raise ValueError(f"challenge_words must be (8,) or (8, {b}), got "
                         f"{tuple(ch.shape)}")
    if idx_hi.shape != (b,):
        raise ValueError("idx_lo/idx_hi must be (B,)")
    checked = [ch, idx_lo, idx_hi, *lane_tensors]
    if isinstance(nonce, (int, np.integer)):
        nonce_args = (None, 0, int(nonce) & 0xFFFFFFFF)
    else:
        if nonce.numel() not in (1, b):
            raise ValueError(f"nonce must have 1 or {b} elements")
        nv = nonce.reshape(-1).contiguous()
        checked.append(nv)
        nonce_args = (nv, int(nonce.numel() == b), 0)
    for t in checked:
        if t.dtype != DTYPE or t.device != dev:
            raise ValueError("proving_hash inputs must be int32 on one device")
    return (ch.contiguous(), (1, 0) if ch.dim() == 1 else (b, 1),
            nonce_args)


def _check(challenge_words, idx_lo, idx_hi, label_words, n_nonces):
    b = idx_lo.shape[0]
    if b % HIT_SEGMENT:
        raise ValueError(f"batch {b} not a multiple of {HIT_SEGMENT}")
    if idx_hi.shape != (b,) or label_words.shape != (4, b):
        raise ValueError("idx_lo/idx_hi must be (B,) and label_words (4, B)")
    for t in (idx_lo, idx_hi, label_words):
        if t.dtype != DTYPE or t.device != idx_lo.device:
            raise ValueError("scan inputs must be int32 on one device")
    if n_nonces < 1:
        raise ValueError("n_nonces must be positive")
    cw = (to_numpy(challenge_words) if isinstance(challenge_words,
                                                  torch.Tensor)
          else np.asarray(challenge_words, dtype=np.uint32))
    if cw.shape != (8,):
        raise ValueError("challenge_words must be (8,)")
    return b, cw


def scan_plain(challenge_words, nonce_base: int, idx_lo: torch.Tensor,
               idx_hi: torch.Tensor, label_words: torch.Tensor,
               threshold: int, valid: int, *, n_nonces: int):
    """Plain twin of the kernel: (mask (n_nonces, B) int8, seg
    (n_nonces, B/64) int32), the outputs of ``_scan_pallas``."""
    b, cw = _check(challenge_words, idx_lo, idx_hi, label_words, n_nonces)
    dev = idx_lo.device
    cwt = from_numpy(cw, dev)
    alive = torch.arange(b, device=dev) < valid
    mask = torch.stack([
        ult(proving_hash_plain(cwt, (nonce_base + k) & 0xFFFFFFFF, idx_lo,
                               idx_hi, label_words), threshold) & alive
        for k in range(n_nonces)])
    seg = mask.reshape(n_nonces, b // HIT_SEGMENT, HIT_SEGMENT).sum(
        -1, dtype=torch.int32)
    return mask.to(torch.int8), seg


def _lib():
    lib = _build.load("proving_scan")
    fn = lib.proving_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return fn


def scan(challenge_words, nonce_base: int, idx_lo: torch.Tensor,
         idx_hi: torch.Tensor, label_words: torch.Tensor, threshold: int,
         valid: int, *, n_nonces: int):
    """Mask + per-segment hit counts for ``n_nonces`` consecutive nonces
    over one label batch (B a multiple of 64); lanes >= ``valid`` never
    hit. ``challenge_words`` is (8,) u32 (numpy or tensor); the scalars are
    Python ints. CUDA tensors launch the kernel, CPU tensors run
    :func:`scan_plain`."""
    global launches
    if idx_lo.device.type == "cpu":
        return scan_plain(challenge_words, nonce_base, idx_lo, idx_hi,
                          label_words, threshold, valid, n_nonces=n_nonces)
    if idx_lo.device.type != "cuda":
        raise ValueError(f"scan: unsupported device {idx_lo.device}")
    b, cw = _check(challenge_words, idx_lo, idx_hi, label_words, n_nonces)
    idx_lo, idx_hi = idx_lo.contiguous(), idx_hi.contiguous()
    label_words = label_words.contiguous()
    dev = idx_lo.device
    mask = torch.empty((n_nonces, b), dtype=torch.int8, device=dev)
    seg = torch.empty((n_nonces, b // HIT_SEGMENT), dtype=DTYPE, device=dev)
    if b == 0:
        return mask, seg
    fn = _lib()
    ch = (ctypes.c_uint32 * 8)(*(int(w) for w in cw))
    with torch.cuda.device(dev):
        err = fn(ch, nonce_base & 0xFFFFFFFF, threshold & 0xFFFFFFFF,
                 max(int(valid), 0), idx_lo.data_ptr(), idx_hi.data_ptr(),
                 label_words.data_ptr(), mask.data_ptr(), seg.data_ptr(), b,
                 n_nonces, torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            launches += 1
        _build.check(err, "proving_scan_launch")
    return mask, seg
