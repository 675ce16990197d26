"""SHA-256 in PyTorch on int32 bit patterns (port of ops/sha256.py).

The plain twins of the SHA-256 kernels, ``csrc/pbkdf2.cu`` (the
PBKDF2-HMAC-SHA256 envelope around ROMix) and ``csrc/k2pow.cu``: the
wrappers of ``ops/pbkdf2_cuda.py`` and ``ops/pow_cuda.py`` run them on CPU
tensors, the tests and ``chip_smoke.py`` hold the kernels to them; k2pow's
prefix midstate is one compression of a CPU tensor. Words are big-endian
packed per FIPS 180-4, lanes trailing: ``state`` (8, B), ``block`` (16, B).
Conversions to scrypt's little-endian layout go through
:func:`byteswap32`.
"""

from __future__ import annotations

import numpy as np
import torch

from .u32 import byteswap32  # noqa: F401  (re-exported)
from .u32 import from_numpy, rotr, s32, shr

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)
_K_S32 = [s32(int(k)) for k in _K]

IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


def iv_tensor(device=None) -> torch.Tensor:
    return from_numpy(IV, device)


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression. ``state``: (8,) or (8, B) int32,
    ``block``: (16, B) int32. Returns (8, B)."""
    tail = block.shape[1:]
    if state.dim() < block.dim():
        state = state.reshape(state.shape + (1,) * (block.dim()
                                                    - state.dim()))
    state = state.expand((8,) + tuple(tail))
    w = list(block.unbind(0))
    for i in range(16, 64):
        a, b = w[i - 15], w[i - 2]
        s0 = rotr(a, 7) ^ rotr(a, 18) ^ shr(a, 3)
        s1 = rotr(b, 17) ^ rotr(b, 19) ^ shr(b, 10)
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    a, b, c, d, e, f, g, h = state.unbind(0)
    for i in range(64):
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K_S32[i] + w[i]
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = t1 + s0 + maj, a, b, c, d + t1, e, f, g
    return state + torch.stack([a, b, c, d, e, f, g, h])


def hmac_midstates(key_words: torch.Tensor):
    """Midstates of HMAC-SHA256 for a 32-byte key given as (8,) or (8, B)
    int32 BE words. Returns (inner, outer) compression states of the same
    shape as the key."""
    kw = key_words if key_words.dim() == 2 else key_words[:, None]
    kw = torch.cat([kw, torch.zeros_like(kw)])
    iv = iv_tensor(kw.device)
    inner = sha256_compress(iv, kw ^ 0x36363636)
    outer = sha256_compress(iv, kw ^ 0x5C5C5C5C)
    if key_words.dim() == 1:
        return inner[:, 0], outer[:, 0]
    return inner, outer


def pad_message_np(msg: bytes) -> np.ndarray:
    """Host-side FIPS 180-4 padding -> (nblocks, 16) u32 BE words."""
    ml = len(msg)
    msg = msg + b"\x80"
    msg += b"\x00" * ((-(len(msg) + 8)) % 64)
    msg += (ml * 8).to_bytes(8, "big")
    arr = np.frombuffer(msg, dtype=">u4").astype(np.uint32)
    return arr.reshape(-1, 16)
