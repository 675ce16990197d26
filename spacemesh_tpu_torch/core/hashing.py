"""BLAKE3 hashing, the framework's canonical hash (port of
``spacemesh_tpu/core/hashing.py``).

The reference hashes everything with blake3 (reference hash/hash.go:16
``hash.Sum``). This is the JAX package's from-spec implementation (7-round
compression, 1024-byte chunks, binary tree with the chunk-stack merge
rule), copied whole.

The ONE-SHOT paths (:func:`sum256`, :func:`sum160`, :func:`keyed`: every
gossip message id, codec content id, address and merkle node) dispatch to
the native C++ twin (``native/blake3.cpp``, the port's own copy, built on
first use and loaded with ctypes), as the JAX package's do. The pure-Python
path costs 0.72-0.78 ms per ATX id on the H100 machine's host CPU, and
the farm's membership kind spent 0.337 s in 12 batches on it there
(``chip_smoke.py`` ``[atx]``, PERF.md). This module stays the reference implementation and the fallback when the
toolchain is absent; ``native.counts()`` says which path answered each
one-shot call. ``Hasher`` (incremental) is Python-only: it sits on cold
paths.
"""

from __future__ import annotations

import ctypes as _ctypes
import struct as _struct

from .. import native as _native_mod

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8
KEYED_HASH = 16

_CHUNK_LEN = 1024
_BLOCK_LEN = 64
_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _compress(cv, block_words, counter: int, block_len: int, flags: int):
    s = [cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
         _IV[0], _IV[1], _IV[2], _IV[3],
         counter & _MASK, (counter >> 32) & _MASK, block_len, flags]
    m = list(block_words)

    def g(a, b, c, d, mx, my):
        s[a] = (s[a] + s[b] + mx) & _MASK
        s[d] = _rotr(s[d] ^ s[a], 16)
        s[c] = (s[c] + s[d]) & _MASK
        s[b] = _rotr(s[b] ^ s[c], 12)
        s[a] = (s[a] + s[b] + my) & _MASK
        s[d] = _rotr(s[d] ^ s[a], 8)
        s[c] = (s[c] + s[d]) & _MASK
        s[b] = _rotr(s[b] ^ s[c], 7)

    for r in range(7):
        g(0, 4, 8, 12, m[0], m[1])
        g(1, 5, 9, 13, m[2], m[3])
        g(2, 6, 10, 14, m[4], m[5])
        g(3, 7, 11, 15, m[6], m[7])
        g(0, 5, 10, 15, m[8], m[9])
        g(1, 6, 11, 12, m[10], m[11])
        g(2, 7, 8, 13, m[12], m[13])
        g(3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[_PERM[i]] for i in range(16)]

    return [(s[i] ^ s[i + 8]) & _MASK for i in range(8)] + \
           [(s[i + 8] ^ cv[i]) & _MASK for i in range(8)]


def _words(block: bytes):
    return _struct.unpack("<16I", block)


class _ChunkState:
    __slots__ = ("cv", "chunk_counter", "block", "blocks_compressed", "flags")

    def __init__(self, key, chunk_counter: int, flags: int):
        self.cv = list(key)
        self.chunk_counter = chunk_counter
        self.block = b""
        self.blocks_compressed = 0
        self.flags = flags

    def len(self) -> int:
        return self.blocks_compressed * _BLOCK_LEN + len(self.block)

    def _start_flag(self) -> int:
        return CHUNK_START if self.blocks_compressed == 0 else 0

    def update(self, data: bytes) -> None:
        while data:
            if len(self.block) == _BLOCK_LEN:
                self.cv = _compress(self.cv, _words(self.block),
                                    self.chunk_counter, _BLOCK_LEN,
                                    self.flags | self._start_flag())[:8]
                self.blocks_compressed += 1
                self.block = b""
            take = min(_BLOCK_LEN - len(self.block), len(data))
            self.block += data[:take]
            data = data[take:]

    def output(self):
        block = self.block + b"\x00" * (_BLOCK_LEN - len(self.block))
        return (self.cv, _words(block), self.chunk_counter, len(self.block),
                self.flags | self._start_flag() | CHUNK_END)


def _parent_output(left_cv, right_cv, key, flags):
    return (list(key), tuple(left_cv + right_cv), 0, _BLOCK_LEN,
            flags | PARENT)


class Hasher:
    """Incremental BLAKE3 (unkeyed or 32-byte-keyed)."""

    def __init__(self, key: bytes | None = None):
        if key is None:
            self._key = _IV
            self._flags = 0
        else:
            if len(key) != 32:
                raise ValueError("key must be 32 bytes")
            self._key = _struct.unpack("<8I", key)
            self._flags = KEYED_HASH
        self._chunk = _ChunkState(self._key, 0, self._flags)
        self._stack: list[list[int]] = []
        self._total_chunks = 0

    def update(self, data: bytes) -> "Hasher":
        while data:
            if self._chunk.len() == _CHUNK_LEN:
                cv, words, counter, blen, flags = self._chunk.output()
                chunk_cv = _compress(cv, words, counter, blen, flags)[:8]
                self._push_chunk(chunk_cv)
                self._chunk = _ChunkState(self._key, self._total_chunks,
                                          self._flags)
            take = min(_CHUNK_LEN - self._chunk.len(), len(data))
            self._chunk.update(data[:take])
            data = data[take:]
        return self

    def _push_chunk(self, cv) -> None:
        self._total_chunks += 1
        total = self._total_chunks
        while total & 1 == 0:
            left = self._stack.pop()
            cv = _compress(*_parent_output(left, cv, self._key,
                                           self._flags))[:8]
            total >>= 1
        self._stack.append(cv)

    def digest(self, length: int = 32) -> bytes:
        # fold the stack right-to-left over the final (possibly partial) chunk
        out = self._chunk.output()
        for left in reversed(self._stack):
            cv = _compress(*out)[:8]
            out = _parent_output(left, cv, self._key, self._flags)
        cv, words, counter, blen, flags = out
        result = b""
        block_counter = 0
        while len(result) < length:
            wide = _compress(cv, words, block_counter, blen, flags | ROOT)
            result += _struct.pack("<16I", *wide)
            block_counter += 1
        return result[:length]

    def hexdigest(self, length: int = 32) -> str:
        return self.digest(length).hex()


# --- native dispatch -------------------------------------------------------

_native = None


def _load_native():
    global _native
    if _native is not None:
        return _native
    lib = _native_mod.load("blake3")
    if lib is not None:
        lib.smtpu_blake3.argtypes = [
            _ctypes.c_char_p, _ctypes.c_size_t, _ctypes.c_char_p,
            _ctypes.c_char_p, _ctypes.c_size_t]
        lib.smtpu_blake3.restype = None
    _native = lib if lib is not None else False
    return _native


def _hash_oneshot(data: bytes, key: bytes | None, length: int) -> bytes:
    lib = _load_native()
    if lib:
        _native_mod.count("blake3", "native")
        out = _ctypes.create_string_buffer(length)
        lib.smtpu_blake3(data, len(data), key, out, length)
        return out.raw
    _native_mod.count("blake3", "python")
    h = Hasher(key=key)
    h.update(data)
    return h.digest(length)


def sum256(*chunks: bytes) -> bytes:
    """32-byte hash of the concatenation (reference hash.Sum)."""
    return _hash_oneshot(b"".join(chunks), None, 32)


def sum160(*chunks: bytes) -> bytes:
    """20-byte truncated hash (reference hash/hash.go Sum20 for addresses)."""
    return _hash_oneshot(b"".join(chunks), None, 20)


def keyed(key: bytes, *chunks: bytes) -> bytes:
    """32-byte keyed hash of the concatenation."""
    if len(key) != 32:
        raise ValueError("key must be 32 bytes")
    return _hash_oneshot(b"".join(chunks), key, 32)
