"""Canonical binary codec for all wire/storage types (port of
``spacemesh_tpu/core/codec.py``, whole; the bytes are the JAX package's).

The reference uses SCALE code-generation for every domain type (reference
codec/codec.go:22-67 wrapping spacemeshos/go-scale). Here the same goals —
deterministic bytes, compact varints, no reflection at encode time — are met
with a small combinator schema: each message type declares a ``FIELDS`` list
of (name, codec) pairs and gets encode/decode/roundtrip for free. Canonical
means: exactly one valid encoding per value (decoders reject non-minimal
varints and trailing bytes at the top level).

Wire grammar:
  u8/u16/u32/u64    little-endian fixed width
  compact           LEB128-like varint, minimal-length enforced
  bytes[N]          fixed-size raw
  bytes             compact length || raw
  str               utf-8 as bytes
  option(C)         0x00 | 0x01 || C
  vec(C)            compact count || items
  struct(T)         nested FIELDS
"""

from __future__ import annotations

import dataclasses
import io
import sys
from typing import Any, Callable


class DecodeError(ValueError):
    pass


class Codec:
    """A pair of (encode into buffer, decode from reader)."""

    def __init__(self, enc: Callable[[io.BytesIO, Any], None],
                 dec: Callable[[io.BufferedReader], Any]):
        self.enc = enc
        self.dec = dec


def _read(r, n: int) -> bytes:
    if n > sys.maxsize:
        # a lying length prefix from the network must reject, not crash:
        # io.BytesIO.read raises OverflowError past index size
        raise DecodeError(f"implausible length {n}")
    b = r.read(n)
    if len(b) != n:
        raise DecodeError(f"unexpected EOF: wanted {n} bytes, got {len(b)}")
    return b


def _uint(width: int) -> Codec:
    def enc(w, v):
        if not 0 <= v < (1 << (8 * width)):
            raise ValueError(f"u{8*width} out of range: {v}")
        w.write(int(v).to_bytes(width, "little"))
    return Codec(enc, lambda r: int.from_bytes(_read(r, width), "little"))


u8 = _uint(1)
u16 = _uint(2)
u32 = _uint(4)
u64 = _uint(8)


def _compact_enc(w, v):
    if v < 0:
        raise ValueError("compact is unsigned")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            w.write(bytes([b | 0x80]))
        else:
            w.write(bytes([b]))
            return


def _compact_dec(r) -> int:
    shift = 0
    out = 0
    while True:
        b = _read(r, 1)[0]
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            if b == 0 and shift != 0:
                raise DecodeError("non-minimal compact encoding")
            if shift > 63 or out >= 1 << 64:
                # the shift guard alone leaks values up to ~2^70: the
                # final byte lands at shift 63 with 7 bits of payload
                raise DecodeError("compact overflows u64")
            return out
        shift += 7
        if shift > 63:
            raise DecodeError("compact overflows u64")


compact = Codec(_compact_enc, _compact_dec)


def fixed(n: int) -> Codec:
    def enc(w, v: bytes):
        if len(v) != n:
            raise ValueError(f"expected {n} bytes, got {len(v)}")
        w.write(v)
    return Codec(enc, lambda r: _read(r, n))


def _bytes_enc(w, v: bytes):
    _compact_enc(w, len(v))
    w.write(v)


def _bytes_dec(r) -> bytes:
    return _read(r, _compact_dec(r))


var_bytes = Codec(_bytes_enc, _bytes_dec)

string = Codec(lambda w, v: _bytes_enc(w, v.encode("utf-8")),
               lambda r: _bytes_dec(r).decode("utf-8"))


def _bool_dec(r):
    b = _read(r, 1)[0]
    if b > 1:
        raise DecodeError(f"invalid bool byte {b}")
    return bool(b)


boolean = Codec(lambda w, v: w.write(b"\x01" if v else b"\x00"), _bool_dec)


def option(c: Codec) -> Codec:
    def enc(w, v):
        if v is None:
            w.write(b"\x00")
        else:
            w.write(b"\x01")
            c.enc(w, v)

    def dec(r):
        tag = _read(r, 1)[0]
        if tag == 0:
            return None
        if tag == 1:
            return c.dec(r)
        raise DecodeError(f"invalid option tag {tag}")
    return Codec(enc, dec)


def vec(c: Codec, max_len: int = 1 << 24) -> Codec:
    def enc(w, v):
        if len(v) > max_len:
            raise ValueError(f"vec too long: {len(v)} > {max_len}")
        _compact_enc(w, len(v))
        for item in v:
            c.enc(w, item)

    def dec(r):
        count = _compact_dec(r)
        if count > max_len:
            raise DecodeError(f"vec too long: {count} > {max_len}")
        return [c.dec(r) for _ in range(count)]
    return Codec(enc, dec)


def struct(cls) -> Codec:
    """Codec for a dataclass with a FIELDS schema."""
    def enc(w, v):
        for name, c in cls.FIELDS:
            c.enc(w, getattr(v, name))

    def dec(r):
        kw = {name: c.dec(r) for name, c in cls.FIELDS}
        return cls(**kw)
    return Codec(enc, dec)


def encode(value, codec: Codec | None = None) -> bytes:
    """Encode a value (dataclass with FIELDS, or explicit codec)."""
    c = codec or struct(type(value))
    w = io.BytesIO()
    c.enc(w, value)
    return w.getvalue()


def decode(data: bytes, cls_or_codec) -> Any:
    """Decode; rejects trailing bytes (canonical top-level framing)."""
    c = cls_or_codec if isinstance(cls_or_codec, Codec) else struct(cls_or_codec)
    r = io.BytesIO(data)
    v = c.dec(r)
    rest = r.read(1)
    if rest:
        raise DecodeError("trailing bytes after message")
    return v


def codec_for(cls) -> Codec:
    return struct(cls)


def register(cls):
    """Class decorator: dataclass + cached struct codec + helpers."""
    cls = dataclasses.dataclass(cls)
    c = struct(cls)
    cls.CODEC = c
    cls.to_bytes = lambda self: encode(self, c)
    cls.from_bytes = classmethod(lambda k, data: decode(data, c))
    return cls
