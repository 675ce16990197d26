"""Range-based set reconciliation (the reference's sync2/rangesync) (port of
``spacemesh_tpu/p2p/rangesync.py``).

Two peers holding large, mostly-equal sets of 32-byte ids (ATXs of an
epoch, malfeasance proofs, ...) converge by comparing XOR FINGERPRINTS
of key ranges and recursively bisecting the ranges that differ
(reference sync2/rangesync/rangesync.go; fingerprint.go uses a 12-byte
XOR fingerprint — same associative/self-inverse trick, 32 bytes here).
Transfer cost is O(diff * log n) instead of O(n).

Redesign notes (not a translation):
* the ordered set is a sorted key list + an XOR FENWICK TREE, so any
  range fingerprint is O(log n) — the reference walks an FPTree;
* the wire protocol is CLIENT-DRIVEN bisection over the existing
  req/resp server (protocol "rs/1"): the initiator asks for
  (fingerprint, count) of a range, recurses on mismatch, and asks for
  items when a differing range is small (DefaultMaxSendRange=16, like
  the reference).  Client-driven framing keeps the responder stateless.

Wire format (request, one frame):
  op u8: 0 = FINGERPRINT, 1 = ITEMS
  x, y: 32-byte range bounds [x, y)   (x == y means the full circle;
        here ranges are plain half-open intervals — wraparound is not
        needed for our callers, who reconcile whole id spaces)
Response:
  FINGERPRINT -> fp(32) || count u64
  ITEMS       -> concatenated 32-byte keys (bounded by max_items)
"""

from __future__ import annotations

import struct
from bisect import bisect_left, insort
from typing import Iterable

KEY = 32
ZERO = bytes(KEY)
TOP = b"\xff" * KEY + b"\x01"  # sorts after every 32-byte key
P_RANGESYNC = "rs/1"
MAX_SEND_RANGE = 16     # reference DefaultMaxSendRange
MAX_ITEMS = 4096        # per ITEMS answer


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


class XorFenwick:
    """Fenwick tree under XOR (associative + self-inverse, so both
    point-update and prefix queries are the classic loops)."""

    def __init__(self, n: int):
        self._t = [ZERO] * (n + 1)
        self.n = n

    def update(self, i: int, key: bytes) -> None:
        i += 1
        while i <= self.n:
            self._t[i] = _xor(self._t[i], key)
            i += i & (-i)

    def prefix(self, i: int) -> bytes:
        out = ZERO
        while i > 0:
            out = _xor(out, self._t[i])
            i -= i & (-i)
        return out


class OrderedSet:
    """Sorted 32-byte keys with O(log n) range fingerprints.

    Inserts rebuild the Fenwick lazily in batches: consensus ingests in
    bursts and reconciliation reads in bursts, so amortizing the rebuild
    beats per-insert tree shifting (a Fenwick can't insert mid-array)."""

    def __init__(self, keys: Iterable[bytes] = ()):
        self._keys: list[bytes] = sorted(set(keys))
        self._fen: XorFenwick | None = None
        self._pending: list[bytes] = []

    def add(self, key: bytes) -> None:
        if len(key) != KEY:
            raise ValueError("keys are 32 bytes")
        self._pending.append(key)

    def __len__(self) -> int:
        self._settle()
        return len(self._keys)

    def __contains__(self, key: bytes) -> bool:
        self._settle()
        i = bisect_left(self._keys, key)
        return i < len(self._keys) and self._keys[i] == key

    def keys(self) -> list[bytes]:
        self._settle()
        return list(self._keys)

    def _settle(self) -> None:
        if self._pending:
            pending, self._pending = set(self._pending), []
            for k in pending:
                i = bisect_left(self._keys, k)
                if i >= len(self._keys) or self._keys[i] != k:
                    insort(self._keys, k)
            self._fen = None
        if self._fen is None:
            self._fen = XorFenwick(len(self._keys))
            for i, k in enumerate(self._keys):
                self._fen.update(i, k)

    def _bounds(self, x: bytes, y: bytes) -> tuple[int, int]:
        return bisect_left(self._keys, x), bisect_left(self._keys, y)

    def fingerprint(self, x: bytes = ZERO, y: bytes = TOP) -> tuple[bytes, int]:
        """XOR of keys in [x, y) and their count."""
        self._settle()
        lo, hi = self._bounds(x, y)
        return _xor(self._fen.prefix(hi), self._fen.prefix(lo)), hi - lo

    def items(self, x: bytes, y: bytes, limit: int = MAX_ITEMS) -> list[bytes]:
        self._settle()
        lo, hi = self._bounds(x, y)
        return self._keys[lo:min(hi, lo + limit)]


def _midpoint(x: bytes, y: bytes) -> bytes:
    """Numeric midpoint of [x, y) over 32-byte keys."""
    xi = int.from_bytes(x.ljust(KEY, b"\0")[:KEY], "big")
    yi = int.from_bytes(y.ljust(KEY, b"\0")[:KEY], "big") \
        if len(y) == KEY else (1 << (8 * KEY))
    return ((xi + yi) // 2).to_bytes(KEY, "big")


# --- server side (stateless; rides p2p/server.py) -------------------------


class RangeSyncResponder:
    def __init__(self, set_for: "callable"):
        """``set_for(name: str) -> OrderedSet | None`` resolves which set
        a request targets (e.g. 'atx/5' = epoch-5 ATX ids)."""
        self.set_for = set_for

    async def handle(self, peer: bytes, data: bytes) -> bytes:
        if len(data) < 1 + 1:
            return b""
        op = data[0]
        nlen = data[1]
        name = data[2:2 + nlen].decode()
        rest = data[2 + nlen:]
        oset = self.set_for(name)
        if oset is None or len(rest) < 2 * KEY:
            return b""
        x, y = rest[:KEY], rest[KEY:2 * KEY]
        # ff*32 (the client's truncated TOP) and (0,0) mean "to the end"
        if y == b"\xff" * KEY or (x == ZERO and y == ZERO):
            y = TOP
        if op == 0:
            fp, count = oset.fingerprint(x, y)
            return fp + struct.pack("<Q", count)
        if op == 1:
            return b"".join(oset.items(x, y))
        return b""


# --- client side ----------------------------------------------------------


class RangeSyncClient:
    """Client-driven recursive reconciliation against one peer."""

    def __init__(self, server, peer: bytes, name: str,
                 timeout: float = 10.0):
        self.server = server
        self.peer = peer
        self.name = name
        self.timeout = timeout
        self.roundtrips = 0

    async def _ask(self, op: int, x: bytes, y: bytes) -> bytes:
        nb = self.name.encode()
        self.roundtrips += 1
        return await self.server.request(
            self.peer, P_RANGESYNC,
            bytes([op, len(nb)]) + nb + x + y[:KEY], timeout=self.timeout)

    async def _fingerprint(self, x: bytes, y: bytes) -> tuple[bytes, int]:
        resp = await self._ask(0, x, y)
        if len(resp) != KEY + 8:
            raise ValueError("malformed fingerprint response")
        return resp[:KEY], struct.unpack("<Q", resp[KEY:])[0]

    async def _items(self, x: bytes, y: bytes) -> list[bytes]:
        resp = await self._ask(1, x, y)
        if len(resp) % KEY:
            raise ValueError("malformed items response")
        return [resp[i:i + KEY] for i in range(0, len(resp), KEY)]

    async def reconcile(self, local: OrderedSet,
                        max_send_range: int = MAX_SEND_RANGE) -> list[bytes]:
        """Return the peer's keys MISSING locally (reference semantics:
        reconciliation surfaces what to fetch; the peer learns nothing —
        run the roles both ways for a symmetric sync)."""
        missing: list[bytes] = []

        async def recurse(x: bytes, y: bytes) -> None:
            theirs_fp, theirs_n = await self._fingerprint(x, y)
            ours_fp, ours_n = local.fingerprint(x, y)
            if theirs_fp == ours_fp and theirs_n == ours_n:
                return
            if theirs_n == 0:
                return  # they have nothing here; nothing to fetch
            if theirs_n <= max_send_range:
                for key in await self._items(x, y):
                    if key not in local:
                        missing.append(key)
                return
            mid = _midpoint(x, y)
            if mid <= x or mid >= y[:KEY].ljust(KEY, b"\xff"):
                # range no longer splittable: take the items
                for key in await self._items(x, y):
                    if key not in local:
                        missing.append(key)
                return
            await recurse(x, mid)
            await recurse(mid, y)

        await recurse(ZERO, TOP)
        return missing
