"""QUIC-lite: a UDP transport with connection ids + ARQ reliability (port
of ``spacemesh_tpu/p2p/quic.py``, wire-identical to it).

Second transport under the same ``Host`` seam (reference
p2p/host.go:28-29,166 EnableQUICTransport — libp2p quic + quicreuse;
aioquic is not in this image, so this is an own implementation of the
properties the stack needs rather than RFC 9000):

* one UDP socket per endpoint, many connections (QUIC's socket sharing —
  quicreuse);
* 8-byte DESTINATION connection ids on every packet, chosen by the
  receiver at handshake — delivery is keyed by conn id, not source
  address, so a peer surviving a NAT rebind keeps its connection
  (QUIC connection migration, RFC 9000 §5.1 in spirit);
* per-connection ordered reliable byte stream: DATA packets carry u32
  sequence numbers; the receiver buffers out-of-order packets and
  cumulatively ACKs; the sender keeps an in-flight window with RTO
  retransmission (doubling backoff) and 3-dup-ACK fast retransmit;
* keepalive PING / idle teardown, FIN close.

The stream is exposed as an ``asyncio.StreamReader`` + a writer facade
with the ``write/drain/close/get_extra_info`` surface the TCP path uses,
so the noise channel (p2p/noise.py — X25519 + ChaCha20-Poly1305 with
channel-binding ids) and the whole Host frame protocol run UNCHANGED
over either transport. Security lives in noise, exactly like the TCP
path; this layer only provides ordered reliable delivery.

Chaos/test hooks: ``QuicEndpoint.loss_rate`` drops that fraction of
outgoing DATA packets (deterministic rng) to exercise retransmission.
"""

from __future__ import annotations

import asyncio
import os
import random
import struct
import time

MAGIC = 0x51  # 'Q'
SYN, SYNACK, DATA, ACK, FIN, PING = 1, 2, 3, 4, 5, 6

HEADER = struct.Struct("<BB8sII")  # magic, type, dest conn id, seq, ack
MAX_PAYLOAD = 1200
WINDOW = 128              # max in-flight DATA packets
RECV_BUF_CAP = 4 << 20    # stop advancing recv_next past this much
                          # undrained reader data (flow control)
RTO_MIN, RTO_MAX = 0.2, 2.0
IDLE_TIMEOUT = 30.0
KEEPALIVE = 5.0
SYN_RETRIES = 5
MAX_HALF_OPEN = 64        # server conns accepted but with no DATA yet —
                          # a spoofed SYN flood stops allocating state here
                          # (the TCP path gets this from the kernel accept
                          # queue)
MAX_CONNS = 1024          # hard cap on live connections per endpoint


class CountingReader(asyncio.StreamReader):
    """StreamReader that tracks buffered bytes (fed minus consumed) so
    receive flow control does not rely on asyncio's private ``_buffer``
    attribute (if that internal were renamed, backpressure
    would silently never engage)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._fed = 0
        self._consumed = 0

    @property
    def buffered(self) -> int:
        return self._fed - self._consumed

    def feed_data(self, data) -> None:
        self._fed += len(data)
        super().feed_data(data)

    # Consumption is counted ONLY at the primitive consume points —
    # read(n>=0), readexactly, readuntil. read(-1) loops over
    # self.read(limit) and readline delegates to self.readuntil, so
    # counting in those wrappers too would double-count every byte and
    # drive `buffered` negative.

    async def read(self, n=-1):
        if n < 0:
            return await super().read(n)  # delegates to counted read(n)
        data = await super().read(n)
        self._consumed += len(data)
        return data

    async def readexactly(self, n):
        try:
            data = await super().readexactly(n)
        except asyncio.IncompleteReadError as e:
            self._consumed += len(e.partial)  # partial IS consumed
            raise
        self._consumed += len(data)
        return data

    async def readuntil(self, separator=b"\n"):
        try:
            data = await super().readuntil(separator)
        except asyncio.IncompleteReadError as e:
            self._consumed += len(e.partial)  # EOF drains the buffer
            raise
        self._consumed += len(data)
        return data

    async def readline(self):
        # StreamReader.readline swallows LimitOverrunError by truncating
        # the private ``_buffer`` directly — bytes this counter never sees
        # as consumed, permanently inflating ``buffered`` and wedging
        # receive flow control. No caller needs line framing (noise.py is
        # readexactly-only), so fail loudly instead of corrupting the
        # accounting.
        raise NotImplementedError(
            "CountingReader does not support readline(): its "
            "LimitOverrunError recovery bypasses flow-control accounting; "
            "use readexactly/readuntil")


class QuicWriter:
    """asyncio.StreamWriter-shaped facade over a QuicConnection."""

    def __init__(self, conn: "QuicConnection"):
        self._conn = conn

    def write(self, data: bytes) -> None:
        self._conn.feed_send(data)

    async def drain(self) -> None:
        await self._conn.drained()

    def close(self) -> None:
        self._conn.close()

    def get_extra_info(self, name: str, default=None):
        if name == "peername":
            return self._conn.remote_addr
        if name == "sockname":
            return self._conn.endpoint.address
        return default


class QuicConnection:
    def __init__(self, endpoint: "QuicEndpoint", remote_addr, local_id: bytes):
        self.endpoint = endpoint
        self.remote_addr = remote_addr
        self.local_id = local_id          # what the PEER puts in dest id
        self.remote_id: bytes | None = None
        self.reader = CountingReader()
        self.writer = QuicWriter(self)
        self.established = asyncio.Event()
        self.closed = False
        self.half_open = False            # server-accepted, no DATA yet
        self._peer_key = None             # (client_id, addr) accept index
        # send side
        self._send_buf = bytearray()
        self._next_seq = 0                # next seq to assign
        self._inflight: dict[int, tuple[bytes, float]] = {}  # seq -> (pkt, t)
        self._base = 0                    # lowest unacked seq
        self._rto = RTO_MIN
        self._dup_acks = 0
        self._drain_ev = asyncio.Event()
        self._drain_ev.set()
        # recv side
        self._recv_next = 0
        self._ooo: dict[int, bytes] = {}
        self.last_heard = self.endpoint._now()
        self._tasks: list[asyncio.Task] = []

    # --- lifecycle ---

    def start_io(self) -> None:
        self._tasks.append(asyncio.ensure_future(self._retransmit_loop()))

    def close(self, *, _send_fin: bool = True) -> None:
        if self.closed:
            return
        self.closed = True
        if self.half_open:
            self.half_open = False
            self.endpoint.half_open_count -= 1
        if _send_fin and self.remote_id is not None:
            self.endpoint._send_raw(FIN, self.remote_id, 0, 0, b"",
                                    self.remote_addr)
        self.reader.feed_eof()
        self.established.set()
        self._drain_ev.set()
        for t in self._tasks:
            t.cancel()
        self.endpoint._forget(self)

    # --- send path ---

    def feed_send(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionError("quic connection closed")
        self._send_buf += data
        self._pump()

    async def drained(self) -> None:
        await self._drain_ev.wait()
        if self.closed:
            raise ConnectionError("quic connection closed")

    def _pump(self) -> None:
        """Move bytes from the send buffer into the in-flight window."""
        while self._send_buf and len(self._inflight) < WINDOW:
            chunk = bytes(self._send_buf[:MAX_PAYLOAD])
            del self._send_buf[:len(chunk)]
            seq = self._next_seq
            self._next_seq += 1
            pkt = HEADER.pack(MAGIC, DATA, self.remote_id, seq,
                              self._recv_next) + chunk
            self._inflight[seq] = (pkt, self.endpoint._now())
            self.endpoint._send_pkt(pkt, self.remote_addr, data=True)
        if self._send_buf or len(self._inflight) >= WINDOW:
            self._drain_ev.clear()
        else:
            self._drain_ev.set()

    def _on_ack(self, ack: int) -> None:
        if ack > self._base:
            for seq in range(self._base, ack):
                self._inflight.pop(seq, None)
            self._base = ack
            self._rto = RTO_MIN
            self._dup_acks = 0
            self._pump()
        elif ack == self._base and self._base < self._next_seq:
            self._dup_acks += 1
            if self._dup_acks >= 3:  # fast retransmit of the base packet
                self._dup_acks = 0
                ent = self._inflight.get(self._base)
                if ent is not None:
                    self.endpoint.stats["retx"] += 1
                    self.endpoint._send_pkt(ent[0], self.remote_addr,
                                            data=True)

    async def _retransmit_loop(self) -> None:
        while not self.closed:
            await asyncio.sleep(self._rto / 2)
            now = self.endpoint._now()
            if self.last_heard + IDLE_TIMEOUT < now:
                self.close()
                return
            ent = self._inflight.get(self._base)
            if ent is not None and now - ent[1] > self._rto:
                pkt, _ = ent
                self._inflight[self._base] = (pkt, now)
                self.endpoint.stats["retx"] += 1
                self.endpoint._send_pkt(pkt, self.remote_addr, data=True)
                self._rto = min(self._rto * 2, RTO_MAX)
            elif not self._inflight and self.remote_id is not None \
                    and self.last_heard + KEEPALIVE < now:
                self.endpoint._send_raw(PING, self.remote_id, 0,
                                        self._recv_next, b"",
                                        self.remote_addr)

    # --- receive path ---

    def on_packet(self, ptype: int, seq: int, ack: int, payload: bytes,
                  addr) -> None:
        self.last_heard = self.endpoint._now()
        # connection-id routing: the peer may have migrated address
        if addr != self.remote_addr:
            self.remote_addr = addr
        if ptype == DATA:
            self._on_ack(ack)
            # flow control: TCP gets backpressure from the kernel recv
            # window; here the stand-in is refusing to advance recv_next
            # while the application hasn't drained the reader — the
            # sender's window fills and its RTO paces retransmission
            # until we catch up (no unbounded reader growth)
            if self.half_open:
                self.half_open = False
                self.endpoint.half_open_count -= 1
            if seq == self._recv_next and self.reader.buffered < RECV_BUF_CAP:
                self.reader.feed_data(payload)
                self._recv_next += 1
                while self._recv_next in self._ooo:
                    self.reader.feed_data(self._ooo.pop(self._recv_next))
                    self._recv_next += 1
            elif seq > self._recv_next:
                if len(self._ooo) < 4 * WINDOW:   # bound rogue buffering
                    self._ooo[seq] = payload
            self.endpoint._send_raw(ACK, self.remote_id, 0,
                                    self._recv_next, b"", self.remote_addr)
        elif ptype == ACK:
            self._on_ack(ack)
        elif ptype == PING:
            self.endpoint._send_raw(ACK, self.remote_id, 0,
                                    self._recv_next, b"", self.remote_addr)
        elif ptype == FIN:
            # full teardown via close() so the half-open accounting runs
            # (a SYN->FIN pair that skipped the decrement
            # leaked admission slots until the endpoint refused everyone);
            # no FIN echo — the peer initiated the close
            self.close(_send_fin=False)


class QuicEndpoint(asyncio.DatagramProtocol):
    """One UDP socket serving many QUIC-lite connections."""

    def __init__(self, on_accept=None, loss_rate: float = 0.0,
                 rng: random.Random | None = None, time_source=None):
        # injected (QuicHost forwards the node clock) so RTO aging,
        # idle timeouts and keepalives follow virtual/skewed time in
        # sim and chaos scenarios; deltas only (SC001 clock discipline)
        self._now = time_source or time.monotonic
        self.on_accept = on_accept        # async callback(reader, writer)
        self.transport: asyncio.DatagramTransport | None = None
        self.address: tuple[str, int] | None = None
        self._by_id: dict[bytes, QuicConnection] = {}
        self._accepted: dict[tuple, QuicConnection] = {}
        # ^ (client_id, addr) -> conn, so retransmitted-SYN dedupe is
        #   O(1) — the SYN path must do constant work per packet or the
        #   flood it refuses still starves the event loop
        self.half_open_count = 0          # O(1) admission check under flood
        self._syn_waiters: dict[bytes, asyncio.Future] = {}
        self.loss_rate = loss_rate
        self._rng = rng or random.Random(0xC0FFEE)
        self.stats = {"tx": 0, "rx": 0, "dropped": 0, "retx": 0}

    # --- lifecycle ---

    async def listen(self, host: str, port: int) -> tuple[str, int]:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(host, port))
        self.address = self.transport.get_extra_info("sockname")[:2]
        return self.address

    def close(self) -> None:
        for conn in list(self._by_id.values()):
            conn.close()
        if self.transport is not None:
            self.transport.close()

    # --- outbound ---

    async def connect(self, addr: tuple[str, int], timeout: float = 5.0):
        """Dial: returns (reader, writer) once the SYN/SYNACK completes."""
        local_id = os.urandom(8)
        conn = QuicConnection(self, tuple(addr), local_id)
        self._by_id[local_id] = conn
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._syn_waiters[local_id] = fut
        try:
            per_try = timeout / SYN_RETRIES
            for _ in range(SYN_RETRIES):
                self._send_raw(SYN, bytes(8), 0, 0, local_id, tuple(addr))
                try:
                    await asyncio.wait_for(asyncio.shield(fut), per_try)
                    break
                except asyncio.TimeoutError:
                    continue
            if not fut.done():
                raise asyncio.TimeoutError("quic connect timeout")
            conn.remote_id = fut.result()  # spacecheck: ok=SC002 fut.done() is guaranteed just above — a done future's result() cannot block
        except BaseException:
            # failed/cancelled dial: the conn was registered in _by_id at
            # construction — without this, every redial to an unreachable
            # bootnode leaks a connection forever
            conn.close()
            raise
        finally:
            self._syn_waiters.pop(local_id, None)
        conn.established.set()
        conn.start_io()
        return conn.reader, conn.writer

    # --- packet IO ---

    def _send_pkt(self, pkt: bytes, addr, data: bool = False) -> None:
        if self.transport is None or self.transport.is_closing():
            return
        self.stats["tx"] += 1
        if data and self.loss_rate and self._rng.random() < self.loss_rate:
            self.stats["dropped"] += 1
            return
        self.transport.sendto(pkt, addr)

    def _send_raw(self, ptype: int, dest_id: bytes | None, seq: int,
                  ack: int, payload: bytes, addr) -> None:
        if dest_id is None:
            return
        self._send_pkt(HEADER.pack(MAGIC, ptype, dest_id, seq, ack)
                       + payload, addr)

    def _forget(self, conn: QuicConnection) -> None:
        if self._by_id.get(conn.local_id) is conn:
            del self._by_id[conn.local_id]
        if conn._peer_key is not None \
                and self._accepted.get(conn._peer_key) is conn:
            del self._accepted[conn._peer_key]

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < HEADER.size:
            return
        magic, ptype, dest_id, seq, ack = HEADER.unpack_from(data)
        if magic != MAGIC:
            return
        payload = data[HEADER.size:]
        self.stats["rx"] += 1
        if ptype == SYN:
            # payload = client's chosen id; allocate ours, reply SYNACK.
            # Retransmitted SYNs for a known client id reuse the
            # existing connection (no duplicate accept).
            client_id = payload[:8]
            if len(client_id) != 8:
                return
            known = self._accepted.get((client_id, addr))
            if known is not None:
                self._send_raw(SYNACK, client_id, 0, 0, known.local_id,
                               addr)
                return
            # admission control: a spoofed SYN flood must not grow
            # _by_id and its tasks unboundedly — refuse new state once
            # too many accepted connections have never sent DATA, or
            # the endpoint is at its hard connection cap.
            # The counter keeps this O(1) on the flooded path.
            if self.half_open_count >= MAX_HALF_OPEN \
                    or len(self._by_id) >= MAX_CONNS:
                self.stats["syn_refused"] = \
                    self.stats.get("syn_refused", 0) + 1
                return
            local_id = os.urandom(8)
            conn = QuicConnection(self, addr, local_id)
            conn.remote_id = client_id
            conn.half_open = True
            conn._peer_key = (client_id, addr)
            self.half_open_count += 1
            self._by_id[local_id] = conn
            self._accepted[conn._peer_key] = conn
            conn.established.set()
            conn.start_io()
            self._send_raw(SYNACK, client_id, 0, 0, local_id, addr)
            if self.on_accept is not None:
                asyncio.ensure_future(
                    self.on_accept(conn.reader, conn.writer))
            return
        if ptype == SYNACK:
            fut = self._syn_waiters.get(dest_id)
            if fut is not None and not fut.done() and len(payload) >= 8:
                fut.set_result(payload[:8])
            return
        conn = self._by_id.get(dest_id)
        if conn is not None:
            conn.on_packet(ptype, seq, ack, payload, addr)

    def error_received(self, exc) -> None:  # pragma: no cover - os-specific
        pass


from .transport import Host as _HostBase  # noqa: E402 (no import cycle:
# transport does not import quic; the app picks the Host class by config)


class QuicHost(_HostBase):
    """The same Host protocol stack (noise handshake, HELLO identity
    proof, gossipsub-lite, req/resp, peer exchange, chaos hooks) over
    QUIC-lite instead of TCP — config-selectable (reference
    p2p/host.go:166,321 EnableQUICTransport + libp2p transport options).

    ``quic_loss_rate`` injects deterministic outbound DATA loss for
    retransmission tests/chaos."""

    def __init__(self, *args, quic_loss_rate: float = 0.0, **kw):
        super().__init__(*args, **kw)
        self._endpoint = QuicEndpoint(
            on_accept=self._accept, loss_rate=quic_loss_rate,
            rng=random.Random(int.from_bytes(self.node_id[:4], "big")),
            time_source=self._now)

    async def _listen(self, host: str, port: int) -> tuple[str, int]:
        return await self._endpoint.listen(host, port)

    async def _open_connection(self, addr: tuple[str, int]):
        return await self._endpoint.connect(tuple(addr))

    async def _close_listener(self) -> None:
        self._endpoint.close()
