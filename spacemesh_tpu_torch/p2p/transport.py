"""TCP transport: real sockets beneath the PubSub / Server seams (port of
``spacemesh_tpu/p2p/transport.py``, wire-identical to it).

One `Host` per node owns a
TCP listener plus outbound dials and slots in as BOTH the pubsub hub
(`PubSub._hub`) and the request/response net (`Server._net`), so every
existing protocol component runs unchanged over a real network.

Reference parity (behavior, not mechanism — the reference rides libp2p):
- noise security: every connection runs an X25519+ChaCha20-Poly1305
  channel (p2p/noise.py) and the peer's node id is its ed25519 key,
  PROVEN by a channel-binding signature in the encrypted HELLO — ids
  are unforgeable (reference p2p/host.go:27-28, 306-309: libp2p noise +
  key-derived peer ids).
- network-cookie handshake: the 20-byte genesis id salts the channel
  keys AND rides in the HELLO; mismatch fails decryption / closes the
  connection (reference p2p/handshake/handshake.go — splits testnets
  from mainnet).
- gossip: flood-publish with content-id dedup and relay-on-accept; a
  validation reject penalizes the sending peer and repeated rejects drop
  it (reference pubsub.go:168 DropPeerOnValidationReject, gossipsub
  scoring).
- req/resp: varint-style framed request/response streams with per-request
  correlation ids (reference p2p/server/server.go).
- peer exchange + redial: HELLO carries the listen port; peers gossip
  known addresses and a maintainer task keeps dialing until min_peers
  (reference p2p discovery/bootstrap, p2p/dhtdiscovery).

Framing: u32 LE length, then u8 frame type, then the payload. One
connection per peer pair (simultaneous-dial ties broken by node id:
the dial initiated by the LOWER id survives).
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
from typing import Optional

from ..core.hashing import sum256
from .noise import ChannelError, NoiseChannel

MSG_HELLO = 0
MSG_GOSSIP = 1
MSG_REQ = 2
MSG_RESP = 3
MSG_PEERS = 4
MSG_GOSSIP_CTRL = 5   # gossipsub-lite GRAFT/PRUNE/IHAVE/IWANT
MSG_FIND = 6          # iterative discovery: find peers near a target id
MSG_FOUND = 7         # reply: (id, addr) entries sorted by XOR distance

MAX_FRAME = 64 << 20
SEEN_CAP = 1 << 14


class HandshakeError(Exception):
    pass


def _xor_dist(a: bytes, b: bytes) -> int:
    """Kademlia XOR metric over 32-byte ids."""
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


SEND_QUEUE_CAP = 4096


class _Conn:
    """One live peer connection (post-handshake).

    Outbound frames go through a bounded per-connection queue drained by a
    writer task: a stalled peer (full socket buffer, SIGSTOP'd process)
    must never block the sender's consensus rounds — the queue overflows
    and the connection drops instead."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, node_id: bytes,
                 listen_addr: Optional[tuple[str, int]], outbound: bool,
                 channel: NoiseChannel | None = None):
        self.reader = reader
        self.writer = writer
        self.channel = channel
        self.node_id = node_id
        self.listen_addr = listen_addr
        self.outbound = outbound
        self.score = 0
        self.send_queue: asyncio.Queue = asyncio.Queue()
        # ordered gossip delivery per peer (frames arrive in order; handler
        # execution must preserve it, like LoopbackHub's per-receiver inbox)
        self.gossip_queue: asyncio.Queue = asyncio.Queue()
        self.closed = asyncio.Event()
        self.tasks: list[asyncio.Task] = []

    async def send(self, frame_type: int, payload: bytes) -> None:
        if self.closed.is_set():
            raise ConnectionError("connection closed")
        if self.send_queue.qsize() >= SEND_QUEUE_CAP:
            self.close()  # peer is not draining; don't buffer unboundedly
            raise ConnectionError("send queue overflow")
        # encrypt at enqueue: the queue is FIFO and the writer drains it
        # in order, so nonce order matches wire order
        self.send_queue.put_nowait(
            self.channel.encrypt_frame(frame_type, payload))

    async def write_loop(self) -> None:
        try:
            while not self.closed.is_set():
                frame = await self.send_queue.get()
                if frame is None:
                    return
                self.writer.write(frame)
                await self.writer.drain()
        except (OSError, ConnectionError):
            self.close()

    def close(self) -> None:
        self.closed.set()
        # wake blocked queue consumers so their tasks can exit
        self.send_queue.put_nowait(None)
        self.gossip_queue.put_nowait(None)
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 — best-effort teardown of an
            # already-dying socket; the connection is closed either way
            # and the caller's drop path owns the accounting
            pass


class Host:
    """One node's transport endpoint: listener + dials + gossip + req/resp.

    Usage:
        host = Host(signer=EdSigner(...), genesis_id=...,
                    listen="127.0.0.1:0", bootstrap=["127.0.0.1:7513"])
        await host.start()
        host.join_pubsub(pubsub)   # pubsub hub seam
        host.join(server)          # req/resp net seam (Server._net)

    The node id IS the signer's ed25519 public key: the handshake proves
    possession of the key, so ids can't be spoofed.
    """

    def __init__(self, *, signer, genesis_id: bytes,
                 listen: str = "127.0.0.1:0", bootstrap: list[str] = (),
                 min_peers: int = 3, max_peers: int = 32,
                 reject_limit: int = 16, ban_seconds: float = 60.0,
                 request_timeout: float = 10.0,
                 gossip_degree: int = 6, gossip_heartbeat: float = 1.0,
                 time_source=None):
        from ..core.signing import EdVerifier
        from .gossipmesh import GossipMesh

        # injected by App so ban windows / dial pacing / heartbeats run
        # on the node's clock (virtual under the sim engine, skewable by
        # chaos timeskew); only deltas are taken, so wall vs monotonic
        # vs virtual origins all work (SC001 clock discipline)
        self._now = time_source or time.monotonic
        self.signer = signer
        self.node_id = signer.node_id
        self.verifier = EdVerifier(prefix=signer.prefix)
        self.genesis_id = genesis_id
        self.listen = listen
        self.bootstrap = list(bootstrap)
        self.min_peers = min_peers
        self.max_peers = max_peers
        self.reject_limit = reject_limit
        self.ban_seconds = ban_seconds
        self.request_timeout = request_timeout

        self.address: tuple[str, int] | None = None  # bound listen addr
        self._conns: dict[bytes, _Conn] = {}
        self._known: dict[tuple[str, int], float] = {}  # addr -> last dial
        self._banned: dict[bytes, float] = {}           # node_id -> until
        self._seen: dict[bytes, None] = {}              # gossip msg-id LRU
        self._req_id = 0
        self._pending: dict[int, asyncio.Future] = {}
        self._disc_pending: dict[int, asyncio.Future] = {}
        # chaos fault injection (systest partition tooling; reference
        # systest/chaos/partition.go does this with iptables — here the
        # transport refuses the blocked peers itself). chaos_link adds
        # seeded loss/delay/duplication on gossip relays.
        self._blocked_addrs: set[tuple] = set()
        self._blocked_ids: set[bytes] = set()
        self._chaos_link: dict | None = None
        self._tasks: list[asyncio.Task] = []
        self._listener: asyncio.AbstractServer | None = None
        self._pubsub = None
        self._server = None
        self._stopping = False
        # gossipsub-lite mesh (p2p/gossipmesh.py); degree bounds scale
        # from the configured degree like the reference's D/D_lo/D_hi
        self.gossip = GossipMesh(
            degree=gossip_degree,
            d_lo=max(2, gossip_degree - 2), d_hi=gossip_degree + 2,
            rng=random.Random(int.from_bytes(self.node_id[:4], "little")))
        self.gossip_heartbeat = gossip_heartbeat
        self.stats = {"gossip_tx": 0, "gossip_rx": 0, "gossip_dup": 0,
                      "ihave_tx": 0, "iwant_served": 0}

    # ------------------------------------------------------------------
    # seam plumbing

    def join_pubsub(self, pubsub) -> None:
        pubsub._hub = self
        self._pubsub = pubsub

    def join(self, server) -> None:  # Server._net surface (LoopbackNet.join)
        server._net = self
        self._server = server

    def leave(self, server) -> None:
        server._net = None
        self._server = None

    @property
    def nodes(self) -> dict[bytes, _Conn]:
        """Connected peer ids (Server.peers() surface)."""
        return self._conns

    # ------------------------------------------------------------------
    # lifecycle

    async def start(self) -> tuple[str, int]:
        host, _, port = self.listen.rpartition(":")
        self.address = await self._listen(host or "127.0.0.1", int(port or 0))
        for spec in self.bootstrap:
            h, _, p = spec.rpartition(":")
            self._known[(h, int(p))] = 0.0
        self._tasks.append(asyncio.ensure_future(self._maintain()))
        return self.address

    # -- transport plumbing (overridden by QuicHost, p2p/quic.py) --

    async def _listen(self, host: str, port: int) -> tuple[str, int]:
        self._listener = await asyncio.start_server(self._accept, host, port)
        return self._listener.sockets[0].getsockname()[:2]

    async def _open_connection(self, addr: tuple[str, int]):
        return await asyncio.open_connection(addr[0], addr[1])

    async def _close_listener(self) -> None:
        if self._listener is not None:
            self._listener.close()
            await self._listener.wait_closed()

    async def stop(self) -> None:
        self._stopping = True
        for task in self._tasks:
            task.cancel()
        for conn in list(self._conns.values()):
            self._drop(conn)
        self._conns.clear()
        await self._close_listener()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("host stopped"))
        self._pending.clear()

    async def _maintain(self, interval: float = 1.0) -> None:
        """Keep dialing known addresses until min_peers is met."""
        last_heartbeat = 0.0
        while not self._stopping:
            try:
                if len(self._conns) < self.min_peers:
                    now = self._now()
                    for addr, last in list(self._known.items()):
                        if addr == self.address:
                            continue
                        if now - last < 2.0:
                            continue
                        if any(c.listen_addr == addr
                               for c in self._conns.values()):
                            continue
                        self._known[addr] = now
                        asyncio.ensure_future(self._dial(addr))
                now = self._now()
                if now - last_heartbeat >= self.gossip_heartbeat:
                    last_heartbeat = now
                    await self._gossip_heartbeat()
            except Exception:  # noqa: BLE001 — keep the maintainer alive
                pass
            await asyncio.sleep(min(interval, self.gossip_heartbeat))

    async def _gossip_heartbeat(self) -> None:
        """Mesh maintenance + lazy IHAVE (gossipsub heartbeat)."""
        from .gossipmesh import IHAVE, encode_ctrl

        sends = self.gossip.heartbeat(set(self._conns))
        for peer, subtype, topic, ids in sends:
            conn = self._conns.get(peer)
            if conn is None:
                continue
            if subtype == IHAVE:
                self.stats["ihave_tx"] += 1
            try:
                await conn.send(MSG_GOSSIP_CTRL,
                                encode_ctrl(subtype, topic, ids))
            except (OSError, ConnectionError):
                self._drop(conn)

    # ------------------------------------------------------------------
    # connections

    def _hello_payload(self, channel: NoiseChannel) -> bytes:
        port = self.address[1] if self.address else 0
        sig = channel.sign_binding(self.signer, channel.initiator)
        return (struct.pack("<B", len(self.genesis_id)) + self.genesis_id
                + self.node_id + struct.pack("<H", port) + sig)

    @staticmethod
    def _parse_hello(payload: bytes) -> tuple[bytes, bytes, int, bytes]:
        # length-check before slicing: a truncated HELLO from an
        # untrusted peer must surface as HandshakeError, not IndexError
        # (unhandled parse errors leaked the socket)
        if len(payload) < 1 or len(payload) < 1 + payload[0] + 34 + 64:
            raise HandshakeError("malformed HELLO")
        glen = payload[0]
        genesis = payload[1:1 + glen]
        node_id = payload[1 + glen:1 + glen + 32]
        (port,) = struct.unpack_from("<H", payload, 1 + glen + 32)
        sig = payload[1 + glen + 34:1 + glen + 34 + 64]
        return genesis, node_id, port, sig

    # -- chaos fault injection (systest partition scenarios) --

    def chaos_block(self, addrs: list = (), node_ids: list = ()) -> None:
        """Sever + refuse the given peers (listen addrs and/or ids) until
        chaos_clear(). The transport-level stand-in for the reference's
        iptables partition (systest/chaos/partition.go:14)."""
        self._blocked_addrs.update(tuple(a) for a in addrs)
        self._blocked_ids.update(node_ids)
        for pid, conn in list(self._conns.items()):
            if pid in self._blocked_ids or (
                    conn.listen_addr
                    and tuple(conn.listen_addr) in self._blocked_addrs):
                self._drop(conn)

    def chaos_link(self, *, loss: float = 0.0, delay: float = 0.0,
                   jitter: float = 0.0, dup: float = 0.0,
                   seed: int = 0) -> None:
        """Degrade every outbound gossip relay until chaos_clear():
        ``loss`` drops frames, ``delay``+``jitter`` defers them,
        ``dup`` sends twice. The link-quality sibling of chaos_block
        for scripted scenarios (sim/faults.py vocabulary; the netem/tc
        analogue of the reference's iptables chaos) — seeded, so a
        scenario's drop pattern replays exactly."""
        if loss or delay or jitter or dup:
            self._chaos_link = {
                "loss": float(loss), "delay": float(delay),
                "jitter": float(jitter), "dup": float(dup),
                "rng": random.Random(("chaos-link", seed).__repr__())}
        else:
            self._chaos_link = None

    def chaos_clear(self) -> None:
        self._blocked_addrs.clear()
        self._blocked_ids.clear()
        self._chaos_link = None

    async def _dial(self, addr: tuple[str, int]) -> None:
        if tuple(addr) in self._blocked_addrs:
            return
        try:
            reader, writer = await asyncio.wait_for(
                self._open_connection(addr), 5.0)
        except (OSError, asyncio.TimeoutError):
            return
        try:
            await self._handshake(reader, writer, outbound=True,
                                  dialed_addr=addr)
        except Exception:  # noqa: BLE001 — any peer garbage: close the fd
            writer.close()

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            await self._handshake(reader, writer, outbound=False)
        except Exception:  # noqa: BLE001 — any peer garbage: close the fd
            writer.close()

    async def _handshake(self, reader, writer, *, outbound: bool,
                         dialed_addr: tuple[str, int] | None = None) -> None:
        await asyncio.wait_for(self._do_handshake(
            reader, writer, outbound=outbound, dialed_addr=dialed_addr), 10.0)

    async def _do_handshake(self, reader, writer, *, outbound: bool,
                            dialed_addr=None) -> None:
        # 1) ephemeral key exchange -> encrypted channel (wrong-genesis
        # peers derive different keys and fail at the first frame)
        channel = await NoiseChannel.establish(
            reader, writer, genesis_id=self.genesis_id, initiator=outbound)
        # 2) encrypted HELLO: identity + listen port + channel-binding
        # signature proving possession of the ed25519 key
        await channel.send(MSG_HELLO, self._hello_payload(channel))
        ftype, payload = await channel.recv()
        if ftype != MSG_HELLO:
            raise HandshakeError("expected HELLO")
        genesis, peer_id, peer_port, sig = self._parse_hello(payload)
        if genesis != self.genesis_id:
            raise HandshakeError("genesis mismatch")  # network cookie
        if not channel.verify_binding(self.verifier, peer_id, sig,
                                      role_initiator=not outbound):
            raise HandshakeError("identity signature invalid")
        if peer_id == self.node_id:
            raise HandshakeError("self-dial")
        if self._banned.get(peer_id, 0) > self._now():
            raise HandshakeError("peer banned")
        if peer_id in self._blocked_ids:
            raise HandshakeError("peer blocked (chaos)")
        if (len(self._conns) >= self.max_peers
                and peer_id not in self._conns):
            raise HandshakeError("max peers reached")
        peer_host = writer.get_extra_info("peername")[0]
        listen_addr = dialed_addr or ((peer_host, peer_port)
                                      if peer_port else None)
        if listen_addr and tuple(listen_addr) in self._blocked_addrs:
            raise HandshakeError("address blocked (chaos)")
        conn = _Conn(reader, writer, peer_id, listen_addr, outbound,
                     channel=channel)

        # one connection per peer pair: on simultaneous dial, the dial
        # initiated by the LOWER node id survives
        existing = self._conns.get(peer_id)
        if existing is not None and not existing.closed.is_set():
            initiator = self.node_id if outbound else peer_id
            if initiator == min(self.node_id, peer_id):
                existing.close()
            else:
                raise HandshakeError("duplicate connection")
        self._conns[peer_id] = conn
        if listen_addr:
            self._known.setdefault(listen_addr, 0.0)
        conn.tasks = [asyncio.ensure_future(self._read_loop(conn)),
                      asyncio.ensure_future(self._gossip_loop(conn)),
                      asyncio.ensure_future(conn.write_loop())]
        # peer exchange: tell the new peer every listen addr we know
        await self._send_peers(conn)

    async def _send_peers(self, conn: _Conn) -> None:
        addrs = [a for a in self._known if a != conn.listen_addr][:64]
        payload = struct.pack("<H", len(addrs))
        for host_s, port in addrs:
            hb = host_s.encode()
            payload += struct.pack("<BH", len(hb), port) + hb
        try:
            await conn.send(MSG_PEERS, payload)
        except (OSError, ConnectionError):
            pass

    def _drop(self, conn: _Conn, ban: bool = False) -> None:
        conn.close()
        if self._conns.get(conn.node_id) is conn:
            del self._conns[conn.node_id]
            self.gossip.drop_peer(conn.node_id)
        if ban:
            self._banned[conn.node_id] = self._now() + self.ban_seconds
        # let the conn's own loops finish, then reap them (peer churn must
        # not accumulate tasks/queues forever)
        for task in conn.tasks:
            if task is not asyncio.current_task():
                task.cancel()
        conn.tasks = []

    # ------------------------------------------------------------------
    # frame processing

    async def _read_loop(self, conn: _Conn) -> None:
        try:
            while not conn.closed.is_set():
                ftype, payload = await conn.channel.recv()
                if ftype == MSG_GOSSIP:
                    # bounded like the send side: a gossip flood faster
                    # than local validation drains must not grow memory —
                    # drop the frame (gossip is redundant across peers)
                    # and penalize the flooder
                    if conn.gossip_queue.qsize() >= SEND_QUEUE_CAP:
                        self._penalize(conn)
                    else:
                        conn.gossip_queue.put_nowait(payload)
                elif ftype == MSG_REQ:
                    asyncio.ensure_future(self._handle_req(conn, payload))
                elif ftype == MSG_RESP:
                    self._handle_resp(conn, payload)
                elif ftype == MSG_PEERS:
                    self._handle_peers(payload)
                elif ftype == MSG_GOSSIP_CTRL:
                    await self._handle_gossip_ctrl(conn, payload)
                elif ftype == MSG_FIND:
                    await self._handle_find(conn, payload)
                elif ftype == MSG_FOUND:
                    self._handle_found(conn, payload)
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                HandshakeError, ChannelError, struct.error, ValueError,
                IndexError, UnicodeDecodeError):
            # the last four: truncated MSG_RESP/MSG_PEERS payloads from a
            # hostile peer — drop the connection, never kill the task
            # with an unhandled error
            pass
        finally:
            self._drop(conn)

    async def _gossip_loop(self, conn: _Conn) -> None:
        while not conn.closed.is_set():
            payload = await conn.gossip_queue.get()
            if payload is None:  # close sentinel
                return
            try:
                await self._handle_gossip(conn, payload)
            except Exception:  # noqa: BLE001 — bad msg must not kill the loop
                pass

    @staticmethod
    def _gossip_frame(topic: str, data: bytes) -> tuple[bytes, bytes]:
        tb = topic.encode()
        msg_id = sum256(tb, data)
        return msg_id, struct.pack("<B", len(tb)) + tb + msg_id + data

    def _mark_seen(self, msg_id: bytes) -> bool:
        """True if newly seen (shared insert/evict policy —
        gossipmesh.mark_seen — so the sim hub's dedup window can never
        silently diverge from the transport it models)."""
        from .gossipmesh import mark_seen

        return mark_seen(self._seen, msg_id, SEEN_CAP)

    async def _handle_gossip(self, conn: _Conn, payload: bytes) -> None:
        tlen = payload[0]
        topic = payload[1:1 + tlen].decode()
        msg_id = payload[1 + tlen:1 + tlen + 32]
        data = payload[1 + tlen + 32:]
        if sum256(topic.encode(), data) != msg_id:
            self._penalize(conn)
            return
        self.stats["gossip_rx"] += 1
        if not self._mark_seen(msg_id):
            self.stats["gossip_dup"] += 1
            return
        ok = True
        if self._pubsub is not None:
            ok = await self._pubsub.deliver(topic, conn.node_id, data)
        if ok:
            # eager-push along the topic mesh only (gossipsub forwarding);
            # lazy IHAVE repairs non-mesh peers at the next heartbeat
            self.gossip.on_message(msg_id, topic, payload)
            targets = self.gossip.eager_targets(topic, set(self._conns),
                                                exclude=conn.node_id)
            await self._relay(payload, targets)
        elif ok is False:
            self._penalize(conn)
        # ok is None: accepted but relay-suppressed (graded-gossip dup) —
        # an honest relayer must not be penalized for delivering it

    async def _handle_gossip_ctrl(self, conn: _Conn, payload: bytes) -> None:
        """GRAFT/PRUNE/IHAVE/IWANT (gossipsub control plane)."""
        from .gossipmesh import encode_ctrl

        replies = self.gossip.on_control(conn.node_id, payload,
                                         seen=lambda mid: mid in self._seen)
        for subtype, topic, ids in replies:
            try:
                if subtype == -1:  # answer IWANT with the full frames
                    for mid in ids:
                        frame = self.gossip.cache.get(mid)
                        if frame is not None:
                            self.stats["iwant_served"] += 1
                            self.stats["gossip_tx"] += 1
                            await conn.send(MSG_GOSSIP, frame)
                else:
                    await conn.send(MSG_GOSSIP_CTRL,
                                    encode_ctrl(subtype, topic, ids))
            except (OSError, ConnectionError):
                self._drop(conn)
                return

    def _penalize(self, conn: _Conn) -> None:
        conn.score += 1
        if conn.score >= self.reject_limit:
            self._drop(conn, ban=True)

    async def _relay(self, frame_payload: bytes,
                     targets: set[bytes]) -> None:
        pol = self._chaos_link
        for peer_id in targets:
            conn = self._conns.get(peer_id)
            if conn is None:
                continue
            copies = 1
            if pol is not None:
                rng = pol["rng"]
                if pol["loss"] and rng.random() < pol["loss"]:
                    continue
                if pol["dup"] and rng.random() < pol["dup"]:
                    copies = 2
                wait = pol["delay"] + (rng.random() * pol["jitter"]
                                       if pol["jitter"] else 0.0)
                if wait > 0:
                    asyncio.get_running_loop().call_later(
                        wait, self._relay_later, conn, frame_payload,
                        copies)
                    continue
            for _ in range(copies):
                self.stats["gossip_tx"] += 1
                try:
                    await conn.send(MSG_GOSSIP, frame_payload)
                except (OSError, ConnectionError):
                    self._drop(conn)
                    break

    def _relay_later(self, conn: _Conn, frame_payload: bytes,
                     copies: int) -> None:
        """Deferred chaos_link delivery; the peer may be gone by now.
        Encrypt-at-enqueue is preserved (nonce order == queue order ==
        wire order), as is the send-queue overflow contract."""
        if conn.closed.is_set():
            return
        for _ in range(copies):
            if conn.send_queue.qsize() >= SEND_QUEUE_CAP:
                conn.close()
                return
            self.stats["gossip_tx"] += 1
            try:
                conn.send_queue.put_nowait(
                    conn.channel.encrypt_frame(MSG_GOSSIP, frame_payload))
            except Exception:  # noqa: BLE001 — chaos must not kill the caller
                return

    async def _handle_req(self, conn: _Conn, payload: bytes) -> None:
        try:
            (req_id,) = struct.unpack_from("<Q", payload)
            plen = payload[8]
            proto = payload[9:9 + plen].decode()
            data = payload[9 + plen:]
        except (struct.error, IndexError, UnicodeDecodeError):
            # runs as its own task: a truncated request must not become
            # an unhandled task exception
            self._penalize(conn)
            return
        status, resp = 0, b""
        try:
            if self._server is None:
                raise ConnectionError("no server attached")
            resp = await self._server.handle(proto, conn.node_id, data)
        except Exception as e:  # noqa: BLE001 — error travels to the caller
            status, resp = 1, str(e).encode()[:512]
        try:
            await conn.send(MSG_RESP,
                            struct.pack("<QB", req_id, status) + resp)
        except (OSError, ConnectionError):
            self._drop(conn)

    def _handle_resp(self, conn: _Conn, payload: bytes) -> None:
        (req_id,) = struct.unpack_from("<Q", payload)
        status = payload[8]
        data = payload[9:]
        # keyed by (peer, req_id): a response only resolves a request that
        # was sent to THAT peer — req_ids are sequential and guessable, so
        # a malicious peer must not be able to answer someone else's
        # request with forged data
        fut = self._pending.pop((conn.node_id, req_id), None)
        if fut is None or fut.done():
            return
        if status == 0:
            fut.set_result(data)
        else:
            from .server import RequestError

            fut.set_exception(RequestError(data.decode(errors="replace")))

    # ------------------------------------------------------------------
    # iterative discovery (Kad-lite; reference p2p/dhtdiscovery/)

    DISC_K = 8       # entries per FIND answer
    DISC_ALPHA = 3   # parallel queries per lookup round

    async def _handle_find(self, conn: _Conn, payload: bytes) -> None:
        """FIND(nonce, target): answer the K connected peers closest to
        target by XOR distance, with their listen addresses (the
        FIND_NODE of Kademlia, scoped to live connections)."""
        (nonce,) = struct.unpack_from("<Q", payload)
        target = payload[8:40]
        if len(target) != 32:
            self._penalize(conn)
            return
        entries = []
        for pid, c in self._conns.items():
            if c.listen_addr is None or pid == conn.node_id:
                continue
            entries.append((_xor_dist(pid, target), pid, c.listen_addr))
        entries.sort(key=lambda e: e[0])
        blob = struct.pack("<QH", nonce, min(len(entries), self.DISC_K))
        for _, pid, (ip, port) in entries[:self.DISC_K]:
            ib = ip.encode()
            blob += pid + struct.pack("<BH", len(ib), port) + ib
        try:
            await conn.send(MSG_FOUND, blob)
        except (OSError, ConnectionError):
            self._drop(conn)

    def _handle_found(self, conn: _Conn, payload: bytes) -> None:
        nonce, count = struct.unpack_from("<QH", payload)
        off = 10
        entries = []
        for _ in range(min(count, self.DISC_K)):
            pid = payload[off:off + 32]
            iplen, port = struct.unpack_from("<BH", payload, off + 32)
            ip = payload[off + 35:off + 35 + iplen].decode()
            off += 35 + iplen
            entries.append((pid, (ip, port)))
        # keyed by (peer, nonce) like _handle_resp: sequential nonces are
        # guessable, a peer must not be able to answer another peer's
        # lookup (discovery poisoning)
        fut = self._disc_pending.pop((conn.node_id, nonce), None)
        if fut is not None and not fut.done():
            fut.set_result(entries)

    async def _find(self, peer_id: bytes, target: bytes,
                    timeout: float = 3.0,
                    addr: tuple | None = None) -> list[tuple[bytes, tuple]]:
        conn = self._conns.get(peer_id)
        if conn is None and addr is not None:
            # Kademlia iterates by CONTACTING closer nodes: dial first
            await self._dial(tuple(addr))
            conn = self._conns.get(peer_id)
        if conn is None:
            return []
        self._req_id += 1
        nonce = self._req_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._disc_pending[(peer_id, nonce)] = fut
        try:
            await conn.send(MSG_FIND,
                            struct.pack("<Q", nonce) + target)
            return await asyncio.wait_for(fut, timeout)
        except (OSError, ConnectionError, asyncio.TimeoutError):
            return []
        finally:
            self._disc_pending.pop((peer_id, nonce), None)

    async def discover(self, target: bytes,
                       max_rounds: int = 5) -> list[tuple[bytes, tuple]]:
        """Iterative lookup: repeatedly ask the closest known peers for
        peers closer to ``target`` until no progress (Kademlia's
        FIND_NODE loop over live connections).  Every address learned is
        fed to the dial maintainer, so lookups double as discovery
        beyond the bootstrap list."""
        shortlist: dict[bytes, tuple] = {
            pid: c.listen_addr for pid, c in self._conns.items()
            if c.listen_addr is not None}
        queried: set[bytes] = set()
        for _ in range(max_rounds):
            frontier = sorted(
                (pid for pid in shortlist if pid not in queried),
                key=lambda p: _xor_dist(p, target))[:self.DISC_ALPHA]
            if not frontier:
                break
            queried.update(frontier)
            results = await asyncio.gather(
                *(self._find(pid, target, addr=shortlist[pid])
                  for pid in frontier))
            for entries in results:
                for pid, addr in entries:
                    if pid == self.node_id or pid in shortlist:
                        continue
                    shortlist[pid] = addr
                    if len(self._known) < 1024:
                        self._known.setdefault(tuple(addr), 0.0)
            # termination: every unqueried candidate exhausted (the walk
            # must tolerate "farther" hops — a chain topology routes
            # through nodes whose ids are XOR-farther than the start)
        return sorted(shortlist.items(),
                      key=lambda e: _xor_dist(e[0], target))

    def _handle_peers(self, payload: bytes) -> None:
        (count,) = struct.unpack_from("<H", payload)
        off = 2
        for _ in range(min(count, 64)):
            hlen, port = struct.unpack_from("<BH", payload, off)
            off += 3
            host_s = payload[off:off + hlen].decode()
            off += hlen
            addr = (host_s, port)
            if addr != self.address and len(self._known) < 1024:
                self._known.setdefault(addr, 0.0)

    # ------------------------------------------------------------------
    # pubsub hub surface (PubSub._hub)

    async def broadcast(self, sender, topic: str, data: bytes) -> None:
        msg_id, frame = self._gossip_frame(topic, data)
        self._mark_seen(msg_id)  # don't re-deliver our own message
        self.gossip.on_message(msg_id, topic, frame)
        await self._relay(frame,
                          self.gossip.eager_targets(topic, set(self._conns)))

    # ------------------------------------------------------------------
    # req/resp net surface (Server._net)

    async def route(self, src: bytes, dst: bytes, protocol: str,
                    data: bytes) -> bytes:
        from .server import RequestError

        conn = self._conns.get(dst)
        if conn is None or conn.closed.is_set():
            raise RequestError(f"peer {dst.hex()[:8]} not reachable")
        self._req_id += 1
        req_id = self._req_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[(dst, req_id)] = fut
        pb = protocol.encode()
        try:
            await conn.send(MSG_REQ, struct.pack("<QB", req_id, len(pb))
                            + pb + data)
            # bounded even when called without Server.request's wait_for:
            # a peer that accepts the request but never answers must not
            # hang the caller
            return await asyncio.wait_for(fut, self.request_timeout)
        except asyncio.TimeoutError:
            raise RequestError(f"request to {dst.hex()[:8]} timed out")
        finally:
            self._pending.pop((dst, req_id), None)
