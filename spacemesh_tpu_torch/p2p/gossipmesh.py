"""Gossipsub-lite: degree-bounded per-topic meshes + lazy IHAVE/IWANT (port
of ``spacemesh_tpu/p2p/gossipmesh.py``).

Replaces flood relay (O(edges) duplication) with the gossipsub structure
the reference rides (reference p2p/pubsub/pubsub.go:211-311 mesh
parameters; libp2p gossipsub v1.0 semantics):

* per-topic MESH of degree ~D: full messages are eager-pushed only to
  mesh peers;
* lazy gossip to a few non-mesh peers each heartbeat: IHAVE(recent ids);
  a peer missing one answers IWANT and gets the full frame — the repair
  path that keeps sparse meshes connected;
* GRAFT/PRUNE keep each topic mesh within [d_lo, d_hi], symmetric via
  the GRAFT handshake (over-subscribed peers answer PRUNE).

Every node here subscribes to every topic (the node runs all protocol
handlers), so subscription bookkeeping is implicit.  Control frames ride
the transport as MSG_GOSSIP_CTRL; full messages stay MSG_GOSSIP so the
wire format of data frames is unchanged.
"""

from __future__ import annotations

import hashlib
import random
import struct

GRAFT, PRUNE, IHAVE, IWANT = range(4)

_ID = 32  # gossip message ids are sum256 digests

SEEN_CAP = 1 << 14


def mark_seen(seen: dict, msg_id: bytes, cap: int = SEEN_CAP) -> bool:
    """Insert into an insertion-ordered seen-cache; True if newly seen.
    Evicts the oldest quarter when full. ONE implementation shared by
    the socket transport and the sim hub so their dedup windows can
    never silently diverge."""
    if msg_id in seen:
        return False
    seen[msg_id] = None
    if len(seen) > cap:
        for key in list(seen)[:cap // 4]:
            del seen[key]
    return True


def relay_sample(topic: str, name: bytes, peers, k: int) -> tuple:
    """Deterministic sparse relay set for a light relay: the first ``k``
    of ``peers`` ranked by sha256(topic || name || peer). Every (topic,
    node) pair gets a different but cross-process-stable subset, so the
    union of relay edges forms a connected expander over the topology
    without any node running the gossipsub control plane."""
    tb = topic.encode()
    ranked = sorted(peers,
                    key=lambda p: hashlib.sha256(tb + name + p).digest())
    return tuple(ranked[:k])


def encode_ctrl(subtype: int, topic: str, ids: list[bytes] = ()) -> bytes:
    tb = topic.encode()
    return struct.pack("<BB", subtype, len(tb)) + tb + b"".join(ids)


def decode_ctrl(payload: bytes) -> tuple[int, str, list[bytes]]:
    subtype, tlen = struct.unpack_from("<BB", payload)
    topic = payload[2:2 + tlen].decode()
    blob = payload[2 + tlen:]
    if len(blob) % _ID:
        raise ValueError("ragged id list")
    ids = [blob[i:i + _ID] for i in range(0, len(blob), _ID)]
    return subtype, topic, ids


class MessageCache:
    """Recent full frames by id, with a sliding IHAVE window (gossipsub
    mcache: `history` heartbeats of ids, payloads kept for IWANT)."""

    def __init__(self, history: int = 5, max_msgs: int = 1 << 10):
        self.history = history
        self.max_msgs = max_msgs
        self._frames: dict[bytes, tuple[str, bytes]] = {}  # id -> (topic, frame)
        self._window: list[list[tuple[bytes, str]]] = [[]]  # per-heartbeat ids

    def put(self, msg_id: bytes, topic: str, frame: bytes) -> None:
        if msg_id in self._frames:
            return
        self._frames[msg_id] = (topic, frame)
        self._window[0].append((msg_id, topic))
        # age out whole rounds first...
        while len(self._window) > 1 and len(self._frames) > self.max_msgs:
            for mid, _ in self._window.pop():
                self._frames.pop(mid, None)
        # ...then hard-trim the current round: a burst bigger than the
        # cache within ONE heartbeat must not balloon memory (frames can
        # be large; ids stay droppable — IWANT for them just misses)
        while len(self._frames) > self.max_msgs and self._window[0]:
            mid, _ = self._window[0].pop(0)
            self._frames.pop(mid, None)

    def get(self, msg_id: bytes) -> bytes | None:
        entry = self._frames.get(msg_id)
        return entry[1] if entry else None

    def empty(self) -> bool:
        """True once every frame AND every window round has aged out —
        the hub's dirty-set heartbeat uses this to retire quiet nodes
        (an empty cache has no IHAVE left to advertise)."""
        return not self._frames and not any(self._window)

    def shift(self) -> None:
        """One heartbeat passed: rotate the IHAVE window."""
        self._window.insert(0, [])
        while len(self._window) > self.history:
            for mid, _ in self._window.pop():
                self._frames.pop(mid, None)

    def recent_ids(self, topic: str) -> list[bytes]:
        return [mid for round_ in self._window
                for mid, t in round_ if t == topic]


class GossipMesh:
    """Mesh membership + control-plane logic; the Host owns the sockets
    and calls in with peer ids, getting (peer, frame-payload) sends out."""

    MAX_TOPICS = 64  # control-frame topic-spam guard (see on_control)

    def __init__(self, *, degree: int = 6, d_lo: int = 4, d_hi: int = 8,
                 lazy: int = 3, history: int = 20,
                 rng: random.Random | None = None):
        # history (IHAVE window in heartbeats) is deliberately deeper than
        # gossipsub's default 5: repair must survive a loaded event loop
        # where several heartbeats' worth of work lands late; ids are 32
        # bytes and frames are already capped by max_msgs, so depth is
        # nearly free
        self.degree = degree
        self.d_lo = d_lo
        self.d_hi = d_hi
        self.lazy = lazy            # IHAVE fanout per heartbeat per topic
        self.mesh: dict[str, set[bytes]] = {}
        self.cache = MessageCache(history=history)
        self.rng = rng or random.Random(0xC0FFEE)
        # ids a peer asked for repeatedly (IWANT abuse guard)
        self._served: dict[tuple[bytes, bytes], int] = {}

    def topics(self) -> list[str]:
        return list(self.mesh)

    def _mesh(self, topic: str) -> set[bytes]:
        return self.mesh.setdefault(topic, set())

    # -- data plane --------------------------------------------------

    def eager_targets(self, topic: str, connected: set[bytes],
                      exclude: bytes | None = None) -> set[bytes]:
        """Peers that get the full frame NOW.  Until the mesh for a topic
        has formed (bootstrap), fall back to flood so nothing stalls.
        Read-only on the topic table: relaying must not grow it (the
        spam cap in on_message owns admission)."""
        mesh = self.mesh.get(topic, set()) & connected
        targets = mesh if mesh else set(connected)
        if exclude is not None:
            targets = targets - {exclude}
        return targets

    def on_message(self, msg_id: bytes, topic: str, frame: bytes) -> None:
        # learn the topic — but attacker-chosen topic strings on DATA
        # frames must not grow the per-topic tables (and with them the
        # heartbeat's GRAFT/IHAVE work) without bound, same cap as the
        # control plane; the frame still lands in the (size-bounded)
        # cache so IWANT can serve it
        if topic in self.mesh or len(self.mesh) < self.MAX_TOPICS:
            self._mesh(topic)
        self.cache.put(msg_id, topic, frame)

    # -- control plane -----------------------------------------------

    def on_control(self, peer: bytes, payload: bytes,
                   seen) -> list[tuple[int, str, list[bytes]]]:
        """Handle one control frame; returns replies [(subtype, topic,
        ids)] to send back to ``peer``.  ``seen(msg_id)`` tells whether
        we already hold a message."""
        subtype, topic, ids = decode_ctrl(payload)
        if topic not in self.mesh and len(self.mesh) >= self.MAX_TOPICS:
            # topic-spam guard: a hostile peer must not grow the
            # per-topic tables without bound — unknown topics past the
            # cap answer GRAFT with PRUNE and drop the rest (data
            # frames hit the same cap in on_message; the node's own
            # topics were learned long before any attacker fills it)
            return [(PRUNE, topic, [])] if subtype == GRAFT else []
        mesh = self._mesh(topic)
        if subtype == GRAFT:
            if len(mesh) >= self.d_hi:
                return [(PRUNE, topic, [])]
            mesh.add(peer)
            return []
        if subtype == PRUNE:
            mesh.discard(peer)
            return []
        if subtype == IHAVE:
            want = [i for i in ids if not seen(i)]
            return [(IWANT, topic, want[:64])] if want else []
        if subtype == IWANT:
            out = []
            for mid in ids[:64]:
                key = (peer, mid)
                self._served[key] = self._served.get(key, 0) + 1
                if self._served[key] > 3:
                    continue  # IWANT spam guard (gossipsub GossipRetransmission)
                if len(self._served) > (1 << 12):
                    self._served.clear()
                if self.cache.get(mid) is not None:
                    out.append(mid)
            return [(-1, topic, out)] if out else []  # -1: send full frames
        raise ValueError(f"unknown control subtype {subtype}")

    def drop_peer(self, peer: bytes) -> None:
        for mesh in self.mesh.values():
            mesh.discard(peer)

    # -- heartbeat ---------------------------------------------------

    def heartbeat(self, connected: set[bytes]) -> list[tuple[bytes, int, str,
                                                             list[bytes]]]:
        """Mesh maintenance + lazy gossip; returns control sends
        [(peer, subtype, topic, ids)]."""
        out: list[tuple[bytes, int, str, list[bytes]]] = []
        for topic in list(self.mesh):
            mesh = self._mesh(topic)
            mesh &= connected  # forget gone peers
            if len(mesh) < self.d_lo:
                candidates = sorted(connected - mesh)
                self.rng.shuffle(candidates)
                for peer in candidates[:self.degree - len(mesh)]:
                    mesh.add(peer)
                    out.append((peer, GRAFT, topic, []))
            elif len(mesh) > self.d_hi:
                excess = sorted(mesh)
                self.rng.shuffle(excess)
                for peer in excess[:len(mesh) - self.degree]:
                    mesh.discard(peer)
                    out.append((peer, PRUNE, topic, []))
            # lazy gossip: advertise the recent window to non-mesh peers
            ids = self.cache.recent_ids(topic)
            if ids:
                lazy_pool = sorted(connected - mesh)
                self.rng.shuffle(lazy_pool)
                for peer in lazy_pool[:self.lazy]:
                    out.append((peer, IHAVE, topic, ids[-64:]))
        self.cache.shift()
        return out
