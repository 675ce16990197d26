"""Consistent-hash placement for the verifyd fleet (port of
``spacemesh_tpu/verifyd/routing.py``: the same hash, ring and moves, so
a router of either package places every client alike).

Two layers, both DETERMINISTIC functions of (seed, member names,
client ids) — never of process identity:

* :class:`HashRing` — the classic vnode ring, hashed with seeded
  sha256.  Python's builtin ``hash()`` is salted per process
  (PYTHONHASHSEED), which would silently break the fleet's core
  contract: two routers built from the same seed and member set MUST
  place the same client on the same replica, or a restarted router
  would scatter every client's admission state (token bucket level,
  fair-share vtime, per-client series) across the fleet.
* :class:`Placement` — a STICKY bounded-load assignment table over the
  ring (Mirrokni et al.'s consistent hashing with bounded loads).  Each
  replica holds at most ``ceil(load_factor * K / N)`` clients; a client
  whose ring owner is full spills clockwise to the next replica with
  headroom.  Membership changes move only the clients they must:
  *remove* re-places exactly the dead replica's clients (≤ capacity of
  one replica), *add* moves only clients whose FIRST ring choice is the
  new replica, hard-capped at ``ceil(K / N)`` — so with the default
  ``load_factor=1.0`` any single membership change relocates at most
  ``ceil(K / N)`` clients.
"""

from __future__ import annotations

import bisect
import hashlib
import math

DEFAULT_VNODES = 64


def ring_hash(seed: int, *parts) -> int:
    """64-bit seeded sha256 point — the ONLY hash the ring uses."""
    h = hashlib.sha256(str(int(seed)).encode("ascii"))
    for p in parts:
        h.update(b"\x00")
        h.update(str(p).encode("utf-8"))
    return int.from_bytes(h.digest()[:8], "big")


class HashRing:
    """Seeded vnode ring over replica names."""

    def __init__(self, members=(), *, seed: int = 0,
                 vnodes: int = DEFAULT_VNODES):
        self.seed = int(seed)
        self.vnodes = max(int(vnodes), 1)
        self._points: list[tuple[int, str]] = []   # sorted (hash, member)
        self._members: set[str] = set()
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return str(member) in self._members

    def members(self) -> list[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        member = str(member)
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            # the member name disambiguates equal hashes so ring order
            # never depends on insertion order
            bisect.insort(self._points,
                          (ring_hash(self.seed, member, v), member))

    def remove(self, member: str) -> None:
        member = str(member)
        if member not in self._members:
            return
        self._members.discard(member)
        self._points = [p for p in self._points if p[1] != member]

    def key_point(self, key: str) -> int:
        return ring_hash(self.seed, "key", key)

    def walk(self, key: str):
        """Members in ring order clockwise from ``key``'s point, each
        yielded once — the client's full preference chain."""
        if not self._points:
            return
        i = bisect.bisect_left(self._points, (self.key_point(key), ""))
        seen: set[str] = set()
        n = len(self._points)
        for off in range(n):
            member = self._points[(i + off) % n][1]
            if member not in seen:
                seen.add(member)
                yield member

    def owner(self, key: str) -> str:
        """First ring choice, ignoring load (raises on an empty ring)."""
        for member in self.walk(key):
            return member
        raise LookupError("hash ring has no members")


class Placement:
    """Sticky bounded-load client→replica assignment over a HashRing."""

    def __init__(self, *, seed: int = 0, vnodes: int = DEFAULT_VNODES,
                 load_factor: float = 1.0):
        self.ring = HashRing(seed=seed, vnodes=vnodes)
        self.load_factor = max(float(load_factor), 1.0)
        self.assign: dict[str, str] = {}           # client -> replica
        self.loads: dict[str, int] = {}            # replica -> #clients

    # -- introspection ---------------------------------------------------

    def replicas(self) -> list[str]:
        return self.ring.members()

    def capacity(self, clients: int | None = None) -> int:
        """Per-replica client cap for ``clients`` total (bounded load)."""
        n = len(self.loads)
        if n == 0:
            raise LookupError("placement has no replicas")
        k = len(self.assign) if clients is None else int(clients)
        return max(math.ceil(self.load_factor * k / n), 1)

    def replica_of(self, cid: str) -> str | None:
        return self.assign.get(str(cid))

    # -- membership ------------------------------------------------------

    def add_replica(self, name: str) -> list[tuple[str, str, str]]:
        """Add a replica; -> [(client, old, new)] for every client moved
        onto it (≤ ceil(K/N) — the hard rebalance budget)."""
        name = str(name)
        if name in self.loads:
            return []
        self.ring.add(name)
        self.loads[name] = 0
        if not self.assign:
            return []
        k, n = len(self.assign), len(self.loads)
        cap = self.capacity()
        budget = math.ceil(k / n)
        moved: list[tuple[str, str, str]] = []
        # deterministic sweep order: ring order of the clients, so two
        # routers replaying the same membership history agree
        for cid in sorted(self.assign,
                          key=lambda c: (self.ring.key_point(c), c)):
            if len(moved) >= budget or self.loads[name] >= cap:
                break
            if self.ring.owner(cid) != name:
                continue
            old = self.assign[cid]
            if old == name:
                continue
            self.loads[old] -= 1
            self.loads[name] += 1
            self.assign[cid] = name
            moved.append((cid, old, name))
        return moved

    def remove_replica(self, name: str) -> list[tuple[str, str, str]]:
        """Drop a replica; its clients (≤ one replica's capacity) spill
        clockwise to survivors with headroom."""
        name = str(name)
        if name not in self.loads:
            return []
        self.ring.remove(name)
        del self.loads[name]
        displaced = sorted(
            (c for c, r in self.assign.items() if r == name),
            key=lambda c: (self.ring.key_point(c), c))
        for cid in displaced:
            del self.assign[cid]
        moved: list[tuple[str, str, str]] = []
        if not self.loads:
            return [(cid, name, "") for cid in displaced]
        for cid in displaced:
            moved.append((cid, name, self.place(cid)))
        return moved

    # -- clients ---------------------------------------------------------

    def place(self, cid: str) -> str:
        """The client's replica (assigning it on first sight): first
        ring choice with bounded-load headroom, spilling clockwise."""
        cid = str(cid)
        got = self.assign.get(cid)
        if got is not None:
            return got
        cap = self.capacity(len(self.assign) + 1)
        last = None
        for member in self.ring.walk(cid):
            last = member
            if self.loads[member] < cap:
                break
        if last is None:
            raise LookupError("placement has no replicas")
        self.assign[cid] = last
        self.loads[last] += 1
        return last

    def reroute(self, cid: str, avoid: str) -> str | None:
        """Move ``cid`` off ``avoid`` to its next ring choice with
        headroom (a typed registry_full shed re-routes instead of
        surfacing); None when no other replica exists."""
        cid = str(cid)
        current = self.assign.get(cid)
        cap = self.capacity()
        best = None
        for member in self.ring.walk(cid):
            if member == avoid:
                continue
            if best is None:
                best = member            # last resort: everyone full
            if self.loads[member] < cap:
                best = member
                break
        if best is None:
            return None
        if current is not None:
            self.loads[current] -= 1
        self.assign[cid] = best
        self.loads[best] += 1
        return best

    def forget(self, cid: str) -> str | None:
        """Drop a client (it unregistered); -> the replica it held."""
        old = self.assign.pop(str(cid), None)
        if old is not None and old in self.loads:
            self.loads[old] -= 1
        return old

    def doc(self) -> dict:
        return {"replicas": self.replicas(),
                "clients": len(self.assign),
                "loads": dict(sorted(self.loads.items())),
                "capacity": (self.capacity() if self.loads else 0),
                "load_factor": self.load_factor}
