"""The port's consistent-hash fleet placement
(``spacemesh_tpu_torch/verifyd/routing.py``), held to the JAX package's.

Twins of ``tests/test_fleet_routing.py`` on the port, plus the parity
case: for seeds 0-3 and 2400 client ids, ``ring_hash``,
``HashRing.owner/walk`` and ``Placement``'s place/reroute/add/remove move
lists equal the JAX package's.

The two contracts everything downstream leans on: placement is a
DETERMINISTIC function of (seed, members, client ids) — pinned across
processes with different PYTHONHASHSEED salts, because a restarted
router that scatters placements scatters every client's admission
state — and membership changes move at most ceil(K/N) clients (the
bounded-load rebalance budget).
"""

import json
import math
import os
import subprocess
import sys

import pytest

from spacemesh_tpu.verifyd import routing as jrouting
from spacemesh_tpu_torch.verifyd.routing import HashRing, Placement, ring_hash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTING = os.path.join(REPO, "spacemesh_tpu_torch", "verifyd",
                       "routing.py")

# loads routing.py standalone (stdlib-only module) so the subprocess
# proves hash stability without paying the package import
_SCRIPT = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("routing", sys.argv[1])
routing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(routing)
p = routing.Placement(seed=42)
for r in ("r0", "r1", "r2"):
    p.add_replica(r)
for i in range(60):
    p.place(f"c{i:03d}")
print(json.dumps(p.assign, sort_keys=True))
"""


def _placement_in_subprocess(hashseed: str) -> dict:
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, ROUTING], env=env,
        capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


def _placed(seed=42, replicas=("r0", "r1", "r2"), clients=60):
    p = Placement(seed=seed)
    for r in replicas:
        p.add_replica(r)
    for i in range(clients):
        p.place(f"c{i:03d}")
    return p


def test_cross_process_placement_is_identical():
    """Same seed + members + ids => same table, whatever the process
    hash salt (builtin hash() would silently break this)."""
    local = _placed().assign
    assert _placement_in_subprocess("1") == local
    assert _placement_in_subprocess("31337") == local


def test_ring_hash_never_uses_builtin_hash():
    # pinned value: any accidental switch to a salted hash shows up as
    # a different constant in SOME process
    assert ring_hash(42, "key", "c000") == ring_hash(42, "key", "c000")
    assert ring_hash(42, "key", "c000") != ring_hash(43, "key", "c000")
    assert ring_hash(0, "a", 1) != ring_hash(0, "a", 2)


def test_ring_order_is_insertion_order_independent():
    a = HashRing(["r0", "r1", "r2"], seed=7)
    b = HashRing(["r2", "r0", "r1"], seed=7)
    for key in ("alice", "bob", "c042"):
        assert list(a.walk(key)) == list(b.walk(key))
    # walk yields every member exactly once
    chain = list(a.walk("alice"))
    assert sorted(chain) == a.members() and len(chain) == 3


def test_empty_ring_raises():
    with pytest.raises(LookupError):
        HashRing(seed=1).owner("x")
    with pytest.raises(LookupError):
        Placement(seed=1).place("x")


def test_bounded_load_capacity_respected_throughout():
    p = Placement(seed=3)
    for r in ("r0", "r1", "r2"):
        p.add_replica(r)
    for i in range(90):
        p.place(f"c{i:03d}")
        k, n = len(p.assign), 3
        cap = math.ceil(k / n)
        assert max(p.loads.values()) <= cap
    assert sum(p.loads.values()) == 90


def test_add_replica_moves_at_most_ceil_k_over_n():
    p = _placed(clients=100)
    before = dict(p.assign)
    moved = p.add_replica("r3")
    assert len(moved) <= math.ceil(100 / 4)
    for cid, old, new in moved:
        assert new == "r3" and before[cid] == old != "r3"
        assert p.assign[cid] == "r3"
    # everyone else stayed put (sticky), and the books balance
    untouched = set(before) - {m[0] for m in moved}
    assert all(p.assign[c] == before[c] for c in untouched)
    assert sum(p.loads.values()) == 100
    # sticky add: survivors keep at most their PRE-add bounded load
    # (shrinking them further would blow the ceil(K/N) move budget)
    assert max(p.loads.values()) <= math.ceil(100 / 3)


def test_remove_replica_moves_only_its_clients():
    p = _placed(clients=100)
    before = dict(p.assign)
    victims = {c for c, r in before.items() if r == "r1"}
    moved = p.remove_replica("r1")
    assert {m[0] for m in moved} == victims
    assert len(moved) <= math.ceil(100 / 3) + 1  # ≤ one replica's cap
    for cid, old, new in moved:
        assert old == "r1" and new in ("r0", "r2")
    untouched = set(before) - victims
    assert all(p.assign[c] == before[c] for c in untouched)
    assert "r1" not in p.loads and sum(p.loads.values()) == 100


def test_membership_change_replay_converges():
    """Two placements replaying the same membership history agree —
    the restarted-router contract, add/remove included."""
    def build():
        p = Placement(seed=9)
        for r in ("r0", "r1"):
            p.add_replica(r)
        for i in range(40):
            p.place(f"c{i:03d}")
        p.add_replica("r2")
        p.remove_replica("r0")
        return p
    assert build().assign == build().assign


def test_reroute_avoids_and_forget_releases():
    p = _placed(clients=12)
    cid = "c003"
    old = p.assign[cid]
    new = p.reroute(cid, old)
    assert new is not None and new != old
    assert p.assign[cid] == new
    assert sum(p.loads.values()) == 12
    assert p.forget(cid) == new
    assert cid not in p.assign and sum(p.loads.values()) == 11
    # single-replica fleet: nowhere else to go
    solo = Placement(seed=1)
    solo.add_replica("only")
    solo.place("x")
    assert solo.reroute("x", "only") is None


# --- parity with the JAX package ------------------------------------------


def _history(mod, seed: int, clients: list) -> list:
    """One membership + client history through a package's Placement;
    every answer and move list in order."""
    p = mod.Placement(seed=seed)
    out = [p.add_replica(r) for r in ("r0", "r1", "r2")]
    out.append([p.place(c) for c in clients])
    out.append([p.reroute(c, p.replica_of(c)) for c in clients[::97]])
    out.append(p.add_replica("r3"))
    out.append(p.remove_replica("r1"))
    out.append([p.place(f"late{i}") for i in range(50)])
    out.append([p.forget(c) for c in clients[::131]])
    out.append(p.add_replica("r1"))
    out.append(p.remove_replica("r0"))
    out.append((dict(p.assign), dict(p.loads), p.doc()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_placement_and_moves_equal_the_jax_package(seed):
    clients = [f"client-{seed}-{i:04d}" for i in range(2400)]
    assert _history(jrouting, seed, clients) == \
        _history(__import__("spacemesh_tpu_torch.verifyd.routing",
                            fromlist=["Placement"]), seed, clients)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_hash_owner_and_walk_equal_the_jax_package(seed):
    members = [f"r{i}" for i in range(5)]
    jring = jrouting.HashRing(members, seed=seed)
    ring = HashRing(members, seed=seed)
    for i in range(2400):
        key = f"c{i:04d}"
        assert ring_hash(seed, "key", key) == \
            jrouting.ring_hash(seed, "key", key)
        assert ring.owner(key) == jring.owner(key)
        if i % 40 == 0:
            assert list(ring.walk(key)) == list(jring.walk(key))
