"""The port's event fabric (``spacemesh_tpu_torch/sim/net.py``) held to the
JAX package's.

``tests/test_sim_fabric.py`` runs on the port through ``torch_twin``: the
wheel's ordering and generation checks, light relays without a control
plane, deterministic relay sets, fault-epoch caches, dirty-set heartbeats,
fabric selection and clean-world parity of the two fabrics. Then one
seeded world (mesh nodes and light relays, a degraded link policy,
partitions, churn and a heal) runs through each package's hub of both
fabrics on the virtual clock: every node's deliveries in order, the hub's
and the network's counters and the fabric metrics' deltas must be equal.
Last, the partition-heal scenario (majority and minority islands, storms,
a malformed-ATX adversary, the merge) must give the JAX package's digest
and ``record full=`` lines for the same seed, its full nodes' POST hashing
from ``hashlib`` (``torch_twin.hashlib_post``).
"""

import asyncio

import pytest

from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim.scenario import run_scenario as jrun
from spacemesh_tpu_torch.sim import scenarios
from torch_twin import export, hashlib_post

export("test_sim_fabric", globals())

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")
NAMES = [b"%03d" % i + bytes(29) for i in range(40)]


def _world(pkg: str, fabric: str) -> dict:
    """A seeded world on ``pkg``'s ``fabric`` hub: 12 mesh nodes, 28 light
    relays, storms under loss/dup/reorder, a partition and churn, a heal."""
    import importlib

    net_mod = importlib.import_module(f"{pkg}.sim.net")
    pubsub = importlib.import_module(f"{pkg}.p2p.pubsub")
    vclock = importlib.import_module(f"{pkg}.utils.vclock")
    metrics = importlib.import_module(f"{pkg}.utils.metrics")
    hub_cls = {"event": net_mod.EventMeshHub,
               "legacy": net_mod.LegacyMeshHub}[fabric]
    before = metrics.sim_fabric_events.sample()

    async def go():
        net = net_mod.SimNetwork(21, degree=4)
        hub = hub_cls(net, gossip_degree=3)
        seen = {}
        for i, name in enumerate(NAMES):
            ps = pubsub.PubSub(node_name=name, deliver_self=False)
            seen[name] = []

            async def h(peer, data, _n=name):
                seen[_n].append(data)
                return True

            ps.register("t1", h)
            hub.join(ps, light=i >= 12)
        net.build_topology()
        net.set_link_policy(net_mod.LinkPolicy(
            loss=0.05, delay=0.01, jitter=0.02, dup=0.05, reorder=0.05))
        for i in range(6):
            await hub._nodes[NAMES[i * 5]].publish("t1", b"a%d" % i)
            hub.heartbeat()
            await asyncio.sleep(0.1)
        net.partition([NAMES[:20], NAMES[20:]])
        for n in NAMES[30:34]:
            hub.suspend(n)
        for i in range(6):
            await hub._nodes[NAMES[(i * 7) % 40]].publish("t1", b"b%d" % i)
            hub.heartbeat()
            await asyncio.sleep(0.1)
        net.heal()
        for n in NAMES[30:34]:
            hub.resume(n)
        net.set_link_policy(net_mod.LinkPolicy())
        for i in range(4):
            await hub._nodes[NAMES[i * 9]].publish("t1", b"c%d" % i)
            hub.heartbeat()
            await asyncio.sleep(0.1)
        await hub.drain()
        await asyncio.sleep(5.0)
        if hasattr(hub, "finalize"):
            hub.finalize()
        if hasattr(hub, "close"):
            hub.close()
        return dict(seen=seen, hub=dict(hub.stats), net=dict(net.stats))

    out = vclock.run_virtual(go())
    after = metrics.sim_fabric_events.sample()
    out["fabric_events"] = {k: after.get(k, 0) - before.get(k, 0)
                            for k in after}
    return out


@pytest.mark.parametrize("fabric", ["event", "legacy"])
def test_seeded_world_equals_the_jax_packages(fabric):
    jax_out, port_out = (_world(pkg, fabric) for pkg in PKGS)
    assert sum(map(len, port_out["seen"].values())) > 0
    assert port_out == jax_out


def test_partition_heal_digest_equals_the_jax_packages(tmp_path):
    with hashlib_post():
        port = scenarios.run(scenarios.builtin("partition-heal"),
                             device="cpu")
    ref = jrun(jscenarios.builtin("partition-heal"), tmp=tmp_path)
    assert port.ok, [a for a in port.asserts if not a["ok"]]
    assert ref.ok
    kinds = {a["kind"]: a for a in port.asserts}
    assert kinds["converged"]["ok"], kinds["converged"]
    records = [[e.split(" ", 1)[1] for e in r.events
                if " record full=" in e] for r in (port, ref)]
    assert records[0] == records[1]
    assert port.digest == ref.digest
