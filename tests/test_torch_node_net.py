"""The port's node network (``spacemesh_tpu_torch/node/app.py`` over
``p2p/{pubsub,server,fetch,sync}.py`` on ``utils/vclock.py``) against the
JAX package's, byte for byte.

``tests/test_multinode.py``'s network (A smeshes, B observes from genesis,
C joins after one epoch and syncs) runs on the port through
``torch_twin`` (``device="cpu"``), and its cases hold there. Then the same
network, with the same seeded signers, genesis and configuration, runs on
the JAX package (its POST on the CPU, as its own tests run it) on the JAX
package's ``VirtualClockLoop``: the ATX ids of each epoch, the applied
block, state root and aggregated hash of every layer on A, B and C, every
tortoise's ``updates()`` and each node's sequence of ``AtxPublished`` and
``LayerUpdate`` events must be equal. Exact equality is the tolerance.
"""

import dataclasses
import importlib

import pytest

from torch_twin import export, load

export("test_multinode", globals())

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def updates_log():
    """Every ``Tortoise.updates()`` drain of both packages, by tortoise
    (autouse: the patch must precede the port network's run)."""
    log: dict[int, list] = {}
    patched = []
    for pkg in PKGS:
        cls = importlib.import_module(f"{pkg}.consensus.tortoise").Tortoise
        real = cls.updates

        def updates(self, _real=real):
            out = _real(self)
            log.setdefault(id(self), []).extend(
                (u.layer, bytes(u.block_id), bool(u.valid)) for u in out)
            return out

        cls.updates = updates
        patched.append((cls, real))
    yield log
    for cls, real in patched:
        cls.updates = real


def _record(apps, pkg, log) -> dict:
    layers = importlib.import_module(f"{pkg}.storage.layers")
    atxs = importlib.import_module(f"{pkg}.storage.atxs")
    a = apps[0]
    out = {"atxs": [atxs.ids_in_epoch(a.state, e) for e in range(4)]}
    for name, app in zip("abc", apps):
        top = layers.last_applied(app.state)
        out[name] = {
            "applied": top,
            "layers": [(lyr, layers.applied_block(app.state, lyr),
                        layers.state_hash(app.state, lyr),
                        layers.aggregated_hash(app.state, lyr))
                       for lyr in range(top + 1)],
            "updates": log.get(id(app.tortoise), []),
            "events": [(etype, dataclasses.astuple(ev))
                       for _t, etype, ev in app.events.recent
                       if etype in ("AtxPublished", "LayerUpdate")],
        }
    return out


def _jax_network(tmp_path_factory):
    mod = load("test_multinode", "spacemesh_tpu")
    return mod.network._get_wrapped_function()(tmp_path_factory)


def test_network_equals_the_jax_packages(updates_log, network,
                                         tmp_path_factory):
    port = _record(network, "spacemesh_tpu_torch", updates_log)
    jax_apps = _jax_network(tmp_path_factory)
    try:
        ref = _record(jax_apps, "spacemesh_tpu", updates_log)
    finally:
        for app in jax_apps:
            app.close()
    assert all(port["atxs"][e] for e in (0, 1))
    assert [t for t, _ in port["a"]["events"]].count("AtxPublished") >= 2
    assert port["atxs"] == ref["atxs"]
    for name in "abc":
        assert port[name]["applied"] >= 3, name
        assert port[name]["layers"] == ref[name]["layers"], name
        assert port[name]["updates"], name
        assert port[name]["updates"] == ref[name]["updates"], name
        assert port[name]["events"] == ref[name]["events"], name
