"""The port's deterministic scenario engine (port of ``spacemesh_tpu/sim/``).

Hundreds-to-thousands of in-process nodes run on ONE VirtualClockLoop
through scripted scenarios: partitions and healing, eclipse, churn, link
degradation and adversarial payloads, judged by the windowed SLIs of
``obs/sli.py``, span traces and consensus state, never by wall-clock
sleeps. Same seed => same event digest, and the digest equals the JAX
package's for the same script, whatever the device.

Layout:
  net.py            SimNetwork (topology + fault state), the event and
                    legacy gossip hubs, SimNet (req/resp)
  node.py           LightNode, FullNode (a real App on ``device``)
  shard.py          the light relays over W worker processes with
                    conservative virtual-time windows
  faults.py         the fault vocabulary and adversarial payloads
  scenario.py       the engine: phases, traffic, faults, SLI and trace
                    judges, the event digest
  crash_recovery.py the faultfs crash sweep over a tiny POST init
  verifyd_load.py, failover.py, fleet.py
                    the verifyd fleet's drills
  scenarios.py      the built-in scripts, ``builtin()`` and ``run()``
  __main__.py       CLI: python -m spacemesh_tpu_torch.sim --scenario ...
                    --device cuda|cpu

Every ``run_scenario`` takes ``device=`` and defaults to ``"cuda"``.
Exports resolve lazily (PEP 562): a shard worker imports
``spacemesh_tpu_torch.sim.shard`` alone, and never imports torch.
"""

_EXPORTS = {
    "LinkPolicy": "net",
    "MeshHub": "net",
    "SimNet": "net",
    "SimNetwork": "net",
    "ScenarioResult": "scenario",
    "run_scenario": "scenario",
    "builtin": "scenarios",
    "builtin_names": "scenarios",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
