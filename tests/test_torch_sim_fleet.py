"""The port's verifyd drills (``spacemesh_tpu_torch/sim/``) on the CPU,
held to the JAX package's.

Twins of ``tests/test_sim_scenarios.py``'s verifyd-outage, fleet,
byzantine-verifyd and runtime-degrade tests and of
``tests/test_verifyd.py``'s verifyd-load replay test: each drill runs
twice through the port (``device="cpu"``), must be ``ok`` with the JAX
tests' named asserts and give equal digests, and its event stream must
equal the JAX package's for the same script. The ``fleet`` script carries
the JAX script's ``merged_capture`` assert (the drill's span capture,
merged and validated), and the fleet and runtime-degrade drills are held
to the JAX package's digests for two seeds.
"""

import copy
import json

import pytest
import torch

from spacemesh_tpu.sim import failover as jfailover
from spacemesh_tpu.sim import fleet as jfleet
from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim import verifyd_load as jverifyd_load
from spacemesh_tpu_torch.sim import failover, fleet, scenarios, verifyd_load

_JAX_RUN = {"verifyd": jverifyd_load.run_scenario,
            "failover": jfailover.run_scenario,
            "fleet": jfleet.run_scenario}


@pytest.fixture(autouse=True)
def built_once(monkeypatch):
    """The port's two runs of a drill share one built workload (the
    seeded init, prover and signers dominate a run on the CPU); the JAX
    side builds its own, and its events must still equal the port's."""
    real = verifyd_load._build_pools
    memo = {}

    def build(script, post_dir, device):
        key = json.dumps([script.get("workload"), script.get("seed"),
                          str(device)], sort_keys=True)
        if key not in memo:
            memo[key] = real(script, post_dir, device)
        return memo[key]

    for mod in (verifyd_load, failover, fleet):
        monkeypatch.setattr(mod, "_build_pools", build)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in
    parallel workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name: str, **overrides) -> dict:
    """The JAX package's script."""
    script = copy.deepcopy(jscenarios.builtin(name, **overrides))
    return script


def _twice_and_jax(script: dict, run, jax_script: dict):
    a = run(script, device="cpu")
    b = run(script, device="cpu")
    assert a.ok, [x for x in a.asserts if not x["ok"]]
    assert b.ok
    assert a.digest == b.digest
    assert script == jax_script
    j = _JAX_RUN[jax_script["engine"]](jax_script)
    assert j.ok
    assert a.events == j.events
    if jax_script["engine"] != "verifyd":
        assert a.digest == j.digest
    return a


def test_verifyd_load_replays_and_equals_the_jax_package():
    """tests/test_verifyd.py's cut-down verifyd-load script."""
    over = dict(waves=4, workload={"sigs": 24, "vrfs": 4, "posts": 2,
                                   "memberships": 4, "pows": 6},
                asserts=[
                    {"kind": "no_wrong_verdicts"},
                    {"kind": "shed", "client": "heavy", "reason": "rate",
                     "min": 1},
                    {"kind": "no_shed", "client": "light-0"},
                    {"kind": "sli_present", "name": "verifyd_request_p99"},
                ])
    script = scenarios.builtin("verifyd-load", light=2)
    script.update(copy.deepcopy(over))
    jscript = copy.deepcopy(jscenarios.builtin("verifyd-load", light=2))
    jscript.update(copy.deepcopy(over))
    a = _twice_and_jax(script, verifyd_load.run_scenario, jscript)
    assert a.stats["hub"]["shed"] >= 1
    json.loads(a.to_json())  # result serializes


def test_verifyd_outage_heals_and_replays_identically():
    a = _twice_and_jax(scenarios.builtin("verifyd-outage"),
                       failover.run_scenario, _jax_script("verifyd-outage"))
    kinds = {x["kind"]: x for x in a.asserts}
    assert kinds["no_wrong_verdicts"]["ok"]
    assert kinds["outage_local"]["ok"], kinds["outage_local"]
    assert kinds["remote_attempts_bounded"]["ok"]
    assert kinds["failback"]["ok"], kinds["failback"]
    assert kinds["breaker_sequence"]["ok"]
    assert kinds["slo_green"]["ok"], kinds["slo_green"]
    assert any(e.get("fault") == "kill_verifyd" for e in a.events)
    assert any(e.get("fault") == "restore_verifyd" for e in a.events)
    assert any(e.get("breaker") == "open" for e in a.events)
    assert any(e.get("breaker") == "closed" for e in a.events)


def test_fleet_drill_survives_chaos_and_replays_identically():
    a = _twice_and_jax(scenarios.builtin("fleet"), fleet.run_scenario,
                       _jax_script("fleet"))
    kinds = {x["kind"]: x for x in a.asserts}
    for k in ("no_wrong_verdicts", "typed_sheds_only", "fleet_bound",
              "reroutes", "steals", "blackout_local",
              "dead_replica_attempts_bounded", "breaker_sequence",
              "failback", "autoscale", "slo_green", "merged_capture"):
        assert kinds[k]["ok"], kinds[k]
    assert any(e.get("fault") == "kill_replica" for e in a.events)
    assert any(e.get("fault") == "blackout" for e in a.events)
    assert any(e.get("breaker") == "open" for e in a.events)
    assert any(e.get("breaker") == "closed" for e in a.events)


def test_byzantine_verifyd_audit_catches_flipped_verdicts():
    a = _twice_and_jax(scenarios.builtin("byzantine-verifyd"),
                       fleet.run_scenario, _jax_script("byzantine-verifyd"))
    kinds = {x["kind"]: x for x in a.asserts}
    for k in ("no_wrong_verdicts", "byzantine_detected",
              "breaker_sequence", "path_served", "failback", "slo_green"):
        assert kinds[k]["ok"], kinds[k]
    assert any(e.get("fault") == "byzantine_replica" for e in a.events)
    assert any(e.get("fault") == "restore_byzantine" for e in a.events)


def test_runtime_degrade_waits_for_the_engine_breaker():
    """The runtime engine's breaker and host fallback under a seeded
    device-fault plan: the breaker opens after the budget, the fallback
    carries the fault span bit-identically, recovery re-closes it."""
    a = _twice_and_jax(scenarios.builtin("runtime-degrade"),
                       failover.run_scenario,
                       _jax_script("runtime-degrade"))
    kinds = {x["kind"]: x for x in a.asserts}
    for k in ("bit_identical", "device_attempts_bounded", "fallbacks",
              "breaker_sequence", "breaker_recloses"):
        assert kinds[k]["ok"], kinds[k]
    rt = a.stats["runtime"]
    assert rt["device_attempts_in_fault"] <= 10
    assert rt["fallbacks"] >= 15 and rt["breaker"]["state"] == "closed"


@pytest.mark.parametrize("name,seed", [
    ("runtime-degrade", 4), ("runtime-degrade", 11), ("fleet", 8)])
def test_drill_digests_equal_the_jax_package_at_other_seeds(name, seed):
    """With the ``fleet`` drill's seed 7 above, two seeds each: the
    port's event stream and digest equal the JAX package's."""
    run = failover.run_scenario if name == "runtime-degrade" \
        else fleet.run_scenario
    a = _twice_and_jax(scenarios.builtin(name, seed=seed), run,
                       _jax_script(name, seed=seed))
    assert a.seed == seed


def test_drills_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in scenarios.builtin_names():
        with pytest.raises(RuntimeError, match="cuda"):
            scenarios.run(scenarios.builtin(name))
