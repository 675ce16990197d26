"""The port's crash drills on the CPU, held to the JAX package's.

``crash-recovery`` (``spacemesh_tpu_torch/sim/crash_recovery.py``, the
faultfs sweep over a tiny POST init: power cuts and torn writes at seeded
op sites, each store rebooted and recovered, then an ENOSPC hold) runs on
the port's plain CPU path with ``device="cpu"`` and must give the JAX
package's digest and event log for the same seeds, replay-stable, with the
JAX test's named asserts (``tests/test_crash_safety.py``'s scenario test).
The sweep reruns one small init a dozen times, so its label batches are
memoized: each is computed once by the port's plain twins.
Then the network's crash drills, twins of ``tests/test_sim_scenarios.py``'s
through ``torch_twin``: ``crash-store`` (node 2 partitioned, killed and
restarted over its stores) and ``timeskew-kill``, each also held to the
JAX package's digest and ``record full=`` lines; their full nodes' POST
hashing comes from ``hashlib`` (``torch_twin.hashlib_post``).
"""

import json

import pytest

from spacemesh_tpu.sim import crash_recovery as jcrashrec
from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim.scenario import run_scenario as jrun
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.sim import crash_recovery, scenarios
from torch_twin import export, hashlib_post

_twin = export("test_sim_scenarios", globals(), only=(
    "test_timeskew_kill_ports_cluster_chaos_assertions",
    "test_crash_store_restart_recovers_surviving_stores"))

# the port's results of the twins' runs, by scenario name (the first run)
_PORT = {}


@pytest.fixture(autouse=True, scope="module")
def kept_results():
    real = _twin.run_scenario

    def kept(script, **kw):
        result = real(script, **kw)
        _PORT.setdefault(script["name"], result)
        return result

    _twin.run_scenario = kept
    yield
    _twin.run_scenario = real


@pytest.fixture(autouse=True)
def post_hashing(request):
    """The network drills hash through hashlib; the crash sweep's label
    batches are memoized, each computed by the port's plain twins."""
    if "crash_recovery" not in request.node.name:
        with hashlib_post():
            yield
        return
    real = tscrypt.scrypt_labels_words
    memo = {}

    def labels(cw, lo, hi, *, n, chunk=None):
        key = tuple(t.numpy().tobytes() for t in (cw, lo, hi)) + (n,)
        if key not in memo:
            memo[key] = real(cw, lo, hi, n=n)
        return memo[key].clone()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscrypt, "scrypt_labels_words", labels)
        yield


def records(events: list) -> list:
    return [e.split(" ", 1)[1] for e in events if " record full=" in e]


@pytest.mark.parametrize("seed,every", [(7, 3), (3, 7)])
def test_crash_recovery_equals_the_jax_packages(seed, every):
    script = scenarios.builtin("crash-recovery", seed=seed)
    script["crash_every"] = every
    port = crash_recovery.run_scenario(script, device="cpu")
    again = scenarios.run(script, device="cpu")
    ref = jcrashrec.run_scenario(script)
    assert port.ok, [a for a in port.asserts if not a["ok"]]
    assert ref.ok
    kinds = {a["kind"]: a for a in port.asserts}
    assert {"bit_identical", "recovered", "enospc_degraded",
            "fault_metrics"} <= set(kinds)
    assert port.events == ref.events
    assert port.digest == again.digest == ref.digest
    json.loads(port.to_json())


@pytest.mark.parametrize("name", ["crash-store", "timeskew-kill"])
def test_network_crash_drill_equals_the_jax_packages(name, tmp_path):
    port = _PORT.get(name) or scenarios.run(scenarios.builtin(name),
                                            device="cpu")
    ref = jrun(jscenarios.builtin(name), tmp=tmp_path)
    assert port.ok, [a for a in port.asserts if not a["ok"]]
    assert ref.ok
    assert records(port.events) == records(ref.events)
    assert port.digest == ref.digest
