"""The port's full-size network scenarios on the CPU, held to the JAX
package's.

Twins of ``tests/test_sim_scenarios.py`` through ``torch_twin``
(``run_scenario`` with ``device="cpu"``): storm-256 (converged, green
SLOs, the fault vocabulary exercised, the storm over the whole fabric,
inside its wall budget), eclipse-campaign run twice, and the tests the JAX
package marks ``slow`` (soak-epochs, storm-4096, the storm-256 replay,
storm-1024), which stay ``slow`` here. Then storm-256 and eclipse-campaign
must give the JAX package's digest and ``record full=`` lines for the same
seed. Their full nodes' labels come from ``hashlib.scrypt``
(``torch_twin.hashlib_post``); the verifyd drills of the JAX file are
twinned in ``tests/test_torch_sim_fleet.py``, the crash drills in
``tests/test_torch_sim_crashrec.py``.
"""

import pytest

from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim.scenario import run_scenario as jrun
from torch_twin import export, hashlib_post

_twin = export("test_sim_scenarios", globals(), only=(
    "test_storm_256_converges_with_green_slos",
    "test_storm_256_exercised_the_fault_vocabulary",
    "test_storm_256_storm_reached_the_whole_fabric",
    "test_storm_256_inside_the_tier1_wall_budget",
    "test_eclipse_campaign_rejects_and_reconverges",
    "test_soak_epochs_state_roots_agree_at_every_boundary",
    "test_storm_4096_runs_on_the_sharded_fabric",
    "test_storm_256_replay_is_byte_identical",
    "test_storm_1024_converges_and_replays_identically"))

# the port's results of the twins' runs, by scenario name (the first run)
_PORT = {}


@pytest.fixture(autouse=True, scope="module")
def post_from_hashlib():
    real = _twin.run_scenario

    def kept(script, **kw):
        result = real(script, **kw)
        _PORT.setdefault(script["name"], result)
        return result

    _twin.run_scenario = kept
    try:
        with hashlib_post():
            yield
    finally:
        _twin.run_scenario = real


def records(result) -> list:
    return [e.split(" ", 1)[1] for e in result.events
            if " record full=" in e]


@pytest.mark.parametrize("name", ["storm-256", "eclipse-campaign"])
def test_digest_equals_the_jax_packages(name, tmp_path):
    port = _PORT.get(name) or _twin.run_scenario(
        jscenarios.builtin(name), tmp=tmp_path / "port", device="cpu")
    ref = jrun(jscenarios.builtin(name), tmp=tmp_path / "jax")
    assert port.ok and ref.ok
    assert records(port) == records(ref)
    assert port.digest == ref.digest
