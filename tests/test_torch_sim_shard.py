"""The port's sharded fabric (``spacemesh_tpu_torch/sim/shard.py``) on the
CPU, held to the JAX package's.

``tests/test_sim_shard.py`` runs on the port through ``torch_twin``
(``run_scenario`` with ``device="cpu"``): ``resolve_shards``, the barrier
math, W=1 against W=4, a sharded replay, a worker killed mid-window, and
the worker module importable without JAX. Then the worker module must
import with torch blocked too (and JAX, and the JAX package), as a worker
process imports it, and a sharded smoke run (W=2) must give the JAX
package's digest for the same seed: the shard count is not in the digest.
The full nodes' labels come from ``hashlib.scrypt``
(``torch_twin.hashlib_post``); the smoke run on the port's plain twins
is ``tests/test_torch_sim_engine.py``'s.
"""

import subprocess
import sys

import pytest

from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim.scenario import run_scenario as jrun
from spacemesh_tpu_torch.sim import scenarios
from torch_twin import export, hashlib_post

export("test_sim_shard", globals())


@pytest.fixture(autouse=True, scope="module")
def post_from_hashlib():
    with hashlib_post():
        yield


_BLOCKED = """
import importlib.abc, sys
sys.modules["torch"] = None
sys.modules["jax"] = None

class NoJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "spacemesh_tpu" or name.startswith("spacemesh_tpu."):
            raise ImportError(name)

sys.meta_path.insert(0, NoJaxPackage())
import spacemesh_tpu_torch.sim.shard
mods = sorted(m for m in sys.modules if m.startswith("spacemesh_tpu_torch"))
print(" ".join(mods))
"""


def test_worker_module_imports_with_torch_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    mods = r.stdout.split()
    assert "spacemesh_tpu_torch.sim.shard" in mods
    # the engine and the node stack stay out of a worker
    assert "spacemesh_tpu_torch.sim.scenario" not in mods
    assert "spacemesh_tpu_torch.node.app" not in mods


def test_sharded_smoke_digest_equals_the_jax_packages(tmp_path):
    script = scenarios.builtin("smoke", light=6)
    script["shards"] = 2
    port = scenarios.run(script, device="cpu")
    ref = jrun(jscenarios.builtin("smoke", light=6), tmp=tmp_path)
    assert port.ok, [a for a in port.asserts if not a["ok"]]
    assert ref.ok
    assert any(" fabric shards=2" in e for e in port.events)
    assert port.digest == ref.digest
