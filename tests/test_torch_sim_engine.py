"""The port's scenario engine (``spacemesh_tpu_torch/sim/``) on the CPU,
held to the JAX package's.

``tests/test_sim_engine.py`` runs on the port through ``torch_twin``
(``run_scenario`` with ``device="cpu"``): topology, fault semantics, hub
delivery under faults, req/resp reachability, the adversarial payloads and
the smoke run replayed twice, its full nodes' POST hashing from
``hashlib`` (``torch_twin.hashlib_post``). Then the payloads must be
byte-equal to the JAX package's (the torsion message's verdicts too, on the
pure-Python verifier of both packages), the smoke scenario on the port's
plain twins must give the JAX package's digest and ``record full=`` lines
for the same seed, and the port's CLI (and its ``tools.simrun`` alias) must
replay a scenario with ``--repeat 2 --device cpu`` and exit 2 without a
card when no device is named. Exact equality is the tolerance.
"""

import os
import subprocess
import sys

import pytest

from spacemesh_tpu.sim import faults as jfaults
from spacemesh_tpu.sim import scenarios as jscenarios
from spacemesh_tpu.sim.scenario import run_scenario as jrun
from spacemesh_tpu_torch.sim import faults, scenarios
from torch_twin import export, hashlib_post

export("test_sim_engine", globals())


@pytest.fixture(autouse=True)
def post_from_hashlib(request):
    """The twins' full nodes hash through hashlib; the smoke digest test
    keeps the port's plain twins."""
    if "plain_twins" in request.node.name:
        yield
        return
    with hashlib_post():
        yield

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records(result) -> list:
    """The ``record full=`` lines, without their virtual instants."""
    return [e.split(" ", 1)[1] for e in result.events
            if " record full=" in e]


@pytest.mark.parametrize("seed,count", [(0, 1), (7, 6), (13, 12), (99, 3)])
def test_malformed_atx_blobs_equal_the_jax_packages(seed, count):
    assert faults.malformed_atx_blobs(seed, count) == \
        jfaults.malformed_atx_blobs(seed, count)


@pytest.mark.parametrize("layer,seed", [(0, 1), (9, 17), (12, 1234)])
def test_torsion_hare_message_equals_the_jax_packages(layer, seed):
    assert faults.torsion_hare_message(layer, seed) == \
        jfaults.torsion_hare_message(layer, seed)


def test_torsion_message_verdicts_on_the_pure_python_verifier(monkeypatch):
    """The cofactored check accepts the torsion-in-R signature inline and
    in a batch on both packages' pure-Python verifiers (the branch the JAX
    test skips where OpenSSL answers)."""
    import importlib

    verdicts = []
    for pkg in ("spacemesh_tpu", "spacemesh_tpu_torch"):
        hare = importlib.import_module(f"{pkg}.consensus.hare")
        signing = importlib.import_module(f"{pkg}.core.signing")
        monkeypatch.setattr(signing, "_HAVE_CRYPTOGRAPHY", False)
        msg = hare.HareMessage.from_bytes(
            faults.torsion_hare_message(layer=5, seed=9))
        v = signing.EdVerifier()
        args = (signing.Domain.HARE, msg.node_id, msg.signed_bytes(),
                msg.signature)
        items = [(int(signing.Domain.HARE),) + args[1:]] * 9
        verdicts.append((v.verify(*args), list(v.verify_many(items))))
    assert verdicts[0] == verdicts[1] == (True, [True] * 9)


def test_builtin_scripts_equal_the_jax_packages():
    assert scenarios.builtin_names() == jscenarios.builtin_names()
    for name in jscenarios.builtin_names():
        assert scenarios.builtin(name) == jscenarios.builtin(name), name


def test_smoke_digest_on_the_plain_twins_equals_the_jax_packages(tmp_path):
    """The whole plain CPU path: every label, proof and k2pow nonce of the
    port's full nodes from its plain twins."""
    port = scenarios.run(scenarios.builtin("smoke"), device="cpu")
    ref = jrun(jscenarios.builtin("smoke"), tmp=tmp_path)
    assert port.ok, [a for a in port.asserts if not a["ok"]]
    assert ref.ok
    assert records(port) == records(ref)
    assert port.digest == ref.digest


def _cli(module: str, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})),
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("module", ["spacemesh_tpu_torch.sim",
                                    "spacemesh_tpu_torch.tools.simrun"])
def test_cli_repeat_replays_on_the_cpu(module):
    r = _cli(module, "--scenario", "smoke", "--light", "4", "--repeat", "2",
             "--device", "cpu", "--quiet")
    assert r.returncode == 0, r.stdout + r.stderr
    digests = {line.split("digest=")[1].split()[0]
               for line in r.stdout.splitlines() if line.startswith("run ")}
    assert len(digests) == 1
    assert "OK: 2 run(s)" in r.stdout


def test_cli_without_a_card_needs_device_cpu():
    r = _cli("spacemesh_tpu_torch.sim", "--scenario", "smoke",
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2, r.stdout + r.stderr
    assert "device='cuda'" in r.stderr
