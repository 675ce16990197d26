"""The port prover's knobs against the JAX package, on the CPU.

The proof must not depend on how the search is cut: at ``window_groups``
1, 2 and 4 (one scan launch of 16 x G nonces per batch), at 1 and 3
readers and batches in flight, and on the serial path, the port's proof
equals the JAX ``Prover``'s at ``window_groups`` 1 and 4 on the same
store. The parameters put the winning nonce in the third group (46), so
the windows cut the search differently, and the prove batch leaves a
ragged tail.
"""

import dataclasses
import hashlib

import pytest
import torch

from spacemesh_tpu.post.prover import ProofParams as JParams
from spacemesh_tpu.post.prover import Prover as JProver
from spacemesh_tpu_torch.post import initializer as tinit
from spacemesh_tpu_torch.post import prover as tprover

NODE = hashlib.sha256(b"knobs-node").digest()
COMMIT = hashlib.sha256(b"knobs-commit").digest()
CHALLENGE = hashlib.sha256(b"knobs-challenge").digest()
TOTAL = 2048
BATCH = 768  # 768, 768, 512: a ragged last batch
PARAMS = dict(k1=8, k2=16, k3=4, pow_difficulty=b"\xff" * 32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("knobs")
    tinit.initialize(d, node_id=NODE, commitment=COMMIT, num_units=1,
                     labels_per_unit=TOTAL, scrypt_n=2, batch_size=TOTAL,
                     device="cpu")
    return d


@pytest.fixture(scope="module")
def jax_proofs(store):
    """The JAX prover's proof at window_groups 1 and 4; they agree."""
    proofs = [dataclasses.asdict(
        JProver(store, JParams(**PARAMS), batch_labels=BATCH, mesh=None,
                window_groups=g).prove(CHALLENGE)) for g in (1, 4)]
    assert proofs[0] == proofs[1]
    assert proofs[0]["nonce"] // 16 == 2  # the third group
    return proofs[0]


@pytest.fixture
def scan_steps(monkeypatch):
    """The n_nonces of every prove scan step the port launches."""
    calls = []
    real = tprover.proving.prove_scan_step

    def step(*args, n_nonces, max_hits):
        calls.append(n_nonces)
        return real(*args, n_nonces=n_nonces, max_hits=max_hits)

    monkeypatch.setattr(tprover.proving, "prove_scan_step", step)
    return calls


@pytest.mark.parametrize("pool", [1, 3], ids=lambda n: f"readers-inflight-{n}")
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_proof_equals_jax_at_every_window_and_pool(store, jax_proofs,
                                                   scan_steps, groups, pool):
    pv = tprover.Prover(store, tprover.ProofParams(**PARAMS),
                        batch_labels=BATCH, window_groups=groups,
                        readers=pool, inflight=pool, device="cpu")
    assert (pv.window_groups, pv.readers, pv.inflight) == (groups, pool, pool)
    proof = pv.prove(CHALLENGE)
    assert dataclasses.asdict(proof) == jax_proofs
    stats = pv.last_stats
    # one scan launch of 16 x G nonces per batch; the winner's group 2
    # falls in window 2 // G
    assert scan_steps == [16 * groups] * stats.batches
    assert stats.windows == 2 // groups + 1
    assert stats.batches <= stats.windows * -(-TOTAL // BATCH)


def test_serial_path_and_environment_overrides(store, jax_proofs,
                                               monkeypatch):
    params = tprover.ProofParams(**PARAMS)
    serial = tprover.Prover(store, params, batch_labels=BATCH,
                            pipelined=False, device="cpu")
    assert not serial.pipelined
    assert dataclasses.asdict(serial.prove(CHALLENGE)) == jax_proofs
    for name, value in (("PIPELINE", "0"), ("WINDOW_GROUPS", "4"),
                        ("INFLIGHT", "2"), ("READERS", "3"),
                        ("QUEUE", "5")):
        monkeypatch.setenv(f"SPACEMESH_PROVE_{name}", value)
    pv = tprover.Prover(store, params, batch_labels=BATCH, device="cpu")
    assert (pv.pipelined, pv.window_groups, pv.inflight, pv.readers,
            pv.reader_queue) == (False, 4, 2, 3, 5)
    # an argument beats the environment
    pv = tprover.Prover(store, params, batch_labels=BATCH, pipelined=True,
                        window_groups=2, device="cpu")
    assert (pv.pipelined, pv.window_groups) == (True, 2)
    assert dataclasses.asdict(pv.prove(CHALLENGE)) == jax_proofs


def test_defaults_are_one_group_three_inflight_two_readers(store,
                                                           monkeypatch):
    for name in ("PIPELINE", "WINDOW_GROUPS", "INFLIGHT", "READERS",
                 "QUEUE"):
        monkeypatch.delenv(f"SPACEMESH_PROVE_{name}", raising=False)
    pv = tprover.Prover(store, device="cpu")
    assert (pv.pipelined, pv.window_groups, pv.inflight, pv.readers,
            pv.reader_queue) == (True, 1, 3, 2, 4)


def test_last_window_is_clamped_to_the_search_bound(store, monkeypatch):
    """A window never scans past MAX_GROUPS: with the bound at 3 groups
    and windows of 2, the second window scans one group and still finds
    the winner in group 2; with the bound at 2 groups, the search gives
    up as the serial one does."""
    params = tprover.ProofParams(**PARAMS)
    monkeypatch.setattr(tprover, "MAX_GROUPS", 3)
    pv = tprover.Prover(store, params, batch_labels=BATCH, window_groups=2,
                        device="cpu")
    assert pv.prove(CHALLENGE).nonce // 16 == 2
    monkeypatch.setattr(tprover, "MAX_GROUPS", 2)
    for pipelined in (True, False):
        pv = tprover.Prover(store, params, batch_labels=BATCH,
                            window_groups=4, pipelined=pipelined,
                            device="cpu")
        with pytest.raises(RuntimeError, match="no winning nonce"):
            pv.prove(CHALLENGE)
