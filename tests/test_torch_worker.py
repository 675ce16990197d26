"""The port's PoST worker against the JAX package, on the CPU.

A store made by the port's CLI (``python -m spacemesh_tpu_torch.post
init``, through ``main(argv)``) is byte-identical to the JAX package's
``initialize()``; the CLI's ``prove`` prints what the JAX CLI prints and
``verify`` accepts it. The port's worker runs in a real subprocess under
``PostSupervisor(device="cpu")`` and answers both packages'
``RemotePostClient``s with the JAX ``Prover``'s proof, restarts after a
kill and after an early exit, exposes its metrics, and refuses unknown
identities. Over gRPC, the JAX package's node
side (``GrpcApiServer``) drives the port's ``GrpcWorker``. Sizes are the
JAX worker tests': 1 unit x 256 labels, N=2, k1=64, k2=8, k3=4.
"""

import asyncio
import dataclasses
import hashlib
import json
import os
import time

import pytest
import torch

from spacemesh_tpu.api.rpc import GrpcApiServer
from spacemesh_tpu.post import __main__ as jcli
from spacemesh_tpu.post import initializer as jinit
from spacemesh_tpu.post import verifier as jverifier
from spacemesh_tpu.post.data import PostMetadata as JMeta
from spacemesh_tpu.post.prover import Proof as JProof
from spacemesh_tpu.post.prover import ProofParams as JParams
from spacemesh_tpu.post.prover import Prover as JProver
from spacemesh_tpu.post.remote import RemotePostClient as JRemote
from spacemesh_tpu_torch.ops import proving
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.post import __main__ as tcli
from spacemesh_tpu_torch.post.data import PostMetadata as TMeta
from spacemesh_tpu_torch.post.grpc_worker import GrpcWorker
from spacemesh_tpu_torch.post.prover import ProofParams
from spacemesh_tpu_torch.post.remote import RemotePostClient, \
    discover_identities
from spacemesh_tpu_torch.post.service import PostClient, PostService
from spacemesh_tpu_torch.post.supervisor import PostSupervisor

NODE_ID = hashlib.sha256(b"torch-worker-node").digest()
COMMITMENT = hashlib.sha256(b"torch-worker-commitment").digest()
CHALLENGE = hashlib.sha256(b"torch-worker-challenge").digest()
POW = b"\x20" + b"\xff" * 31
PARAMS = ProofParams(k1=64, k2=8, k3=4, pow_difficulty=POW)
JPARAMS = JParams(k1=64, k2=8, k3=4, pow_difficulty=POW)
K = ["--k1", "64", "--k2", "8", "--k3", "4"]


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
def stores(tmp_path_factory):
    """The port CLI's store (under a base dir, as the worker serves it)
    and the JAX package's, of the same identity."""
    base = tmp_path_factory.mktemp("torch-worker")
    tdir = base / NODE_ID.hex()[:16]
    rc = tcli.main(["init", "--data-dir", str(tdir),
                    "--node-id-hex", NODE_ID.hex(),
                    "--commitment-hex", COMMITMENT.hex(), "--num-units", "1",
                    "--labels-per-unit", "256", "--scrypt-n", "2",
                    "--batch", "128", "--device", "cpu"])
    assert rc == 0
    jdir = tmp_path_factory.mktemp("jax-worker")
    jinit.initialize(jdir, node_id=NODE_ID, commitment=COMMITMENT,
                     num_units=1, labels_per_unit=256, scrypt_n=2,
                     batch_size=128, mesh=None, meta_interval_s=1e9)
    return base, tdir, jdir


@pytest.fixture(scope="module")
def jax_proof(stores):
    _, tdir, _ = stores
    return JProver(tdir, JPARAMS, mesh=None).prove(CHALLENGE)


@pytest.fixture(scope="module")
def supervisor(stores):
    base, _, _ = stores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    sup = PostSupervisor(base, listen="127.0.0.1:0", params=PARAMS,
                         restart_backoff=0.2, env=env, device="cpu")
    sup.start(timeout=120)
    yield sup
    sup.stop()


def _jax_verifies(proof) -> bool:
    return jverifier.verify(jverifier.VerifyItem(
        proof=proof, challenge=CHALLENGE, node_id=NODE_ID,
        commitment=COMMITMENT, scrypt_n=2, total_labels=256), JPARAMS)


def _same_proof(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# --- the CLI -----------------------------------------------------------------


def test_cli_init_store_is_byte_identical_to_jax(stores, capsys):
    _, tdir, jdir = stores
    names = sorted(p.name for p in jdir.glob("postdata_*.bin"))
    assert names and names == sorted(p.name
                                     for p in tdir.glob("postdata_*.bin"))
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes()
    assert dataclasses.asdict(TMeta.load(tdir)) == \
        dataclasses.asdict(JMeta.load(jdir))


def test_cli_prove_prints_what_the_jax_cli_prints(stores, tmp_path, capsys):
    _, tdir, jdir = stores
    outs = []
    for cli, d, extra in ((tcli, tdir, ["--device", "cpu"]),
                          (jcli, jdir, [])):
        capsys.readouterr()
        proof_file = tmp_path / f"{cli.__name__}.json"
        assert cli.main(["prove", "--data-dir", str(d), "--challenge-hex",
                         CHALLENGE.hex(), *K, "--out", str(proof_file),
                         *extra]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out.pop("elapsed_s")
        outs.append((out, proof_file.read_text()))
    assert outs[0] == outs[1]


def test_cli_verify_accepts_and_rejects(stores, tmp_path, capsys):
    """``verify`` exits 0 with {"valid": true} on the CLI's proof; with one
    index swapped for a non-qualifying one (and k3 = k2, so every index
    is checked) it exits 1 with {"valid": false}."""
    _, tdir, _ = stores
    proof_file = tmp_path / "proof.json"
    assert tcli.main(["prove", "--data-dir", str(tdir), "--challenge-hex",
                      CHALLENGE.hex(), *K, "--out", str(proof_file),
                      "--device", "cpu"]) == 0
    capsys.readouterr()
    verify = ["verify", "--data-dir", str(tdir), "--challenge-hex",
              CHALLENGE.hex(), "--k1", "64", "--k2", "8", "--device", "cpu"]
    assert tcli.main(verify + ["--k3", "8",
                               "--proof-file", str(proof_file)]) == 0
    assert json.loads(capsys.readouterr().out) == {"valid": True}

    proof = json.loads(proof_file.read_text())
    thr = proving.threshold_u32(64, 256)
    labels = tscrypt.scrypt_labels(COMMITMENT, range(256), n=2, device="cpu")
    values = proving.proving_hashes(CHALLENGE, proof["nonce"], range(256),
                                    labels, device="cpu")
    proof["indices"][0] = next(i for i in range(256)
                               if i not in proof["indices"]
                               and values[i] >= thr)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(proof))
    assert tcli.main(verify + ["--k3", "8", "--proof-file", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out) == {"valid": False}
    # the JAX verifier agrees on both (the CLI proves at the default k2pow)
    for doc, want in ((json.loads(proof_file.read_text()), True),
                      (proof, False)):
        assert jverifier.verify(jverifier.VerifyItem(
            proof=JProof(**doc), challenge=CHALLENGE, node_id=NODE_ID,
            commitment=COMMITMENT, scrypt_n=2, total_labels=256),
            JParams(k1=64, k2=8, k3=8)) is want


def test_cli_benchmark_reports_a_rate(capsys):
    assert tcli.main(["benchmark", "--batch", "64", "--scrypt-n", "16",
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"device", "batch", "scrypt_n", "labels_per_s",
                        "compile_s"}
    assert out["device"] == "cpu" and out["labels_per_s"] > 0


# --- the JSON-RPC worker -------------------------------------------------------


def test_info_over_the_wire_to_both_clients(stores, supervisor):
    _, tdir, _ = stores
    want = dataclasses.asdict(PostClient(tdir, PARAMS, device="cpu").info())
    for cls in (RemotePostClient, JRemote):
        client = cls(supervisor.address, NODE_ID)
        info = client.info()
        assert dataclasses.asdict(info) == want
        assert info.num_units == 1 and info.labels_per_unit == 256
        assert client.ping() == [NODE_ID]


def test_proof_over_the_wire_equals_the_jax_prover(supervisor, jax_proof):
    for cls in (RemotePostClient, JRemote):
        proof, meta = cls(supervisor.address, NODE_ID,
                          timeout=300).proof(CHALLENGE)
        assert _same_proof(proof, jax_proof)
        assert meta.labels_written == 256
        assert _jax_verifies(proof)


def test_port_client_talks_to_the_jax_server(stores, jax_proof):
    """The other direction: the JAX package's WorkerServer, the port's
    client."""
    from spacemesh_tpu.post.remote import WorkerServer
    from spacemesh_tpu.post.remote import \
        discover_identities as jdiscover

    base, _, _ = stores

    async def go():
        server = WorkerServer(jdiscover(base, params=JPARAMS, mesh=None))
        addr = await server.start()
        try:
            client = RemotePostClient(addr, NODE_ID, timeout=300)
            info = await asyncio.to_thread(client.info)
            proof, _ = await asyncio.to_thread(client.proof, CHALLENGE)
            return info, proof
        finally:
            await server.stop()

    info, proof = asyncio.run(go())
    assert info.node_id == NODE_ID and info.commitment == COMMITMENT
    assert _same_proof(proof, jax_proof)


def test_unknown_identity_is_an_error(supervisor):
    for cls in (RemotePostClient, JRemote):
        with pytest.raises(RuntimeError, match="not registered"):
            cls(supervisor.address, b"\x42" * 32).info()


def test_worker_exposes_its_metrics(supervisor):
    """The worker process's registry over the wire: a proof's label reads
    show in post_store_read_calls_total, the ENOSPC gauge is defined."""
    client = RemotePostClient(supervisor.address, NODE_ID, timeout=300)
    client.proof(CHALLENGE)
    text = client.metrics()
    reads = [float(line.split()[-1]) for line in text.splitlines()
             if line.startswith("post_store_read_calls_total ")]
    assert reads and reads[0] > 0
    assert "# TYPE post_store_degraded gauge" in text


def test_supervisor_restarts_a_worker_that_exits_before_serving(stores):
    """A worker that dies before it serves for a passing cause (its port
    still held by another process) is restarted with backoff until it
    comes up; only the CLI's usage exit (no card) ends supervision."""
    import socket
    import threading

    base, _, _ = stores
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen()
    port = holder.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    sup = PostSupervisor(base, listen=f"127.0.0.1:{port}", params=PARAMS,
                         restart_backoff=0.2, env=env, device="cpu")
    result = {}
    starter = threading.Thread(
        target=lambda: result.setdefault("addr", sup.start(timeout=120)))
    starter.start()
    try:
        deadline = time.time() + 60
        while sup.restarts < 1 and time.time() < deadline:
            time.sleep(0.1)
        assert sup.restarts >= 1, "the worker was not restarted"
        holder.close()
        starter.join(timeout=120)
        assert result["addr"] == ("127.0.0.1", port)
        assert RemotePostClient(result["addr"], NODE_ID).ping() == [NODE_ID]
    finally:
        holder.close()
        sup.stop()
        starter.join(timeout=10)
    assert not sup.alive()


def test_supervisor_restarts_killed_worker(supervisor, jax_proof):
    assert supervisor.alive()
    before = supervisor.restarts
    port = supervisor.address[1]
    supervisor._proc.kill()
    client = RemotePostClient(supervisor.address, NODE_ID, timeout=10)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if client.ping() == [NODE_ID]:
                break
        except (OSError, RuntimeError):
            time.sleep(0.3)
    else:
        raise AssertionError("worker did not come back after kill")
    assert supervisor.restarts > before
    assert supervisor.address[1] == port  # the same port after a restart
    proof, _ = RemotePostClient(supervisor.address, NODE_ID,
                                timeout=300).proof(CHALLENGE)
    assert _same_proof(proof, jax_proof)


# --- the gRPC worker -------------------------------------------------------------


def test_grpc_worker_against_the_jax_node_side(stores, jax_proof):
    _, tdir, _ = stores
    svc = PostService()
    svc.register(NODE_ID, PostClient(tdir, PARAMS, device="cpu"))

    async def go():
        server = GrpcApiServer(app=None, listen="127.0.0.1:0",
                               post_query_interval=0.05)
        port = await server.start()
        worker = GrpcWorker(svc, f"127.0.0.1:{port}", reconnect_backoff=0.2)
        await worker.start()
        try:
            await worker.wait_connected(timeout=10)
            await server.post_service.wait_registered([NODE_ID], timeout=10)
            client = server.post_service.client(NODE_ID)
            info = await asyncio.to_thread(client.info)
            proof, _ = await asyncio.to_thread(client.proof, CHALLENGE)
            return info, proof
        finally:
            await worker.stop()
            await server.stop()

    info, proof = asyncio.run(go())
    assert info.node_id == NODE_ID and info.commitment == COMMITMENT
    assert info.num_units == 1 and info.labels_per_unit == 256
    assert _same_proof(proof, jax_proof)
    assert _jax_verifies(proof)


def test_discover_identities_passes_device(stores):
    base, tdir, _ = stores
    svc = discover_identities(base, params=PARAMS, device="cpu")
    client = svc.client(NODE_ID)
    assert svc.registered() == [NODE_ID]
    assert client.data_dir == tdir and client.device.type == "cpu"
    assert client._prove_opts == {}
