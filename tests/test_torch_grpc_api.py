"""The port's gRPC API (``spacemesh_tpu_torch/api/{rpc,rpc_v2}.py`` and
the generated ``api/gen`` modules) against the JAX package's.

The cases of ``tests/test_grpc_api.py`` and ``tests/test_grpc_v2.py`` run
on the port through ``torch_twin`` (the PoST store, clients, supervisor and
verifier those tests build are given ``device="cpu"``).
"""

from torch_twin import export

export("test_grpc_api", globals())
export("test_grpc_v2", globals())


# --- byte identity across the packages ----------------------------------

import asyncio  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

PKGS = ("spacemesh_tpu", "spacemesh_tpu_torch")
GEN = ("core_pb2", "v2alpha1_pb2", "post_pb2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", GEN)
def test_descriptors_are_byte_identical(name):
    """Each generated module's serialized descriptor equals the JAX one's,
    so both load into one default pool and share message classes."""
    ref = importlib.import_module(f"spacemesh_tpu.api.gen.{name}")
    port = importlib.import_module(f"spacemesh_tpu_torch.api.gen.{name}")
    assert port.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    assert port.DESCRIPTOR is ref.DESCRIPTOR


def test_both_packages_gen_modules_import_in_one_process():
    """Either import order, in a fresh interpreter: no descriptor clash."""
    for first, second in (PKGS, PKGS[::-1]):
        code = "\n".join(
            [f"import {pkg}.api.gen.{n}" for pkg in (first, second)
             for n in GEN] + ["print('ok')"])
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"},
                             cwd=REPO)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == "ok"


NODE_ID = hashlib.sha256(b"seam-node").digest()
COMMITMENT = hashlib.sha256(b"seam-commitment").digest()
CHALLENGES = [hashlib.sha256(b"seam-challenge-%d" % i).digest()
              for i in range(2)]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _params(pkg):
    return _mod(pkg, "post.prover").ProofParams(
        k1=64, k2=8, k3=4, pow_difficulty=b"\x20" + b"\xff" * 31)


def _kw(pkg):
    return {"device": "cpu"} if pkg == "spacemesh_tpu_torch" else {}


@pytest.fixture(scope="module")
def seam_store(tmp_path_factory):
    """One identity's store (the port's init on the CPU) and the direct
    proofs of its challenges by each package's prover."""
    d = tmp_path_factory.mktemp("seam") / NODE_ID.hex()[:16]
    _mod("spacemesh_tpu_torch", "post.initializer").initialize(
        d, node_id=NODE_ID, commitment=COMMITMENT, num_units=1,
        labels_per_unit=256, scrypt_n=2, batch_size=128, device="cpu")
    direct = {}
    for pkg in PKGS:
        prover = _mod(pkg, "post.prover").Prover(d, _params(pkg), **_kw(pkg))
        direct[pkg] = [prover.prove(c) for c in CHALLENGES]
    assert [p.to_dict() for p in direct["spacemesh_tpu"]] == \
        [p.to_dict() for p in direct["spacemesh_tpu_torch"]]
    return d, [p.to_dict() for p in direct["spacemesh_tpu"]]


@pytest.mark.parametrize("node_pkg,worker_pkg", [
    ("spacemesh_tpu_torch", "spacemesh_tpu"),
    ("spacemesh_tpu", "spacemesh_tpu_torch")])
def test_post_service_seam_across_packages(seam_store, node_pkg,
                                           worker_pkg):
    """A GrpcWorker of one package registers with the other's
    PostGrpcService; the node's GrpcPostClient proves through the Register
    stream, and every proof equals the direct prover's and verifies in
    both packages."""
    post_dir, direct = seam_store
    svc_mod = _mod(worker_pkg, "post.service")
    svc = svc_mod.PostService()
    svc.register(NODE_ID, svc_mod.PostClient(post_dir, _params(worker_pkg),
                                             **_kw(worker_pkg)))

    async def go():
        server = _mod(node_pkg, "api.rpc").GrpcApiServer(
            app=None, listen="127.0.0.1:0", post_query_interval=0.05)
        port = await server.start()
        worker = _mod(worker_pkg, "post.grpc_worker").GrpcWorker(
            svc, f"127.0.0.1:{port}", reconnect_backoff=0.2)
        await worker.start()
        try:
            await worker.wait_connected(timeout=10)
            await server.post_service.wait_registered([NODE_ID], timeout=10)
            client = server.post_service.client(NODE_ID)
            info = await asyncio.to_thread(client.info)
            proofs = [await asyncio.to_thread(client.proof, c)
                      for c in CHALLENGES]
            return info, proofs
        finally:
            await worker.stop()
            await server.stop()

    info, proofs = asyncio.run(go())
    assert (info.node_id, info.commitment, info.num_units,
            info.labels_per_unit) == (NODE_ID, COMMITMENT, 1, 256)
    assert [p.to_dict() for p, _meta in proofs] == direct
    for pkg in PKGS:
        verifier = _mod(pkg, "post.verifier")
        for (proof, _meta), challenge in zip(proofs, CHALLENGES):
            proof = _mod(pkg, "post.prover").Proof.from_dict(proof.to_dict())
            assert verifier.verify(verifier.VerifyItem(
                proof=proof, challenge=challenge, node_id=NODE_ID,
                commitment=COMMITMENT, scrypt_n=2, total_labels=256),
                _params(pkg), **_kw(pkg)), pkg
