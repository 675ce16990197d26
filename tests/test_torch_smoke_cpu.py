"""The port as a whole on the CPU: its import boundary, its device rule,
the main path end to end at a small size, and the pieces chip_smoke.py
and the kernels stand on (the bounded pipeline, the kernel build).
"""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from spacemesh_tpu_torch import convert, device
from spacemesh_tpu_torch.ops import _build, proving, proving_cuda, romix_cuda
from spacemesh_tpu_torch.ops import pow as tpow
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.post import initializer, prover, verifier
from spacemesh_tpu_torch.runtime import engine

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "spacemesh_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tier-1 runs test files in parallel worker processes; torch's default
    OpenMP pool (a thread per core in every process) then oversubscribes
    the cores, and its spin-waits make mid-sized CPU ops (the 65536-nonce
    k2pow batch) hundreds of times slower. One intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    files = sorted((REPO / "spacemesh_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_port_import_walk_covers_the_node_seam():
    rel = {str(p.relative_to(REPO)) for p in _port_files()}
    for name in ("node/__init__", "node/__main__", "node/app",
                 "node/events", "node/clock", "node/config",
                 "node/checkpoint", "node/bootstrap", "node/peersync",
                 "p2p/server", "p2p/fetch", "p2p/sync", "p2p/rangesync",
                 "utils/vclock"):
        assert f"spacemesh_tpu_torch/{name}.py" in rel, name


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_checkout(tmp_path, where):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if where == "checkout":
        env["CUDA_VISIBLE_DEVICES"] = ""  # no card visible
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.DEFAULT == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve()
    node = hashlib.sha256(b"n").digest()
    with pytest.raises(RuntimeError, match="cuda"):
        initializer.initialize(tmp_path, node_id=node, commitment=node,
                               num_units=1, labels_per_unit=64, scrypt_n=2)
    assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="cuda"):
        tscrypt.scrypt_labels(node, [1], n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tpow.search(node, node, bytes([255]) * 32)
    with pytest.raises(RuntimeError, match="cuda"):
        verifier.verify_many([], prover.ProofParams())
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_main_path_end_to_end_on_cpu_at_mainnet_k(tmp_path):
    """initialize -> prove (pipelined == serial) -> verify_many, with the
    mainnet k1/k2/k3 and default k2pow, over a small N=16 unit; the CPU
    path never launches a kernel."""
    node = hashlib.sha256(b"smoke-node").digest()
    commitment = hashlib.sha256(b"smoke-commitment").digest()
    challenge = hashlib.sha256(b"smoke-challenge").digest()
    params = prover.ProofParams()
    launches = (romix_cuda.launches, proving_cuda.launches)
    meta, res = initializer.initialize(
        tmp_path, node_id=node, commitment=commitment, num_units=2,
        labels_per_unit=2048, scrypt_n=16, max_file_size=8192,
        batch_size=1000, device="cpu")
    assert meta.labels_written == 4096 and res.labels_per_s > 0
    stored = np.frombuffer((tmp_path / "postdata_3.bin").read_bytes(),
                           dtype=np.uint8).reshape(-1, 16)
    for i in (0, 511):
        want = hashlib.scrypt(commitment,
                              salt=(1536 + i).to_bytes(8, "little"),
                              n=16, r=1, p=1, dklen=16)
        assert bytes(stored[i]) == want
    pv = prover.Prover(tmp_path, params, batch_labels=1000, device="cpu")
    proof = pv.prove(challenge)
    assert pv.last_stats.labels_swept > 0
    assert proof == pv.prove_serial(challenge)
    assert len(proof.indices) == params.k2
    assert tpow.verify(challenge, node, params.pow_difficulty,
                       proof.pow_nonce)
    thr = proving.threshold_u32(params.k1, 4096)
    bad = prover.Proof(nonce=proof.nonce, indices=list(proof.indices),
                       pow_nonce=proof.pow_nonce, k2=proof.k2)
    bad.indices[5] = next(
        i for i in range(4096) if i not in proof.indices
        and proving.proving_hashes(
            challenge, proof.nonce, [i],
            tscrypt.scrypt_labels(commitment, [i], n=16, device="cpu"),
            device="cpu")[0] >= thr)
    items = [verifier.VerifyItem(proof=p, challenge=challenge, node_id=node,
                                 commitment=commitment, scrypt_n=16,
                                 total_labels=4096) for p in (proof, bad)]
    assert verifier.verify_many(items, params, device="cpu") == [True, False]
    assert (romix_cuda.launches, proving_cuda.launches) == launches


def test_pipeline_window_early_exit_and_stop():
    log = []

    def dispatch(i):
        log.append(("d", i))
        return i

    def retire(i):
        log.append(("r", i))
        return i if i == 4 else None

    pipe = engine.Pipeline(inflight=2)
    assert pipe.run(range(10), dispatch, retire) == 4
    assert log[:4] == [("d", 0), ("d", 1), ("r", 0), ("d", 2)]
    assert ("d", 6) not in log and pipe.stats.early_exited
    depth = max(sum(1 for e in log[:k] if e[0] == "d")
                - sum(1 for e in log[:k] if e[0] == "r")
                for k in range(len(log) + 1))
    assert depth == 2
    retired = []
    stopping = engine.Pipeline(inflight=3, stop=lambda: len(retired) >= 2)
    assert stopping.run(range(10), lambda i: i, retired.append) is None
    assert stopping.stats.stopped and retired == [0, 1]
    assert engine.Pipeline().run([], dispatch, retire) is None


def test_pipeline_records_the_first_dispatch_apart(monkeypatch):
    clock = iter(range(100))
    monkeypatch.setattr(engine.time, "perf_counter", lambda: next(clock))
    pipe = engine.Pipeline(inflight=8)
    assert pipe.run(range(3), lambda i: i, lambda i: None) is None
    # each dispatch reads the clock twice, one tick apart
    assert pipe.stats.batches == 3
    assert pipe.stats.first_dispatch_s == 1
    assert pipe.stats.dispatch_s == 3


def test_bound_is_the_larger_of_bytes_and_operations():
    from spacemesh_tpu_torch.tools import measure

    by_ops = measure.bound(10**12, 0, 10**12)
    assert by_ops == {"bound_ms": 1000.0, "bound_by": "operations"}
    by_bytes = measure.bound(1, int(measure.HBM_BYTES_PER_S), 10**12)
    assert by_bytes == {"bound_ms": 1000.0, "bound_by": "bytes"}


def test_kernel_ms_profiles_again_when_a_session_records_no_kernel(
        monkeypatch):
    """A profiler session that records none of the run's kernels is
    retried; only ``_PROFILE_ATTEMPTS`` empty sessions give None."""
    import torch.profiler
    from torch.autograd import DeviceType

    from spacemesh_tpu_torch.tools import measure

    def event(name, us):
        return types.SimpleNamespace(
            name=name, device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(elapsed_us=lambda: us))

    sessions = []

    class Session:
        def __init__(self, activities):
            self.recorded = sessions.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.recorded

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    sessions[:] = [[], [event("window_kernel", 4000.0),
                        event("window_kernel", 2000.0),
                        event("other_kernel", 9.0)]]
    assert measure.kernel_ms(lambda: calls.append(1), "window_kernel",
                             reps=2) == 3.0
    assert len(calls) == 1 + 2 + 2 and not sessions
    sessions[:] = [[], [event("window_kernel", 4000.0)]]
    assert measure.kernel_ms(lambda: None, "window_kernel", reps=2,
                             per_call=True) == 2.0
    sessions[:] = [[event("other_kernel", 1.0)]] + [
        [] for _ in range(measure._PROFILE_ATTEMPTS - 1)]
    assert measure.kernel_ms(lambda: None, "window_kernel", reps=2) is None
    assert not sessions


def test_kernel_build_keys_on_source_and_raises_on_failed_nvcc(
        monkeypatch, tmp_path):
    a = _build.library_path("romix")
    assert a.name.startswith("libromix-") and a.suffix == ".so"
    assert a != _build.library_path("proving_scan")
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    (fake / "nvcc").write_text("#!/bin/sh\necho 'error: refused' ; exit 1\n")
    (fake / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    assert _build.nvcc() == str(fake / "nvcc")
    with pytest.raises(RuntimeError, match="refused"):
        _build.build_all()
    assert not list((tmp_path / "build").glob("*.so*"))


def test_kernel_build_key_follows_included_headers(monkeypatch, tmp_path):
    """A source's library path hashes the local headers it includes,
    through other headers too, so an edited header never loads a stale
    library; an unrelated file changes nothing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n'
                               'int k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// rounds\n")
    (csrc / "other.cuh").write_text("// unrelated\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.source_files("k")] == ["k.cu", "a.cuh",
                                                           "b.cuh"]
    before = _build.library_path("k")
    (csrc / "other.cuh").write_text("// unrelated, edited\n")
    assert _build.library_path("k") == before
    (csrc / "b.cuh").write_text("// rounds, edited\n")
    edited = _build.library_path("k")
    assert edited != before and edited.name.startswith("libk-")
    monkeypatch.undo()
    assert "k2pow" in _build.SOURCES
    for name in ("pbkdf2", "k2pow"):
        assert "sha256.cuh" in [p.name for p in _build.source_files(name)]


def test_host_copy_and_state_conversion_round_trip():
    t = torch.arange(5, dtype=torch.int32)
    assert device.HostCopy(t).get() is t
    words = np.array([[0, 1, 2**31, 2**32 - 1]], dtype=np.uint32)
    assert np.array_equal(convert.words_from_torch(
        convert.words_to_torch(words)), words)
    carry = tscrypt.vrf_carry_init((2**64 - 1, 5), 2**40 + 3)
    back = convert.vrf_carry_from_torch(convert.vrf_carry_to_torch(carry))
    assert tscrypt.vrf_carry_decode(back) == (2**40 + 3, (2**64 - 1, 5))
    counts = np.array([3, 0], dtype=np.int32)
    hits = np.full((2, 2, 4), 2**32 - 1, dtype=np.uint32)
    c, h = convert.hit_state_from_torch(
        *convert.hit_state_to_torch(counts, hits))
    assert np.array_equal(c, counts) and np.array_equal(h, hits)
    with pytest.raises(ValueError):
        convert.vrf_carry_to_torch(np.zeros(5, np.uint32))


WORKER_MODULES = ("spacemesh_tpu_torch.post",
                  "spacemesh_tpu_torch.post.__main__",
                  "spacemesh_tpu_torch.post.service",
                  "spacemesh_tpu_torch.post.remote",
                  "spacemesh_tpu_torch.post.supervisor",
                  "spacemesh_tpu_torch.post.faultfs",
                  "spacemesh_tpu_torch.api",
                  "spacemesh_tpu_torch.api.gen",
                  "spacemesh_tpu_torch.utils.metrics",
                  "spacemesh_tpu_torch.runtime.scheduler",
                  "spacemesh_tpu_torch.runtime.workloads")


def _importers(pred) -> dict:
    """{file: sorted enclosing function names ("" at module level)} of
    every import of a module name matching ``pred`` in the port."""
    found: dict = {}
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for fn in [tree] + [n for n in ast.walk(tree) if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            body = ast.Module(body=fn.body, type_ignores=[])
            own = {id(n) for inner in ast.walk(body) if inner is not body
                   and isinstance(inner, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                   for n in ast.walk(inner) if n is not inner}
            for node in ast.walk(body):
                if id(node) in own:
                    continue
                if any(pred(name) for name in _imported(
                        ast.Module(body=[node], type_ignores=[]))
                       if isinstance(node, (ast.Import, ast.ImportFrom))):
                    rel = path.relative_to(REPO).as_posix()
                    found.setdefault(rel, set()).add(getattr(fn, "name", ""))
    return {k: sorted(v) for k, v in found.items()}


def _is_grpc(name: str) -> bool:
    return name == "grpc" or name.startswith(("grpc.", "google.protobuf"))


def test_only_the_grpc_worker_imports_grpc_and_protobuf():
    """grpc and google.protobuf are imported at module level by
    ``post/grpc_worker.py``, the node's gRPC API (``api/rpc.py``,
    ``api/rpc_v2.py``) and the generated ``api/gen/{post,core,
    v2alpha1}_pb2.py`` alone, and by verifyd only inside the functions
    that open its gRPC surface (the server's ``_start_grpc``, the
    client's ``grpc_verify``), and by ``chip_smoke.py``'s ``[api]`` client
    only inside its gRPC calls; everything else of the worker, the ``api``
    package with its wire helpers included, imports with both blocked, as
    on a card host that has neither."""
    assert _importers(_is_grpc) == {
        "spacemesh_tpu_torch/post/grpc_worker.py": [""],
        "spacemesh_tpu_torch/api/gen/post_pb2.py": [""],
        "spacemesh_tpu_torch/api/gen/core_pb2.py": [""],
        "spacemesh_tpu_torch/api/gen/v2alpha1_pb2.py": [""],
        "spacemesh_tpu_torch/api/rpc.py": [""],
        "spacemesh_tpu_torch/api/rpc_v2.py": [""],
        # chip_smoke.py's [api] client: the operator's gRPC calls to a node
        "chip_smoke.py": ["_grpc_events", "_poll", "grpc_unary"],
        "spacemesh_tpu_torch/verifyd/server.py": ["_start_grpc"],
        "spacemesh_tpu_torch/verifyd/client.py": ["grpc_verify"]}
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'grpc' or name.startswith(('grpc.',\n"
        "                                              'google.protobuf')):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {WORKER_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules\n"
        "            if m == 'grpc' or m.startswith('google.protobuf')]\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


VERIFY_MODULES = ("spacemesh_tpu_torch.verify",
                  "spacemesh_tpu_torch.verify.workload",
                  "spacemesh_tpu_torch.verifyd",
                  "spacemesh_tpu_torch.verifyd.service",
                  "spacemesh_tpu_torch.verifyd.client",
                  "spacemesh_tpu_torch.verifyd.__main__",
                  "spacemesh_tpu_torch.core.signing")


def test_aiohttp_only_in_the_verifyd_server_and_client_session():
    """aiohttp is imported by ``verifyd/server.py``, the node's JSON API
    (``api/http.py``, which ``api`` exports on first use) and, lazily, by
    the client's and the fleet's replica endpoint's sessions; the farm, the
    service, signing and the verifyd package import and verify a
    signature with aiohttp, grpc, protobuf and cryptography all blocked,
    as on a host that has none of them (signing then takes its
    pure-Python branch)."""
    assert _importers(lambda n: n.split(".")[0] == "aiohttp") == {
        "spacemesh_tpu_torch/verifyd/server.py": [""],
        "spacemesh_tpu_torch/api/http.py": [""],
        "spacemesh_tpu_torch/verifyd/client.py": ["_sess"],
        "spacemesh_tpu_torch/verifyd/fleet.py": ["_sess"]}
    code = (
        "import asyncio, importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('aiohttp', 'grpc',\n"
        "                                  'cryptography') or\\\n"
        "                name.startswith('google.protobuf'):\n"
        "            raise ModuleNotFoundError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {VERIFY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from spacemesh_tpu_torch.core import signing\n"
        "from spacemesh_tpu_torch.verify.farm import (SigRequest,\n"
        "                                             VerificationFarm)\n"
        "assert not signing._HAVE_CRYPTOGRAPHY\n"
        "s = signing.EdSigner(seed=bytes(32))\n"
        "req = SigRequest(3, s.public_key, b'm', s.sign(3, b'm'))\n"
        "async def go():\n"
        "    farm = VerificationFarm(device='cpu')\n"
        "    try:\n"
        "        return await farm.submit(req)\n"
        "    finally:\n"
        "        await farm.aclose()\n"
        "assert asyncio.run(go()) is True\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('aiohttp', 'grpc', 'cryptography')]\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


FLEET_MODULES = ("spacemesh_tpu_torch.obs.remediate",
                 "spacemesh_tpu_torch.obs.sli",
                 "spacemesh_tpu_torch.obs.federate",
                 "spacemesh_tpu_torch.verifyd.routing",
                 "spacemesh_tpu_torch.verifyd.failover",
                 "spacemesh_tpu_torch.verifyd.fleet",
                 "spacemesh_tpu_torch.sim",
                 "spacemesh_tpu_torch.sim.verifyd_load",
                 "spacemesh_tpu_torch.sim.failover",
                 "spacemesh_tpu_torch.sim.fleet",
                 "spacemesh_tpu_torch.sim.scenarios")


def test_fleet_modules_import_without_jax_the_jax_package_or_aiohttp():
    """The fleet's modules and drills import, and ``fleet_from_urls``
    builds its verifier, with jax, the JAX package and aiohttp blocked:
    the replica endpoint opens its aiohttp session only on first use."""
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                  'spacemesh_tpu', 'aiohttp'):\n"
        "            raise ModuleNotFoundError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {FLEET_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from spacemesh_tpu_torch.verifyd import fleet_from_urls\n"
        "fv = fleet_from_urls(['http://127.0.0.1:1', 'http://127.0.0.1:2'],\n"
        "                     farm=None)\n"
        "assert sorted(fv.router.replicas) == ['r0', 'r1']\n"
        "fv.shutdown()\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'jaxlib', 'spacemesh_tpu', 'aiohttp')]\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


def test_worker_entry_points_default_to_cuda_and_never_fall_back(
        monkeypatch, tmp_path, capsys):
    """The CLI without --device, PostClient, discover_identities' clients
    and PostSupervisor all default to cuda and raise or exit non-zero
    without a card; nothing is written."""
    from spacemesh_tpu_torch.post import __main__ as cli
    from spacemesh_tpu_torch.post.data import PostMetadata
    from spacemesh_tpu_torch.post.remote import discover_identities
    from spacemesh_tpu_torch.post.service import PostClient
    from spacemesh_tpu_torch.post.supervisor import PostSupervisor

    node = hashlib.sha256(b"n").hexdigest()
    store = tmp_path / "store"
    store.mkdir()
    PostMetadata(node_id=node, commitment=node, scrypt_n=2, num_units=1,
                 labels_per_unit=64, max_file_size=1024,
                 labels_written=64).save(store)
    (tmp_path / "proof.json").write_text(json.dumps(
        {"nonce": 0, "indices": [1], "pow_nonce": 0, "k2": 1}))
    fresh = tmp_path / "fresh"
    argvs = {
        "init": ["--data-dir", str(fresh), "--node-id-hex", node,
                 "--commitment-hex", node, "--num-units", "1",
                 "--labels-per-unit", "64", "--scrypt-n", "2"],
        "prove": ["--data-dir", str(store), "--challenge-hex", node],
        "verify": ["--data-dir", str(store), "--challenge-hex", node,
                   "--proof-file", str(tmp_path / "proof.json")],
        "benchmark": ["--batch", "8", "--scrypt-n", "2"],
        "serve": ["--data-dir", str(tmp_path)],
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd, argv in argvs.items():
        capsys.readouterr()
        assert cli.main([cmd, *argv]) != 0, cmd
        out = capsys.readouterr()
        assert out.out == "" and "cuda" in out.err, cmd
    assert not fresh.exists()
    with pytest.raises(RuntimeError, match="cuda"):
        PostClient(store)
    with pytest.raises(RuntimeError, match="cuda"):
        discover_identities(tmp_path)
    assert discover_identities(tmp_path, device="cpu").registered() == [
        bytes.fromhex(node)]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    sup = PostSupervisor(tmp_path, env=env)
    assert sup.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        sup.start(timeout=120)
    assert not sup.alive()
