"""The port's topology (``spacemesh_tpu_torch/parallel/topology.py``) and
the mesh routing of the scheduler's packs and the verifier, held to the
JAX package's ``tests/test_topology.py`` contracts.

The port sees eight ``cpu`` stripes (``topology.reset``), the JAX side its
eight virtual host devices; ``SPACEMESH_MESH=4`` routes both packages'
packs and verify recomputes over four of them. Stores, VRF nonces and
verdicts must be equal, bit for bit.
"""

import hashlib

import numpy as np
import pytest
import torch

from spacemesh_tpu_torch.ops import autotune, scrypt
from spacemesh_tpu_torch.parallel import data_mesh, topology
from spacemesh_tpu_torch.parallel import mesh as pmesh

N = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def stripes(tmp_path, monkeypatch):
    """Eight ``cpu`` stripes, a private cache root, racing off (the
    conftest's setting), no overrides."""
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "cache"))
    for var in (autotune.ENV_IMPL, autotune.ENV_CHUNK, autotune.ENV_MESH):
        monkeypatch.delenv(var, raising=False)
    autotune.reset_memo()
    topology.reset(["cpu"] * 8)
    yield topology.get()
    autotune.reset_memo()
    topology.reset()


def test_one_layouts_object_per_count(stripes):
    """Every entry point takes the same mesh and layouts objects: built
    once per count (and per device list), never per call."""
    t = stripes
    assert t is topology.get()
    lay = t.layouts()
    assert lay is t.layouts()
    assert lay.mesh is data_mesh()
    assert lay.mesh.shape == {"data": 8, "model": 1}
    sub = t.layouts(4)
    assert sub is t.layouts_for_devices(["cpu"] * 4)
    assert sub.mesh is data_mesh(["cpu"] * 4)
    assert pmesh.lane_sharding(sub.mesh) is sub
    assert sub.streams == (None,) * 4  # CPU stripes have no stream
    assert t.layouts(99) is lay       # clipped to the visible devices


def test_layouts_for_foreign_mesh_resolves_by_devices(stripes):
    lay = stripes.layouts(2)
    assert stripes.layouts_for(lay.mesh) is lay
    # a mesh built outside the catalog resolves by its device list
    foreign = topology.MeshLayouts(["cpu", "cpu"]).mesh
    assert stripes.layouts_for(foreign) is lay
    with pytest.raises(ValueError, match="one device type"):
        topology.MeshLayouts(["cpu", "cuda:0"])


def test_replicate_is_noop_for_resident_carry(stripes):
    """A carry already on every stripe comes back as it is (the same
    list), so a pass places it once."""
    lay = stripes.layouts()
    placed = lay.replicate(scrypt.vrf_carry_init())
    assert len(placed) == 8
    assert lay.replicate(placed) is placed
    assert pmesh.replicate(lay.mesh, placed) is placed
    # a list of the wrong length is placed afresh
    assert stripes.layouts(4).replicate(placed) is not placed


@pytest.mark.parametrize("totals", [(1,), (7,), (7, 300)],
                         ids=["1", "7", "7+300"])
def test_packed_init_sharded_equals_jax(stripes, tmp_path, monkeypatch,
                                        totals):
    """The scheduler's packs routed over four stripes write the JAX
    scheduler's stores (its packs routed over four virtual devices) and
    VRF nonces, at ragged totals."""
    from spacemesh_tpu.post.data import LabelStore as JStore
    from spacemesh_tpu.runtime import TenantScheduler as JSched
    from spacemesh_tpu_torch.post.data import LabelStore as TStore
    from spacemesh_tpu_torch.runtime import TenantScheduler as TSched

    monkeypatch.setenv(autotune.ENV_MESH, "4")
    striped = []
    real = pmesh.scrypt_labels_sharded
    monkeypatch.setattr(
        pmesh, "scrypt_labels_sharded",
        lambda mesh, *a, **k: striped.append(mesh.size) or real(mesh, *a,
                                                                **k))
    ids = [(f"t{i}", hashlib.sha256(b"tnode%d" % i).digest(),
            hashlib.sha256(b"tcommit%d" % i).digest(), total)
           for i, total in enumerate(totals)]
    metas = {}
    for tag, sched_cls, kw in (("jax", JSched, {}),
                               ("torch", TSched, {"device": "cpu"})):
        with sched_cls(workers=2, pack_lanes=256, **kw) as sched:
            handles = []
            for tid, node, commit, total in ids:
                sched.register_tenant(tid)
                handles.append((tid, sched.submit_init(
                    tid, tmp_path / tag / tid, node_id=node,
                    commitment=commit, num_units=1, labels_per_unit=total,
                    scrypt_n=N, max_file_size=1 << 20)))
            for tid, h in handles:
                metas[tag, tid] = h.result(timeout=600)
    # a pack of one lane cannot stripe: it runs on one device, as in JAX
    assert set(striped) == ({4} if sum(totals) >= 4 else set())
    for tid, _, commit, total in ids:
        jm, tm = metas["jax", tid], metas["torch", tid]
        want = JStore(tmp_path / "jax" / tid, jm).read_labels(0, total)
        store = TStore(tmp_path / "torch" / tid, tm)
        assert store.read_labels(0, total) == want, tid
        store.close()
        assert (tm.vrf_nonce, tm.vrf_nonce_value) \
            == (jm.vrf_nonce, jm.vrf_nonce_value), tid


@pytest.mark.parametrize("count", [1, 7, 40])
def test_farm_verify_sharded_matches_jax(stripes, monkeypatch, count):
    """verify_many's recompute striped over four stripes gives the JAX
    package's verdicts (its recompute sharded over four devices) and the
    port's own single-device verdicts, at ragged totals."""
    from spacemesh_tpu.post import verifier as jverifier
    from spacemesh_tpu.post.prover import Proof as JProof
    from spacemesh_tpu.post.prover import ProofParams as JParams
    from spacemesh_tpu_torch.post import verifier as tverifier
    from spacemesh_tpu_torch.post.prover import Proof as TProof
    from spacemesh_tpu_torch.post.prover import ProofParams as TParams

    total_labels = 64
    pow_all = bytes([255] * 32)

    def items(verifier, proof_cls):
        return [verifier.VerifyItem(
            proof_cls(nonce=i % 3, indices=[(5 * i) % total_labels],
                      pow_nonce=0, k2=1),
            hashlib.sha256(b"vch%d" % i).digest(),
            hashlib.sha256(b"vnode%d" % i).digest(),
            hashlib.sha256(b"vcommit%d" % i).digest(),
            N, total_labels) for i in range(count)]

    seed = b"topology-seed".ljust(32, b"\0")
    single = tverifier.verify_many(
        items(tverifier, TProof), TParams(k1=8, k2=1, k3=1,
                                          pow_difficulty=pow_all),
        seed, device="cpu")
    monkeypatch.setenv(autotune.ENV_MESH, "4")
    calls = []
    real = pmesh.scrypt_labels_hash_sharded
    monkeypatch.setattr(
        pmesh, "scrypt_labels_hash_sharded",
        lambda mesh, *a, **k: calls.append(mesh.size) or real(mesh, *a, **k))
    sharded = tverifier.verify_many(
        items(tverifier, TProof), TParams(k1=8, k2=1, k3=1,
                                          pow_difficulty=pow_all),
        seed, device="cpu")
    want = jverifier.verify_many(
        items(jverifier, JProof), JParams(k1=8, k2=1, k3=1,
                                          pow_difficulty=pow_all), seed)
    assert sharded == single == want
    assert calls == ([4] if count >= 4 else [])
    if count == 40:
        assert any(want) and not all(want)


def test_sharded_scan_needs_no_divisible_batch(stripes):
    """The stripes split by whole 64-lane segments, raggedly; one stripe
    may be empty, and the labels still equal the single-device path."""
    lay = stripes.layouts(8)
    assert [m for _, m in lay.bounds(3 * 64, 64)] == [64, 64, 64] + [0] * 5
    idx = np.arange(5, dtype=np.uint64)
    lo, hi = scrypt.split_indices(idx)
    cw = scrypt.commitment_to_words(bytes(32))
    parts = pmesh.scrypt_labels_sharded(lay.mesh, cw, lo, hi, n=2)
    assert [p.shape[1] for p in parts] == [1] * 5 + [0] * 3
    got = scrypt.labels_to_bytes(torch.cat(parts, dim=1))
    assert got == scrypt.scrypt_labels(bytes(32), idx, n=2,
                                       device="cpu").tobytes()
