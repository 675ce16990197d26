"""The port's device mesh (``spacemesh_tpu_torch/parallel/``) held to the
JAX package's sharded functions.

The JAX side runs over the conftest's virtual host devices; the port's
side stripes the same lanes over an explicit list of ``cpu`` entries
(each entry a stripe, ``parallel/topology.py``), so 2-, 4- and 8-way
striping runs on the CPU. Inputs come from numpy seeds; every comparison
is exact. The labels are scrypt at N=2/4 over at most 1024 lanes.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacemesh_tpu.ops import proving as jproving
from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.parallel import mesh as jmesh
from spacemesh_tpu_torch import convert
from spacemesh_tpu_torch.ops import proving as tproving
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.ops import u32
from spacemesh_tpu_torch.parallel import mesh as tmesh
from spacemesh_tpu_torch.parallel import topology

COMMIT = hashlib.sha256(b"c").digest()
NDEV = (2, 4, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def cpu_stripes(tmp_path, monkeypatch):
    """Eight ``cpu`` stripes visible, as the JAX side sees eight virtual
    devices; a fresh cache root, no autotune overrides."""
    monkeypatch.setenv("SPACEMESH_TORCH_CACHE", str(tmp_path / "cache"))
    for var in ("SPACEMESH_ROMIX", "SPACEMESH_ROMIX_CHUNK", "SPACEMESH_MESH"):
        monkeypatch.delenv(var, raising=False)
    topology.reset(["cpu"] * 8)
    yield
    topology.reset()


def _meshes(ndev):
    return (jmesh.data_mesh(jax.devices()[:ndev]),
            tmesh.data_mesh(["cpu"] * ndev))


def _bytes(parts) -> bytes:
    """The port's striped words, joined in lane order, as label bytes."""
    return tscrypt.labels_to_bytes(torch.cat(list(parts), dim=1))


@pytest.mark.parametrize("ndev", NDEV)
def test_sharded_labels_equal_jax(ndev):
    jm, tm = _meshes(ndev)
    idx = np.arange(256, dtype=np.uint64)
    lo, hi = jscrypt.split_indices(idx)
    cw = jscrypt.commitment_to_words(COMMIT)
    want = jscrypt.labels_to_bytes(np.asarray(
        jmesh.scrypt_labels_sharded(jm, cw, lo, hi, n=4)))
    parts = tmesh.scrypt_labels_sharded(tm, cw, lo, hi, n=4)
    assert len(parts) == ndev
    assert {p.shape[1] for p in parts} == {256 // ndev}
    assert _bytes(parts) == want
    assert want == jscrypt.scrypt_labels(COMMIT, idx, n=4).tobytes()
    # the proving hash's LE words, on the stripes' devices
    le = torch.cat(tmesh.words_to_le(parts), dim=1)
    assert np.array_equal(u32.to_numpy(le), jscrypt.labels_to_words(
        np.frombuffer(want, dtype=np.uint8).reshape(-1, 16)))


@pytest.mark.parametrize("ndev", NDEV)
def test_sharded_multi_identity_equal_jax(ndev):
    jm, tm = _meshes(ndev)
    rng = np.random.default_rng(11)
    commits = np.repeat(rng.integers(0, 256, (4, 32), dtype=np.uint8), 64,
                        axis=0)
    idx = np.tile(rng.integers(0, 2**40, 64, dtype=np.uint64), 4)
    cw = commits.view(">u4").astype(np.uint32).reshape(-1, 8).T
    lo, hi = jscrypt.split_indices(idx)
    want = jscrypt.labels_to_bytes(np.asarray(
        jmesh.scrypt_labels_sharded(jm, cw, lo, hi, n=4)))
    assert _bytes(tmesh.scrypt_labels_sharded(tm, cw, lo, hi, n=4)) == want


@pytest.mark.parametrize("ndev", NDEV)
def test_labels_with_min_sharded_equal_jax(ndev):
    """Two chained batches: the same words, and the same carry and
    snapshot as the JAX mesh's (the first-occurrence LE-u128 minimum)."""
    jm, tm = _meshes(ndev)
    cw = jscrypt.commitment_to_words(COMMIT)
    jcarry = tcarry = jscrypt.vrf_carry_init()
    for start in (0, 128):
        lo, hi = jscrypt.split_indices(
            np.arange(start, start + 128, dtype=np.uint64))
        jw, jcarry, jsnap = jmesh.labels_with_min_sharded(
            jm, cw, lo, hi, jcarry, n=4)
        tw, tcarry, tsnap = tmesh.labels_with_min_sharded(
            tm, cw, lo, hi, tcarry, n=4)
        assert _bytes(tw) == jscrypt.labels_to_bytes(np.asarray(jw))
        assert np.array_equal(u32.to_numpy(tsnap), np.asarray(jsnap))
        assert len(tcarry) == ndev
        assert all(np.array_equal(u32.to_numpy(c), np.asarray(jcarry))
                   for c in tcarry)
        # the carry stays where it is from batch to batch
        assert tmesh.replicate(tm, tcarry) is tcarry
    want = jscrypt.scrypt_labels(COMMIT, np.arange(256, dtype=np.uint64),
                                 n=4)
    lo_ = want[:, :8].copy().view("<u8").ravel()
    hi_ = want[:, 8:].copy().view("<u8").ravel()
    assert tscrypt.vrf_carry_decode(tsnap)[0] == int(
        np.lexsort((lo_, hi_))[0])


@pytest.mark.parametrize("ndev", NDEV)
def test_init_step_sharded_equal_jax(ndev):
    jm, tm = _meshes(ndev)
    idx = np.arange(512, dtype=np.uint64)
    lo, hi = jscrypt.split_indices(idx)
    cw = jscrypt.commitment_to_words(COMMIT)
    t = jproving.threshold_u32(64, 512)
    jw, jq, jhi, jlo = jmesh.init_step_sharded(jm, cw, lo, hi, t, n=2)
    tw, tq, thi, tlo = tmesh.init_step_sharded(tm, cw, lo, hi, t, n=2)
    assert _bytes(tw) == jscrypt.labels_to_bytes(np.asarray(jw))
    assert (int(tq), int(thi), int(tlo)) == (int(jq), int(jhi), int(jlo))


@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("start", [0, 2**32 - 700], ids=["0", "hi-carry"])
def test_prove_step_sharded_equal_jax(ndev, start):
    """Two prove steps over seeded label words with a ragged tail: the hit
    counts, each step's batch counts and the hit carry equal the JAX
    mesh's; the second start's hits cross into idx_hi."""
    jm, tm = _meshes(ndev)
    rng = np.random.default_rng(ndev)
    batch, count, n_nonces, cap = 1024, 1000, 16, 8
    cw = jproving.challenge_words(hashlib.sha256(b"ch").digest())
    t = jproving.threshold_u32(40, 2048)
    jc, jcarry = jproving.init_hit_state(n_nonces, cap)
    tc, tcarry = tproving.init_hit_state(n_nonces, cap, "cpu")
    for step, valid in enumerate((batch, count)):
        s = start + step * batch
        lo, hi = jscrypt.split_indices(
            np.arange(s, s + batch, dtype=np.uint64))
        lw = rng.integers(0, 2**32, (4, batch), dtype=np.uint32)
        jc, jbc, jcarry = jmesh.prove_step_sharded(
            jm, jnp.asarray(cw), jnp.uint32(0), lo, hi, lw, jnp.uint32(t),
            jc, jcarry, jnp.uint32(valid), jnp.uint32(s & 0xFFFFFFFF),
            jnp.uint32(s >> 32), n_nonces=n_nonces, max_hits=cap)
        tc, tbc, tcarry = tmesh.prove_step_sharded(
            tm, cw, 0, lo, hi, lw, t, tc, tcarry, valid, s & 0xFFFFFFFF,
            s >> 32, n_nonces=n_nonces, max_hits=cap)
        assert np.array_equal(tbc.numpy(), np.asarray(jbc))
    got = convert.hit_state_from_torch(tc, tcarry)
    assert np.array_equal(got[0], np.asarray(jc))
    assert np.array_equal(got[1], np.asarray(jcarry))
    assert int(np.asarray(jc).max()) > cap  # some nonce dropped hits


@pytest.mark.parametrize("ndev", NDEV)
def test_initialize_mesh_equals_jax(tmp_path, ndev):
    """A streaming init over ``ndev`` stripes writes the JAX mesh init's
    store bytes and VRF nonce, a ragged last batch included."""
    from spacemesh_tpu.post import initializer as jinit
    from spacemesh_tpu.post.data import LabelStore as JStore
    from spacemesh_tpu_torch.post import initializer as tinit
    from spacemesh_tpu_torch.post.data import LabelStore as TStore
    from spacemesh_tpu_torch.utils import metrics

    jm, tm = _meshes(ndev)
    node = hashlib.sha256(b"mesh-node").digest()
    total, batch = 333, 128  # last batch of 77 lanes
    kw = dict(node_id=node, commitment=COMMIT, num_units=1,
              labels_per_unit=total, scrypt_n=4, max_file_size=1 << 20,
              batch_size=batch)
    jmeta, _ = jinit.initialize(tmp_path / "jax", mesh=jm, **kw)
    tmeta, res = tinit.initialize(tmp_path / "torch", mesh=tm,
                                  device="cpu", **kw)
    want = JStore(tmp_path / "jax", jmeta).read_labels(0, total)
    assert TStore(tmp_path / "torch", tmeta).read_labels(0, total) == want
    assert (tmeta.vrf_nonce, tmeta.vrf_nonce_value) \
        == (jmeta.vrf_nonce, jmeta.vrf_nonce_value)
    assert res.stats.shards == 3 * ndev
    assert metrics.post_mesh_devices._values.get(()) == ndev
    assert 0.0 <= metrics.post_mesh_shard_imbalance._values.get(()) <= 1.0


def test_min_tie_across_stripes_goes_to_the_lower_index(monkeypatch):
    """Planted labels: every lane's key is the maximum except two equal
    minima, one in stripe 1 and one in stripe 2. The combine must keep
    stripe 1's (the lower global index), as the single-device scan's
    first-occurrence rule does; a tie with the incoming carry keeps the
    carry."""
    tm = tmesh.data_mesh(["cpu"] * 4)
    low = {70, 150}  # lanes 64..127 are stripe 1, 128..191 stripe 2

    def planted(cw, lo, hi, *, n, chunk=None):
        idx = u32.to_numpy(lo).astype(np.int64)
        words = np.full((4, idx.size), 0xFFFFFFFF, dtype=np.uint32)
        words[:, np.isin(idx, list(low))] = 0x01020304
        return u32.from_numpy(words)

    monkeypatch.setattr(tscrypt, "scrypt_labels_words", planted)
    cw = jscrypt.commitment_to_words(COMMIT)
    lo, hi = jscrypt.split_indices(np.arange(256, dtype=np.uint64))
    _, carry, snap = tmesh.labels_with_min_sharded(
        tm, cw, lo, hi, jscrypt.vrf_carry_init(), n=2)
    _, one, _ = tscrypt.scrypt_labels_with_min(
        u32.from_numpy(cw), u32.from_numpy(lo), u32.from_numpy(hi),
        u32.from_numpy(jscrypt.vrf_carry_init()), n=2)
    assert tscrypt.vrf_carry_decode(snap)[0] == 70
    assert torch.equal(snap, one)
    # the same key again in a later batch: the earlier carry holds
    lo2, hi2 = jscrypt.split_indices(np.arange(256, 512, dtype=np.uint64))
    low.update({300, 400})
    _, _, snap2 = tmesh.labels_with_min_sharded(tm, cw, lo2, hi2, carry, n=2)
    assert tscrypt.vrf_carry_decode(snap2)[0] == 70


def test_ragged_stripes_differ_by_one_lane():
    """A batch the mesh does not divide: stripes differ by at most one
    lane (or one 64-lane segment for the scan), and the labels are the
    single-device path's."""
    lay = topology.get().layouts(4)
    assert lay.bounds(10) == [(0, 3), (3, 3), (6, 2), (8, 2)]
    assert lay.bounds(3 * 64 + 5, 64) == [(0, 64), (64, 64), (128, 64),
                                           (192, 5)]
    idx = np.arange(37, dtype=np.uint64)
    lo, hi = jscrypt.split_indices(idx)
    parts = tmesh.scrypt_labels_sharded(lay.mesh, jscrypt.commitment_to_words(
        COMMIT), lo, hi, n=2)
    assert [p.shape[1] for p in parts] == [10, 9, 9, 9]
    assert _bytes(parts) == jscrypt.scrypt_labels(COMMIT, idx, n=2).tobytes()


def test_prover_mesh_equals_jax(tmp_path, monkeypatch):
    """A prove striped over four stripes (the third nonce group wins,
    batches of 768 with a ragged tail) gives the JAX mesh prover's proof;
    every scan step went through ``prove_step_sharded``."""
    from spacemesh_tpu.post.prover import ProofParams as JParams
    from spacemesh_tpu.post.prover import Prover as JProver
    from spacemesh_tpu_torch.post import initializer as tinit
    from spacemesh_tpu_torch.post import prover as tprover

    params = dict(k1=8, k2=16, k3=4, pow_difficulty=b"\xff" * 32)
    challenge = hashlib.sha256(b"knobs-challenge").digest()
    tinit.initialize(tmp_path, node_id=hashlib.sha256(b"knobs-node").digest(),
                     commitment=hashlib.sha256(b"knobs-commit").digest(),
                     num_units=1, labels_per_unit=2048, scrypt_n=2,
                     batch_size=2048, mesh=None, device="cpu")
    jm, tm = _meshes(4)
    want = JProver(tmp_path, JParams(**params), batch_labels=768,
                   mesh=jm).prove(challenge)
    steps = []
    real = tmesh.prove_step_sharded
    monkeypatch.setattr(tmesh, "prove_step_sharded",
                        lambda m, *a, **k: steps.append(m.size)
                        or real(m, *a, **k))
    got = tprover.Prover(tmp_path, tprover.ProofParams(**params),
                         batch_labels=768, mesh=tm,
                         device="cpu").prove(challenge)
    assert (got.nonce, got.indices, got.pow_nonce) \
        == (want.nonce, want.indices, want.pow_nonce)
    assert got.nonce // 16 == 2 and steps and set(steps) == {4}
