"""The port's label-init pipeline and PoST round trip on the CPU: the
cases of ``tests/test_post_pipeline.py`` and ``tests/test_post_roundtrip.py``
that build their components through the entry points ``torch_twin`` puts
on the CPU run on the port.

The cases that call a host function or class whose ``device`` defaults
to the card (``scrypt_labels``, ``Initializer``) are written out here side
by side with the JAX package: the smoke run and a stop before the next
dispatch. The profiler hook's ``probe`` argument is not ported
(``docs/PORT_PARITY.md``).
"""

import hashlib

import numpy as np
from torch_twin import export

from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu.post import initializer as jinit
from spacemesh_tpu.post.data import PostMetadata as JMeta
from spacemesh_tpu_torch.post import initializer as tinit
from spacemesh_tpu_torch.post.data import LabelStore, PostMetadata

export("test_post_pipeline", globals(), only=(
    "test_pipeline_exports_metrics",
    "test_crash_in_writer_surfaces_and_resumes",
    "test_writer_durable_cursor_is_contiguous",
    "test_interval_metadata_saves_happen_midrun"))
export("test_post_roundtrip", globals(), only=(
    "test_mismatched_params_rejected",
    "test_prove_verify_roundtrip",
    "test_serial_roundtrip_and_identity",
    "test_wrong_nonce_rejected_both_paths",
    "test_corrupted_labels_rejected_both_paths",
    "test_tampered_proofs_rejected",
    "test_proof_dict_roundtrip"))

NODE = hashlib.sha256(b"pipe-node").digest()
COMMIT = hashlib.sha256(b"pipe-commitment").digest()
TOTAL, BATCH, N = 1024, 256, 2


def _disk(d, count):
    store = LabelStore(d, PostMetadata.load(d))
    try:
        return store.read_labels(0, count)
    finally:
        store.close()


def test_pipeline_smoke_equals_jax(tmp_path):
    kw = dict(node_id=NODE, commitment=COMMIT, num_units=1,
              labels_per_unit=TOTAL, scrypt_n=N, max_file_size=1 << 20,
              batch_size=BATCH)
    meta, res = tinit.initialize(tmp_path / "port", device="cpu", **kw)
    jmeta, _ = jinit.initialize(tmp_path / "jax", mesh=None, **kw)
    assert meta.labels_written == TOTAL and res.labels_per_s > 0
    assert res.stats is not None and res.stats.batches == TOTAL // BATCH
    want = jscrypt.scrypt_labels(COMMIT, np.arange(TOTAL, dtype=np.uint64),
                                 n=N)
    assert _disk(tmp_path / "port", TOTAL) == want.tobytes()
    # the VRF nonce: the first occurrence of the LE-u128 minimum
    lo = want[:, :8].copy().view("<u8").ravel()
    hi = want[:, 8:].copy().view("<u8").ravel()
    k = int(np.lexsort((lo, hi))[0])
    assert (meta.vrf_nonce, meta.vrf_nonce_value) \
        == (jmeta.vrf_nonce, jmeta.vrf_nonce_value) \
        == (k, bytes(want[k]).hex())


def test_stop_before_dispatch_persists_cursor(tmp_path):
    """``stop()`` takes effect before the next batch is dispatched, and the
    discarded-pending path still persists the flushed cursor, as in the
    JAX package."""
    out = {}
    for name, mod, meta_cls, extra in (
            ("port", tinit, PostMetadata, dict(device="cpu")),
            ("jax", jinit, JMeta, {})):
        d = tmp_path / name
        meta = meta_cls(node_id=NODE.hex(), commitment=COMMIT.hex(),
                        scrypt_n=N, num_units=1, labels_per_unit=TOTAL,
                        max_file_size=1 << 20)
        dispatched = []
        init = mod.Initializer(
            d, meta, batch_size=BATCH, inflight=3, mesh=None,
            progress=lambda done, total: (dispatched.append(done),
                                          init.stop()), **extra)
        init.run()
        out[name] = (init.status.value, dispatched,
                     meta_cls.load(d).labels_written)
    assert out["port"] == out["jax"] == ("stopped", [BATCH], BATCH)
    want = jscrypt.scrypt_labels(COMMIT, np.arange(BATCH, dtype=np.uint64),
                                 n=N)
    assert _disk(tmp_path / "port", BATCH) == want.tobytes()
