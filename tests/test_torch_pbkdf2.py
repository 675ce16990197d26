"""The port's PBKDF2-HMAC-SHA256 envelope (spacemesh_tpu_torch/ops/
pbkdf2_cuda.py) against the JAX package and hashlib, on the CPU, with
exact equality.

On the CPU the wrappers run their plain twins; the CUDA kernel itself is
held against those twins on the card (tests/test_torch_cuda.py).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacemesh_tpu.ops import scrypt as jscrypt
from spacemesh_tpu_torch.ops import pbkdf2_cuda, romix_cuda
from spacemesh_tpu_torch.ops import scrypt as tscrypt
from spacemesh_tpu_torch.ops import u32

T = u32.from_numpy
N_ = u32.to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_ops.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indices(b, seed):
    """(B,) u64 label indices: edge values around 2^32 and 2^63, then
    random ones."""
    edges = np.array([0, 1, 2**32 - 1, 2**32, 2**32 + 1, 2**63 - 1, 2**63,
                      2**63 + 5, 2**64 - 1], dtype=np.uint64)
    rnd = np.random.default_rng(seed).integers(0, 2**64, b, dtype=np.uint64)
    return np.concatenate([edges, rnd])[:b]


def _commitments(b, per_lane, seed):
    """Commitment words, (8,) shared or (8, B) per lane, BE u32."""
    rng = np.random.default_rng(seed)
    if not per_lane:
        return jscrypt.commitment_to_words(bytes(rng.integers(
            0, 256, 32, dtype=np.uint8)))
    raw = rng.integers(0, 256, (b, 32), dtype=np.uint8)
    return raw.view(">u4").astype(np.uint32).T.copy()


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("b", [1, 9, 37])
def test_expand_and_finish_match_jax(per_lane, b):
    idx = _indices(b, b)
    lo, hi = jscrypt.split_indices(idx)
    cw = _commitments(b, per_lane, 100 + b)
    jinner, jouter, jblk = jscrypt._expand(jnp.asarray(cw), jnp.asarray(lo),
                                           jnp.asarray(hi))
    launches = (pbkdf2_cuda.expand_launches, pbkdf2_cuda.finish_launches)
    blk = pbkdf2_cuda.expand(T(cw), T(lo), T(hi))
    assert blk.shape == (32, b)
    assert np.array_equal(N_(blk), np.asarray(jblk))
    # finish over an arbitrary block, not only the expansion's
    b_le = np.random.default_rng(b).integers(0, 2**32, (32, b),
                                             dtype=np.uint32)
    want = np.asarray(jscrypt._pbkdf2_second(jinner, jouter,
                                             jnp.asarray(b_le)))[:4]
    got = pbkdf2_cuda.finish(T(cw), T(b_le))
    assert got.shape == (4, b) and np.array_equal(N_(got), want)
    # a CPU tensor never launches the kernel
    assert (pbkdf2_cuda.expand_launches,
            pbkdf2_cuda.finish_launches) == launches


@pytest.mark.parametrize("per_lane", [False, True])
def test_expand_romix_finish_is_hashlib_scrypt(per_lane):
    b, n = 11, 16
    idx = _indices(b, 7)
    lo, hi = tscrypt.split_indices(idx)
    cw = _commitments(b, per_lane, 8)
    blk = romix_cuda.romix(pbkdf2_cuda.expand(T(cw), T(lo), T(hi)), n)
    words = pbkdf2_cuda.finish(T(cw), blk)
    got = np.frombuffer(tscrypt.labels_to_bytes(words),
                        dtype=np.uint8).reshape(b, 16)
    for i in range(b):
        pw = (cw[:, i] if per_lane else cw).astype(">u4").tobytes()
        assert bytes(got[i]) == hashlib.scrypt(
            pw, salt=int(idx[i]).to_bytes(8, "little"), n=n, r=1, p=1,
            dklen=16)


def test_empty_batch():
    cw = T(_commitments(0, False, 3))
    empty = torch.zeros(0, dtype=torch.int32)
    assert pbkdf2_cuda.expand(cw, empty, empty).shape == (32, 0)
    assert pbkdf2_cuda.finish(cw, torch.zeros((32, 0), dtype=torch.int32)
                              ).shape == (4, 0)


def test_bad_shapes_and_dtypes_raise():
    cw = T(_commitments(4, False, 4))
    lo = torch.zeros(4, dtype=torch.int32)
    blk = torch.zeros((32, 4), dtype=torch.int32)
    bad_expand = [
        (cw[:7], lo, lo),                                  # short key
        (T(_commitments(5, True, 5)), lo, lo),             # (8, 5) vs B=4
        (cw, lo, lo[:3]),                                  # halves differ
        (cw, lo.view(2, 2), lo.view(2, 2)),                # not (B,)
        (cw, lo.to(torch.int64), lo),                      # dtype
        (cw.to(torch.int64), lo, lo),
        (cw.to("meta"), lo.to("meta"), lo.to("meta")),     # device
    ]
    for args in bad_expand:
        with pytest.raises(ValueError):
            pbkdf2_cuda.expand(*args)
    bad_finish = [
        (cw, blk[:16]),                                    # not (32, B)
        (cw, blk[0]),
        (cw, blk.to(torch.int64)),
        (T(_commitments(3, True, 6)), blk),                # (8, 3) vs B=4
        (cw.to(torch.uint8), blk),
    ]
    for args in bad_finish:
        with pytest.raises(ValueError):
            pbkdf2_cuda.finish(*args)


def test_bounds_count_the_compressions():
    assert pbkdf2_cuda.COMPRESS_OPS == 1310
    # a shared commitment's midstates are needed once for the batch
    assert pbkdf2_cuda.int_ops(3, "expand", False) == (3 * 8 + 2) * 1310
    assert pbkdf2_cuda.int_ops(3, "finish", False) == (3 * 4 + 2) * 1310
    assert pbkdf2_cuda.int_ops(3, "expand", True) == 3 * 10 * 1310
    assert pbkdf2_cuda.int_ops(3, "finish", True) == 3 * 6 * 1310
    assert pbkdf2_cuda.io_bytes(3, "expand", False) == 32 + 3 * 136
    assert pbkdf2_cuda.io_bytes(3, "finish", True) == 3 * (32 + 144)
