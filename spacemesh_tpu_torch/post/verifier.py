"""PoST verification: recompute-and-check, batched across proofs.

Port of ``spacemesh_tpu/post/verifier.py``. All spot-checked (proof,
index) pairs are flattened into one label recompute with the proving hash
(per-lane commitments, challenges and nonces,
``ops/scrypt.py:scrypt_labels_hash``: on the card PBKDF2 expand, ROMix,
and PBKDF2 finish, which hashes each label in the registers that hold it),
so only the (B,) hash values come back to the host; then each proof's
values are held against its threshold. The K3 spot-check subset is drawn
from the verifier's seed; the k2pow witness is checked with hashlib.

When the shared mesh routing stripes the recompute
(``ops/autotune.py:resolve_auto_mesh``; with one card it never does),
each stripe recomputes its lanes' labels and hashes them on its own
device and stream (``parallel/mesh.py:scrypt_labels_hash_sharded``): the
JAX package's sharded labels, ``words_to_le`` and proving hash, with the
byte swap and the hash in the finish kernel's epilogue as on one device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np

from ..device import resolve
from ..ops import autotune
from ..ops import pow as k2pow
from ..ops import proving, scrypt, u32
from .prover import Proof, ProofParams


@dataclasses.dataclass
class VerifyItem:
    """One proof plus the identity/geometry it claims to cover."""

    proof: Proof
    challenge: bytes
    node_id: bytes
    commitment: bytes
    scrypt_n: int
    total_labels: int


def _k3_subset(item: VerifyItem, k3: int, seed: bytes) -> list[int]:
    """K3-subsample of the proof's indices, keyed by the verifier's seed
    (unpredictable to the prover)."""
    idx = item.proof.indices
    if k3 >= len(idx):
        return list(idx)
    h = hashlib.sha256(seed + item.challenge + item.node_id).digest()
    rng = np.random.default_rng(np.frombuffer(h[:8], dtype=np.uint64)[0])
    pick = rng.choice(len(idx), size=k3, replace=False)
    return [idx[i] for i in sorted(pick)]


def verify_many(items: list[VerifyItem], params: ProofParams | None = None,
                seed: bytes | None = None, device="cuda",
                timing: dict | None = None) -> list[bool]:
    """Verify a batch of proofs; returns per-proof validity.

    ``seed`` keys the K3 spot-check subset; by default a fresh random seed
    is drawn per call. Pass one only for reproducible verification.
    ``timing``, when given, gains the host seconds of each stage: ``prep``
    (structure, k2pow and K3 checks, the per-lane arrays), ``labels`` (the
    recompute: its inputs' copies and three kernel launches on the card,
    the last of which also hashes), ``hash`` (the wait for those kernels
    and the values' copy to the host) and ``check`` (the thresholds)."""
    dev = resolve(device)
    t0 = time.perf_counter()
    p = params or ProofParams()
    if seed is None:
        seed = os.urandom(32)
    results = [True] * len(items)

    # 1) structural + pow checks (host, cheap)
    flat_idx: list[int] = []
    flat_owner: list[int] = []
    for i, it in enumerate(items):
        pr = it.proof
        if (len(pr.indices) < p.k2
                or len(set(pr.indices)) != len(pr.indices)
                or any(not (0 <= j < it.total_labels) for j in pr.indices)
                or not k2pow.verify(it.challenge, it.node_id,
                                    p.pow_difficulty, pr.pow_nonce)):
            results[i] = False
            continue
        for j in _k3_subset(it, p.k3, seed):
            flat_idx.append(j)
            flat_owner.append(i)
    if not flat_idx:
        _lap(timing, "prep", t0)
        return results

    # 2) one label recompute with the proving hash per scrypt N (usually 1)
    owners = np.array(flat_owner)
    idx = np.array(flat_idx, dtype=np.uint64)
    commits = np.stack([scrypt.commitment_to_words(items[o].commitment)
                        for o in flat_owner]).T  # (8, B) BE words
    chals = np.stack([proving.challenge_words(items[o].challenge)
                      for o in flat_owner]).T  # (8, B)
    nonces = np.array([items[o].proof.nonce for o in flat_owner],
                      dtype=np.uint32)
    values = np.empty(len(idx), dtype=np.uint32)
    t0 = _lap(timing, "prep", t0)
    for n in sorted({items[o].scrypt_n for o in flat_owner}):
        sel = np.array([items[o].scrypt_n == n for o in flat_owner])
        lo_h, hi_h = scrypt.split_indices(idx[sel])
        # the shared mesh routing: the recompute is a label batch like any
        # other, so it stripes like one
        devs, d = autotune.resolve_auto_mesh(n, int(sel.sum()),
                                             platform=dev.type)
        if devs is not None and len(devs) > 1:
            from ..parallel import mesh as pmesh

            mesh = pmesh.data_mesh(devs)
            parts = pmesh.host_copies(mesh, pmesh.scrypt_labels_hash_sharded(
                mesh, commits[:, sel], lo_h, hi_h, chals[:, sel],
                nonces[sel], n=n, chunk=d.chunk))
            t0 = _lap(timing, "labels", t0)
            values[sel] = np.concatenate(
                [u32.to_numpy(hc.get()) for hc in parts if hc is not None])
            t0 = _lap(timing, "hash", t0)
            continue
        vals, _ = scrypt.scrypt_labels_hash(
            u32.from_numpy(commits[:, sel], dev), u32.from_numpy(lo_h, dev),
            u32.from_numpy(hi_h, dev), u32.from_numpy(chals[:, sel], dev),
            u32.from_numpy(nonces[sel], dev), n=n, chunk=d.chunk)
        t0 = _lap(timing, "labels", t0)
        values[sel] = u32.to_numpy(vals)
        t0 = _lap(timing, "hash", t0)

    # 3) threshold check per item
    thr = np.array([proving.threshold_u32(p.k1, items[o].total_labels)
                    for o in flat_owner], dtype=np.uint64)
    for o in set(owners[values >= thr].tolist()):
        results[o] = False
    _lap(timing, "check", t0)
    return results


def _lap(timing: dict | None, stage: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``timing[stage]``; the time now."""
    now = time.perf_counter()
    if timing is not None:
        timing[stage] = timing.get(stage, 0.0) + (now - t0)
    return now


def verify(item: VerifyItem, params: ProofParams | None = None,
           seed: bytes | None = None, device="cuda") -> bool:
    return verify_many([item], params, seed, device=device)[0]
