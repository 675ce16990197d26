"""Decides ``correct``: what the timed path produced, against the plain
reference (``benchmark/reference/``), at the timed sizes.

* Labels: a sample drawn from the seed of every identity's stored labels,
  each recomputed by ``hashlib.scrypt`` at the configuration's N.
* The VRF nonce (mixes with ``check_vrf_nonce``): each initializing
  identity's persisted nonce and its label against the smallest of every
  label its metadata says is written, read back from the store.
* Proofs: the k2pow nonce of every proof that returned must be the
  smallest valid one (``hashlib.sha256``). A sample drawn from the seed,
  with the slowest proof of the window in it, must carry the nonce and
  indices that the plain proving hash finds over the identity's stored
  labels. That step follows the program's store: the labels themselves
  are judged by the sample above.
* Answers that never came: a proof open in the window that failed or did
  not return within the drain, a proving identity with no proof returned
  inside the window, an init that failed, a window that retired no label.

Every number is a count of wrong or missing answers, an exact comparison,
so every limit is 0.
"""

from __future__ import annotations

import numpy as np

from .drive import Run, derive
from .reference import k2pow, labels, proving, store, vrf


def _picks(rng, written: int, k: int) -> list[int]:
    if written <= k:
        return list(range(written))
    return sorted(set(int(i) for i in rng.integers(0, written, size=k)))


def _proof_sample(rng, run: Run, k: int) -> list:
    """Up to ``k`` returned proofs drawn from the seed, and the slowest
    one of the window."""
    returned = [r for r in run.proofs if r.proof is not None]
    picks = [returned[int(i)] for i in rng.permutation(len(returned))[:k]]
    due = [r for r in run.due_proofs() if r.proof is not None]
    if due:
        slowest = max(due, key=lambda r: r.done - r.submit)
        if slowest not in picks:
            picks.append(slowest)
    return picks


def _vrf_mismatch(ident, mfs: int) -> int:
    meta = store.read_metadata(ident.dir)
    if meta is None or not meta.get("labels_written"):
        return 1
    want = vrf.smallest(store.read_range(ident.dir, meta["labels_written"],
                                         mfs))
    value = meta.get("vrf_nonce_value")
    got = (meta.get("vrf_nonce"),
           bytes.fromhex(value) if value is not None else None)
    return int(got != want)


def check(run: Run, config: dict, seed: int, device) -> dict:
    """-> {name: (value, limit)}; the run is correct when every value is
    at most its limit. ``config`` is the configuration as stated, which
    the reference follows whatever the program ran with."""
    n = config["scrypt_n"]
    mfs = config["max_file_size"]
    traffic = run.traffic
    rng = np.random.default_rng(
        int.from_bytes(derive(seed, "sample")[:8], "little"))
    bad_labels = sampled = 0
    for ident in run.identities:
        k = traffic.get("sample_labels" if ident.role == "init"
                        else "sample_prove_store_labels", 64)
        picks = _picks(rng, run.written.get(ident.tid, 0), k)
        got = store.read_labels(ident.dir, picks, mfs)
        want = labels.labels(ident.commitment, picks, n)
        bad_labels += sum(g != w for g, w in zip(got, want))
        sampled += len(picks)

    inits = [i for i in run.identities if i.role == "init"]
    bad_vrf = (sum(_vrf_mismatch(i, mfs) for i in inits)
               if traffic.get("check_vrf_nonce") else 0)

    by_tid = {i.tid: i for i in run.identities}
    difficulty = bytes.fromhex(config["pow_difficulty"])
    bad_pow = 0
    for rec in run.proofs:
        if rec.proof is not None and rec.proof.pow_nonce != k2pow.smallest(
                rec.challenge, by_tid[rec.tid].node_id, difficulty):
            bad_pow += 1
    stored: dict[str, np.ndarray] = {}
    bad_proofs = 0
    for rec in _proof_sample(rng, run, traffic.get("sample_proofs", 24)):
        ident = by_tid[rec.tid]
        if rec.tid not in stored:
            stored[rec.tid] = store.read_range(ident.dir, ident.total, mfs)
        want = proving.prove(rec.challenge, stored[rec.tid], config["k1"],
                             config["k2"], device=device)
        p = rec.proof
        if want is None or p.k2 != config["k2"] \
                or (p.nonce, list(p.indices)) != want:
            bad_proofs += 1
    missing = sum(1 for r in run.due_proofs() if r.proof is None)
    starved = sum(1 for c in run.window_completions().values() if c == 0)
    return {
        "label_mismatch": (bad_labels, 0),
        "labels_unchecked": (int(sampled == 0), 0),
        "vrf_mismatch": (bad_vrf, 0),
        "proof_mismatch": (bad_proofs, 0),
        "pow_mismatch": (bad_pow, 0),
        "proof_missing": (missing, 0),
        "identity_without_proofs": (starved, 0),
        "init_failed": (len(run.init_errors), 0),
        "window_without_labels": (int(bool(inits)
                                      and run.window_labels() == 0), 0),
    }
