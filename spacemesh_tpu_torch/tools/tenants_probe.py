"""Prove latency beside a packed init on the card, with a CUDA stream per
scheduler thread and with one shared stream; k2pow quanta against serial
searches.

    python3 -m spacemesh_tpu_torch.tools.tenants_probe

Needs one CUDA card and ``nvcc``. Makes 8 identities' stores of 2^16 labels
at N=8192 through the multi-tenant scheduler. Then, in turns own, shared,
shared, own, a ``TenantScheduler`` runs a packed init of 8 other
identities x 2^18 labels and, while it runs, 8 ``submit_prove`` on the
stores: "own" is the scheduler as it ships (its worker threads and its
packer each launch on a stream of their own), "shared" the same with every
thread on the default stream. Prints each turn's prove latencies (p50,
max) and the packed init's rate. Then 16 k2pow searches at the default
difficulty: in series on one thread, and as 16 ``submit_pow`` on 1 and on
2 workers. About 40 s of command time.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import statistics
import sys
import tempfile
import time

from .measure import smi

N = 8192
PROVERS = 8
LABELS = 1 << 16
LOAD_LABELS = 1 << 18


def _ids(salt: bytes, count: int) -> list:
    return [(f"{salt.decode()}{i}",
             hashlib.sha256(b"probe-node-%d" % i + salt).digest(),
             hashlib.sha256(b"probe-commit-%d" % i + salt).digest())
            for i in range(count)]


def _inits(sched, base: str, ids: list, labels: int) -> list:
    for tid, _, _ in ids:
        sched.register_tenant(tid)
    return [sched.submit_init(tid, os.path.join(base, tid), node_id=node,
                              commitment=commit, num_units=1,
                              labels_per_unit=labels, scrypt_n=N)
            for tid, node, commit in ids]


def _turn(shared: bool, base: str, provers: list, challenge: bytes,
          params) -> tuple[list, list, float]:
    """One packed init beside 8 proves; (proofs, prove latencies, init
    labels/s)."""
    from ..runtime import TenantScheduler

    sched = TenantScheduler(device="cuda", autostart=False)
    if shared:
        sched._stream = contextlib.nullcontext  # every thread: default stream
    sched.start()
    load_dir = os.path.join(base, "load")
    try:
        t0 = time.perf_counter()
        load = _inits(sched, load_dir, _ids(b"load", PROVERS), LOAD_LABELS)
        for tid, _, _ in provers:
            sched.register_tenant(tid)
        t1 = time.perf_counter()
        done = {}
        handles = [sched.submit_prove(tid, os.path.join(base, tid),
                                      challenge, params)
                   for tid, _, _ in provers]
        for i, h in enumerate(handles):
            h.future.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
        proofs = [h.result(timeout=600) for h in handles]
        for h in load:
            h.result(timeout=600)
        init_s = time.perf_counter() - t0
    finally:
        sched.close()
        shutil.rmtree(load_dir, ignore_errors=True)
    return proofs, [done[i] - t1 for i in range(len(handles))], \
        PROVERS * LOAD_LABELS / init_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tenants_probe: no CUDA card", file=sys.stderr)
        return 2
    from ..ops import pow as k2pow
    from ..post import prover
    from ..runtime import TenantScheduler

    print(smi("name,power.limit"), flush=True)
    params = prover.ProofParams()  # mainnet k1/k2/k3, default k2pow
    challenge = hashlib.sha256(b"probe-challenge").digest()
    provers = _ids(b"id", PROVERS)
    with tempfile.TemporaryDirectory(prefix="tenants-probe-") as base:
        with TenantScheduler(device="cuda") as sched:
            for h in _inits(sched, base, provers, LABELS):
                h.result(timeout=600)
        ref = None
        for shared in (False, True, True, False):
            proofs, lat, rate = _turn(shared, base, provers, challenge,
                                      params)
            if ref is None:
                ref = proofs
            if proofs != ref:
                raise RuntimeError("proofs differ between turns")
            print(f"[probe] {'shared stream' if shared else 'own streams'}: "
                  f"{PROVERS} proves beside a packed init of {PROVERS} x "
                  f"{LOAD_LABELS} labels: latency p50 "
                  f"{statistics.median(lat):.3f} s, max {max(lat):.3f} s; "
                  f"init {rate:.0f} labels/s", flush=True)
    pows = _ids(b"pow", 16)
    t0 = time.perf_counter()
    want = [k2pow.search(challenge, node, params.pow_difficulty,
                         device="cuda") for _, node, _ in pows]
    serial_s = time.perf_counter() - t0
    for workers in (1, 2):
        with TenantScheduler(device="cuda", workers=workers) as sched:
            for tid, _, _ in pows:
                sched.register_tenant(tid)
            t0 = time.perf_counter()
            got = [h.result(timeout=600) for h in [
                sched.submit_pow(tid, challenge, node, params.pow_difficulty)
                for tid, node, _ in pows]]
            sched_s = time.perf_counter() - t0
        if got != want:
            raise RuntimeError("submit_pow differs from ops.pow.search")
        print(f"[probe] 16 k2pow searches: {serial_s:.3f} s in series, "
              f"{sched_s:.3f} s as submit_pow on {workers} worker(s)",
              flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
