#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PoST main path on one NVIDIA H100.

Run from the repository root with no arguments on a machine with one
card: ``python3 chip_smoke.py``. It imports nothing of JAX or of the JAX
package. Phases, each printed as it runs:

1. device: the card's name and power limit; build the three CUDA sources
   from ``spacemesh_tpu_torch/csrc`` (one nvcc each, started together) and
   print each kernel's registers and spills;
2. ROMix: the kernel against its plain PyTorch version on the card (N=1024
   at a ragged batch, and N=8192 at the init batch of 32768 lanes), whole
   and fill phase only (``mix_phase=False``), and full labels against
   ``hashlib.scrypt``; exact equality; the fill/mix time split;
3. PBKDF2: both entry points of the envelope kernel against their plain
   versions at the init batch (32768 lanes, one shared commitment) and at
   a ragged batch of per-lane commitments (the verifier's form); exact
   equality; timed;
4. proving scan: the kernel against its plain version, and one prove step
   through the kernel against the plain step, on random device-resident
   labels with 16 nonces, at the main path's prove batch (2^18 lanes, all
   valid) and at 2^24 lanes with a ragged ``valid``; exact equality; the
   kernel and its plain version timed at both shapes;
5. end to end at mainnet parameters (N=8192, k1=26, k2=37, k3=37, the
   default k2pow difficulty): ``initialize()`` 2^20 labels in batches of
   32768 lanes, ``Prover.prove()`` pipelined and ``prove_serial()``,
   ``verify_many()`` on the proof and on a tampered copy, each held
   against hashlib and the plain CPU path; the kernels' launch counts are
   zeroed just before and read just after; the torch calls one init batch
   makes around the kernels, counted on the card; the first init batch's
   dispatch time apart from the others', beside one bare allocation of
   its 32 GiB V scratch;
6. a JSON line of per-kernel launches, times and bounds, each time taken
   at the shape the main path launches the kernel at (the scan's 2^24
   times beside it under ``full_width``).

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without it. Labels per unit are cut from mainnet's 2^32 to 2^20
for the time limit; N, the label width and k1/k2/k3 are not cut.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import tempfile
import time

from spacemesh_tpu_torch.tools.measure import (HBM_BYTES_PER_S, bound,
                                               cuda_ms, int_ops_per_s, smi)

N_MAIN = 8192
INIT_BATCH = 1 << 15
UNIT_LABELS = 1 << 20
PROVE_BATCH = 1 << 18
SCAN_LANES = 1 << 24
SCAN_NONCES = 16
RAGGED_LANES = 1037


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over u32 values held as int32 bit patterns."""
    import torch

    mask = 0xFFFFFFFF
    da = a.to(torch.int64) & mask
    db = b.to(torch.int64) & mask
    return int((da - db).abs().max().item()) if a.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device(ctx: dict) -> None:
    import torch
    from spacemesh_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    ctx["smi"] = smi("name,power.limit")
    log(ctx["smi"])
    ctx["int_ops_per_s"], sms, max_mhz = int_ops_per_s()
    log(f"[device] {sms} SMs, max SM clock {max_mhz:.0f} MHz -> integer "
        f"instruction peak {ctx['int_ops_per_s'] / 1e12:.2f} Top/s")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {', '.join(_build.library_path(n).name for n in logs)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"[build] {name}: {line.strip()}")


def phase_romix(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import romix_cuda, scrypt, u32

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    x = u32.from_numpy(rng.integers(0, 2**32, (32, 300), dtype=np.uint32),
                       dev)
    got = romix_cuda.romix(x, 1024)
    want = romix_cuda.romix_r1(x, 1024)
    err = max_abs_err(got, want)
    require(err == 0, "ROMix kernel == plain at N=1024, 300 lanes")
    got = romix_cuda.romix(x, 1024, mix_phase=False)
    want = romix_cuda.romix_r1(x, 1024, mix_phase=False)
    fill_err = max_abs_err(got, want)
    require(fill_err == 0, "ROMix fill-only kernel == plain at N=1024")
    log(f"[romix] N=1024 B=300 kernel == plain (max_abs_err {err}), "
        f"fill only too (max_abs_err {fill_err})")

    commits = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    idx = rng.integers(0, 2**63, 32, dtype=np.uint64)
    labels = scrypt.scrypt_labels_multi(commits, idx, n=N_MAIN, device=dev)
    for i in range(32):
        want_b = hashlib.scrypt(bytes(commits[i]),
                                salt=int(idx[i]).to_bytes(8, "little"),
                                n=N_MAIN, r=1, p=1, dklen=16)
        require(bytes(labels[i]) == want_b, f"label {i} == hashlib.scrypt")
    log(f"[romix] N={N_MAIN}: 32 random (commitment, index) labels == "
        "hashlib.scrypt")

    # the init batch's shape: kernel vs plain, then their times
    x = u32.from_numpy(rng.integers(0, 2**32, (32, INIT_BATCH),
                                    dtype=np.uint32), dev)
    got = romix_cuda.romix(x, N_MAIN)
    ms = cuda_ms(lambda: romix_cuda.romix(x, N_MAIN), reps=3)
    fill = romix_cuda.romix(x, N_MAIN, mix_phase=False)
    fill_ms = cuda_ms(lambda: romix_cuda.romix(x, N_MAIN, mix_phase=False),
                      reps=3)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = romix_cuda.romix_r1(x, N_MAIN)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, want)
    require(err == 0, f"ROMix kernel == plain at N={N_MAIN}, "
                      f"{INIT_BATCH} lanes")
    del want
    torch.cuda.empty_cache()
    want = romix_cuda.romix_r1(x, N_MAIN, mix_phase=False)
    torch.cuda.synchronize()
    fill_err = max_abs_err(fill, want)
    require(fill_err == 0, f"ROMix fill-only kernel == plain at "
                           f"N={N_MAIN}, {INIT_BATCH} lanes")
    del want
    torch.cuda.empty_cache()
    ops = romix_cuda.int_ops(INIT_BATCH, N_MAIN)
    nbytes = romix_cuda.io_bytes(INIT_BATCH)
    scratch_ms = (romix_cuda.scratch_bytes(INIT_BATCH, N_MAIN)
                  / HBM_BYTES_PER_S * 1e3)
    ctx["romix"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=max(err, fill_err),
        shape=f"(32, {INIT_BATCH}) N={N_MAIN}", fill_ms=fill_ms,
        scratch_bound_ms=scratch_ms,
        **bound(ops, nbytes, ctx["int_ops_per_s"]))
    log(f"[romix] N={N_MAIN} B={INIT_BATCH} kernel == plain, whole and "
        f"fill only; kernel {ms:.2f} ms ({INIT_BATCH / ms * 1e3:.0f} "
        f"labels/s), plain {plain_ms:.0f} ms, bound "
        f"{ctx['romix']['bound_ms']:.2f} ms ({ctx['romix']['bound_by']}), "
        f"V scratch traffic floor {scratch_ms:.2f} ms")
    log(f"[romix] fill/mix split: fill {fill_ms:.2f} ms, mix "
        f"{ms - fill_ms:.2f} ms")


def pbkdf2_case(ctx: dict, b: int, per_lane: bool, seed: int) -> dict:
    """Both PBKDF2 entry points against their plain versions on ``b``
    random (commitment, index) lanes on the card, then both timed."""
    import numpy as np
    from spacemesh_tpu_torch.ops import pbkdf2_cuda, u32

    rng = np.random.default_rng(seed)
    dev = "cuda"
    cw = u32.from_numpy(rng.integers(0, 2**32, (8, b) if per_lane else (8,),
                                     dtype=np.uint32), dev)
    lo, hi = (u32.from_numpy(rng.integers(0, 2**32, b, dtype=np.uint32), dev)
              for _ in range(2))
    blk = pbkdf2_cuda.expand(cw, lo, hi)
    inner, outer, want = pbkdf2_cuda._expand(cw, lo, hi)
    out = {"expand": max_abs_err(blk, want)}
    b_le = u32.from_numpy(rng.integers(0, 2**32, (32, b), dtype=np.uint32),
                          dev)
    words = pbkdf2_cuda.finish(cw, b_le)
    out["finish"] = max_abs_err(
        words, pbkdf2_cuda._pbkdf2_second(inner, outer, b_le)[:4])
    form = "per-lane" if per_lane else "shared"
    for entry in ("expand", "finish"):
        require(out[entry] == 0, f"PBKDF2 {entry} kernel == plain at B={b} "
                                 f"({form} commitments)")
    calls = {"expand": (lambda: pbkdf2_cuda.expand(cw, lo, hi),
                        lambda: pbkdf2_cuda._expand(cw, lo, hi)),
             "finish": (lambda: pbkdf2_cuda.finish(cw, b_le),
                        lambda: pbkdf2_cuda._pbkdf2_second(
                            *pbkdf2_cuda._midstates(cw), b_le))}
    res = {}
    for entry, (kernel, plain) in calls.items():
        res[entry] = dict(
            ms=cuda_ms(kernel, reps=50), plain_ms=cuda_ms(plain, reps=2),
            max_abs_err=out[entry], shape=f"B={b} {form} commitment",
            **bound(pbkdf2_cuda.int_ops(b, entry, per_lane),
                    pbkdf2_cuda.io_bytes(b, entry, per_lane),
                    ctx["int_ops_per_s"]))
        log(f"[pbkdf2] {entry} B={b} ({form} commitments): kernel == plain; "
            f"kernel {res[entry]['ms']:.4f} ms, plain "
            f"{res[entry]['plain_ms']:.1f} ms, bound "
            f"{res[entry]['bound_ms']:.4f} ms ({res[entry]['bound_by']})")
    return res


def phase_pbkdf2(ctx: dict) -> None:
    # the init batch's shape (one commitment for every lane), then a ragged
    # batch of per-lane commitments as the verifier sends
    main = pbkdf2_case(ctx, INIT_BATCH, per_lane=False, seed=6)
    ragged = pbkdf2_case(ctx, RAGGED_LANES, per_lane=True, seed=7)
    for entry in ("expand", "finish"):
        ctx[f"pbkdf2_{entry}"] = dict(
            main[entry], ragged={k: ragged[entry][k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")})


def scan_case(b: int, valid: int, start: int, thr: int, seed: int,
              plain_reps: int) -> dict:
    """The scan kernel against its plain version, and one prove step through
    the kernel against the plain step, on ``b`` random device-resident
    labels at global indices ``start``.. with ``SCAN_NONCES`` nonces; then
    both timed on the same inputs."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import proving, proving_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ng = SCAN_NONCES
    lw = torch.randint(-2**31, 2**31, (4, b), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int32)
    idx = torch.arange(start, start + b, device=dev, dtype=torch.int64)
    # u32 halves as int32 bit patterns: shift [2^31, 2^32) down by 2^32
    lo = (((idx & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    hi = (idx >> 32).to(torch.int32)
    cw = np.frombuffer(hashlib.sha256(b"chip-smoke-scan").digest(),
                       dtype="<u4").astype(np.uint32)
    mask, seg = proving_cuda.scan(cw, 7, lo, hi, lw, thr, valid,
                                  n_nonces=ng)
    pmask, pseg = proving_cuda.scan_plain(cw, 7, lo, hi, lw, thr, valid,
                                          n_nonces=ng)
    require(torch.equal(mask, pmask), f"scan mask == plain at B={b}")
    require(torch.equal(seg, pseg), f"scan segment counts == plain at B={b}")
    hits = int(seg.sum().item())
    require(hits > 0, f"scan found hits at B={b}")

    counts, carry = proving.init_hit_state(ng, 37, dev)
    got = proving.prove_scan_step(cw, 7, lo, hi, lw, thr, counts, carry,
                                  valid, start & 0xFFFFFFFF, start >> 32,
                                  n_nonces=ng, max_hits=37)
    c, p, ok = proving.compact_hits(pmask.bool(), pseg, max_hits=37)
    want = proving.merge_hits(counts, carry, c, p, ok, start & 0xFFFFFFFF,
                              start >> 32)
    for g, w in zip(got, want):
        require(torch.equal(g, w), f"prove step via kernel == plain at B={b}")

    ms = cuda_ms(lambda: proving_cuda.scan(cw, 7, lo, hi, lw, thr, valid,
                                           n_nonces=ng), reps=10)
    plain_ms = cuda_ms(lambda: proving_cuda.scan_plain(
        cw, 7, lo, hi, lw, thr, valid, n_nonces=ng), reps=plain_reps)
    return dict(ms=ms, plain_ms=plain_ms, hits=hits,
                max_abs_err=max_abs_err(mask, pmask),
                ops=proving_cuda.int_ops(b, ng),
                nbytes=proving_cuda.io_bytes(b, ng))


def phase_scan(ctx: dict) -> None:
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import prover

    # the main path's shape: every prove batch is PROVE_BATCH lanes, full,
    # at the mainnet k1 threshold over the unit
    k1 = prover.ProofParams().k1
    m = scan_case(PROVE_BATCH, PROVE_BATCH, PROVE_BATCH,
                  proving.threshold_u32(k1, UNIT_LABELS), seed=4,
                  plain_reps=3)
    # full width: 2^24 lanes, a ragged valid, a window crossing idx_hi = 1
    f = scan_case(SCAN_LANES, SCAN_LANES - 1000, (1 << 32) - (1 << 20),
                  proving.threshold_u32(4096, SCAN_LANES), seed=2,
                  plain_reps=2)
    for key, b, c in (("scan", PROVE_BATCH, m),
                      ("scan_full", SCAN_LANES, f)):
        ctx[key] = dict(ms=c["ms"], plain_ms=c["plain_ms"],
                        max_abs_err=c["max_abs_err"],
                        shape=f"B={b} nonces={SCAN_NONCES}",
                        **bound(c["ops"], c["nbytes"], ctx["int_ops_per_s"]))
        rate = b * SCAN_NONCES / c["ms"] / 1e6
        log(f"[scan] B={b} nonces={SCAN_NONCES}: kernel == plain (mask, "
            f"segments; {c['hits']} hits), prove step via kernel == plain "
            f"step; kernel {c['ms']:.4f} ms ({rate:.2f} G label-nonces/s), "
            f"plain {c['plain_ms']:.1f} ms, bound "
            f"{ctx[key]['bound_ms']:.4f} ms")


def phase_main_path(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import (pbkdf2_cuda, proving, proving_cuda,
                                         romix_cuda)
    from spacemesh_tpu_torch.post import initializer, prover, verifier
    from spacemesh_tpu_torch.post.data import LabelStore

    node = hashlib.sha256(b"chip-smoke-node").digest()
    commitment = hashlib.sha256(b"chip-smoke-commitment").digest()
    challenge = hashlib.sha256(b"chip-smoke-challenge").digest()
    params = prover.ProofParams()  # mainnet k1/k2/k3, default k2pow
    alloc_ms = v_alloc_ms()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as d:
        romix_cuda.launches = 0
        proving_cuda.launches = 0
        pbkdf2_cuda.expand_launches = 0
        pbkdf2_cuda.finish_launches = 0
        t0 = time.perf_counter()
        meta, res = initializer.initialize(
            d, node_id=node, commitment=commitment, num_units=1,
            labels_per_unit=UNIT_LABELS, scrypt_n=N_MAIN,
            batch_size=INIT_BATCH, device="cuda")
        init_s = time.perf_counter() - t0
        pv = prover.Prover(d, params, batch_labels=PROVE_BATCH,
                           device="cuda")
        t0 = time.perf_counter()
        proof = pv.prove(challenge)
        prove_s = time.perf_counter() - t0
        swept = pv.last_stats.labels_swept
        t0 = time.perf_counter()
        serial = pv.prove_serial(challenge)
        serial_s = time.perf_counter() - t0
        bad = dataclasses.replace(proof, indices=list(proof.indices))
        total = meta.total_labels
        thr = proving.threshold_u32(params.k1, total)
        item = verifier.VerifyItem(proof=proof, challenge=challenge,
                                   node_id=node, commitment=commitment,
                                   scrypt_n=N_MAIN, total_labels=total)
        bad.indices[0] = replacement_index(proof, commitment, challenge,
                                           thr, total)
        bad_item = verifier.VerifyItem(proof=bad, challenge=challenge,
                                       node_id=node, commitment=commitment,
                                       scrypt_n=N_MAIN, total_labels=total)
        t0 = time.perf_counter()
        verdicts = verifier.verify_many([item, bad_item], params,
                                        device="cuda")
        verify_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        ctx["launches"] = {"romix": romix_cuda.launches,
                           "scan": proving_cuda.launches,
                           "pbkdf2_expand": pbkdf2_cuda.expand_launches,
                           "pbkdf2_finish": pbkdf2_cuda.finish_launches}

        require(meta.labels_written == UNIT_LABELS, "init wrote every label")
        st = res.stats
        log(f"[init] {UNIT_LABELS} labels N={N_MAIN} batch={INIT_BATCH}: "
            f"{init_s:.2f} s, {res.labels_per_s:.0f} labels/s; stats "
            f"{json.dumps(st.as_dict())}")
        shares = {k: getattr(st, k) / res.elapsed_s for k in (
            "dispatch_s", "fetch_s", "write_stall_s", "save_s")}
        log(f"[init] share of the init time: " + ", ".join(
            f"{k} {v:.1%}" for k, v in shares.items()))
        calls = envelope_calls()
        rest = st.dispatch_s - st.first_dispatch_s
        log(f"[init] envelope: {calls} torch calls per batch around the "
            f"kernels (counted on the card); dispatch of the first batch "
            f"{st.first_dispatch_s * 1e3:.2f} ms (one bare allocation of "
            f"its V scratch: {alloc_ms:.2f} ms), of each later batch "
            f"{rest / max(st.batches - 1, 1) * 1e3:.2f} ms on average")
        store = LabelStore(d, meta)
        try:
            stored = np.frombuffer(store.read_labels(0, UNIT_LABELS),
                                   dtype=np.uint8).reshape(-1, 16)
        finally:
            store.close()
        rng = np.random.default_rng(3)
        for i in sorted(rng.choice(UNIT_LABELS, 16, replace=False).tolist()):
            want = hashlib.scrypt(commitment, salt=i.to_bytes(8, "little"),
                                  n=N_MAIN, r=1, p=1, dklen=16)
            require(bytes(stored[i]) == want, f"stored label {i} == hashlib")
        lo = stored[:, :8].copy().view("<u8").ravel()
        hi = stored[:, 8:].copy().view("<u8").ravel()
        vrf = int(np.lexsort((lo, hi))[0])
        require(meta.vrf_nonce == vrf, "VRF nonce is the stored minimum")
        require(bytes.fromhex(meta.vrf_nonce_value) == bytes(stored[vrf]),
                "VRF nonce value is its label")
        log(f"[init] 16 sampled stored labels == hashlib.scrypt; VRF nonce "
            f"{vrf} is the minimum of the store")

        require(proof == serial, "pipelined proof == serial proof")
        log(f"[prove] nonce {proof.nonce}, pow_nonce {proof.pow_nonce}: "
            f"pipelined {prove_s:.2f} s ({swept} labels swept, "
            f"{swept / prove_s:.0f} labels/s), serial {serial_s:.2f} s, "
            "identical proofs")

        require(verdicts == [True, False],
                f"verify_many verdicts {verdicts} == [True, False]")
        labels = np.stack([np.frombuffer(hashlib.scrypt(
            commitment, salt=i.to_bytes(8, "little"), n=N_MAIN, r=1, p=1,
            dklen=16), dtype=np.uint8) for i in proof.indices])
        vals = proving.proving_hashes(challenge, proof.nonce, proof.indices,
                                      labels, device="cpu")
        require(bool((vals < thr).all()), "hashlib + plain CPU path accept")
        log(f"[verify] verify_many -> {verdicts} in {verify_s:.2f} s; "
            "hashlib labels + plain CPU hashes agree")
    for key, n in ctx["launches"].items():
        require(n > 0, f"main path launched {key}")
    log(f"[launches] main path: {json.dumps(ctx['launches'])}")


def v_alloc_ms() -> float:
    """Host milliseconds of one allocation of an init batch's ROMix V
    scratch with the allocator's cache emptied first, as the main path's
    first batch finds it; the cache is emptied again after."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v = torch.empty((INIT_BATCH, N_MAIN, 32), dtype=torch.int32,
                    device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del v
    torch.cuda.empty_cache()
    return ms


def envelope_calls() -> int:
    """Torch calls one init batch makes around the kernels on the card:
    the wrappers of PBKDF2 expand, ROMix and PBKDF2 finish, and the VRF
    min-scan (the count does not depend on the batch size or N)."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import scrypt, u32

    class Count(torch.overrides.TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    dev = "cuda"
    cw = u32.from_numpy(scrypt.commitment_to_words(bytes(32)), dev)
    lo = u32.from_numpy(np.arange(64, dtype=np.uint32), dev)
    hi = torch.zeros(64, dtype=torch.int32, device=dev)
    carry = u32.from_numpy(scrypt.vrf_carry_init(), dev)
    with Count():
        scrypt.scrypt_labels_with_min(cw, lo, hi, carry, n=16)
    torch.cuda.synchronize()
    return Count.calls


def replacement_index(proof, commitment, challenge, thr, total) -> int:
    """An index outside the proof whose proving hash misses the threshold
    (hashlib label, plain CPU hash), so the tampered proof must fail."""
    import numpy as np
    from spacemesh_tpu_torch.ops import proving

    cand = (proof.indices[0] + 1) % total
    while True:
        if cand not in proof.indices:
            label = np.frombuffer(hashlib.scrypt(
                commitment, salt=cand.to_bytes(8, "little"), n=N_MAIN, r=1,
                p=1, dklen=16), dtype=np.uint8)[None]
            val = proving.proving_hashes(challenge, proof.nonce, [cand],
                                         label, device="cpu")[0]
            if val >= thr:
                return cand
        cand = (cand + 1) % total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    ctx: dict = {}
    t0 = time.perf_counter()
    phase_device(ctx)
    phase_romix(ctx)
    phase_pbkdf2(ctx)
    phase_scan(ctx)
    phase_main_path(ctx)
    extra = {"romix": {k: ctx["romix"][k] for k in ("fill_ms",
                                                     "scratch_bound_ms")},
             "scan": {"full_width": {k: ctx["scan_full"][k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by")}},
             "pbkdf2_expand": {"ragged": ctx["pbkdf2_expand"]["ragged"]},
             "pbkdf2_finish": {"ragged": ctx["pbkdf2_finish"]["ragged"]}}
    envelope = ("spacemesh_tpu/ops/scrypt.py:440 (XLA-fused envelope, no "
                "Pallas kernel)")
    kernels = []
    for key, name, source, replaces in (
            ("romix", "romix_r1", "spacemesh_tpu_torch/csrc/romix.cu",
             "spacemesh_tpu/ops/romix_pallas.py:96"),
            ("scan", "proving_scan", "spacemesh_tpu_torch/csrc/proving_scan.cu",
             "spacemesh_tpu/ops/proving_pallas.py:65"),
            ("pbkdf2_expand", "pbkdf2_expand",
             "spacemesh_tpu_torch/csrc/pbkdf2.cu", envelope),
            ("pbkdf2_finish", "pbkdf2_finish",
             "spacemesh_tpu_torch/csrc/pbkdf2.cu", envelope)):
        m = ctx[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": ctx["launches"][key],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "shape": m["shape"], **extra[key]})
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(ctx["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
