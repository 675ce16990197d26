"""Operator benchmark / tuning tool on the card (port of
``spacemesh_tpu/tools/profiler.py``).

The reference exposes provider enumeration + benchmarking so an operator
can pick the POST compute device and batch size before committing to a
multi-day init (reference activation/post_supervisor.go:105-127
Providers()/Benchmark(); post-rs ships a standalone `profiler` binary).
The port's views:

- ``providers`` — the card (``cuda:<index>``: its name and the cards
  visible) or, with ``--device cpu``, the host's plain PyTorch twins
  (``cpu:torch``), plus the OpenSSL scrypt paths (single-core and
  all-cores), which are the reference CPU provider's exact labeling
  function;
- ``benchmark`` — labels/second per provider across batch sizes, with a
  recommendation (provider + batch) an operator can paste into the
  smeshing config. A card batch is the three kernel launches of
  ``ops/scrypt.py:scrypt_labels_words`` (PBKDF2 expand -> ROMix -> PBKDF2
  finish), each timed call ended by a device synchronize.

Usage:
  python -m spacemesh_tpu_torch.tools.profiler --providers
  python -m spacemesh_tpu_torch.tools.profiler --n 8192 --batches 8192,32768
  python -m spacemesh_tpu_torch.tools.profiler --pipeline --n 8192   # per-stage
  python -m spacemesh_tpu_torch.tools.profiler --prove               # prove view
  python -m spacemesh_tpu_torch.tools.profiler --verify-farm         # farm view
  python -m spacemesh_tpu_torch.tools.profiler --romix --n 8192      # kernel view
  python -m spacemesh_tpu_torch.tools.profiler --warm                # warmcache
  python -m spacemesh_tpu_torch.tools.profiler --timeline trace.json # flame view
Prints ONE JSON document on stdout (the JAX package's keys); progress goes
to stderr. Every view but ``--timeline`` and ``--flight`` runs on
``--device`` (default ``cuda``); without a card and without ``--device
cpu`` the tool exits 2. ``--no-probe`` is accepted and does nothing (the
port has no accelerator probe). --pipeline runs a real (tiny) init through
the streaming pipeline and dumps per-stage host seconds
(dispatch/fetch/write/stall) so stalls are visible without a full profile.
--timeline digests a span-trace export (``/debug/trace/export`` or
utils/tracing.export_json): top spans by self-time plus a per-stage
queue-wait vs work split, with the text flame summary on stderr.
--warm runs ``tools/warmcache.py`` (``--warm-batches``, ``--warm-prove``):
the kernel builds and the persisted autotune winners. ``--romix``'s
``impls`` starts with the stage-timed row of the kernel as the port runs
it, followed by the autotuner's raced rows for this N (labels/s, and
``winner`` on the row the decision took): the place the JAX package gives
``--romix-pallas``, since the port's variants are the raced lane chunks
and device counts of one kernel.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import sys
import time

# label lanes of the --romix view by default: the JAX package's ROMix
# autotune calibration batch (spacemesh_tpu/ops/autotune.py CAL_BATCH)
CAL_BATCH = 512


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _timed(dev, fn):
    """Seconds of one call of ``fn``, the device's queue drained before and
    after, so a card's time is its work's and not the enqueue's."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def providers(device="cuda") -> list[dict]:
    """Enumerate label-compute providers (post_supervisor.go:105
    Providers()): the device's row, then the two OpenSSL rows."""
    import torch

    from ..device import resolve

    dev = resolve(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        out = [{
            "id": f"cuda:{index}",
            "kind": torch.cuda.get_device_name(index),
            "platform": "gpu",
            "devices": torch.cuda.device_count(),
            "impl": "cuda-scrypt",
        }]
    else:
        out = [{"id": "cpu:torch", "kind": "plain PyTorch twins",
                "platform": "cpu", "devices": 1, "impl": "torch-plain"}]
    out.append({"id": "cpu:openssl", "kind": "single core",
                "platform": "cpu", "impl": "hashlib.scrypt"})
    out.append({"id": "cpu:openssl-mt",
                "kind": f"{os.cpu_count()} threads",
                "platform": "cpu", "impl": "hashlib.scrypt"})
    return out


def _cpu_rate(commitment: bytes, n: int, count: int,
              threads: int = 1) -> float:
    def burst(start: int, m: int) -> None:
        for i in range(start, start + m):
            hashlib.scrypt(commitment, salt=i.to_bytes(8, "little"),
                           n=n, r=1, p=1, maxmem=256 * 1024 * 1024,
                           dklen=16)

    t0 = time.perf_counter()
    if threads <= 1:
        burst(0, count)
    else:
        per = max(count // threads, 1)
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            # hashlib.scrypt releases the GIL: real parallelism
            futs = [pool.submit(burst, k * per, per)
                    for k in range(threads)]
            for f in futs:
                f.result()
        count = per * threads
    return count / (time.perf_counter() - t0)


def _torch_rate(commitment: bytes, n: int, batch: int, reps: int,
                dev) -> float:
    import numpy as np

    from ..ops import scrypt, u32

    cw = u32.from_numpy(scrypt.commitment_to_words(commitment), dev)
    lo_, hi_ = scrypt.split_indices(np.arange(batch, dtype=np.uint64))
    lo, hi = u32.from_numpy(lo_, dev), u32.from_numpy(hi_, dev)

    def labels():
        scrypt.scrypt_labels_words(cw, lo, hi, n=n)

    first = _timed(dev, labels)
    _log(f"  batch={batch}: build+first {first:.1f}s")
    rate = 0.0
    for _ in range(reps):
        rate = max(rate, batch / _timed(dev, labels))
    return rate


def benchmark(n: int, batches: list[int], reps: int,
              cpu_labels: int, device="cuda") -> dict:
    """Per-provider labels/s + a tuning recommendation
    (post_supervisor.go:117 Benchmark())."""
    from ..device import resolve

    dev = resolve(device)
    commitment = hashlib.sha256(b"profiler-commitment").digest()
    provs = providers(dev)
    results = []
    for p in provs:
        if p["id"] == provs[0]["id"]:
            best, best_batch = 0.0, 0
            for batch in batches:
                try:
                    rate = _torch_rate(commitment, n, batch, reps, dev)
                except Exception as e:  # noqa: BLE001 — e.g. HBM OOM
                    _log(f"  batch={batch}: failed "
                         f"({type(e).__name__}: {e})")
                    continue
                _log(f"{p['id']} batch={batch}: {rate:,.0f} labels/s")
                if rate > best:
                    best, best_batch = rate, batch
            results.append({**p, "labels_per_sec": round(best, 1),
                            "best_batch": best_batch})
        else:
            threads = os.cpu_count() if p["id"].endswith("-mt") else 1
            rate = _cpu_rate(commitment, n, cpu_labels, threads)
            _log(f"{p['id']}: {rate:,.1f} labels/s")
            results.append({**p, "labels_per_sec": round(rate, 1),
                            "best_batch": None})
    results.sort(key=lambda r: -r["labels_per_sec"])
    winner = results[0]
    recommendation = {
        "provider": winner["id"],
        "labels_per_sec": winner["labels_per_sec"],
    }
    if winner["best_batch"]:
        recommendation["init_batch"] = winner["best_batch"]
    su = 1 << 32  # labels per space unit (mainnet.go:186)
    if winner["labels_per_sec"] > 0:
        recommendation["hours_per_space_unit"] = round(
            su / winner["labels_per_sec"] / 3600, 1)
    return {"scrypt_n": n, "providers": results,
            "recommendation": recommendation}


def pipeline_benchmark(n: int, labels: int, batch: int,
                       inflight: int | None = None,
                       writers: int | None = None,
                       device="cuda") -> dict:
    """Per-stage timings of the streaming init pipeline (dispatch/fetch/
    write/stall), so an operator can see where a slow init spends its time
    without a full profile. Runs a real (tiny) init through
    post/initializer.py on ``device`` and dumps its PipelineStats."""
    import tempfile

    from ..post import initializer

    node = hashlib.sha256(b"profiler-pipe-node").digest()
    commit = hashlib.sha256(b"profiler-pipe-commit").digest()
    with tempfile.TemporaryDirectory() as d:
        _, res = initializer.initialize(
            d, node_id=node, commitment=commit, num_units=1,
            labels_per_unit=labels, scrypt_n=n,
            max_file_size=64 * 1024 * 1024, batch_size=batch,
            inflight=inflight, writers=writers, device=device)
    stats = res.stats.as_dict() if res.stats else {}
    doc = {
        "scrypt_n": n, "labels": labels, "batch": batch,
        "labels_per_sec": round(res.labels_per_s, 1),
        "elapsed_s": round(res.elapsed_s, 2),
        "stages": {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in stats.items()},
    }
    busiest = max(("dispatch_s", "fetch_s", "write_stall_s"),
                  key=lambda k: stats.get(k, 0.0))
    doc["bottleneck"] = busiest
    return doc


def prove_benchmark(labels: int, batch: int,
                    window_groups: int | None = None,
                    inflight: int | None = None,
                    device="cuda") -> dict:
    """Per-stage timings of the streaming prove pipeline (read/dispatch/
    retire) against the serial scan over the same tiny store, so an
    operator can see where prove time goes — and whether the sound early
    exit fired — before pointing the prover at a multi-TiB label store.
    The deterministic fixture is post/workload.py's."""
    import tempfile

    from ..post import workload

    with tempfile.TemporaryDirectory() as d:
        prover = workload.build(d, labels, batch, device=device,
                                window_groups=window_groups,
                                inflight=inflight)
        res = workload.compare_serial_vs_pipelined(prover, reps=1)
    stats = res["stats"]
    doc = {
        "labels": labels, "batch": batch,
        "proof_nonce": res["proof"].nonce,
        "serial_s": round(res["serial_s"], 4),
        "pipelined_s": round(res["pipelined_s"], 4),
        "speedup": round(res["speedup"], 2) if res["speedup"] else None,
        "stages": {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in stats.items()},
    }
    busiest = max(("read_wait_s", "dispatch_s", "retire_s"),
                  key=lambda k: stats.get(k, 0.0))
    doc["bottleneck"] = busiest
    return doc


def romix_roofline(n: int, r: int = 1, p: int = 1,
                   labels_per_sec: float | None = None,
                   gbps: float | None = None) -> dict:
    """Analytic memory-traffic roofline for one scrypt label.

    ROMix moves the V scratch exactly twice per label: the fill phase
    writes all N blocks of 128*r bytes, the mix phase reads N blocks
    back in data-dependent order — 2*128*r*N bytes per label per
    parallel chunk (p). Compute cost is 2 BlockMix passes of 2*r
    Salsa20/8 cores each: 4*N*r*p Salsa20/8 calls per label. Both
    follow from N/r/p alone, so a measured labels/s converts directly
    into achieved DRAM/HBM bandwidth and (given a peak, via ``gbps``
    or ``SPACEMESH_ROOFLINE_GBPS``) a utilization fraction — the
    number that says whether the kernel is bandwidth-bound or leaving
    the memory system idle."""
    n, r, p = int(n), int(r), int(p)
    bytes_per_label = 2 * 128 * r * n * p
    out = {
        "bytes_per_label": bytes_per_label,
        "salsa20_8_per_label": 4 * n * r * p,
    }
    if gbps is None:
        gbps = float(os.environ.get("SPACEMESH_ROOFLINE_GBPS", "0") or 0)
    if labels_per_sec:
        out["achieved_gbps"] = round(
            bytes_per_label * float(labels_per_sec) / 1e9, 3)
    if gbps > 0:
        out["roofline_gbps"] = gbps
        out["roofline_labels_per_sec"] = round(gbps * 1e9
                                               / bytes_per_label, 1)
        if labels_per_sec:
            out["utilization"] = round(out["achieved_gbps"] / gbps, 4)
    return out


def romix_benchmark(n: int, batch: int, reps: int = 2,
                    device="cuda") -> dict:
    """Per-stage timings of the label kernels — expand (PBKDF2 first),
    fill (ROMix phase 1), mix (ROMix phase 2), finish (PBKDF2 second) —
    through the kernel wrappers on ``device``. The fill/mix split runs
    ROMix once with its mix phase off (``mix_phase=False``) and
    subtracts. ``decision`` is what the port runs at this N: the CUDA
    kernel, over launches of at most ``lanes_that_fit`` lanes (the plain
    twin on the CPU)."""
    import numpy as np

    from ..device import resolve
    from ..ops import pbkdf2_cuda, romix_cuda, scrypt, u32

    dev = resolve(device)
    romix_cuda.check_n(n)
    if dev.type == "cuda":
        lanes = romix_cuda.lanes_that_fit(n, dev)
        decision = {"impl": "cuda",
                    "source": "spacemesh_tpu_torch/csrc/romix.cu",
                    "lanes_that_fit": lanes,
                    "launches_per_batch": -(-batch // lanes)}
    else:
        lanes = None
        decision = {"impl": "plain", "source":
                    "spacemesh_tpu_torch/ops/romix_cuda.py:romix_r1",
                    "lanes_that_fit": None, "launches_per_batch": None}

    commitment = hashlib.sha256(b"profiler-romix").digest()
    cw = u32.from_numpy(scrypt.commitment_to_words(commitment), dev)
    lo_, hi_ = scrypt.split_indices(np.arange(batch, dtype=np.uint64))
    lo, hi = u32.from_numpy(lo_, dev), u32.from_numpy(hi_, dev)

    def best_of(fn):
        _timed(dev, fn)  # build + warm
        return min(_timed(dev, fn) for _ in range(reps))

    expand_s = best_of(lambda: pbkdf2_cuda.expand(cw, lo, hi))
    x = pbkdf2_cuda.expand(cw, lo, hi)
    fill_s = best_of(lambda: romix_cuda.romix(x, n, mix_phase=False))
    romix_s = best_of(lambda: romix_cuda.romix(x, n))
    blk = romix_cuda.romix(x, n)
    finish_s = best_of(lambda: pbkdf2_cuda.finish(cw, blk))

    total = expand_s + romix_s + finish_s
    rate = round(batch / total, 1)
    # roofline against the ROMix phase alone (the only stage that touches
    # V): the PBKDF2 envelope would dilute the bandwidth number with
    # compute that moves no scratch memory
    roof = romix_roofline(n, labels_per_sec=batch / romix_s)
    impl = decision["impl"]
    # the autotuner's decision for this batch (a race when none is
    # persisted and racing is on) and its raced rows
    from ..ops import autotune

    tuned = autotune.decide(n, batch, platform=dev.type)
    decision["tuned"] = tuned.as_json()
    line = (f"{impl}: {roof['bytes_per_label']:,} B/label, "
            f"{roof['salsa20_8_per_label']:,} salsa20/8 calls/label")
    if "achieved_gbps" in roof:
        line += f", {roof['achieved_gbps']} GB/s achieved"
    if "utilization" in roof:
        line += (f" = {roof['utilization'] * 100:.1f}% of "
                 f"{roof['roofline_gbps']} GB/s roofline")
    elif "achieved_gbps" in roof:
        line += (" (set SPACEMESH_ROOFLINE_GBPS=<peak> for a "
                 "utilization fraction)")
    _log(line)
    row = {
        "impl": impl, "chunk": lanes, "interpret": False,
        "stages": {"expand_s": round(expand_s, 4),
                   "fill_s": round(fill_s, 4),
                   "mix_s": round(max(romix_s - fill_s, 0.0), 4),
                   "finish_s": round(finish_s, 4)},
        "romix_s": round(romix_s, 4),
        "labels_per_sec": rate,
        "roofline": roof,
    }
    rows = [row]
    for r in autotune.raced_rows(dev.type, n):
        rows.append({"impl": r["impl"], "chunk": r["chunk"],
                     "devices": r["devices"], "raced": True,
                     "labels_per_sec": r["labels_per_sec"],
                     "winner": (r["chunk"], r["devices"])
                     == (tuned.chunk, tuned.devices)
                     and tuned.source in ("race", "cache")})
    return {"scrypt_n": n, "batch": batch, "decision": decision,
            "impls": rows}


def verify_benchmark(counts: list[int], reps: int = 2,
                     device="cuda") -> dict:
    """Proof-verification throughput (BASELINE config 3: batch of NIPoST
    proofs through the batched verifier vs the reference's CPU worker
    pool). Builds one tiny real unit + proof (scrypt N=2) on ``device``,
    then measures verify_many over batches of that proof — proofs are
    LANES in the batched pass, so duplicates exercise the same compute
    path as distinct proofs."""
    import tempfile

    from ..post import initializer, verifier
    from ..post.prover import ProofParams, Prover

    node = hashlib.sha256(b"profiler-node").digest()
    commit = hashlib.sha256(b"profiler-commit").digest()
    challenge = hashlib.sha256(b"profiler-challenge").digest()
    params = ProofParams(k1=64, k2=16, k3=8,
                         pow_difficulty=bytes([32]) + bytes([255]) * 31)
    rates = []
    with tempfile.TemporaryDirectory() as d:
        meta, _ = initializer.initialize(
            d, node_id=node, commitment=commit, num_units=2,
            labels_per_unit=512, scrypt_n=2, max_file_size=4096,
            batch_size=256, device=device)
        proof = Prover(d, params, batch_labels=512,
                       device=device).prove(challenge)
        item = verifier.VerifyItem(
            proof=proof, challenge=challenge, node_id=node,
            commitment=commit, scrypt_n=meta.scrypt_n,
            total_labels=meta.total_labels)
        for count in counts:
            batch = [item] * count
            best = 0.0
            for _ in range(reps + 1):  # the first rep pays the build
                t0 = time.perf_counter()
                ok = verifier.verify_many(batch, params, device=device)
                best = max(best, count / (time.perf_counter() - t0))
                if not all(ok):
                    # a throughput number for proofs that FAILED would
                    # be worse than no number (and `assert` vanishes
                    # under python -O)
                    raise RuntimeError("verifier rejected a valid proof")
            _log(f"verify batch={count}: {best:,.0f} proofs/s")
            rates.append({"batch": count, "proofs_per_sec": round(best, 1)})
    return {"verify": rates}


def verify_farm_benchmark(items: int = 256, device="cuda") -> dict:
    """The verification farm (spacemesh_tpu_torch/verify/) against the
    inline serial path on one mixed workload, both on ``device``, with the
    farm's own telemetry (batch occupancy, per-lane queue peaks, dispatch
    seconds, dedup hits) so an operator can see the coalescing behavior,
    not just the end-to-end ratio."""
    import tempfile

    from ..verify import workload

    posts = max(items // 8, 4)
    vrfs = max(items // 16, 4)
    mems = max(items // 16, 4)
    sigs = max(items - posts - vrfs - mems, 8)
    with tempfile.TemporaryDirectory() as d:
        w = workload.build(d, sigs=sigs, vrfs=vrfs, posts=posts,
                           memberships=mems, post_challenges=4,
                           device=device)
        doc = workload.compare_serial_vs_farm(w)
    return {
        "items": doc["items"],
        "rejected": doc["rejected"],
        "decisions_match": True,  # compare_serial_vs_farm raises otherwise
        "serial_s": round(doc["serial_s"], 3),
        "batched_s": round(doc["batched_s"], 3),
        "speedup": doc["speedup"],
        "farm": {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in doc["stats"].items()},
    }


def _drop_hint(warnings: list[str]) -> str | None:
    """A loud, actionable capacity hint when any capture dropped spans.

    Drops are the one failure mode that silently corrupts every number
    in a timeline (self-time, queue-wait splits, link counts all become
    lower bounds), so the hint has to be impossible to miss."""
    if not warnings:
        return None
    lines = ["!" * 66]
    lines += [f"!!! {w}" for w in warnings]
    lines += [
        "!!! Self-time, wait/work splits and link counts below are",
        "!!! LOWER BOUNDS. Re-capture with a larger span ring:",
        "!!!   scenario scripts:  \"trace_capacity\": <spans>",
        "!!!   capture-from-boot: SPACEMESH_TRACE=<spans>",
        "!!!   verifyd replicas:  /debug/trace/start?capacity=<spans>",
        "!" * 66,
    ]
    return "\n".join(lines)


def timeline_view(path: str, top: int = 20) -> dict:
    """Digest one or more captured span traces (tools view over
    utils/tracing.summarize): validates the trace-event JSON first, so a
    truncated or hand-edited capture fails loudly, not with a nonsense
    flame summary. A comma-separated list of captures (one per process)
    is merged into a single federated timeline via
    tracing.merge_captures before summarizing."""
    from ..utils import tracing

    docs = []
    for one in str(path).split(","):
        one = one.strip()
        if not one:
            continue
        with open(one, encoding="utf-8") as f:
            docs.append(json.load(f))
    doc = docs[0] if len(docs) == 1 else tracing.merge_captures(docs)
    warnings = tracing.validate(doc)
    summary = tracing.summarize(doc, top=top)
    _log(tracing.render_summary(summary))
    hint = _drop_hint(warnings)
    if hint:
        _log(hint)
    other = doc.get("otherData", {})
    return {
        "trace": path,
        "merged": len(docs) > 1,
        "captured_spans": other.get("captured_spans"),
        "dropped_spans": other.get("dropped_spans"),
        **summary,
    }


def flight_view(path: str, top: int = 10) -> dict:
    """Digest a flight-recorder bundle (obs/flight.py): validates the
    trace export and the metrics snapshot while loading, then summarizes
    what was unhealthy and where the captured time went."""
    from ..obs import flight as flight_mod
    from ..utils import tracing

    bundle = flight_mod.read_bundle(path)
    doc = flight_mod.digest(bundle, top=top)
    lines = [f"flight bundle: {doc['bundle']}",
             f"  reason: {doc['reason']}  ready: {doc['ready']}"]
    for name, reason in (doc["unhealthy_components"] or {}).items():
        lines.append(f"  unhealthy {name}: {reason}")
    for name, ent in (doc["breached_slos"] or {}).items():
        lines.append(f"  breached SLO {name}: value={ent['value']} "
                     f"target={ent['target']} burn={ent['burn']}")
    for name, ent in (doc["procs"] or {}).items():
        lines.append(f"  proc {name}: {ent['spans']} spans"
                     + ("  [CRASHED — retained snapshot]"
                        if ent["crashed"] else ""))
    _log("\n".join(lines))
    # render over the MERGED timeline (parent + every procs/ child),
    # the same doc digest() summarized — not the parent capture alone
    procs = bundle.get("procs") or {}
    child = [ent["trace"] for _, ent in sorted(procs.items())
             if ent.get("trace") is not None]
    merged = bundle["trace"] if not child else \
        tracing.merge_captures([bundle["trace"]] + child)
    _log(tracing.render_summary(tracing.summarize(merged, top=top)))
    hint = _drop_hint(doc.get("trace_warnings") or [])
    if hint:
        _log(hint)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="profiler",
        description="POST provider enumeration + label benchmark")
    ap.add_argument("--device", default="cuda",
                    help="device of every view but --timeline/--flight "
                    "(cuda or cpu)")
    ap.add_argument("--providers", action="store_true",
                    help="list providers only, no benchmark")
    ap.add_argument("--verify", action="store_true",
                    help="benchmark proof verification instead of labels")
    ap.add_argument("--verify-batches", default="100,1000",
                    help="comma-separated proof batch sizes for --verify")
    ap.add_argument("--verify-farm", action="store_true",
                    help="serial vs farm-batched mixed verification + "
                    "farm telemetry (occupancy, lanes, dedup)")
    ap.add_argument("--verify-items", type=int, default=256,
                    help="workload size for --verify-farm")
    ap.add_argument("--pipeline", action="store_true",
                    help="profile the streaming init pipeline per stage "
                    "(dispatch/fetch/write/stall)")
    ap.add_argument("--pipeline-labels", type=int, default=4096,
                    help="labels for the --pipeline run")
    ap.add_argument("--pipeline-batch", type=int, default=1024)
    ap.add_argument("--inflight", type=int, default=None,
                    help="in-flight device batches for --pipeline/--prove")
    ap.add_argument("--writers", type=int, default=None,
                    help="writer threads for --pipeline")
    ap.add_argument("--prove", action="store_true",
                    help="profile the streaming prove pipeline per stage "
                    "(read/dispatch/retire) vs the serial scan")
    ap.add_argument("--romix", action="store_true",
                    help="profile the label kernels per stage (expand/fill/"
                    "mix/finish)")
    ap.add_argument("--romix-batch", type=int, default=CAL_BATCH,
                    help="label lanes for --romix")
    ap.add_argument("--prove-labels", type=int, default=16384,
                    help="store size for the --prove run")
    ap.add_argument("--prove-batch", type=int, default=2048)
    ap.add_argument("--window-groups", type=int, default=None,
                    help="nonce groups per disk pass for --prove")
    ap.add_argument("--n", type=int, default=8192, help="scrypt N")
    ap.add_argument("--batches", default="1024,2048,4096",
                    help="comma-separated label lanes per batch")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warm", action="store_true",
                    help="build the kernel libraries and persist the "
                    "autotuned winners (tools/warmcache.py)")
    ap.add_argument("--warm-batches", default="8192,4096,2048,1024,512",
                    help="batch sizes for --warm")
    ap.add_argument("--warm-prove", action="store_true",
                    help="--warm also runs the prover's scan step")
    ap.add_argument("--cpu-labels", type=int, default=16,
                    help="labels for the OpenSSL reference measurement")
    ap.add_argument("--timeline", metavar="TRACE_JSON[,TRACE_JSON...]",
                    default=None,
                    help="summarize a span-trace export (top spans by "
                    "self-time, per-stage wait-vs-work split) instead of "
                    "benchmarking; a comma-separated list merges one "
                    "capture per process into a federated timeline")
    ap.add_argument("--timeline-top", type=int, default=20,
                    help="rows in the --timeline self-time ranking")
    ap.add_argument("--flight", metavar="BUNDLE_DIR", default=None,
                    help="digest a flight-recorder bundle "
                    "(obs/flight.py spool entry): validates the trace "
                    "+ metrics snapshot, prints unhealthy components, "
                    "breached SLOs and a trace summary")
    ap.add_argument("--no-probe", action="store_true",
                    help="accepted for the JAX package's command lines; "
                    "the port has no accelerator probe")
    a = ap.parse_args(argv)

    if a.timeline:
        # pure file digestion: no device
        print(json.dumps(timeline_view(a.timeline, top=a.timeline_top),
                         indent=2))
        return 0

    if a.flight:
        # pure file digestion too
        print(json.dumps(flight_view(a.flight, top=a.timeline_top),
                         indent=2))
        return 0

    from ..device import resolve

    try:
        dev = resolve(a.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if a.warm:
        from . import warmcache

        doc = warmcache.warm(
            a.n, [int(b) for b in a.warm_batches.split(",") if b],
            prove=a.warm_prove, device=dev)
    elif a.providers:
        doc = {"providers": providers(dev)}
    elif a.pipeline:
        doc = pipeline_benchmark(
            a.n, a.pipeline_labels, a.pipeline_batch,
            inflight=a.inflight, writers=a.writers, device=dev)
    elif a.romix:
        doc = romix_benchmark(a.n, a.romix_batch, reps=a.reps, device=dev)
    elif a.prove:
        doc = prove_benchmark(
            a.prove_labels, a.prove_batch,
            window_groups=a.window_groups, inflight=a.inflight, device=dev)
    elif a.verify:
        doc = verify_benchmark(
            [int(b) for b in a.verify_batches.split(",")],
            reps=a.reps, device=dev)
    elif a.verify_farm:
        doc = verify_farm_benchmark(a.verify_items, device=dev)
    else:
        doc = benchmark(a.n, [int(b) for b in a.batches.split(",")],
                        a.reps, a.cpu_labels, device=dev)
    print(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
