"""Deterministic crash-recovery scenario over the POST storage plane (port
of ``spacemesh_tpu/sim/crash_recovery.py``; the inits run on ``device``,
default ``"cuda"``).

The network scenario engine (sim/scenario.py) exercises whole nodes;
this engine exercises the CRASH SAFETY of the POST data plane the same
way: scripted, seeded, replayable — same seed, byte-identical outcome
digest across processes (the CLI's ``--repeat`` contract;
sim/__main__.py dispatches here when a script carries
``"engine": "crashrec"``).

One run:

1. an **uninjected reference init** (tiny geometry from the script)
   through a counting :class:`post.faultfs.FaultFS` — its mutating-op
   total defines the crash sites, its store sha256 the ground truth;
2. a seeded selection of op indices (``crash_every``-th site, offset
   by the seed) each gets a fresh data dir and a scripted fault —
   power-cut and torn-write variants alternate — then crash → reboot
   (un-fsynced bytes vanish) → reopen → recovery → resume, looping
   until the init completes; the finished store must hash identical
   to the reference;
3. an **ENOSPC phase**: the disk "fills" at a scripted op for a
   scripted hold window; the writer pool must park (degraded — the
   ``post.store`` probe flips, sampled from inside the injection
   hook), resume when the plan releases space, and still converge
   bit-identically.

Determinism: faults fire at exact op counts (no wall clock), label
computation is bit-deterministic, the writer pool runs one thread, and
metadata checkpoints are label-interval-driven (the time interval is
pinned far away), so the whole event log replays byte-identically.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import shutil
import tempfile
from pathlib import Path

from ..device import resolve
from ..obs import health as health_mod
from ..post import faultfs, initializer
from ..post.data import LabelStore, PostMetadata
from ..utils import metrics

NODE_SEED = b"crashrec-node"
COMMIT_SEED = b"crashrec-commit"
MAX_RESUMES = 6


@dataclasses.dataclass
class CrashRecResult:
    """CLI-compatible result (sim/__main__.py prints digest/ok/slis/
    stats["hub"] for every engine)."""

    name: str
    seed: int
    digest: str
    ok: bool
    asserts: list
    slis: dict
    stats: dict
    events: list

    def to_json(self) -> str:
        return json.dumps({
            "name": self.name, "seed": self.seed, "digest": self.digest,
            "ok": self.ok, "asserts": self.asserts, "slis": self.slis,
            "stats": self.stats, "events": self.events,
        }, indent=1, sort_keys=True)


def _init_kwargs(script: dict) -> dict:
    labels = int(script.get("labels", 512))
    return dict(
        node_id=hashlib.sha256(NODE_SEED).digest(),
        commitment=hashlib.sha256(COMMIT_SEED).digest(),
        num_units=1, labels_per_unit=labels,
        scrypt_n=int(script.get("scrypt_n", 2)),
        max_file_size=int(script.get("max_file_size", 4096)),
        batch_size=int(script.get("batch", 128)),
        writers=1, save_barrier=True,
        meta_interval_s=1e9,  # label-driven checkpoints only (determinism)
        meta_interval_labels=int(script.get("interval_labels", 128)),
    )


def _store_sha(d) -> tuple[str, int]:
    meta = PostMetadata.load(d)
    store = LabelStore(d, meta)
    try:
        sha = hashlib.sha256(
            store.read_labels(0, meta.total_labels)).hexdigest()
    finally:
        store.close()
    return sha, int(meta.vrf_nonce if meta.vrf_nonce is not None else -1)


def _run_to_completion(d, kw: dict, fs: faultfs.FaultFS,
                       enospc_retry_s: float = 0.01) -> int:
    """Drive one init across crash/reboot cycles; returns reboots."""
    reboots = 0
    while True:
        try:
            initializer.initialize(d, fs=fs,
                                   enospc_retry_s=enospc_retry_s, **kw)
            return reboots
        except BaseException as e:  # noqa: BLE001 — PowerCut rides behind pool errors
            if faultfs.power_cut_behind(e) is None:
                raise
            if reboots >= MAX_RESUMES:
                raise RuntimeError(
                    f"init did not converge within {MAX_RESUMES} "
                    "reboots") from e
            fs.reboot()
            reboots += 1


def run_scenario(script: dict, device="cuda") -> CrashRecResult:
    seed = int(script.get("seed", 7))
    rng = random.Random(seed)
    kw = dict(_init_kwargs(script), device=resolve(device))
    events: list = []
    faults_before = metrics.post_store_fault_injections.sample()
    recov_before = metrics.post_store_recovery_runs.sample()

    root = Path(tempfile.mkdtemp(prefix="crashrec-"))
    try:
        # 1. uninjected reference
        ref_dir = root / "ref"
        count_fs = faultfs.FaultFS()
        initializer.initialize(ref_dir, fs=count_fs, **kw)
        total_ops = count_fs.write_ops
        ref_sha, ref_nonce = _store_sha(ref_dir)
        events.append({"phase": "reference", "ops": total_ops,
                       "sha": ref_sha[:16], "vrf_nonce": ref_nonce})

        # 2. seeded crash sweep: every crash_every-th op site, phase
        # offset drawn from the seed, variants alternating
        every = max(int(script.get("crash_every", 3)), 1)
        offset = rng.randrange(every)
        variants = list(script.get("variants") or ["powercut", "torn"])
        for i, op in enumerate(range(1 + offset, total_ops + 1, every)):
            kind = variants[i % len(variants)]
            d = root / f"crash-{op}-{kind}"
            plan = faultfs.FaultPlan(
                [faultfs.FaultSpec(op=op, kind=kind)], seed=seed)
            fs = faultfs.FaultFS(plan)
            reboots = _run_to_completion(d, kw, fs)
            sha, nonce = _store_sha(d)
            events.append({
                "phase": "crash", "op": op, "kind": kind,
                "reboots": reboots,
                "fired": [e["kind"] for e in fs.injected],
                "bit_identical": sha == ref_sha and nonce == ref_nonce,
            })

        # 3. ENOSPC: the disk fills mid-init and stays full for a
        # scripted op window; the probe must flip degraded (sampled
        # from inside the injection hook — deterministic, sleep-free)
        en = dict(script.get("enospc") or {"op": 2, "hold": 6})
        degraded_seen = [False]

        def on_inject(spec, n):
            if spec.kind != "enospc":
                return
            report = health_mod.HEALTH.report(0.0)
            ent = report.get("post.store")
            if ent is not None and not ent["healthy"]:
                degraded_seen[0] = True

        d = root / "enospc"
        plan = faultfs.FaultPlan(
            [faultfs.FaultSpec(op=int(en.get("op", 2)), kind="enospc",
                               hold_ops=int(en.get("hold", 6)))],
            seed=seed, on_inject=on_inject)
        fs = faultfs.FaultFS(plan)
        reboots = _run_to_completion(d, kw, fs)
        sha, nonce = _store_sha(d)
        events.append({
            "phase": "enospc", "op": int(en.get("op", 2)),
            "hold": int(en.get("hold", 6)), "reboots": reboots,
            "degraded_seen": degraded_seen[0],
            "waits": len([e for e in fs.injected
                          if e["kind"] == "enospc"]),
            "bit_identical": sha == ref_sha and nonce == ref_nonce,
        })
    finally:
        shutil.rmtree(root, ignore_errors=True)

    faults_after = metrics.post_store_fault_injections.sample()
    recov_after = metrics.post_store_recovery_runs.sample()
    fault_delta = (sum(faults_after.values())
                   - sum(faults_before.values()))
    recov_delta = (sum(recov_after.values())
                   - sum(recov_before.values()))

    crash_events = [e for e in events if e["phase"] == "crash"]
    asserts = []
    for spec in script.get("asserts") or (
            [{"kind": "bit_identical"}, {"kind": "recovered", "min": 1}]):
        kind = spec.get("kind")
        ent = dict(spec)
        if kind == "bit_identical":
            bad = [e for e in events if e.get("bit_identical") is False]
            ent["ok"] = not bad and bool(crash_events)
            ent["detail"] = (f"{len(bad)} diverging stores of "
                            f"{len(crash_events) + 1} injected runs")
        elif kind == "recovered":
            n = sum(e["reboots"] for e in crash_events)
            ent["ok"] = n >= int(spec.get("min", 1))
            ent["detail"] = f"{n} crash/reboot/resume cycles"
        elif kind == "enospc_degraded":
            en_ev = [e for e in events if e["phase"] == "enospc"]
            ent["ok"] = bool(en_ev) and en_ev[0]["degraded_seen"] \
                and en_ev[0]["bit_identical"]
            ent["detail"] = f"enospc events: {en_ev}"
        elif kind == "fault_metrics":
            ent["ok"] = fault_delta >= int(spec.get("min", 1)) \
                and recov_delta >= 1
            ent["detail"] = (f"{fault_delta} injections, "
                            f"{recov_delta} recovery runs")
        else:
            ent["ok"] = False
            ent["detail"] = f"unknown assert kind {kind!r}"
        asserts.append(ent)

    # digest covers ONLY replay-stable facts: script identity + the
    # per-run outcome log (metric deltas are cross-run cumulative on a
    # shared registry, so they argue in asserts, not the digest)
    digest_doc = {
        "name": script.get("name"), "seed": seed, "engine": "crashrec",
        "events": events,
        "asserts": [{k: v for k, v in a.items() if k != "detail"}
                    for a in asserts],
    }
    digest = hashlib.sha256(
        json.dumps(digest_doc, sort_keys=True).encode()).hexdigest()[:16]
    hub = {
        "runs": len(crash_events) + 2,
        "crashes": sum(e["reboots"] for e in crash_events),
        "op_sites": len(crash_events),
        "enospc_waits": next((e["waits"] for e in events
                              if e["phase"] == "enospc"), 0),
    }
    return CrashRecResult(
        name=str(script.get("name", "crash-recovery")), seed=seed,
        digest=digest, ok=all(a["ok"] for a in asserts),
        asserts=asserts, slis={}, stats={"hub": hub}, events=events)
