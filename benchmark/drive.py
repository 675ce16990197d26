"""The one general load generator: a traffic mix (a data file under
``traffic/``) over a configuration (a file under ``configs/``), driven
through the program's entry points.

A mix names its entry and its identities:

* ``entry``: ``"initializer"`` (each initializing identity runs its own
  ``post.initializer.Initializer.run``) or ``"scheduler"`` (every identity
  is a tenant of one ``runtime.TenantScheduler``: ``submit_init`` and
  ``submit_prove``);
* ``init_identities``: identities that initialize a unit of
  ``num_units * labels_per_unit`` labels, more than the window can finish;
* ``prove_identities``: identities that hold a finished store of
  ``num_units * prove_labels_per_unit`` labels and prove in a closed
  loop: each submits its next PoET challenge, drawn from the seed, the
  moment its last proof returns;
* ``warm_batches`` (label batches, or packs, retired before the window
  opens) and ``warm_proofs`` (proofs completed before it, all identities
  together);
* ``drain_s``: how long after the window the proofs open in it may take
  to return; ``sample_labels`` (per initializing identity),
  ``sample_prove_store_labels`` (per proving identity) and
  ``sample_proofs``: how many stored labels and proofs the reference
  recomputes; ``check_vrf_nonce``: whether the reference works out each
  initializing identity's persisted VRF nonce again.

The initializing identities' node ids and commitments, and every
challenge, come from ``--seed`` (:func:`derive`). A proving identity's
store is what a smesher proves over: made once, by an earlier process,
and the same for every seed. The stores are built by the first run in a
checkout under a fixed directory of the checkout (:func:`prove_stores`),
keyed by everything that fixes their bytes, and read by every later run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import queue
import shutil
import tempfile
import threading
import time
from pathlib import Path

SETUP_TIMEOUT_S = 600.0


def derive(seed, *parts) -> bytes:
    """32 bytes from the seed (a whole number, or ``"store"`` for what is
    the same for every seed) and a path of names."""
    text = "/".join(["spacemesh-bench", str(seed)] + [str(p) for p in parts])
    return hashlib.sha256(text.encode()).digest()


@dataclasses.dataclass
class Identity:
    tid: str
    role: str            # "init" or "prove"
    node_id: bytes
    commitment: bytes
    num_units: int
    labels_per_unit: int
    dir: Path

    @property
    def total(self) -> int:
        return self.num_units * self.labels_per_unit


@dataclasses.dataclass
class ProofRecord:
    tid: str
    seq: int
    challenge: bytes
    submit: float
    done: float | None = None
    proof: object = None
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What one run of a mix produced; the metrics and the check read it."""

    config: dict
    traffic: dict
    identities: list
    t0: float = 0.0
    t1: float = 0.0
    # tid -> [(perf_counter s, labels written)], in order
    frontiers: dict = dataclasses.field(default_factory=dict)
    written: dict = dataclasses.field(default_factory=dict)  # final, per tid
    batches: int = 0        # label batches (or packs) retired in the window
    proofs: list = dataclasses.field(default_factory=list)
    init_errors: list = dataclasses.field(default_factory=list)
    registry: dict = dataclasses.field(default_factory=dict)  # "t0"/"t1"
    spans: list = dataclasses.field(default_factory=list)
    dtrace: object = None   # devtrace.DeviceTrace of a traced window
    pack_lanes: int = 0
    device_kind: str = ""   # the card's name; peaks.py keys on it

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def labels_at(self, tid: str, t: float) -> int:
        n = 0
        for ts, v in self.frontiers.get(tid, ()):
            if ts > t:
                break
            n = v
        return n

    def window_labels(self) -> int:
        return sum(self.labels_at(i.tid, self.t1) - self.labels_at(i.tid,
                                                                   self.t0)
                   for i in self.identities if i.role == "init")

    def due_proofs(self) -> list:
        """Every proof open at some moment of the window: submitted before
        it closed and not returned before it opened."""
        return [r for r in self.proofs if r.submit < self.t1
                and (r.done is None or r.done >= self.t0)]

    def proof_latencies(self) -> list[float]:
        """Seconds from submit to proof for every proof due in the window;
        one that failed or never returned is infinite."""
        return [r.done - r.submit if r.proof is not None and r.done
                else math.inf for r in self.due_proofs()]

    def window_completions(self) -> dict:
        """Proofs returned inside the window, per proving identity."""
        out = {i.tid: 0 for i in self.identities if i.role == "prove"}
        for r in self.proofs:
            if r.proof is not None and r.done is not None \
                    and self.t0 <= r.done < self.t1:
                out[r.tid] += 1
        return out


STORE_FIELDS = ("scrypt_n", "num_units", "prove_labels_per_unit",
                "max_file_size")


def identities(seed: int, config: dict, traffic: dict, base: Path,
               stores: Path) -> list:
    """The mix's identities: initializing ones in ``base`` (made anew),
    proving ones in ``stores`` (built once, see :func:`prove_stores`)."""
    out = []
    for i in range(traffic.get("init_identities", 0)):
        tid = f"init{i:02d}"
        out.append(Identity(tid, "init", derive(seed, tid, "node"),
                            derive(seed, tid, "commitment"),
                            config["num_units"], config["labels_per_unit"],
                            base / tid))
    for i in range(traffic.get("prove_identities", 0)):
        tid = f"prove{i:02d}"
        node, commitment = (derive("store", tid, "node"),
                            derive("store", tid, "commitment"))
        # every number that fixes the store's bytes names its directory
        key = hashlib.sha256(repr(
            [tid, node, commitment] + [config[k] for k in STORE_FIELDS]
        ).encode()).hexdigest()[:16]
        out.append(Identity(tid, "prove", node, commitment,
                            config["num_units"],
                            config["prove_labels_per_unit"],
                            stores / f"{tid}-{key}"))
    return out


def _wait(cond, timeout: float, what: str, alive=lambda: True) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if not alive():
            raise RuntimeError(f"set-up: the program stopped before {what}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"set-up: {what} took over {timeout:.0f} s")
        time.sleep(0.005)


class _Window:
    """Opens the measured window: registry snapshot, and in a traced run
    the span capture and the device profile."""

    def __init__(self, run: Run, trace: bool):
        self.run, self.trace = run, trace

    def __enter__(self):
        from spacemesh_tpu_torch.utils import metrics, tracing

        self._metrics, self._tracing = metrics, tracing
        if self.trace:
            from .devtrace import DeviceTrace

            tracing.start(capacity=1 << 20, torch_bridge=False)
            self.run.dtrace = DeviceTrace().__enter__()
        self.run.registry["t0"] = metrics.REGISTRY.sample()
        self.run.t0 = time.perf_counter()
        return self

    def hold(self, seconds: float) -> None:
        """Let the program run until the window is ``seconds`` long."""
        while (left := self.run.t0 + seconds - time.perf_counter()) > 0:
            time.sleep(min(left, 0.05))

    def __exit__(self, *exc):
        self.run.t1 = time.perf_counter()
        self.run.registry["t1"] = self._metrics.REGISTRY.sample()
        if self.trace:
            self.run.dtrace.__exit__(*exc)
            self._tracing.stop()
            self.run.spans = [
                (e["name"], e["ts"], e["ts"] + e["dur"], e["args"])
                for e in self._tracing.export()["traceEvents"]
                if e.get("ph") == "X"]
        return False


def run_and_check(seed: int, seconds: float, trace: bool, config: dict,
                  traffic: dict, device: str, stores: Path, after) -> tuple:
    """Set up the mix, measure ``seconds``, wind the program down, then
    call ``after(run)`` while the stores still exist; -> (run, after's
    result). The initializing identities' stores live in a temporary
    directory under ``TMPDIR``, removed on the way out; the proving
    identities' stores under ``stores``, kept for the next run."""
    base = Path(tempfile.mkdtemp(prefix="spacemesh-bench-"))
    try:
        run = Run(config, traffic,
                  identities(seed, config, traffic, base, stores))
        prove_stores(run, device)
        entry = traffic["entry"]
        if entry == "initializer":
            _drive_initializer(run, seed, seconds, trace, device)
        elif entry == "scheduler":
            _drive_scheduler(run, seed, seconds, trace, device)
        else:
            raise ValueError(f"unknown entry {entry!r}")
        return run, after(run)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def prove_stores(run: Run, device: str) -> None:
    """Each proving identity's finished store, built by the lone
    initializer where the checkout has none yet. A store is built beside
    its directory and renamed into place when whole, so a run cut short
    leaves nothing that a later run would take for a store."""
    from spacemesh_tpu_torch.post import initializer

    cfg = run.config
    for ident in run.identities:
        if ident.role != "prove":
            continue
        run.written[ident.tid] = ident.total
        if ident.dir.is_dir():
            continue
        part = ident.dir.with_name(ident.dir.name + ".part")
        shutil.rmtree(part, ignore_errors=True)
        part.parent.mkdir(parents=True, exist_ok=True)
        meta = initializer.open_or_create_meta(
            part, node_id=ident.node_id, commitment=ident.commitment,
            num_units=ident.num_units,
            labels_per_unit=ident.labels_per_unit,
            scrypt_n=cfg["scrypt_n"], max_file_size=cfg["max_file_size"])
        initializer.Initializer(part, meta, batch_size=cfg["init_batch"],
                                tenant=ident.tid, device=device).run()
        if meta.labels_written != ident.total:
            raise RuntimeError(f"set-up: {ident.tid}'s store holds "
                               f"{meta.labels_written} of {ident.total}")
        part.rename(ident.dir)


def _progress(run: Run, tid: str):
    log = run.frontiers.setdefault(tid, [])

    def cb(done: int, _total: int) -> None:
        log.append((time.perf_counter(), int(done)))
    return cb


def _drive_initializer(run: Run, seed: int, seconds: float, trace: bool,
                       device: str) -> None:
    from spacemesh_tpu_torch.post import initializer

    cfg, traffic = run.config, run.traffic
    inits, threads, results = [], [], {}
    for ident in run.identities:
        if ident.role != "init":
            raise ValueError("the initializer entry drives initializing "
                             "identities only")
        meta = initializer.open_or_create_meta(
            ident.dir, node_id=ident.node_id, commitment=ident.commitment,
            num_units=ident.num_units,
            labels_per_unit=ident.labels_per_unit,
            scrypt_n=cfg["scrypt_n"], max_file_size=cfg["max_file_size"])
        init = initializer.Initializer(
            ident.dir, meta, batch_size=cfg["init_batch"],
            progress=_progress(run, ident.tid), tenant=ident.tid,
            device=device)

        def body(init=init, tid=ident.tid):
            try:
                results[tid] = init.run()
            except Exception as exc:  # noqa: BLE001 — reported as a failed init
                run.init_errors.append(f"{tid}: {exc!r}")
        inits.append((ident, init, meta))
        threads.append(threading.Thread(target=body, name=ident.tid,
                                        daemon=True))
    for t in threads:
        t.start()
    try:
        warm = traffic.get("warm_batches", 2)
        _wait(lambda: all(len(run.frontiers.get(i.tid, ())) >= warm
                          for i, _, _ in inits),
              SETUP_TIMEOUT_S, f"{warm} warm batches",
              alive=lambda: all(t.is_alive() for t in threads))
        with _Window(run, trace) as window:
            window.hold(seconds)
    finally:
        for _, init, _ in inits:
            init.stop()
        for t in threads:
            t.join(timeout=120)
    run.batches = sum(1 for i, _, _ in inits
                      for ts, _ in run.frontiers.get(i.tid, ())
                      if run.t0 < ts <= run.t1)
    for ident, _, meta in inits:
        run.written[ident.tid] = meta.labels_written
    if any(t.is_alive() for t in threads):
        run.init_errors.append("an initializer did not stop within 120 s")


def _drive_scheduler(run: Run, seed: int, seconds: float, trace: bool,
                     device: str) -> None:
    from spacemesh_tpu_torch.post.prover import ProofParams
    from spacemesh_tpu_torch.runtime import TenantScheduler

    cfg, traffic = run.config, run.traffic
    params = ProofParams(k1=cfg["k1"], k2=cfg["k2"], k3=cfg["k3"],
                         pow_difficulty=bytes.fromhex(cfg["pow_difficulty"]))
    run.pack_lanes = cfg["init_batch"]
    inits = [i for i in run.identities if i.role == "init"]
    provers = [i for i in run.identities if i.role == "prove"]

    def submit_init(sched, ident, progress=None):
        return sched.submit_init(
            ident.tid, ident.dir, node_id=ident.node_id,
            commitment=ident.commitment, num_units=ident.num_units,
            labels_per_unit=ident.labels_per_unit, scrypt_n=cfg["scrypt_n"],
            max_file_size=cfg["max_file_size"], progress=progress)

    sched = TenantScheduler(pack_lanes=cfg["init_batch"], device=device)
    init_handles = []
    loop = None
    try:
        for ident in run.identities:
            sched.register_tenant(ident.tid)
        packs0 = sched.pack_stats.packs
        init_handles = [(i, submit_init(sched, i, _progress(run, i.tid)))
                        for i in inits]
        loop = _ProveLoop(run, seed, sched, params, provers)
        loop.start()
        warm = traffic.get("warm_batches", 2) if inits else 0
        warm_proofs = traffic.get("warm_proofs", 1) if provers else 0
        try:
            _wait(lambda: (sched.pack_stats.packs - packs0 >= warm
                           and loop.completed() >= warm_proofs),
                  SETUP_TIMEOUT_S, "the warm packs and proofs",
                  alive=lambda: not any(h.done() for _, h in init_handles)
                  and not loop.failed())
        except (RuntimeError, TimeoutError) as exc:
            errors = [f"{r.tid}#{r.seq}: {r.error}" for r in run.proofs
                      if r.error] + [
                f"{i.tid}: {h.future.exception()!r}" for i, h in init_handles
                if h.done() and not h.future.cancelled()]
            raise RuntimeError(f"{exc}; " + "; ".join(errors[:4])) from exc
        with _Window(run, trace) as window:
            packs_t0 = sched.pack_stats.packs
            window.hold(seconds)
            loop.stop_submitting()
            packs_t1 = sched.pack_stats.packs
        run.batches = packs_t1 - packs_t0
        # the proofs open in the window finish beside the running inits
        loop.wait_due(run.t1, traffic.get("drain_s", 60.0))
    finally:
        if loop is not None:
            loop.close()
        for _, h in init_handles:
            h.cancel()
        # JobHandle.wait() does not return early for a cancelled job (the
        # future is never marked notified), so poll done() instead
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline \
                and not all(h.done() for _, h in init_handles):
            time.sleep(0.005)
        sched.close()
    for ident, h in init_handles:
        log = run.frontiers.get(ident.tid, ())
        run.written[ident.tid] = log[-1][1] if log else 0
        exc = h.future.exception() if (h.done() and not h.future.cancelled()
                                       ) else None
        if exc is not None and type(exc).__name__ != "SchedulerClosed":
            run.init_errors.append(f"{ident.tid}: {exc!r}")


class _ProveLoop:
    """Closed-loop proving: each identity's next challenge goes in the
    moment its last proof returns. Completions land on a queue that one
    submitting thread drains, so the scheduler's workers only stamp the
    time."""

    def __init__(self, run: Run, seed: int, sched, params, provers: list):
        self.run, self.seed, self.sched, self.params = run, seed, sched, params
        self.provers = provers
        self._q: queue.Queue = queue.Queue()
        self._next = {i.tid: 0 for i in provers}
        self._done = {i.tid: 0 for i in provers}
        self._lock = threading.Lock()
        self._submitting = True
        self._thread = threading.Thread(target=self._body, name="prove-loop",
                                        daemon=True)

    def start(self) -> None:
        for ident in self.provers:
            self._submit(ident)
        self._thread.start()

    def _submit(self, ident) -> None:
        seq = self._next[ident.tid]
        self._next[ident.tid] = seq + 1
        rec = ProofRecord(ident.tid, seq,
                          derive(self.seed, ident.tid, "challenge", seq),
                          time.perf_counter())
        with self._lock:
            self.run.proofs.append(rec)
        h = self.sched.submit_prove(ident.tid, ident.dir, rec.challenge,
                                    self.params)
        h.future.add_done_callback(
            lambda f, rec=rec, ident=ident: self._finished(rec, ident, f))

    def _finished(self, rec, ident, fut) -> None:
        rec.done = time.perf_counter()
        try:
            rec.proof = fut.result()
        except BaseException as exc:  # noqa: BLE001 — a failed proof is recorded, not raised
            rec.error = repr(exc)
        with self._lock:
            self._done[ident.tid] += 1
        self._q.put(ident)

    def _body(self) -> None:
        while True:
            ident = self._q.get()
            if ident is None:
                return
            with self._lock:
                go = self._submitting
            if go:
                self._submit(ident)

    def completed(self) -> int:
        with self._lock:
            return sum(self._done.values())

    def failed(self) -> bool:
        with self._lock:
            return any(r.error for r in self.run.proofs)

    def stop_submitting(self) -> None:
        with self._lock:
            self._submitting = False

    def wait_due(self, t1: float, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                open_ = [r for r in self.run.proofs
                         if r.submit < t1 and r.done is None]
            if not open_:
                return
            time.sleep(0.01)

    def close(self) -> None:
        self.stop_submitting()
        self._q.put(None)
        self._thread.join(timeout=30)
