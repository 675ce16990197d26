"""Speculative batch sizing for the verification service (port of
``spacemesh_tpu/verifyd/batchtune.py``).

The farm's static policy — dispatch at ``max_batch`` or when a 2-10 ms
lane deadline expires — is tuned for ONE node's gossip ingest.  A
network verification service (verifyd) sees workloads whose optimal
batch size varies by orders of magnitude per kind: a k2pow witness
batch amortizes device dispatch across thousands of lanes, a pure-Python
ed25519 MSM check peaks around a few hundred signatures, a POST
recompute is already near-flat past a handful of proofs.  Guessing those
numbers per host is what the **race-and-persist** pattern is for:

* :meth:`BatchTuner.ensure_raced` measures each kind's REAL backend at
  a ladder of candidate batch sizes on a deterministic calibration
  workload (once per host), and persists the measured ``batch ->
  items/sec`` rows to the port's own file,
  ``spacemesh_tpu_torch/build/verifyd_batchtune.json`` (beside the
  built kernels) — a second process skips the race entirely. Rows are
  keyed by the device they were measured on (the card's name, or
  ``cpu``) under a ``torch-`` schema tag, so the port never reads rows
  the JAX package measured, on a TPU or anywhere else.
  ``SPACEMESH_VERIFYD_TUNE=off`` disables racing (static defaults +
  online refinement only), as in the JAX package;
  ``SPACEMESH_TORCH_VERIFYD_TUNE_CACHE`` moves the file. A corrupt or
  unreadable file is ignored and re-raced.
* Live batches keep the model honest: the farm calls
  :meth:`observe` after every dispatch (an EWMA into the nearest
  measured row), so kinds too expensive to race (POST) converge on real
  numbers anyway.

The **speculative dispatch decision** (:meth:`dispatch_now`): with
``n`` items pending and a measured arrival rate, dispatching now costs
``service(n) / n`` seconds per item; waiting to fill the tuned target
batch costs ``(fill_wait + service(target)) / target``.  The batch goes
NOW as soon as the marginal wait exceeds the predicted throughput gain
— a partially-full batch is dispatched the moment waiting stops paying,
and the farm's lane deadlines remain a hard latency cap on top
(verify/farm.py consumes this through its ``tuner`` hook).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

SCHEMA = 1
ENV_TUNE = "SPACEMESH_VERIFYD_TUNE"
ENV_CACHE = "SPACEMESH_TORCH_VERIFYD_TUNE_CACHE"
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "verifyd_batchtune.json")
_OFF = ("0", "off", "none", "false")

# candidate batch-size ladders per kind: the raced grid, and the
# buckets live observations EWMA into (a raw-occupancy key per batch
# would fragment the model into noise). post is deliberately absent
# from the RACED set — building a real POST store for calibration is a
# multi-second affair — so it starts from the static target and
# converges through observe() alone.
CANDIDATES: dict[str, tuple[int, ...]] = {
    "sig": (1, 8, 32, 128, 256),
    "vrf": (1, 4, 16),
    "membership": (1, 16, 64),
    "pow": (1, 32, 256, 1024),
    "post": (1, 4, 8, 32),
}

# static fallbacks when no measurement exists yet (race disabled or a
# cold in-process start): the JAX package's near-peak batch sizes, kept
# so both packages start from one policy
STATIC_TARGETS: dict[str, int] = {
    "sig": 256, "vrf": 64, "membership": 64, "post": 8, "pow": 1024,
}

_EWMA = 0.3           # weight of a fresh observation
_ARRIVAL_EWMA = 0.2   # weight of a fresh interarrival sample
CAL_REPS = 2


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def race_enabled() -> bool:
    return (os.environ.get(ENV_TUNE) or "").lower() not in _OFF


def cache_path() -> str:
    """The measured-rates file: ``$SPACEMESH_TORCH_VERIFYD_TUNE_CACHE``,
    else :data:`DEFAULT_CACHE` in the port's build directory."""
    explicit = os.environ.get(ENV_CACHE)
    if explicit:
        return os.path.expanduser(explicit)
    return DEFAULT_CACHE


def device_platform(device) -> str:
    """The row key of a device: the card's name on CUDA, else ``cpu``."""
    from ..device import resolve

    dev = resolve(device)
    if dev.type == "cuda":
        import torch

        return torch.cuda.get_device_name(dev)
    return "cpu"


def _load_cache(path: str | None = None) -> dict:
    path = path or cache_path()
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("batchtune cache root is not an object")
        return doc
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        # a corrupt rates file must never break admission — re-race
        _log(f"verifyd batchtune: ignoring unreadable cache {path} ({e})")
        return {}


def _store(key: str, entry: dict) -> None:
    path = cache_path()
    doc = _load_cache(path)
    doc[key] = entry
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # durable write (tmp + fsync + rename + dir-fsync): a power cut
        # mid-save must never leave a half-written rates file that the
        # corrupt-cache-ignored path above silently re-measures away
        from ..utils import fsio

        fsio.atomic_write_text(
            path, json.dumps(doc, indent=1, sort_keys=True))
    except OSError as e:
        # persistence is an optimization (read-only HOME, sandboxed CI)
        _log(f"verifyd batchtune: cannot persist rates ({e})")


def _key(platform: str, kind: str) -> str:
    return f"torch-v{SCHEMA}:{platform}:{kind}"


def _valid_rows(raw) -> dict[int, float]:
    out: dict[int, float] = {}
    if not isinstance(raw, dict):
        return out
    for b, rate in raw.items():
        try:
            bi = int(b)
        except (TypeError, ValueError):
            continue
        if bi >= 1 and isinstance(rate, (int, float)) and rate > 0:
            out[bi] = float(rate)
    return out


# --- calibration workloads ----------------------------------------------
#
# Deterministic, cheap, and REAL: each builder returns farm request
# objects the backend under test actually dispatches, so the race
# measures the code path production runs.


def _cal_sigs(count: int) -> list:
    import hashlib

    from ..core.signing import Domain, EdSigner
    from ..verify.farm import SigRequest

    s = EdSigner(seed=hashlib.sha256(b"batchtune-sig").digest())
    return [SigRequest(int(Domain.BALLOT), s.public_key,
                       b"cal-%d" % i, s.sign(Domain.BALLOT, b"cal-%d" % i))
            for i in range(count)]


def _cal_vrfs(count: int) -> list:
    import hashlib

    from ..core.signing import EdSigner
    from ..verify.farm import VrfRequest

    vs = EdSigner(seed=hashlib.sha256(b"batchtune-vrf").digest()
                  ).vrf_signer()
    return [VrfRequest(vs.public_key, b"cal-alpha-%d" % i,
                       vs.prove(b"cal-alpha-%d" % i))
            for i in range(count)]


def _cal_memberships(count: int) -> list:
    from ..consensus.poet import merkle_path, merkle_root
    from ..verify.farm import MembershipRequest

    members = [b"cal-member-%d" % k for k in range(16)]
    root = merkle_root(members)
    return [MembershipRequest(members[i % 16],
                              merkle_path(members, i % 16), root, 16)
            for i in range(count)]


def _cal_pows(count: int) -> list:
    import hashlib

    from ..verify.farm import PowRequest

    challenge = hashlib.sha256(b"batchtune-pow-c").digest()
    node = hashlib.sha256(b"batchtune-pow-n").digest()
    # all-ones difficulty: every nonce is a hit, so calibration measures
    # pure hash+compare throughput, no search
    return [PowRequest(challenge, node, bytes([0xFF]) * 32, i)
            for i in range(count)]


_CAL_BUILDERS = {
    "sig": _cal_sigs,
    "vrf": _cal_vrfs,
    "membership": _cal_memberships,
    "pow": _cal_pows,
}


class BatchTuner:
    """Measured per-kind batch-rate model + the speculative dispatch
    policy (module docstring).  ``platform`` keys the persisted rows
    (default: :func:`device_platform` of the card, read on first use;
    the service passes its own device's).  Plugs into VerificationFarm
    via its
    ``tuner=`` hook: the farm calls :meth:`note_arrival` per submit,
    :meth:`observe` per dispatched batch, and consults
    :meth:`target_batch` / :meth:`dispatch_now` when coalescing.

    ``backend(kind, requests) -> verdicts`` is the callable raced by
    :meth:`ensure_raced` (verifyd passes the farm's ``_run_backend``);
    without one, racing is skipped and the model starts from the static
    targets, refined online.  All state is lock-guarded — the farm
    drives it from the event loop, races run on a worker thread.
    """

    def __init__(self, *, backend=None, platform: str | None = None,
                 max_batch: int = 1024,
                 time_source=time.monotonic):
        self._backend = backend
        self._platform = platform
        self.max_batch = max(int(max_batch), 1)
        self._now = time_source
        self._lock = threading.Lock()
        # kind -> {batch: items/s} (persisted rows + online EWMA)
        self._rates: dict[str, dict[int, float]] = {}
        self._loaded: set[str] = set()
        self._raced: set[str] = set()
        # kind -> (last arrival t, EWMA interarrival s)
        self._arrivals: dict[str, tuple[float, float | None]] = {}
        # (kind, bucket) pairs whose FIRST live observation was
        # discarded: the first dispatch at a bucket pays one-time costs
        # (the kernels' build and load, the allocator's first V), and
        # timing that run would model batching as far slower than it is
        self._warmed: set[tuple[str, int]] = set()
        self.stats = {"races": 0, "observations": 0,
                      "discarded_cold": 0,
                      "speculative_dispatches": 0}

    # -- persistence ---------------------------------------------------

    def platform(self) -> str:
        if self._platform is None:
            self._platform = device_platform("cuda")
        return self._platform

    def _rows(self, kind: str) -> dict[int, float]:
        """The model rows for ``kind``, loading persisted measurements
        on first touch (never racing — see ensure_raced)."""
        rows = self._rates.get(kind)
        if rows is None:
            rows = self._rates[kind] = {}
        if kind not in self._loaded:
            self._loaded.add(kind)
            entry = _load_cache().get(_key(self.platform(), kind), {})
            for b, r in _valid_rows(entry.get("raced")).items():
                rows.setdefault(b, r)
        return rows

    def ensure_raced(self, kinds=None) -> dict:
        """Race any kind with no persisted measurements, persist the
        rows, and return ``{kind: {batch: rate}}`` for the raced set.

        Blocking (one backend run per candidate batch): call it from a
        worker thread at service start, never from the event loop.  A
        no-op per kind once measurements exist (persisted or from a
        prior call), when racing is disabled (``SPACEMESH_VERIFYD_TUNE=
        off``), or without a backend."""
        out: dict = {}
        if self._backend is None or not race_enabled():
            return out
        for kind in (kinds if kinds is not None else sorted(CANDIDATES)):
            builder = _CAL_BUILDERS.get(kind)
            if builder is None:
                continue
            with self._lock:
                rows = dict(self._rows(kind))
                if rows or kind in self._raced:
                    continue  # measured already (here or a prior process)
                self._raced.add(kind)
            raced = self._race_kind(kind, builder)
            if not raced:
                continue
            with self._lock:
                self._rows(kind).update(raced)
            _store(_key(self.platform(), kind),
                   {"raced": {str(b): round(r, 1)
                              for b, r in raced.items()},
                    "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime())})
            out[kind] = raced
        return out

    def _race_kind(self, kind: str, builder) -> dict[int, float]:
        from ..core.signing import clear_verify_cache
        from ..utils import metrics, tracing

        metrics.verifyd_batchtune_races.inc()
        self.stats["races"] += 1
        cands = [b for b in CANDIDATES[kind] if b <= self.max_batch] or [1]
        items = builder(max(cands))
        raced: dict[int, float] = {}
        with tracing.span("verifyd.batchtune_race", {"kind": kind}
                          if tracing.is_enabled() else None):
            for b in cands:
                reqs = items[:b]
                try:
                    best = float("inf")
                    for _ in range(CAL_REPS):
                        # the verdict LRU must not subsidize a rep: a
                        # cached race would model cache-hit throughput,
                        # not verification
                        clear_verify_cache()
                        t0 = time.perf_counter()
                        self._backend(kind, reqs)
                        best = min(best, time.perf_counter() - t0)
                    raced[b] = b / max(best, 1e-9)
                except Exception as e:  # noqa: BLE001 — a failing candidate loses the race, it must not kill service start
                    _log(f"verifyd batchtune: {kind}/b={b} failed "
                         f"({type(e).__name__}: {e})")
            if raced:
                best_b = max(raced, key=lambda b: raced[b])
                _log(f"verifyd batchtune: {kind}: "
                     + ", ".join(f"b{b}={raced[b]:,.0f}/s"
                                 for b in sorted(raced))
                     + f" -> target {best_b} (persisted)")
        return raced

    # -- the live model -------------------------------------------------

    def note_arrival(self, kind: str, now: float) -> None:
        """One submitted item (farm submit hook): EWMA interarrival."""
        with self._lock:
            last = self._arrivals.get(kind)
            if last is None:
                self._arrivals[kind] = (now, None)
                return
            t_prev, ia = last
            dt = max(now - t_prev, 1e-6)
            ia = dt if ia is None else (_ARRIVAL_EWMA * dt
                                        + (1 - _ARRIVAL_EWMA) * ia)
            self._arrivals[kind] = (now, ia)

    def arrival_rate(self, kind: str) -> float:
        """Items/s from the interarrival EWMA; 0.0 before two arrivals."""
        with self._lock:
            last = self._arrivals.get(kind)
        if last is None or last[1] is None or last[1] <= 0:
            return 0.0
        return 1.0 / last[1]

    def observe(self, kind: str, batch: int, seconds: float) -> None:
        """One dispatched batch's measured wall cost (farm hook): EWMA
        into the nearest candidate row, so the model tracks the live
        workload even for kinds that were never raced."""
        if batch < 1 or seconds <= 0:
            return
        rate = batch / seconds
        cands = CANDIDATES.get(kind)
        near = (min(cands, key=lambda b: abs(b - batch)) if cands
                else batch)
        with self._lock:
            if (kind, near) not in self._warmed:
                # first observation at this bucket: likely one-time
                # costs — discard it (comment on _warmed)
                self._warmed.add((kind, near))
                self.stats["discarded_cold"] += 1
                return
            rows = self._rows(kind)
            old = rows.get(near)
            rows[near] = rate if old is None else (
                _EWMA * rate + (1 - _EWMA) * old)
            self.stats["observations"] += 1

    def rates(self, kind: str) -> dict[int, float]:
        with self._lock:
            return dict(self._rows(kind))

    NOISE_BAND = 0.90  # rows within 10% of the best rate count as tied

    def target_batch(self, kind: str) -> int:
        """The measured-throughput-optimal batch size for ``kind`` (the
        static default while no measurement exists), capped at
        ``max_batch``.  Among rows within the noise band of the best
        rate the LARGEST batch wins — the inverse of the autotuner's
        fewer-devices tie-break, for the same reason mirrored: small
        calibration batches flatter fixed-overhead amortization, so a
        near-tie at calibration is a real win for the fuller batch at
        service scale (and fewer dispatches is itself a win under
        load)."""
        with self._lock:
            rows = self._rows(kind)
            if rows:
                best_rate = max(rows.values())
                best = max(b for b, r in rows.items()
                           if r >= self.NOISE_BAND * best_rate)
            else:
                best = STATIC_TARGETS.get(kind, self.max_batch)
        return max(1, min(int(best), self.max_batch))

    def service_s(self, kind: str, n: int) -> float | None:
        """Predicted backend seconds for a batch of ``n`` (linear
        interpolation of the measured rate between the bracketing
        rows, clamped outside); None with no measurements."""
        n = max(int(n), 1)
        with self._lock:
            rows = sorted(self._rows(kind).items())
        if not rows:
            return None
        if n <= rows[0][0]:
            return n / rows[0][1]
        if n >= rows[-1][0]:
            return n / rows[-1][1]
        for (b0, r0), (b1, r1) in zip(rows, rows[1:]):
            if b0 <= n <= b1:
                frac = (n - b0) / (b1 - b0)
                return n / (r0 + frac * (r1 - r0))
        return n / rows[-1][1]

    def dispatch_now(self, kind: str, n: int, oldest_age_s: float) -> bool:
        """True when a batch of ``n`` should go NOW rather than linger
        for more arrivals: per-item latency of dispatching immediately
        is no worse than the predicted per-item latency of waiting to
        fill the target batch (fill wait estimated from the arrival
        EWMA).  False defers to the farm's deadline policy — this hook
        only ever dispatches EARLIER."""
        del oldest_age_s  # the lane deadline stays the hard latency cap
        if n <= 0:
            return False
        target = self.target_batch(kind)
        if n >= target:
            return True
        svc_n = self.service_s(kind, n)
        svc_t = self.service_s(kind, target)
        if svc_n is None or svc_t is None:
            # no model yet: dispatch now (the latency-safe default —
            # the first observed batch creates the model)
            self.stats["speculative_dispatches"] += 1
            return True
        arr = self.arrival_rate(kind)
        if arr <= 0.0:
            # no arrival estimate — assume nothing else is coming
            self.stats["speculative_dispatches"] += 1
            return True
        fill_wait = (target - n) / arr
        per_now = svc_n / n
        per_wait = (fill_wait + svc_t) / target
        go = per_now <= per_wait
        if go:
            self.stats["speculative_dispatches"] += 1
        return go
