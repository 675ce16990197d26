"""PoST proving: k2pow gate + streaming nonce search over stored labels.

Port of ``spacemesh_tpu/post/prover.py`` for one device. The default path
is a streaming pipeline:

  read     — a bounded background reader pool (``post/data.py``
             LabelReader) prefetches label batches while the device scans;
  dispatch — up to K batches in flight, each one scan step over the
             window's nonces (``ops/proving.py:prove_scan_step``: the scan
             kernel, then hit compaction and a merge into the running hit
             state, all on the device); a ragged tail is padded to the
             batch size with its pad lanes masked off;
  retire   — the per-batch device-to-host copy is one count vector (one
             count per nonce); the (nonce, index) hits are fetched once
             per pass.

Each disk pass scans a window of ``window_groups`` nonce groups of 16, in
one scan launch per batch (``n_nonces = 16 * window_groups``). A pass stops
early once the winner is decided: the lowest nonce with >= k2 hits, once
every lower nonce provably cannot reach k2 with the labels left. That rule
makes the pipelined proof identical to the serial scan's
(``prove_serial``, which fetches each batch's full mask) at any window.

The knobs are the JAX ``Prover``'s, each with its ``SPACEMESH_PROVE_*``
environment override: ``pipelined`` (``_PIPELINE``, on by default),
``window_groups`` (``_WINDOW_GROUPS``, 1), ``inflight`` (``_INFLIGHT``, 3),
``readers`` (``_READERS``, 2) and ``reader_queue`` (``_QUEUE``, 4); ``fs``
is the injectable I/O layer (``utils/fsio.py``).

A proof for challenge ``ch`` is: nonce (the winning proving nonce), indices
(the first k2 label indices qualifying under it) and pow_nonce (the k2pow
witness for (ch, node_id), ``ops/pow.py``).

The spans are the JAX package's: ``prove.run`` per session,
``prove.k2pow``, ``prove.window`` per disk pass, and per batch
``prove.read_wait``, ``prove.dispatch`` (the engine's), ``prove.retire``
and the readers' ``prove.read_io``, all carrying the pass's ``window``
(its base nonce); ``prove.early_exit`` marks where a pass stopped. While
a window scans, the ``post.prove`` watchdog on ``obs.health.HEALTH``
requires the batch counter to advance within :data:`STALL_DEADLINE_S`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np

from ..device import HostCopy, resolve
from ..obs import health as health_mod
from ..ops import pow as k2pow
from ..ops import proving, scrypt, u32
from ..runtime import engine
from ..utils import metrics, tracing
from .data import LabelStore, PostMetadata

NONCE_GROUP = 16          # nonces per group; a window is G groups
DEFAULT_INFLIGHT = 3      # device batches in flight before the oldest retires
DEFAULT_READERS = 2       # background reader threads
DEFAULT_READER_QUEUE = 4  # prefetched batches before reader backpressure
MAX_GROUPS = 1025         # nonce search gives up past this many groups
# the post.prove watchdog's deadline (obs/health.py)
STALL_DEADLINE_S = 30.0


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class Proof:
    nonce: int
    indices: list[int]          # k2 qualifying label indices, ascending
    pow_nonce: int
    k2: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Proof":
        return cls(**d)


@dataclasses.dataclass
class ProofParams:
    """Difficulty parameters (reference defaults activation/post.go:148,
    mainnet config/mainnet.go:187-189)."""

    k1: int = 26
    k2: int = 37
    k3: int = 37
    pow_difficulty: bytes = bytes([0, 255]) + bytes([255]) * 30


@dataclasses.dataclass
class ProverStats:
    """Per-prove pipeline accounting."""

    windows: int = 0          # disk passes (one nonce window each)
    batches: int = 0          # label batches dispatched
    labels_swept: int = 0     # labels covered across all passes
    read_wait_s: float = 0.0  # blocked on the reader pool
    read_io_s: float = 0.0    # filesystem time inside the reader pool
    dispatch_s: float = 0.0   # host time converting + enqueueing batches
    retire_s: float = 0.0     # blocked fetching per-batch count vectors
    d2h_bytes: int = 0        # compacted device->host traffic
    early_exited: bool = False
    elapsed_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Prover:
    def __init__(self, data_dir: str | Path, params: ProofParams | None = None,
                 batch_labels: int = 1 << 14,
                 pipelined: bool | None = None,
                 window_groups: int | None = None,
                 inflight: int | None = None,
                 readers: int | None = None,
                 reader_queue: int | None = None,
                 fs=None, device="cuda"):
        self.device = resolve(device)
        self.stall_deadline_s = STALL_DEADLINE_S
        self.meta = PostMetadata.load(data_dir, fs=fs)
        if self.meta.labels_written < self.meta.total_labels:
            raise ValueError("POST data is not fully initialized")
        self.store = LabelStore(data_dir, self.meta, fs=fs)
        self.params = params or ProofParams()
        # every batch of a pass has one size, a multiple of the segment
        seg = proving.HIT_SEGMENT
        self.batch_labels = -(-max(batch_labels, seg) // seg) * seg
        if pipelined is None:
            pipelined = os.environ.get(
                "SPACEMESH_PROVE_PIPELINE", "1") not in ("0", "off")
        self.pipelined = pipelined
        self.window_groups = max(
            window_groups if window_groups is not None
            else _env_int("SPACEMESH_PROVE_WINDOW_GROUPS", 1), 1)
        self.inflight = max(inflight if inflight is not None
                            else _env_int("SPACEMESH_PROVE_INFLIGHT",
                                          DEFAULT_INFLIGHT), 1)
        self.readers = max(readers if readers is not None
                           else _env_int("SPACEMESH_PROVE_READERS",
                                         DEFAULT_READERS), 1)
        self.reader_queue = max(reader_queue if reader_queue is not None
                                else _env_int("SPACEMESH_PROVE_QUEUE",
                                              DEFAULT_READER_QUEUE), 1)
        self.last_stats: ProverStats | None = None

    # -- entry points -------------------------------------------------------

    def prove(self, challenge: bytes) -> Proof:
        if self.pipelined:
            return self._prove_pipelined(challenge, None)
        return self.prove_serial(challenge)

    def session(self, challenge: bytes, tenant: str = "-"
                ) -> "ProveSession":
        """A resumable streaming prove: each ``step()`` is one quantum (the
        k2pow gate first, then one disk pass per nonce window), so the
        multi-tenant scheduler can run other tenants' work between windows
        (``runtime/scheduler.py``). ``tenant`` labels the runtime
        metrics."""
        return ProveSession(self, challenge, tenant=tenant)

    def _prove_pipelined(self, challenge: bytes,
                         pow_nonce: int | None) -> Proof:
        """Drive a session to completion; a given ``pow_nonce`` pre-pays
        the k2pow gate (the comparator's entry, ``post/workload.py``)."""
        session = self.session(challenge)
        session.pow_nonce = pow_nonce
        try:
            while True:
                proof = session.step()
                if proof is not None:
                    return proof
        finally:
            session.close()

    def prove_serial(self, challenge: bytes) -> Proof:
        """The synchronous scan: read -> scan -> full-mask fetch -> host
        nonzero per group."""
        try:
            return self._prove_serial(challenge, self._pow(challenge))
        finally:
            self.store.close()

    def _pow(self, challenge: bytes, parent: int | None = None) -> int:
        with tracing.span("prove.k2pow", parent=parent):
            pow_nonce = k2pow.search(challenge,
                                     bytes.fromhex(self.meta.node_id),
                                     self.params.pow_difficulty,
                                     device=self.device)
        if pow_nonce is None:
            raise RuntimeError("k2pow search exhausted")
        return pow_nonce

    # -- serial path --------------------------------------------------------

    def _prove_serial(self, challenge: bytes, pow_nonce: int) -> Proof:
        meta, p = self.meta, self.params
        t = proving.threshold_u32(p.k1, meta.total_labels)
        ng = NONCE_GROUP
        group = 0
        while True:
            hits: list[list[int]] = [[] for _ in range(ng)]
            start = 0
            while start < meta.total_labels:
                count = min(self.batch_labels, meta.total_labels - start)
                idx = np.arange(start, start + count, dtype=np.uint64)
                labels = np.frombuffer(
                    self.store.read_labels(start, count), dtype=np.uint8
                ).reshape(count, scrypt.LABEL_BYTES)
                mask = proving.proving_scan(challenge, group * ng, idx,
                                            labels, t, n_nonces=ng,
                                            device=self.device)
                for k in range(ng):
                    if len(hits[k]) < p.k2:
                        found = np.nonzero(mask[k])[0]
                        hits[k].extend((start + found).tolist())
                start += count
            for k in range(ng):
                if len(hits[k]) >= p.k2:
                    return Proof(nonce=group * ng + k,
                                 indices=[int(i) for i in hits[k][:p.k2]],
                                 pow_nonce=pow_nonce, k2=p.k2)
            group += 1
            if group > MAX_GROUPS - 1:
                raise RuntimeError("no winning nonce found (k1/k2 mismatch?)")

    # -- streaming pipeline -------------------------------------------------

    def _scan_window(self, cw, thr: int, nonce_base: int, groups: int,
                     stats: ProverStats, tenant: str = "-",
                     parent: int | None = None):
        """One disk pass over the store scanning the ``groups * 16`` nonces
        from ``nonce_base``, in one scan launch per batch. Returns
        (winner_nonce, indices) or (None, None). ``parent`` is the
        session's span."""
        meta, p = self.meta, self.params
        dev = self.device
        total = meta.total_labels
        b = self.batch_labels
        cap = max(p.k2, 1)
        nn = groups * NONCE_GROUP
        traced = tracing.is_enabled()
        wsp = tracing.span("prove.window",
                           {"window": nonce_base, "groups": groups,
                            "labels": total} if traced else None,
                           parent=parent)
        wsp.__enter__()
        reader = None
        try:
            ranges = [(s, min(b, total - s)) for s in range(0, total, b)]
            state = list(proving.init_hit_state(nn, cap, dev))
            host_counts = np.zeros(nn, dtype=np.int64)
            stats.windows += 1
            retired_end = [0]
            reader = self.store.start_reader(ranges, self.readers,
                                             self.reader_queue)

            def dispatch(item):
                start, count = item
                tr = time.perf_counter()
                with tracing.span("prove.read_wait",
                                  {"window": nonce_base, "start": start}
                                  if traced else None):
                    raw = reader.get()
                stats.read_wait_s += time.perf_counter() - tr
                labels = np.frombuffer(raw, dtype=np.uint8).reshape(
                    count, scrypt.LABEL_BYTES)
                if count < b:  # pad: one batch size per pass
                    labels = np.concatenate([
                        labels, np.zeros((b - count, scrypt.LABEL_BYTES),
                                         np.uint8)])
                lo, hi = scrypt.split_indices(
                    np.arange(start, start + b, dtype=np.uint64))
                counts, bc, carry = proving.prove_scan_step(
                    cw, nonce_base, u32.from_numpy(lo, dev),
                    u32.from_numpy(hi, dev),
                    u32.from_numpy(scrypt.labels_to_words(labels), dev),
                    thr, state[0], state[1], count, start & 0xFFFFFFFF,
                    start >> 32, n_nonces=nn, max_hits=cap)
                state[:] = [counts, carry]
                stats.batches += 1
                return start + count, HostCopy(bc)

            def retire(ticket):
                retired_end[0] = ticket[0]
                if self._retire(ticket, host_counts, total, stats,
                                nonce_base):
                    return ticket[0]  # sound early exit: scanned_end
                return None

            pipe = engine.Pipeline(
                kind="prove", tenant=tenant, inflight=self.inflight,
                span="prove",
                attrs=lambda it: {"window": nonce_base, "start": it[0],
                                  "count": it[1]})
            rw0 = stats.read_wait_s
            res = pipe.run(ranges, dispatch, retire)
            exited = res is not None
            stats.dispatch_s += max(
                pipe.stats.dispatch_s - (stats.read_wait_s - rw0), 0.0)
            scanned = retired_end[0] if exited else total
        finally:
            if reader is not None:
                reader.close()
                stats.read_io_s += reader.read_seconds
            wsp.__exit__(None, None, None)
        if exited:
            stats.early_exited = True
        stats.labels_swept += scanned
        qualified = np.nonzero(host_counts >= p.k2)[0]
        if qualified.size == 0:
            return None, None
        w = int(qualified[0])
        counts, carry = state
        indices = proving.decode_hits(counts, carry, w, p.k2)
        stats.d2h_bytes += (carry.numel() + counts.numel()) * 4
        return nonce_base + w, indices

    def _retire(self, item, host_counts, total, stats,
                nonce_base: int = 0) -> bool:
        """Fold one batch's per-nonce counts in; True on a sound early
        exit: some nonce has k2 hits and every lower nonce of the window
        cannot reach k2 with the labels left in this pass."""
        scanned_end, bc = item
        p = self.params
        tr = time.perf_counter()
        with tracing.span("prove.retire",
                          {"window": nonce_base, "end": scanned_end}
                          if tracing.is_enabled() else None):
            vec = bc.get().numpy()
            host_counts += vec
        stats.d2h_bytes += vec.nbytes
        stats.retire_s += time.perf_counter() - tr
        qualified = host_counts >= p.k2
        if not qualified.any():
            return False
        w = int(np.argmax(qualified))
        remaining = total - scanned_end
        exit_now = bool(np.all(host_counts[:w] + remaining < p.k2))
        if exit_now:
            # where the pass stopped, on the timeline
            tracing.instant("prove.early_exit",
                            {"window": nonce_base, "nonce": nonce_base + w,
                             "scanned": scanned_end}
                            if tracing.is_enabled() else None)
        return exit_now


class ProveSession:
    """One resumable streaming prove over an initialized store.

    ``step()`` runs one quantum (the k2pow gate on the first call, then one
    disk pass per nonce window) and returns the Proof once decided.
    ``close()`` is idempotent and must run on every path: it ends the
    ``prove.run`` span, unregisters the ``post.prove`` watchdog and drops
    the store's cached read fds."""

    def __init__(self, prover: Prover, challenge: bytes, tenant: str = "-"):
        self.prover = prover
        self.challenge = challenge
        self.tenant = tenant
        self.stats = ProverStats()
        prover.last_stats = self.stats
        self.pow_nonce: int | None = None
        self.proof: Proof | None = None
        self._t0 = time.monotonic()
        self._base = 0
        self._max_nonce = MAX_GROUPS * NONCE_GROUP
        self._closed = False
        self._scanning = False
        self._span = tracing.span(
            "prove.run",
            {"challenge": challenge.hex()[:16],
             "labels": prover.meta.total_labels, "tenant": tenant}
            if tracing.is_enabled() else None).begin()
        # detached: a scheduler may step and close the session on another
        # worker thread than the one that opened it; close() ends it on
        # every path
        # liveness: progress advances per batch, and only while a window
        # scans (a session parked between quanta, or searching k2pow, has
        # no batch counter to advance)
        self._wd = health_mod.Watchdog(
            "post.prove",
            progress=lambda: (self.stats.batches, self.stats.labels_swept),
            deadline_s=prover.stall_deadline_s,
            active=lambda: self._scanning)
        health_mod.HEALTH.register("post.prove", self._wd.check)

    def step(self) -> Proof | None:
        if self._closed:
            raise RuntimeError("prove session is closed")
        if self.proof is not None:
            return self.proof
        p = self.prover
        if self.pow_nonce is None:
            self.pow_nonce = p._pow(self.challenge, parent=self._span.id)
            return None
        if self._base >= self._max_nonce:
            raise RuntimeError("no winning nonce found (k1/k2 mismatch?)")
        thr = proving.threshold_u32(p.params.k1, p.meta.total_labels)
        cw = proving.challenge_words(self.challenge)
        # clamp the last window to the serial prover's give-up bound, so
        # both paths search the same nonce range
        groups = min(p.window_groups,
                     (self._max_nonce - self._base) // NONCE_GROUP)
        tw = time.perf_counter()
        self._scanning = True
        try:
            winner, indices = p._scan_window(cw, thr, self._base, groups,
                                             self.stats, tenant=self.tenant,
                                             parent=self._span.id)
        finally:
            self._scanning = False
        metrics.post_prove_window_seconds.observe(time.perf_counter() - tw)
        self._base += groups * NONCE_GROUP
        if winner is None:
            return None
        self.proof = Proof(nonce=winner, indices=indices,
                           pow_nonce=self.pow_nonce, k2=p.params.k2)
        return self.proof

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        health_mod.HEALTH.unregister("post.prove", self._wd.check)
        self._span.end()
        self.stats.elapsed_s = time.monotonic() - self._t0
        self.prover.store.close()
