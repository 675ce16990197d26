"""Windowed service-level indicators over the metrics registry (port of
``spacemesh_tpu/obs/sli.py``, the same specs, names and arithmetic).

Cumulative counters and since-boot histograms answer "how much, ever";
an SLO needs "how is it going NOW". The :class:`SliSampler` snapshots
the whole registry (``Registry.sample()``) on an interval and computes
each SLI from the DELTA between the newest snapshot and the one at the
far edge of a rolling window:

* ``rate``      — counter delta / elapsed seconds (e.g. init labels/s);
* ``quantile``  — p50/p95/p99 linearly interpolated from histogram
                  bucket-count deltas (the standard
                  ``histogram_quantile`` estimator, applied to the
                  window's observations only);
* ``gauge``     — the newest sampled value (loop lag, RSS).

Counter resets (a restarted process re-registering from zero) make a
delta negative; the window is then truncated to "since the reset" by
using the newest cumulative values alone. An empty window (no snapshots
old enough, or zero observations in the delta) yields ``None`` — absence
of data is not a number, and SLO evaluation treats it as unknown rather
than healthy-by-default-zero.

Runtime collectors registered here via the registry's scrape-time hook
(``Registry.add_collector``) keep process RSS and open-fd gauges honest
at observation time. The verifyd fleet's router folds ``fleet_slis``
into its load scores and autoscaling signal
(``verifyd/fleet.py:FleetRouter.update_signals``).
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import threading
import time
from collections import deque

from ..utils import metrics

DEFAULT_WINDOW_S = 60.0
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


# --- quantile interpolation from bucket deltas --------------------------


def quantile_from_buckets(bounds, counts, q: float) -> float | None:
    """``histogram_quantile``: interpolate the q-quantile from cumulative
    bucket ``counts`` at upper ``bounds`` (le semantics, last bound may
    be +Inf). Returns None when the distribution is empty.

    Within a bucket the observations are assumed uniform (linear
    interpolation); a quantile landing in the +Inf bucket clamps to the
    highest finite bound — the estimator cannot know more than the
    layout recorded.
    """
    if not counts or counts[-1] <= 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = counts[-1]
    rank = q * total
    # first bucket whose cumulative count reaches the rank
    i = bisect.bisect_left(counts, rank)
    while i < len(counts) and counts[i] <= 0:
        i += 1  # bisect on rank 0.0: skip leading empty buckets
    i = min(i, len(counts) - 1)
    hi = bounds[i]
    if hi == float("inf"):
        # the +Inf bucket has no width to interpolate in; clamp to the
        # highest finite bound (Prometheus does the same)
        return float(bounds[i - 1]) if i > 0 else 0.0
    lo = float(bounds[i - 1]) if i > 0 else 0.0
    below = counts[i - 1] if i > 0 else 0
    in_bucket = counts[i] - below
    if in_bucket <= 0:
        return float(hi)
    frac = (rank - below) / in_bucket
    return lo + (float(hi) - lo) * min(max(frac, 0.0), 1.0)


# --- SLI specifications -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SliSpec:
    """One indicator: which instrument, how to reduce it, over what.

    ``labels`` is a labelset filter as a sorted item tuple
    (``(("kind", "sig"),)``): an exact labelset matches directly, and
    otherwise every series CONTAINING those items aggregates (bucket
    deltas sum, counter deltas sum) — so ``(("client", "a"),)`` covers
    all of one verifyd client's ``{client=a, kind=...}`` series.
    ``None`` aggregates across every labelset of the instrument.
    """

    name: str
    metric: str
    kind: str                      # "quantile" | "rate" | "gauge"
    q: float = 0.99
    labels: tuple | None = None


def quantile_slis(metric: str, prefix: str,
                  quantiles=DEFAULT_QUANTILES,
                  labels: tuple | None = None) -> list[SliSpec]:
    """p50/p95/p99 spec triple for one histogram."""
    return [SliSpec(name=f"{prefix}_p{int(q * 100)}", metric=metric,
                    kind="quantile", q=q, labels=labels)
            for q in quantiles]


def default_slis() -> list[SliSpec]:
    """The node-wide indicator set: layer apply, farm queue
    wait + dispatch (aggregate and per hot kind), prove window time,
    gossip handler latency, init labels/s, plus the runtime gauges."""
    specs: list[SliSpec] = []
    specs += quantile_slis("layer_apply_seconds", "layer_apply")
    specs += quantile_slis("verify_farm_queue_wait_seconds",
                           "farm_queue_wait")
    specs += quantile_slis("verify_farm_dispatch_seconds", "farm_dispatch")
    for kind in ("sig", "post"):
        key = (("kind", kind),)
        specs.append(SliSpec(name=f"farm_dispatch_{kind}_p95",
                             metric="verify_farm_dispatch_seconds",
                             kind="quantile", q=0.95, labels=key))
        specs.append(SliSpec(name=f"farm_queue_wait_{kind}_p95",
                             metric="verify_farm_queue_wait_seconds",
                             kind="quantile", q=0.95, labels=key))
    specs += quantile_slis("post_prove_window_seconds", "prove_window")
    specs += quantile_slis("gossip_handler_seconds", "gossip_handler")
    specs.append(SliSpec(name="init_labels_per_sec",
                         metric="post_pipeline_labels_total", kind="rate"))
    specs.append(SliSpec(name="event_loop_lag",
                         metric="runtime_event_loop_lag_seconds",
                         kind="gauge"))
    specs.append(SliSpec(name="process_rss_bytes",
                         metric="process_resident_memory_bytes",
                         kind="gauge"))
    return specs


def verifyd_slis() -> list[SliSpec]:
    """The verification service's indicator set (docs/VERIFYD.md):
    admitted-request latency quantiles per lane (the overload SLO
    constrains the BLOCK lane), admission/shed rates, pending depth."""
    specs: list[SliSpec] = []
    specs += quantile_slis("verifyd_request_seconds", "verifyd_request")
    for lane in ("block", "gossip", "sync"):
        specs.append(SliSpec(name=f"verifyd_request_{lane}_p99",
                             metric="verifyd_request_seconds",
                             kind="quantile", q=0.99,
                             labels=(("lane", lane),)))
    specs.append(SliSpec(name="verifyd_items_per_sec",
                         metric="verifyd_items_total", kind="rate"))
    specs.append(SliSpec(name="verifyd_shed_per_sec",
                         metric="verifyd_shed_total", kind="rate"))
    specs.append(SliSpec(name="verifyd_pending_items",
                         metric="verifyd_pending_items", kind="gauge"))
    return specs


def failover_slis() -> list[SliSpec]:
    """The failover verifier's indicator set (verifyd/failover.py): the
    latency the NODE saw regardless of serving path — the signal that
    must stay green straight through a verifyd outage (the BLOCK-lane
    p99 is the verifyd-outage scenario's acceptance SLO) — plus
    per-path request rates that make a failover visible as a rate
    crossover."""
    specs: list[SliSpec] = []
    specs += quantile_slis("failover_verify_seconds", "failover_verify")
    for lane in ("block", "gossip", "sync"):
        specs.append(SliSpec(name=f"failover_{lane}_p99",
                             metric="failover_verify_seconds",
                             kind="quantile", q=0.99,
                             labels=(("lane", lane),)))
    for path in ("remote", "local", "local_fastfail"):
        specs.append(SliSpec(name=f"failover_{path}_per_sec",
                             metric="failover_requests_total",
                             kind="rate", labels=(("path", path),)))
    return specs


def fleet_slis(replicas=()) -> list[SliSpec]:
    """The verifyd fleet's indicator set (verifyd/fleet.py): the
    latency the NODE saw whatever replica (or local path) served it —
    the BLOCK-lane p99 is the fleet sim's acceptance SLO — plus the
    per-replica load signals FleetRouter.update_signals() turns into
    work-steal decisions and the ``fleet_desired_replicas`` autoscaling
    gauge: each replica's queue-wait p99 and shed rate, named exactly
    ``fleet_replica_{name}_queue_p99`` / ``fleet_replica_{name}_
    shed_per_sec`` (the router looks them up by that contract)."""
    specs: list[SliSpec] = []
    specs += quantile_slis("fleet_verify_seconds", "fleet_verify")
    for lane in ("block", "gossip", "sync"):
        specs.append(SliSpec(name=f"fleet_{lane}_p99",
                             metric="fleet_verify_seconds",
                             kind="quantile", q=0.99,
                             labels=(("lane", lane),)))
    for path in ("remote", "local", "local_fastfail"):
        specs.append(SliSpec(name=f"fleet_{path}_per_sec",
                             metric="fleet_requests_total",
                             kind="rate", labels=(("path", path),)))
    for name in replicas:
        key = (("replica", str(name)),)
        specs.append(SliSpec(
            name=f"fleet_replica_{name}_queue_p99",
            metric="fleet_replica_verify_seconds",
            kind="quantile", q=0.99, labels=key))
        specs.append(SliSpec(
            name=f"fleet_replica_{name}_shed_per_sec",
            metric="fleet_replica_sheds_total",
            kind="rate", labels=key))
    specs.append(SliSpec(name="fleet_desired_replicas",
                         metric="fleet_desired_replicas", kind="gauge"))
    return specs


def verifyd_client_slis(clients) -> list[SliSpec]:
    """Per-client indicators for the given client ids — each spec's
    labelset filter aggregates every series carrying that ``client``
    label (admitted items/s, sheds/s, pending depth). The caller scopes
    the list (e.g. the service's registered clients at engine build
    time): specs are static, clients churn."""
    specs: list[SliSpec] = []
    for cid in clients:
        key = (("client", str(cid)),)
        specs.append(SliSpec(name=f"verifyd_client_{cid}_items_per_sec",
                             metric="verifyd_items_total", kind="rate",
                             labels=key))
        specs.append(SliSpec(name=f"verifyd_client_{cid}_shed_per_sec",
                             metric="verifyd_shed_total", kind="rate",
                             labels=key))
        specs.append(SliSpec(name=f"verifyd_client_{cid}_pending",
                             metric="verifyd_client_pending_items",
                             kind="gauge", labels=key))
    return specs


# --- the sampler --------------------------------------------------------


class SliSampler:
    """Rolling snapshots of one registry + windowed SLI computation.

    ``sample(now)`` is called by the embedder's tick (the fleet drills
    on their virtual clock, ``chip_smoke.py`` after a run) — nothing
    here sleeps or schedules.
    Snapshots older than ``window_s`` plus one sampling slack are
    dropped, so memory is bounded by window/interval.
    """

    def __init__(self, registry: metrics.Registry = metrics.REGISTRY,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_samples: int = 256):
        self.registry = registry
        self.window_s = float(window_s)
        self._snaps: deque = deque(maxlen=max(int(max_samples), 2))
        self._lock = threading.Lock()

    def sample(self, now: float | None = None) -> None:
        """Take one registry snapshot stamped ``now`` (monotonic)."""
        t = time.monotonic() if now is None else float(now)
        snap = self.registry.sample()
        with self._lock:
            self._snaps.append((t, snap))
            # keep one snapshot beyond the window edge so a full window
            # is always spannable
            while (len(self._snaps) > 2
                   and self._snaps[1][0] <= t - self.window_s):
                self._snaps.popleft()

    def _edges(self):
        """(old, new) snapshots spanning the window, or None.

        The old edge is the LATEST snapshot at or beyond the window
        start (delta covers a full window); with nothing that old yet,
        the oldest snapshot available (a partial, honest window)."""
        with self._lock:
            if len(self._snaps) < 2:
                return None
            snaps = list(self._snaps)
        new_t, new = snaps[-1]
        edge = new_t - self.window_s
        old_t, old = snaps[0]
        for t, s in snaps[:-1]:
            if t <= edge:
                old_t, old = t, s
            else:
                break
        if old_t >= new_t:
            return None
        return (old_t, old), (new_t, new)

    @staticmethod
    def _sum_counter(data: dict, labels: tuple | None) -> float | None:
        if labels is not None:
            exact = data.get(labels)
            if exact is not None:
                return exact
            # subset semantics: aggregate every series containing the
            # filter items (a per-entity SLI over multi-label series)
            items = set(labels)
            vals = [v for k, v in data.items()
                    if items.issubset(set(k))]
            return sum(vals) if vals else None
        return sum(data.values()) if data else None

    @staticmethod
    def _sum_hist(data: dict, labels: tuple | None):
        """-> (bucket counts, total count) aggregated per the filter
        (exact labelset first, else every series containing it)."""
        series = data["series"]
        if labels is not None:
            s = series.get(labels)
            if s is not None:
                return (list(s[0]), s[2])
            items = set(labels)
            picked = [s for k, s in series.items()
                      if items.issubset(set(k))]
        else:
            picked = list(series.values())
        agg = None
        total = 0
        for counts, _sum, n in picked:
            if agg is None:
                agg = list(counts)
            else:
                agg = [a + c for a, c in zip(agg, counts)]
            total += n
        return (agg, total) if agg is not None else None

    def compute(self, spec: SliSpec) -> float | None:
        """The spec's current windowed value, or None (no data)."""
        if spec.kind == "gauge":
            # gauges are instantaneous: newest snapshot alone suffices
            with self._lock:
                if not self._snaps:
                    return None
                _, snap = self._snaps[-1]
            ent = snap.get(spec.metric)
            if ent is None or ent[0] != "gauge":
                return None
            return self._sum_counter(ent[1], spec.labels)
        edges = self._edges()
        if edges is None:
            return None
        (old_t, old), (new_t, new) = edges
        ent_new = new.get(spec.metric)
        if ent_new is None:
            return None
        kind, data_new = ent_new
        ent_old = old.get(spec.metric)
        data_old = ent_old[1] if ent_old is not None else None
        if spec.kind == "rate":
            # a counter that EXISTS but saw no increments is rate 0.0
            # (an idle pipeline), not unknown — only a missing metric is
            nv = self._sum_counter(data_new, spec.labels) or 0.0
            ov = (self._sum_counter(data_old, spec.labels)
                  if data_old is not None else None) or 0.0
            if nv < ov:
                ov = 0.0  # counter reset: window truncates to the restart
            return (nv - ov) / (new_t - old_t)
        if spec.kind == "quantile":
            if kind != "histogram":
                return None
            hn = self._sum_hist(data_new, spec.labels)
            if hn is None:
                return None
            counts_new, _ = hn
            ho = (self._sum_hist(data_old, spec.labels)
                  if ent_old is not None and ent_old[0] == "histogram"
                  else None)
            if ho is not None and len(ho[0]) == len(counts_new):
                deltas = [n - o for n, o in zip(counts_new, ho[0])]
                if any(d < 0 for d in deltas):
                    deltas = counts_new  # reset: since-restart window
            else:
                deltas = counts_new
            return quantile_from_buckets(data_new["buckets"], deltas,
                                         spec.q)
        raise ValueError(f"unknown SLI kind {spec.kind!r}")

    def values(self, specs) -> dict[str, float | None]:
        return {spec.name: self.compute(spec) for spec in specs}


# --- runtime collectors (scrape-time hooks) -----------------------------

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _collect_rss() -> None:
    try:
        with open("/proc/self/statm", "rb") as f:
            rss_pages = int(f.read().split()[1])
        metrics.process_rss_bytes.set(rss_pages * _PAGE)
    except (OSError, ValueError, IndexError):
        try:  # non-procfs fallback: peak RSS is better than nothing
            import resource

            metrics.process_rss_bytes.set(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
        except Exception:  # noqa: BLE001
            pass


def _collect_fds() -> None:
    try:
        metrics.process_open_fds.set(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass


def register_runtime_collectors(
        registry: metrics.Registry = metrics.REGISTRY) -> None:
    """Attach the process-level collectors to ``registry`` (idempotent
    per registry instance; the marker lives ON the object — an id()-
    keyed set would confuse a new registry reusing a dead one's
    address)."""
    if getattr(registry, "_runtime_collectors_attached", False):
        return
    registry._runtime_collectors_attached = True
    # spacecheck: ok=SC004 idempotence-guarded just above (attribute marker on the registry)
    registry.add_collector(_collect_rss)
    registry.add_collector(_collect_fds)  # spacecheck: ok=SC004 same attribute-marker guard
