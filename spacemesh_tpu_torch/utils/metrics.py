"""Metrics: counters, gauges and histograms with Prometheus text exposition.

Port of ``spacemesh_tpu/utils/metrics.py``: the instrument types, the
registry and the exposition format, with the same names, labels and
buckets. Only the instruments the port records are defined here: the
node's public gauges (``node_current_layer``, ``tortoise_verified_layer``,
``mesh_last_applied_layer``, ``p2p_connected_peers``, ``sync_state``,
``tortoise_mode``; set on each scrape of ``api/http.py``'s ``/metrics``)
and ``post_proofs_generated``; the init pipeline's ``post_pipeline_*`` and
the prover's ``post_prove_*`` families; the device mesh's ``post_mesh_*``
and the ROMix autotuner's ``post_romix_autotune_races_total``; the
``post_store_*`` family
(label-store reads, fsyncs, fault injections, recovery, ENOSPC parking);
the ``runtime_*`` family (the device-job engine and the multi-tenant
scheduler, ``runtime/``); the CUDA caching allocator's cudaMalloc calls
(``device_allocator_calls``, set by ``device.py``'s collector); the
verification farm's and verifyd's, the breakers' and the verifyd fleet's
(``failover_*``, ``fleet_*``, ``federated_procs``); the
instrumentation's: the span tracer's capture state (``trace_*``), the
sanitizers' (``sanitize_violations_total``), the
health engine's (``slo_*``, ``component_*``, the event-loop lag), the
flight recorder's (``flight_bundles_total``), the remediation engine's and
the engine's host fallbacks (``runtime_fallbacks_total``); gossip's and
the state database's (``pubsub_handler_drops_total``,
``gossip_handler_seconds``; the per-role ``sql_<role>_query_seconds`` and
``sql_<role>_queries``, made by ``storage/db.py``); the mesh's
``layer_apply_seconds``, and the node's event bus
(``events_subscription_overflows_total``, ``events_queue_depth``).
``Registry.sample()`` and
scrape-time collectors feed the windowed SLIs (``obs/sli.py``).

Every instrument's series map is declared shared to the lockset
sanitizer (``utils/sanitize.py``, ``race``), and the registry asserts
that instruments are created on the thread that built it
(``registry-thread``), as in the JAX package.
"""

from __future__ import annotations

import threading
from collections import defaultdict

from . import sanitize


def _escape(value) -> str:
    """Escape a label VALUE per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped inside the
    quoted value, or one peer id / reason string containing a quote
    corrupts the entire /metrics scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(labels) -> str:
    return ",".join(f'{k}="{_escape(v)}"' for k, v in labels)


class _Instrument:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        # series maps are DECLARED SHARED to the lockset sanitizer
        # (SPACEMESH_SANITIZE=race): every access must hold this lock,
        # which the tracked twin feeds into the per-thread held-lockset
        self._lock = sanitize.lock(f"metrics.{name}")
        self._shared = sanitize.SharedField(f"metrics.{name}.series")

    def _series_map(self) -> dict:
        return self._values  # Histogram overrides (its map is _series)

    def remove_matching(self, **labels) -> int:
        """Drop every labelset containing these label items (all of a gone
        tenant's series, whatever labels ride with it): when the entity
        goes away, all of its series must leave the scrape, or a churn of
        short-lived clients grows the registry without bound. Returns the
        number of series removed."""
        items = set(labels.items())
        with self._lock:
            self._shared.touch()
            m = self._series_map()
            gone = [k for k in m if items.issubset(set(k))]
            for k in gone:
                del m[k]
        return len(gone)


class Counter(_Instrument):
    def __init__(self, name, help_=""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._shared.touch()
            self._values[tuple(sorted(labels.items()))] += value

    def sample(self) -> dict[tuple, float]:
        """Point-in-time {labelset: value} snapshot (obs/sli.py sampler)."""
        with self._lock:
            self._shared.touch(write=False)
            return dict(self._values)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            for labels, v in self._values.items():
                lbl = _labelstr(labels)
                out.append(f"{self.name}{{{lbl}}} {v}" if lbl
                           else f"{self.name} {v}")
        return out


class Gauge(_Instrument):
    def __init__(self, name, help_=""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._shared.touch()
            self._values[tuple(sorted(labels.items()))] = value

    def remove(self, **labels) -> None:
        """Drop one labelset's series — a gauge describing something
        that no longer exists (an unregistered health component) must
        disappear from the scrape, not pin its last value forever."""
        with self._lock:
            self._shared.touch()
            self._values.pop(tuple(sorted(labels.items())), None)

    def sample(self) -> dict[tuple, float]:
        with self._lock:
            self._shared.touch(write=False)
            return dict(self._values)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            for labels, v in self._values.items():
                lbl = _labelstr(labels)
                out.append(f"{self.name}{{{lbl}}} {v}" if lbl
                           else f"{self.name} {v}")
        return out


class Histogram(_Instrument):
    """Bucketed distribution with label support: each distinct labelset
    carries its own buckets/sum/count series (like Counter/Gauge), so
    e.g. verify-farm dispatch timings split per request kind instead of
    blending signatures and POST proofs into one histogram."""

    DEFAULT_BUCKETS = (0.005, 0.05, 0.5, 5.0, 50.0, float("inf"))

    def __init__(self, name, help_="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(buckets)
        # labelset -> [per-bucket counts, sum, count]
        self._series: dict[tuple, list] = {}

    def _series_map(self) -> dict:
        return self._series

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._shared.touch()
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * len(self.buckets), 0.0, 0]
            s[1] += value
            s[2] += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s[0][i] += 1

    def sample(self) -> dict[tuple, tuple[list, float, int]]:
        """{labelset: (cumulative bucket counts, sum, count)} snapshot."""
        with self._lock:
            self._shared.touch(write=False)
            return {k: (list(s[0]), s[1], s[2])
                    for k, s in self._series.items()}

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            series = [(k, [list(s[0]), s[1], s[2]])
                      for k, s in self._series.items()]
        for labels, (counts, sum_, n) in series:
            base = _labelstr(labels)
            sep = "," if base else ""
            for b, c in zip(self.buckets, counts):
                le = "+Inf" if b == float("inf") else b
                out.append(f'{self.name}_bucket{{{base}{sep}le="{le}"}} {c}')
            out.append(f"{self.name}_sum{{{base}}} {sum_}" if base
                       else f"{self.name}_sum {sum_}")
            out.append(f"{self.name}_count{{{base}}} {n}" if base
                       else f"{self.name}_count {n}")
        return out


class Registry:
    def __init__(self) -> None:
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: list = []
        self._lock = sanitize.lock("metrics.registry")
        self._shared = sanitize.SharedField("metrics.registry.instruments")
        # the owning thread: instrument CREATION belongs at module
        # import on this thread; recording is thread-safe from anywhere.
        # The runtime sanitizer (utils/sanitize.py, SPACEMESH_SANITIZE)
        # asserts this affinity on the create branch of _get.
        self._created_thread = threading.get_ident()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "", buckets=None) -> Histogram:
        inst = self._get(
            name, lambda: Histogram(name, help_,
                                    buckets or Histogram.DEFAULT_BUCKETS),
            Histogram)
        # re-registering with DIFFERENT buckets used to silently return
        # the original instrument — the caller would then record into a
        # bucket layout it never asked for and every quantile computed
        # from the deltas would be wrong without a trace
        if buckets is not None and tuple(buckets) != inst.buckets:
            raise ValueError(
                f"histogram {name} already registered with buckets "
                f"{inst.buckets}, re-registration asked for "
                f"{tuple(buckets)}")
        return inst

    def _get(self, name, factory, cls):
        with self._lock:
            self._shared.touch()
            inst = self._instruments.get(name)
            if inst is None:
                sanitize.on_instrument_create(name, self)
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(f"{name} already registered as "
                                f"{type(inst).__name__}")
            return inst

    # --- scrape-time collectors ---------------------------------------

    def add_collector(self, fn) -> None:
        """Register a zero-arg hook run before every scrape/sample.

        Collectors recompute gauges whose truth lives elsewhere (event
        queue depths, process RSS, open fds) at OBSERVATION time instead
        of trusting the last write — a gauge set on emit and never
        decayed lies to every later scrape."""
        with self._lock:
            self._shared.touch()
            self._collectors.append(fn)

    def run_collectors(self) -> None:
        with self._lock:
            self._shared.touch(write=False)
            fns = list(self._collectors)
        for fn in fns:
            try:
                fn()
            except Exception:  # noqa: BLE001 — one bad hook ≠ dead scrape
                pass

    def sample(self) -> dict[str, tuple[str, object]]:
        """Run collectors, then snapshot every instrument:
        {name: (kind, data)} where kind is counter/gauge/histogram and
        data is the instrument's ``sample()`` (histograms additionally
        carry their bucket bounds). The SLI sampler diffs two of these."""
        self.run_collectors()
        with self._lock:
            self._shared.touch(write=False)
            instruments = list(self._instruments.items())
        out: dict[str, tuple[str, object]] = {}
        for name, inst in instruments:
            if isinstance(inst, Histogram):
                out[name] = ("histogram", {"buckets": inst.buckets,
                                           "series": inst.sample()})
            elif isinstance(inst, Counter):
                out[name] = ("counter", inst.sample())
            else:
                out[name] = ("gauge", inst.sample())
        return out

    def expose(self) -> str:
        """Every instrument in the text exposition format."""
        self.run_collectors()
        with self._lock:
            self._shared.touch(write=False)
            instruments = list(self._instruments.values())
        lines: list[str] = []
        for inst in instruments:
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# curated "public" metrics (reference metrics/public/public.go): the node's
# frontiers, set by api/http.py on each /metrics scrape, and the prover's
# proof count
layer_gauge = REGISTRY.gauge("node_current_layer", "wall-clock layer")
verified_gauge = REGISTRY.gauge("tortoise_verified_layer", "verified frontier")
proofs_generated = REGISTRY.counter("post_proofs_generated", "proofs made")
peers_gauge = REGISTRY.gauge("p2p_connected_peers", "connected peers")
sync_state_gauge = REGISTRY.gauge(
    "sync_state", "0 notSynced, 1 gossipSync, 2 synced")
tortoise_mode_gauge = REGISTRY.gauge(
    "tortoise_mode", "0 verifying, 1 full (reference tortoise/metrics.go)")
applied_gauge = REGISTRY.gauge("mesh_last_applied_layer", "applied frontier")

# PoST init streaming pipeline (post/initializer.py). Stage seconds carry a
# stage label (dispatch/fetch/write/stall) so an operator can see where a
# slow init spends its time without a full profile. Host counters: no
# launch and no sync on the card's path.
post_pipeline_dispatched = REGISTRY.counter(
    "post_pipeline_batches_dispatched_total",
    "label batches enqueued on the accelerator")
post_pipeline_inflight = REGISTRY.gauge(
    "post_pipeline_inflight_batches", "device batches currently in flight")
post_pipeline_stage_seconds = REGISTRY.counter(
    "post_pipeline_stage_seconds_total",
    "host seconds per pipeline stage (label=stage)")
post_pipeline_meta_saves = REGISTRY.counter(
    "post_pipeline_meta_saves_total", "interval resume-metadata rewrites")
post_pipeline_labels_per_sec = REGISTRY.gauge(
    "post_pipeline_labels_per_sec", "labels/s of the last init session")

# the device mesh (parallel/, routed by ops/autotune.py and consumed by
# post/initializer.py + post/prover.py). The imbalance gauge is (max-min)/
# max over the last batch's per-stripe fetch seconds (the first stripe's
# include the wait for the batch), so a straggling device or stream is
# visible without a trace capture.
post_mesh_devices = REGISTRY.gauge(
    "post_mesh_devices",
    "device count label batches are sharded over (1 = single device)")
post_mesh_shard_imbalance = REGISTRY.gauge(
    "post_mesh_shard_imbalance",
    "(max-min)/max per-shard fetch seconds of the last sharded batch")

# the ROMix autotuner (ops/autotune.py): one race per (platform, N) whose
# measurements are neither memoized nor persisted yet
post_romix_autotune_races = REGISTRY.counter(
    "post_romix_autotune_races_total",
    "ROMix kernel autotune races run (persisted-winner cache misses)")

# PoST label-store reads (post/data.py LabelStore.read_labels: the serial
# prover and the LabelReader pool both land here)
post_store_read_calls = REGISTRY.counter(
    "post_store_read_calls_total", "label-store read_labels invocations")
post_store_read_bytes = REGISTRY.counter(
    "post_store_read_bytes_total", "label bytes read back from disk")
post_store_read_retries = REGISTRY.counter(
    "post_store_read_retries_total",
    "transient-EIO label reads retried with backoff (post/data.py)")

# PoST store crash safety (post/data.py recover_store + LabelWriter fsync
# discipline, post/faultfs.py injection)
post_store_fsyncs = REGISTRY.counter(
    "post_store_fsyncs_total",
    "label-file fsyncs at checkpoint/drain boundaries")
post_store_fault_injections = REGISTRY.counter(
    "post_store_fault_injections_total",
    "disk faults fired by a faultfs plan (label=kind)")
post_store_recovery_runs = REGISTRY.counter(
    "post_store_recovery_runs_total",
    "reopens where recovery repaired files or rolled the cursor back")
post_store_recovery_truncated_bytes = REGISTRY.counter(
    "post_store_recovery_truncated_bytes_total",
    "torn/un-fsynced label bytes truncated on reopen")
post_store_recovery_intervals_dropped = REGISTRY.counter(
    "post_store_recovery_intervals_dropped_total",
    "checkpoint intervals that failed CRC verification on reopen")
post_store_degraded = REGISTRY.gauge(
    "post_store_degraded",
    "1 while the label writer is parked waiting out ENOSPC")
post_store_enospc_waits = REGISTRY.counter(
    "post_store_enospc_waits_total",
    "ENOSPC retry waits entered by the label writer pool")

# PoST proving streaming pipeline (post/prover.py). Stage seconds carry a
# stage label (read/dispatch/retire) mirroring the init pipeline's.
post_prove_windows = REGISTRY.counter(
    "post_prove_windows_total", "nonce windows swept over the label store")
post_prove_batches = REGISTRY.counter(
    "post_prove_batches_total", "label batches dispatched by the prover")
post_prove_early_exits = REGISTRY.counter(
    "post_prove_early_exits_total",
    "prove passes cut short once the winning nonce was decided")
post_prove_stage_seconds = REGISTRY.counter(
    "post_prove_stage_seconds_total",
    "host seconds per prove pipeline stage (label=stage)")
post_prove_d2h_bytes = REGISTRY.counter(
    "post_prove_d2h_bytes_total",
    "bytes copied device->host by the prover (compacted hits, not masks)")
post_prove_labels_per_sec = REGISTRY.gauge(
    "post_prove_labels_per_sec",
    "store labels covered per second by the last prove call")

# the health engine's SLI substrate on the PoST path (obs/sli.py
# default_slis): the init rate and the prove window's wall time
post_pipeline_labels = REGISTRY.counter(
    "post_pipeline_labels_total",
    "labels fetched to host by the init pipeline (rate = init labels/s)")
post_prove_window_seconds = REGISTRY.histogram(
    "post_prove_window_seconds",
    "wall seconds per prove nonce-window disk pass",
    buckets=(0.05, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0, float("inf")))

# PoST proving sessions of the gRPC worker (post/grpc_worker.py)
post_prove_inflight = REGISTRY.gauge(
    "post_prove_inflight", "proving sessions currently running (grpc worker)")

# device-job runtime (runtime/): the dispatch -> retire engine every device
# pipeline runs on, plus the multi-tenant scheduler on top. Every series
# carries the workload `kind`; per-identity series carry `tenant` ("-" when
# the embedder is single-tenant).
runtime_dispatched = REGISTRY.counter(
    "runtime_batches_dispatched_total",
    "device batches dispatched through the runtime engine "
    "(labels: kind, tenant)")
runtime_retired = REGISTRY.counter(
    "runtime_batches_retired_total",
    "device batches retired (results consumed) (labels: kind, tenant)")
runtime_inflight = REGISTRY.gauge(
    "runtime_inflight_batches",
    "device batches currently in flight (label: kind)")
runtime_stage_seconds = REGISTRY.counter(
    "runtime_stage_seconds_total",
    "host seconds per engine stage (labels: kind, stage)")
runtime_fallbacks = REGISTRY.counter(
    "runtime_fallbacks_total",
    "dispatch failures absorbed by a pipeline's fallback hook "
    "(label: kind); no entry point of the port passes a fallback")
# the label pipelines' stream ring (device.py:StreamRing): a batch counts
# as overlapped when it is dispatched while the other ring stream's
# previous batch is still on the card
runtime_overlapped = REGISTRY.counter(
    "runtime_batches_overlapped_total",
    "device batches dispatched while the other ring stream's previous "
    "batch was still on the card (labels: kind, tenant)")
runtime_pipeline_streams = REGISTRY.gauge(
    "runtime_pipeline_streams",
    "CUDA streams a pipeline's batches alternate over, set at its start: "
    "2 for a label pipeline whose two batches fit the card, else 1 "
    "(label: kind)")
runtime_tenant_jobs = REGISTRY.counter(
    "runtime_tenant_jobs_total",
    "scheduler jobs by outcome (labels: tenant, kind, state)")
runtime_tenant_queued = REGISTRY.gauge(
    "runtime_tenant_queued_jobs",
    "jobs queued per tenant in the scheduler (label: tenant)")
runtime_tenant_labels = REGISTRY.counter(
    "runtime_tenant_labels_total",
    "init labels computed+written through the scheduler (label: tenant)")
runtime_pack_occupancy = REGISTRY.histogram(
    "runtime_pack_occupancy_lanes",
    "lanes per packed multi-tenant init dispatch",
    buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192, float("inf")))
runtime_pack_tenants = REGISTRY.histogram(
    "runtime_pack_tenants",
    "distinct tenants per packed init dispatch",
    buckets=(1, 2, 4, 8, 16, 32, float("inf")))
runtime_quantum_seconds = REGISTRY.counter(
    "runtime_quantum_seconds_total",
    "worker seconds per scheduler quantum (labels: kind, tenant)")
runtime_deadline_boosts = REGISTRY.counter(
    "runtime_deadline_boosts_total",
    "quanta admitted by deadline (EDF) ahead of fair-share order")
runtime_quantum_wait = REGISTRY.histogram(
    "runtime_quantum_wait_seconds",
    "seconds from a job's enqueue or requeue to its quantum's start, the "
    "wait for a gang slot included (label: kind)",
    buckets=(0.001, 0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
             float("inf")))

# the CUDA caching allocator's cudaMalloc and cudaFree calls, totals since
# the process started, set by device.py's collector for every card it has
# resolved. A cudaFree waits for the whole card, so a count that grows in
# steady state marks an allocator stall
device_allocator_calls = REGISTRY.gauge(
    "device_allocator_calls",
    "CUDA caching-allocator cudaMalloc/cudaFree calls since start "
    "(label: call=malloc|free|retry)")

# verification farm (verify/farm.py): the micro-batching admission service
# for signatures / VRFs / POST proofs / poet membership / k2pow witnesses.
verify_farm_requests = REGISTRY.counter(
    "verify_farm_requests_total",
    "verification requests submitted (labels: kind, lane)")
verify_farm_dedup_hits = REGISTRY.counter(
    "verify_farm_dedup_hits_total",
    "requests coalesced onto an identical in-flight request")
verify_farm_batches = REGISTRY.counter(
    "verify_farm_batches_total", "batches dispatched (label: kind)")
verify_farm_batch_occupancy = REGISTRY.histogram(
    "verify_farm_batch_occupancy", "requests per dispatched batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, float("inf")))
verify_farm_dispatch_seconds = REGISTRY.histogram(
    "verify_farm_dispatch_seconds",
    "backend seconds per batch (label: kind)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, float("inf")))
verify_farm_queue_depth = REGISTRY.gauge(
    "verify_farm_queue_depth", "pending requests (label: lane)")
verify_farm_queue_wait_seconds = REGISTRY.histogram(
    "verify_farm_queue_wait_seconds",
    "submit -> batch-take queue wait seconds (label: kind)",
    buckets=(0.001, 0.003, 0.01, 0.05, 0.25, 1.0, 10.0, float("inf")))

# verifyd (verifyd/): every per-client series is REMOVED on unregister and
# the client population is bounded by the service's max_clients, so a
# connect-flood cannot grow the registry without bound.
verifyd_clients = REGISTRY.gauge(
    "verifyd_clients", "registered verifyd clients")
verifyd_client_pending = REGISTRY.gauge(
    "verifyd_client_pending_items",
    "admitted items in flight per client (label: client)")
verifyd_pending = REGISTRY.gauge(
    "verifyd_pending_items", "admitted items in flight, all clients")
verifyd_requests = REGISTRY.counter(
    "verifyd_requests_total",
    "verification requests by outcome (labels: client, outcome)")
verifyd_items = REGISTRY.counter(
    "verifyd_items_total",
    "verification items admitted (labels: client, kind)")
verifyd_shed = REGISTRY.counter(
    "verifyd_shed_total",
    "requests shed with a typed reason (labels: client, reason)")
verifyd_request_seconds = REGISTRY.histogram(
    "verifyd_request_seconds",
    "admitted request latency, admission to verdicts (label: lane)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf")))
verifyd_batchtune_races = REGISTRY.counter(
    "verifyd_batchtune_races_total",
    "batch-size calibration races run (persisted-rates cache misses)")

# gossip (p2p/pubsub.py): a raising handler is counted + logged, never
# allowed to abort delivery to the remaining subscribers; each handler's
# wall time, farm queue wait included, is the gossip-latency SLI. The
# state database's sql_state_query_seconds / sql_state_queries families
# are made per role by storage/db.py.
pubsub_handler_drops = REGISTRY.counter(
    "pubsub_handler_drops_total",
    "handler exceptions swallowed during delivery (label: topic)")
gossip_handler_seconds = REGISTRY.histogram(
    "gossip_handler_seconds",
    "per-handler gossip validation seconds (label: topic)",
    buckets=(0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0, float("inf")))

# event bus (node/events.py): the counter fires per dropped event
# (label=type); the gauge tracks the deepest subscription queue, so a
# consumer falling behind shows up before it overflows.
events_overflows = REGISTRY.counter(
    "events_subscription_overflows_total",
    "events dropped on full subscription queues (label: type)")
events_queue_depth = REGISTRY.gauge(
    "events_queue_depth",
    "deepest subscription queue, recomputed at scrape time")

# mesh (consensus/mesh.py): one observation per process_layer, read by
# obs/sli.py's layer_apply SLIs and obs/health.py's layer_apply_latency SLO.
layer_apply_seconds = REGISTRY.histogram(
    "layer_apply_seconds",
    "mesh.process_layer wall seconds (tortoise tally + apply)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf")))

# span tracer (utils/tracing.py): capture state for operators reading
# /metrics while a /debug/trace capture runs (verifyd/server.py).
trace_enabled_gauge = REGISTRY.gauge(
    "trace_capture_enabled", "1 while the span tracer is recording")
trace_spans_gauge = REGISTRY.gauge(
    "trace_spans_recorded",
    "spans recorded by the current capture (incl. ring overwrites)")

# runtime collectors (obs/sli.py register_runtime_collectors): recomputed
# by scrape-time hooks, not trusted last writes
process_rss_bytes = REGISTRY.gauge(
    "process_resident_memory_bytes", "resident set size")
process_open_fds = REGISTRY.gauge(
    "process_open_fds", "open file descriptors")
event_loop_lag = REGISTRY.gauge(
    "runtime_event_loop_lag_seconds",
    "asyncio scheduling lag measured by the health engine heartbeat")

# SLO evaluation (obs/health.py HealthEngine)
slo_healthy = REGISTRY.gauge(
    "slo_healthy", "1 while the SLO is met (label: slo)")
slo_burn = REGISTRY.gauge(
    "slo_burn_rate",
    "violating fraction of the SLO window, 0..1 (label: slo)")
slo_breaches = REGISTRY.counter(
    "slo_breaches_total", "healthy->breach transitions (label: slo)")

# component health + stall watchdogs (obs/health.py HealthRegistry)
component_healthy = REGISTRY.gauge(
    "component_healthy", "1 while the liveness probe passes "
    "(label: component)")
component_stalls = REGISTRY.counter(
    "component_stalls_total",
    "healthy->unhealthy probe transitions (label: component)")

# flight recorder (obs/flight.py)
flight_bundles = REGISTRY.counter(
    "flight_bundles_total", "diagnostic bundles written (label: trigger)")

# remediation engine + circuit breakers (obs/remediate.py) around the
# engine's dispatch, the farm's per-kind backends, the failover client and
# each fleet replica. Per-component breaker series are REMOVED when the
# breaker unregisters.
remediation_actions = REGISTRY.counter(
    "remediation_actions_total",
    "recovery actions decided by the remediation engine "
    "(labels: component, action, outcome)")
remediation_breaker_state = REGISTRY.gauge(
    "remediation_breaker_state",
    "0 closed, 1 open, 2 half-open, 3 quarantined (label: component)")
remediation_breaker_transitions = REGISTRY.counter(
    "remediation_breaker_transitions_total",
    "breaker state transitions (labels: component, to)")

# verifyd failover client (verifyd/failover.py): requests by serving
# path, and the latency the node actually saw regardless of path — the
# signal that proves a verifyd outage never dented the BLOCK lane.
failover_requests = REGISTRY.counter(
    "failover_requests_total",
    "failover verifier batches by serving path "
    "(labels: path=remote|local|local_fastfail, lane)")
failover_verify_seconds = REGISTRY.histogram(
    "failover_verify_seconds",
    "failover verifier batch latency by serving path "
    "(labels: path, lane)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf")))

# verifyd fleet (verifyd/fleet.py + routing.py): the replica-sharded
# service plane.  Per-replica series are REMOVED when the replica
# unregisters from the router, so fleet membership churn cannot grow the
# registry without bound.
fleet_replicas = REGISTRY.gauge(
    "fleet_replicas", "verifyd replicas registered on the router")
fleet_desired_replicas = REGISTRY.gauge(
    "fleet_desired_replicas",
    "autoscaling signal: replicas the fleet's windowed load wants")
fleet_replica_load = REGISTRY.gauge(
    "fleet_replica_load_score",
    "windowed load score per replica, ~1.0 = at target (label: replica)")
fleet_clients = REGISTRY.gauge(
    "fleet_clients", "clients placed by the fleet router")
fleet_requests = REGISTRY.counter(
    "fleet_requests_total",
    "fleet verifier batches by serving path "
    "(labels: path=<replica>|local|local_fastfail, lane)")
fleet_verify_seconds = REGISTRY.histogram(
    "fleet_verify_seconds",
    "fleet verifier batch latency by origin "
    "(labels: path=remote|local|local_fastfail, lane)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf")))
fleet_replica_verify_seconds = REGISTRY.histogram(
    "fleet_replica_verify_seconds",
    "per-replica remote verify latency — the steal/autoscale queue-wait "
    "signal (labels: replica, lane)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, float("inf")))
fleet_replica_sheds = REGISTRY.counter(
    "fleet_replica_sheds_total",
    "typed sheds seen per replica — the steal/autoscale pressure "
    "signal (labels: replica, reason)")
fleet_reroutes = REGISTRY.counter(
    "fleet_reroutes_total",
    "clients moved between replicas (labels: reason)")
fleet_steals = REGISTRY.counter(
    "fleet_steals_total",
    "batches stolen from a hot replica (labels: src, dst)")
fleet_audit_divergence = REGISTRY.counter(
    "fleet_audit_divergence_total",
    "remote batches whose spot-checked verdicts diverged from the "
    "local farm — byzantine replica detections (label: replica)")
# sim fabric (sim/net.py EventMeshHub): the O(edges-that-matter) claim
# made observable.  Hot paths bump plain ints; the hub flushes deltas
# once per heartbeat so a million-frame storm costs the registry ~one
# inc per virtual second, not per frame.
sim_fabric_events = REGISTRY.counter(
    "sim_fabric_events_total",
    "event-wheel calendar entries (labels: kind=scheduled|fired)")
sim_fabric_dirty = REGISTRY.gauge(
    "sim_fabric_heartbeat_dirty_nodes",
    "mesh nodes with pending control-plane work after the last beat "
    "(idle nodes cost zero — this staying << population is the win)")
sim_fabric_cache = REGISTRY.counter(
    "sim_fabric_cache_total",
    "fault-epoch cache lookups on reachable()/neighbors() "
    "(labels: result=hit|miss)")

# sharded fabric (sim/shard.py): the multi-process event wheel's
# conservative-window exchange plane
sim_shard_events = REGISTRY.counter(
    "sim_shard_events_total",
    "per-shard event-wheel activity merged at finalize "
    "(labels: shard, kind=fired)")
sim_shard_barrier_waits = REGISTRY.counter(
    "sim_shard_barrier_waits_total",
    "cross-shard exchange rounds (settlements + window grants) — the "
    "synchronization cost of the conservative protocol")
sim_shard_imbalance = REGISTRY.gauge(
    "sim_shard_imbalance_ratio",
    "(max - min) / max of events fired across shards at finalize — "
    "0 is a perfectly balanced partition")
sim_shard_worker_stats = REGISTRY.gauge(
    "sim_shard_worker_stat",
    "WORKER-side event-wheel stats set in the worker's own registry "
    "just before each federated snapshot ships (labels: shard, stat); "
    "the parent re-exposes them under proc=shard-<k> via obs.federate")
federated_procs = REGISTRY.gauge(
    "federated_procs",
    "processes with a live federated snapshot in obs.federate "
    "(labels: state=live|crashed); crashed snapshots are retained "
    "for forensics until explicitly dropped")

# runtime sanitizers (utils/sanitize.py, SPACEMESH_SANITIZE=1): each
# recorded violation (a slow event-loop callback, an off-thread instrument
# creation, a race or lock-order inversion) counts here, so a sanitized
# run surfaces its findings on /metrics too
sanitize_violations = REGISTRY.counter(
    "sanitize_violations_total",
    "runtime sanitizer violations (label: kind)")
