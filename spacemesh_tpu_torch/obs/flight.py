"""Flight recorder: spool a diagnostic bundle when something breaks
(port of ``spacemesh_tpu/obs/flight.py``, the same bundle layout).

An SLO breach or a stalled component is exactly the moment an operator
wishes they had started a trace capture five minutes ago. The flight
recorder makes that retroactively true: the span tracer's ring, the
full metrics exposition and the health report are all already in
memory; a dump just serializes them into a timestamped bundle directory
under the spool dir:

    flight-<unix_ts>-<pid>-<seq>/
        manifest.json   {reason, unix_ts, pid, health, remediation, ...}
        trace.json      tracing.export() (validates via tracing.validate)
        metrics.prom    Registry.expose() text exposition
        events.json     recent event-bus emissions: always [] in the port
                        until the event bus comes (ROADMAP [13])
        health.json     the engine's readiness report at dump time
        procs/<proc>/   per-federated-process trace.json + metrics.prom
                        (obs/federate.py; only when children federated)

Automatic dumps (engine tick transitions) are rate-limited to one per
``min_interval_s`` so a flapping SLO cannot fill the disk; a manual dump
(``force=True``) bypasses the limit. The spool keeps the newest ``keep``
bundles and prunes the rest. :func:`read_bundle` loads and validates a
bundle, :func:`digest` summarizes it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import time
from pathlib import Path

from ..utils import fsio
from ..utils import logging as slog
from ..utils import metrics, tracing

_log = slog.get("flight")

DEFAULT_MIN_INTERVAL_S = 60.0
DEFAULT_KEEP = 8

MANIFEST = "manifest.json"
TRACE = "trace.json"
METRICS = "metrics.prom"
EVENTS = "events.json"
HEALTH = "health.json"
PROCS = "procs"


def _jsonable(obj):
    """Best-effort JSON projection for manifest payloads (bytes -> hex)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


class FlightRecorder:
    def __init__(self, spool_dir, *,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 keep: int = DEFAULT_KEEP,
                 registry: metrics.Registry = metrics.REGISTRY,
                 time_source=time.monotonic):
        self.spool = Path(spool_dir)
        self.min_interval_s = float(min_interval_s)
        self.keep = max(int(keep), 1)
        self.registry = registry
        self.time_source = time_source
        self._last_dump: float | None = None
        self._seq = itertools.count()

    def dump(self, reason: str, *, now: float | None = None,
             health: dict | None = None,
             remediation: dict | None = None,
             force: bool = False) -> Path | None:
        """Write one bundle; returns its path, or None when rate-limited.

        ``now`` is the engine's monotonic clock (rate limiting only —
        bundle names use wall time so operators can correlate them with
        logs)."""
        t = self.time_source() if now is None else float(now)
        if (not force and self._last_dump is not None
                and t - self._last_dump < self.min_interval_s):
            return None
        # pid in the name: a crash-looping node restarting within one
        # wall-clock second resets the seq counter, and colliding with a
        # previous run's bundle would fail os.replace (ENOTEMPTY) and
        # drop the dump at exactly the moment it matters
        name = (f"flight-{int(time.time())}-{os.getpid()}-"
                f"{next(self._seq):03d}")
        path = self.spool / name
        tmp = self.spool / f".{name}.tmp"
        try:
            tmp.mkdir(parents=True, exist_ok=True)
            from ..utils import sanitize

            if remediation is None:
                # breaker states always ride along: a bundle taken at
                # the unhealthy moment must answer "was the node
                # already remediating?" even for loop-less embedders
                from . import remediate as remediate_mod

                remediation = {
                    "breakers": remediate_mod.BREAKERS.snapshot()}
            manifest = {
                "reason": reason,
                "unix_ts": time.time(),
                "pid": os.getpid(),
                "trace_enabled": tracing.is_enabled(),
                "health": health,
                "remediation": remediation,
                # sanitizer findings ride along so a bundle taken at the
                # unhealthy moment carries the race/slow-callback reports
                # (the counters themselves survive via metrics.prom)
                "sanitize_violations": [dataclasses.asdict(v)
                                        for v in sanitize.violations()],
            }
            (tmp / MANIFEST).write_text(
                json.dumps(_jsonable(manifest), indent=1))
            (tmp / TRACE).write_text(json.dumps(tracing.export()))
            (tmp / METRICS).write_text(self.registry.expose())
            (tmp / EVENTS).write_text("[]")
            (tmp / HEALTH).write_text(
                json.dumps(_jsonable(health or {}), indent=1))
            # fleet federation: every child process's last trace +
            # proc=-labeled metrics land under procs/ so ONE bundle
            # answers for the whole fleet, crashed workers included
            from .federate import FEDERATION

            for proc, ent in sorted(FEDERATION.flight_procs().items()):
                pdir = tmp / PROCS / proc.replace("/", "_")
                pdir.mkdir(parents=True, exist_ok=True)
                if ent["trace"] is not None:
                    (pdir / TRACE).write_text(json.dumps(ent["trace"]))
                (pdir / METRICS).write_text(ent["metrics"])
                if ent["crashed"]:
                    (pdir / "CRASHED").write_text("retained snapshot\n")
            # durable publish (utils/fsio): fsync + atomic rename +
            # parent-dir fsync — the bundle an operator reaches for
            # after a crash must not itself be a casualty of the crash
            fsio.persist(tmp, path)
        except OSError as exc:
            _log.error("flight dump failed: %r", exc)
            shutil.rmtree(tmp, ignore_errors=True)
            return None
        # rate limit arms only on SUCCESS: a failed write (disk full)
        # must not suppress the next automatic dump once it could work
        self._last_dump = t
        metrics.flight_bundles.inc(trigger=reason.split(":", 1)[0])
        _log.warning("flight bundle written: %s (%s)", path, reason)
        self._prune()
        return path

    def bundles(self) -> list[Path]:
        if not self.spool.is_dir():
            return []
        return sorted(p for p in self.spool.iterdir()
                      if p.is_dir() and p.name.startswith("flight-"))

    def _prune(self) -> None:
        for stale in self.bundles()[:-self.keep]:
            shutil.rmtree(stale, ignore_errors=True)


# --- bundle digestion ---------------------------------------------------


def read_bundle(path) -> dict:
    """Load + validate one bundle. Raises on a malformed trace or an
    unparseable metrics snapshot — a corrupt bundle must fail loudly."""
    p = Path(path)
    if not (p / MANIFEST).exists():
        raise FileNotFoundError(f"{p}: not a flight bundle (no {MANIFEST})")
    manifest = json.loads((p / MANIFEST).read_text())
    trace = json.loads((p / TRACE).read_text())
    tracing.validate(trace)
    metrics_text = (p / METRICS).read_text()
    samples = 0
    for line in metrics_text.splitlines():
        if line and not line.startswith("#"):
            if " " not in line:
                raise ValueError(f"{p}/{METRICS}: bad sample {line!r}")
            samples += 1
    events = json.loads((p / EVENTS).read_text()) \
        if (p / EVENTS).exists() else []
    health = json.loads((p / HEALTH).read_text()) \
        if (p / HEALTH).exists() else {}
    procs: dict = {}
    procs_dir = p / PROCS
    if procs_dir.is_dir():
        for pdir in sorted(procs_dir.iterdir()):
            if not pdir.is_dir():
                continue
            ptrace = None
            if (pdir / TRACE).exists():
                ptrace = json.loads((pdir / TRACE).read_text())
                tracing.validate(ptrace)
            procs[pdir.name] = {
                "trace": ptrace,
                "metrics": ((pdir / METRICS).read_text()
                            if (pdir / METRICS).exists() else ""),
                "crashed": (pdir / "CRASHED").exists(),
            }
    return {"path": str(p), "manifest": manifest, "trace": trace,
            "metrics_samples": samples, "events": events,
            "health": health, "procs": procs}


def digest(bundle: dict, top: int = 10) -> dict:
    """A render-ready summary of ``read_bundle()``'s output. When the
    bundle carries federated ``procs/``, the trace summary runs over
    the MERGED timeline (parent + every child capture) so per-proc
    self-time and cross-process link counts appear in one table."""
    health = bundle.get("health") or {}
    components = health.get("components", {})
    slos = health.get("slos", {})
    procs = bundle.get("procs") or {}
    child_traces = [ent["trace"] for _, ent in sorted(procs.items())
                    if ent.get("trace") is not None]
    doc = bundle["trace"]
    if child_traces:
        doc = tracing.merge_captures([doc] + child_traces)
    summary = tracing.summarize(doc, top=top)
    return {
        "bundle": bundle["path"],
        "reason": bundle["manifest"].get("reason"),
        "unix_ts": bundle["manifest"].get("unix_ts"),
        "ready": health.get("ready"),
        "unhealthy_components": {
            name: ent.get("reason") for name, ent in components.items()
            if not ent.get("healthy", True)},
        "breached_slos": {
            name: {"value": ent.get("value"), "target": ent.get("target"),
                   "burn": ent.get("burn")}
            for name, ent in slos.items() if ent.get("breached")},
        "slis": health.get("slis", {}),
        "metrics_samples": bundle["metrics_samples"],
        "events": len(bundle["events"]),
        "trace_spans": summary["spans"],
        "trace_top_self_time": summary["top_self_time"][:top],
        "procs": {name: {"crashed": ent.get("crashed", False),
                         "spans": (ent["trace"]["otherData"].get(
                             "captured_spans", 0)
                             if ent.get("trace") else 0)}
                  for name, ent in sorted(procs.items())},
        "proc_self_time": summary.get("procs", []),
        "cross_proc_links": summary.get("cross_proc_links",
                                        {"total": 0, "pairs": {}}),
        "trace_warnings": summary.get("warnings", []),
    }
