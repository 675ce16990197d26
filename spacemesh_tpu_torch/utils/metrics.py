"""Metrics: counters and gauges with Prometheus text exposition.

Port of ``spacemesh_tpu/utils/metrics.py``: the instrument types, the
registry and the exposition format, with the same names and labels. Only
the instruments the port records are defined here: the ``post_store_*``
family (label-store reads, fsyncs, fault injections, recovery, ENOSPC
parking) and ``post_prove_inflight`` (the gRPC worker's proving sessions).
"""

from __future__ import annotations

import threading
from collections import defaultdict


def _escape(value) -> str:
    """Escape a label value per the text exposition format: backslash,
    double quote and newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(labels) -> str:
    return ",".join(f'{k}="{_escape(v)}"' for k, v in labels)


class _Instrument:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()


class Counter(_Instrument):
    def __init__(self, name, help_=""):
        super().__init__(name, help_)
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] += value

    def sample(self) -> dict[tuple, float]:
        """Point-in-time {labelset: value} snapshot."""
        with self._lock:
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
            self._values[tuple(sorted(labels.items()))] = value

    def remove(self, **labels) -> None:
        """Drop one labelset's series."""
        with self._lock:
            self._values.pop(tuple(sorted(labels.items())), None)

    def sample(self) -> dict[tuple, float]:
        with self._lock:
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


class Registry:
    def __init__(self) -> None:
        self._instruments: dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def _get(self, name, factory, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(f"{name} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def expose(self) -> str:
        """Every instrument in the text exposition format."""
        with self._lock:
            instruments = list(self._instruments.values())
        lines: list[str] = []
        for inst in instruments:
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

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

# PoST proving sessions of the gRPC worker (post/grpc_worker.py)
post_prove_inflight = REGISTRY.gauge(
    "post_prove_inflight", "proving sessions currently running (grpc worker)")
