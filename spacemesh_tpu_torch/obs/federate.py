"""Fleet-wide observability: the cross-process collection plane (port of
``spacemesh_tpu/obs/federate.py``).

* **Metrics**: children ship full registry snapshots
  (``Registry.sample()``, or Prometheus exposition text over HTTP, as a
  verifyd replica's ``/metrics`` gives it) and the parent re-exposes
  every series under a ``proc=`` label with strict cardinality hygiene:
  ``FEDERATION.drop(proc)`` removes a process's entire snapshot the
  moment it exits or unregisters (the verifyd fleet's
  ``unregister_replica`` drops ``replica-<name>``), while a CRASHED
  process's last snapshot is retained and flagged so its final counters
  survive for forensics.
* **Traces**: capture documents collected here (the fleet router's
  ``pull_captures``) feed ``tracing.merge_captures()`` into one validated
  timeline (:meth:`Federation.merged_capture`); the per-proc trace and
  metrics pairs also land in flight bundles' ``procs/`` subdir
  (obs/flight.py).

The exposition parser is the STRICT escape-aware one: label values in
the wild carry quotes, backslashes and newlines (peer ids, error
reasons), and a sloppy regex split corrupts exactly the scrape you
need during an incident.
"""

from __future__ import annotations

import re
import threading

from ..utils.metrics import _escape, federated_procs

# metric line: name, optional {labels}, value. Labels are parsed
# separately because escaped quotes make a single regex fragile.
_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"      # metric name
    r"(?:\{(.*)\})?"                    # optional label block
    r" (-?(?:[0-9.eE+-]+|inf|nan))$")   # value


def _parse_labels(s: str) -> dict:
    """Parse a Prometheus label block honoring ``\\\\``, ``\\"`` and
    ``\\n`` escapes inside quoted values. Raises ValueError on any
    malformed input — federation must not guess at a corrupt scrape."""
    labels: dict[str, str] = {}
    i, n = 0, len(s)
    while i < n:
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', s[i:])
        if not m:
            raise ValueError(f"bad label at {s[i:]!r}")
        name = m.group(1)
        i += m.end()
        out = []
        while i < n:
            c = s[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ValueError("dangling escape")
                nxt = s[i + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                out.append(c)
                i += 1
        else:
            raise ValueError("unterminated label value")
        labels[name] = "".join(out)
        if i < n and s[i] == ",":
            i += 1
    return labels


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Parse Prometheus text exposition into (name, labels, value)
    triples. Strict: any non-comment line that does not parse raises
    (a silent skip would hide exactly the series being tested)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"unparseable metric line: {line!r}")
        name, labelblock, value = m.groups()
        labels = _parse_labels(labelblock) if labelblock else {}
        out.append((name, labels, float(value)))
    return out


def flatten_samples(samples: dict) -> list[tuple[str, dict, float]]:
    """Flatten a ``Registry.sample()`` document into exposition-shaped
    (name, labels, value) triples — histograms expand to their
    ``_bucket``/``_sum``/``_count`` series, exactly what ``expose()``
    would have printed, so pipe-shipped (pickled sample) and
    HTTP-shipped (parsed exposition) snapshots federate identically."""
    out: list[tuple[str, dict, float]] = []
    for name, (kind, data) in sorted(samples.items()):
        if kind == "histogram":
            buckets = data["buckets"]
            for labelset, (counts, sum_, count) in sorted(
                    data["series"].items()):
                labels = dict(labelset)
                for b, c in zip(buckets, counts):
                    le = "+Inf" if b == float("inf") else str(b)
                    out.append((f"{name}_bucket",
                                {**labels, "le": le}, float(c)))
                out.append((f"{name}_sum", labels, float(sum_)))
                out.append((f"{name}_count", labels, float(count)))
        else:
            for labelset, v in sorted(data.items()):
                out.append((name, dict(labelset), float(v)))
    return out


class Federation:
    """Per-process metric snapshots (and a slot for each one's trace
    capture), re-exposed with ``proc=`` provenance. One module instance
    (``FEDERATION``) serves the parent process; tests may build private
    ones."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # proc -> {"series": [(name, labels, value)], "crashed": bool,
        #          "trace": export doc | None}
        self._procs: dict[str, dict] = {}

    def _gauge(self) -> None:
        # caller holds self._lock
        crashed = sum(1 for e in self._procs.values() if e["crashed"])
        federated_procs.set(float(len(self._procs) - crashed),
                            state="live")
        federated_procs.set(float(crashed), state="crashed")

    # --- ingestion ----------------------------------------------------

    def update(self, proc: str, series, trace: dict | None = None) -> None:
        """Replace ``proc``'s snapshot with (name, labels, value)
        triples (and optionally its latest trace capture). A re-update
        clears any crash flag — the process is evidently alive."""
        series = [(str(n), dict(l), float(v)) for n, l, v in series]
        with self._lock:
            ent = self._procs.setdefault(
                proc, {"series": [], "crashed": False, "trace": None})
            ent["series"] = series
            ent["crashed"] = False
            if trace is not None:
                ent["trace"] = trace
            self._gauge()

    def update_from_samples(self, proc: str, samples: dict,
                            trace: dict | None = None) -> None:
        """Ingest a ``Registry.sample()`` document (the pipe-shipped
        form)."""
        self.update(proc, flatten_samples(samples), trace=trace)

    def parse_and_update(self, proc: str, text: str,
                         trace: dict | None = None) -> int:
        """Ingest Prometheus exposition text (the HTTP-pulled form from
        verifyd replicas' ``/metrics``). Returns the number of series
        ingested."""
        series = parse_exposition(text)
        self.update(proc, series, trace=trace)
        return len(series)

    # --- lifecycle / cardinality hygiene ------------------------------

    def drop(self, proc: str) -> bool:
        """Remove EVERYTHING federated for ``proc`` — called when a
        worker exits cleanly or a replica unregisters. This is the
        federation-layer remove_matching: after drop, zero ``proc=``
        series for that process survive on any scrape."""
        with self._lock:
            gone = self._procs.pop(proc, None) is not None
            self._gauge()
            return gone

    def mark_crashed(self, proc: str) -> None:
        """Flag ``proc`` crashed but RETAIN its last snapshot: the dead
        worker's final counters are exactly the forensics a crash report
        needs."""
        with self._lock:
            ent = self._procs.get(proc)
            if ent is not None:
                ent["crashed"] = True
            self._gauge()

    def clear(self) -> None:
        with self._lock:
            self._procs.clear()
            self._gauge()

    # --- read side ----------------------------------------------------

    def procs(self) -> dict[str, dict]:
        """{proc: {"crashed", "series"(count), "trace"(bool)}} summary."""
        with self._lock:
            return {p: {"crashed": e["crashed"],
                        "series": len(e["series"]),
                        "trace": e["trace"] is not None}
                    for p, e in self._procs.items()}

    def series(self, proc: str) -> list[tuple[str, dict, float]]:
        with self._lock:
            ent = self._procs.get(proc)
            return list(ent["series"]) if ent else []

    def trace(self, proc: str) -> dict | None:
        with self._lock:
            ent = self._procs.get(proc)
            return ent["trace"] if ent else None

    def captures(self) -> dict[str, dict]:
        """{proc: trace export doc} for every proc that shipped one —
        the input half of ``tracing.merge_captures()``."""
        with self._lock:
            return {p: e["trace"] for p, e in self._procs.items()
                    if e["trace"] is not None}

    def flight_procs(self) -> dict[str, dict]:
        """Per-proc payloads for a flight bundle's ``procs/`` subdir:
        {proc: {"trace": doc|None, "metrics": exposition text,
        "crashed": bool}}."""
        with self._lock:
            items = [(p, dict(e)) for p, e in self._procs.items()]
        return {p: {"trace": e["trace"],
                    "metrics": self._expose_proc(p, e),
                    "crashed": e["crashed"]}
                for p, e in items}

    @staticmethod
    def _expose_proc(proc: str, ent: dict) -> str:
        lines = []
        for name, labels, value in ent["series"]:
            merged = {"proc": proc, **labels}
            lbl = ",".join(f'{k}="{_escape(v)}"'
                           for k, v in sorted(merged.items()))
            lines.append(f"{name}{{{lbl}}} {value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def expose(self) -> str:
        """Every federated series as exposition text, each line under
        its origin's ``proc=`` label, deterministically ordered; a
        ``federated_proc_crashed`` marker series flags retained
        snapshots of dead processes. The HTTP ``/metrics`` handlers
        append this after the local registry's exposition."""
        with self._lock:
            items = sorted(self._procs.items())
        lines: list[str] = []
        for proc, ent in items:
            if ent["crashed"]:
                lines.append(
                    f'federated_proc_crashed{{proc="{_escape(proc)}"}} 1')
            chunk = self._expose_proc(proc, ent)
            if chunk:
                lines.append(chunk.rstrip("\n"))
        return "\n".join(lines) + ("\n" if lines else "")

    def merged_capture(self, parent: dict | None = None) -> dict | None:
        """Merge the parent's capture (if given) with every federated
        child capture into one timeline; None when nothing federated
        and no parent given."""
        from ..utils import tracing

        captures = [] if parent is None else [parent]
        captures.extend(doc for _, doc in sorted(self.captures().items()))
        if not captures:
            return None
        return tracing.merge_captures(captures)


FEDERATION = Federation()
