"""Span tracing: causal timelines from a verify request to a kernel
launch (port of ``spacemesh_tpu/utils/tracing.py``, the same API, ring,
export format and merge rules).

The metrics registry (utils/metrics.py) answers *how much*: seconds per
pipeline stage, batches per second. This module answers *which one and
why then*: each unit of work (a verify-farm batch, a prove window, an
init batch's launches) records a **span** (name, wall interval,
attributes, parent) into a bounded in-memory ring, and the whole capture
exports as Chrome trace-event / Perfetto-compatible JSON, so one
init+prove+verify run reads as a single causal timeline in
https://ui.perfetto.dev.

Design constraints, in order:

1. **Free when off.** Tracing is always compiled in but disabled by
   default; the disabled ``span()`` call is one attribute load, one
   branch, and the return of a module-singleton no-op context manager:
   no dict, no object allocation, no clock read (asserted by a test).
   Hot paths therefore call it unconditionally.
2. **Fixed memory when on.** Completed spans land in a preallocated
   ring of ``capacity`` slots; the writer index is an
   ``itertools.count`` (atomic under the GIL), so recording from pool
   threads takes no lock and a capture can run for hours overwriting
   its own tail. Overwritten spans are counted, not silently lost.
3. **Causality across tasks and threads.** The current span travels
   through ``contextvars``: awaits, ``asyncio.to_thread`` and task
   creation all inherit it. Long-lived worker threads (the label
   writer/reader pools) cannot inherit a context, so ``current_id()``
   lets the submitting side capture the parent explicitly and pass it
   with the work item.

Controls:

* ``start(capacity=..)`` / ``stop()`` / ``export()``: the embedder API;
  verifyd's HTTP server maps them to ``/debug/trace/start|stop|export``
  (verifyd/server.py).
* ``SPACEMESH_TRACE``: capture from boot: ``1``/``on`` starts the
  tracer at import with the default ring; an integer value sets the
  ring capacity.
* ``SPACEMESH_TRACE_TORCH`` (or ``start(torch_bridge=True)``): bridge
  each span into a ``torch.profiler.record_function`` range, so inside a
  ``torch.profiler.profile`` capture the host spans line up with the CUDA
  runtime's launch calls and, through the profiler's launch correlation,
  with the card's kernel events. The profiler keeps the ranges of the
  thread that started it only; ``chip_smoke.py`` ``[trace]`` pairs those
  ranges with the same spans in this ring to put both on one clock, then
  joins every launch, whatever its thread, to the ring's spans.
* Garbage collection: while a capture runs, a hook in ``gc.callbacks``
  records each collection as a ``host.gc`` span (``generation``,
  ``collected``), since a collection stops every thread of the process.
  ``start()`` installs the hook and ``stop()`` removes it, so with tracing
  off no collection pays for it.

Span linkage in the export: every event's ``args`` carries its ``id``
and its ``parent`` id; cross-cutting links that are not parent/child
(a verify-farm batch and its member requests) are recorded as explicit
``args`` references (``batch``/``members``).

Fleet federation: each process declares an identity with
``set_process_identity(role)``; exports then carry
``otherData["proc"]`` (role, pid, clock domain) and a Perfetto
``process_name`` metadata event. ``merge_captures()`` combines N such
exports into one ``validate()``-clean timeline: span ids are rewritten
per capture so rings that each started counting at 1 cannot collide,
and a span recorded with a ``link`` arg holding a ``"<role>/<id>"``
token (built by ``link_token()`` on the sending side and shipped with
the cross-process request) gets its ``parent`` resolved to the merged
id of the remote span: the cross-process parent edges a single-process
tracer could never draw.
"""

from __future__ import annotations

import contextvars
import gc
import itertools
import json
import os
import threading
import time

DEFAULT_CAPACITY = 65536

# the current span id, inherited by child tasks/coroutines/to_thread
_current: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "spacemesh_trace_span", default=None)


def current_id() -> int | None:
    """The enclosing span's id (None when untraced/disabled) — for
    handing to long-lived worker threads as an explicit parent."""
    return _current.get()


# --- process identity (fleet federation provenance) ---------------------
#
# One role per process: verifyd fleet replicas are "replica-<name>", the
# parent defaults to "pid-<pid>". merge_captures() keys cross-process link
# tokens and per-proc provenance on this role.

_proc_identity = {"role": None, "clock_domain": "wall"}


def set_process_identity(role: str, clock_domain: str = "wall") -> None:
    """Declare this process's role label (``replica-r1``, ``fleet-parent``)
    and clock domain (``wall`` perf_counter µs, or ``virtual`` for sim
    wheels that timestamp spans in virtual time). Carried in every
    export's ``otherData["proc"]`` and as a Perfetto ``process_name``."""
    _proc_identity["role"] = str(role)
    _proc_identity["clock_domain"] = str(clock_domain)


def process_identity() -> dict:
    """This process's federation identity (role defaults to pid-N)."""
    return {
        "role": _proc_identity["role"] or f"pid-{os.getpid()}",
        "pid": os.getpid(),
        "clock_domain": _proc_identity["clock_domain"],
    }


def link_token(span_id: int | None = None) -> str | None:
    """A globally-unique token naming a span of THIS process —
    ``"<role>/<id>"`` — for shipping with a cross-process request.
    The receiving side records it as a ``link`` attr on its own span;
    ``merge_captures()`` resolves it into a real parent edge. None when
    untraced (callers ship nothing)."""
    sid = span_id if span_id is not None else _current.get()
    if sid is None:
        return None
    return f"{process_identity()['role']}/{sid}"


class _NopSpan:
    """The disabled-path singleton: every operation is a no-op."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def begin(self):
        return self

    def end(self):
        return None


_NOP = _NopSpan()


class _Span:
    """A live span: a context manager that records itself on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "parent", "id",
                 "_t0", "_token", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs, parent, cat):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.parent = parent if parent is not None else _current.get()
        self.id = next(tracer._ids)
        self._token = None
        self._ann = None

    def set(self, **attrs):
        """Attach/overwrite attributes on a live span."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._token = _current.set(self.id)
        tracer = self._tracer
        if tracer.torch_bridge:
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 — bridge is best-effort
                tracer.torch_bridge = False
                self._ann = None
        self._t0 = time.perf_counter_ns()
        return self

    def begin(self):
        """Open a detached span: timed as ``with`` times it, but neither
        the contextvar nor the torch bridge is touched, so :meth:`end`
        may run on another thread (a session that outlives the quantum
        which opened it). Its children name it with ``parent=span.id``."""
        self._t0 = time.perf_counter_ns()
        return self

    def end(self):
        self.__exit__(None, None, None)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        if self._token is not None:
            _current.reset(self._token)
        self._tracer._record(self.name, self.cat, self._t0 // 1000,
                             (t1 - self._t0) // 1000, self.id, self.parent,
                             self.attrs, "X")
        return False

    # spans bracket awaits too; the sync protocol does the work
    async def __aenter__(self):
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb):
        return self.__exit__(exc_type, exc, tb)


class Tracer:
    """A bounded-ring span recorder. One module-level instance (TRACER)
    serves the whole process; tests may build private ones."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = max(int(capacity), 16)
        self.torch_bridge = False
        self._ids = itertools.count(1)
        self._buf: list = []
        self._slots = itertools.count()
        self._recorded = 0  # approximate under thread races; display only
        self._tid_names: dict[int, str] = {}
        self._started_at: float | None = None
        self._gc_t0: int | None = None

    # --- lifecycle ----------------------------------------------------

    def start(self, capacity: int | None = None,
              torch_bridge: bool | None = None) -> None:
        """(Re)start a capture with a fresh ring. Idempotent-ish: a
        second start resets the buffer (a new capture window).
        ``torch_bridge=None`` defers to ``SPACEMESH_TRACE_TORCH``."""
        if capacity is not None:
            self.capacity = max(int(capacity), 16)
        if torch_bridge is None:
            torch_bridge = os.environ.get(
                "SPACEMESH_TRACE_TORCH", "") not in ("", "0", "off")
        self.torch_bridge = bool(torch_bridge)
        self._buf = [None] * self.capacity
        self._slots = itertools.count()
        self._recorded = 0
        self._tid_names = {}
        self._started_at = time.time()
        self.enabled = True
        if self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)

    def stop(self) -> int:
        """Stop recording; the ring stays exportable. Returns the number
        of spans retained."""
        self.enabled = False
        while self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        self._gc_t0 = None
        return min(self._recorded, self.capacity)

    def _on_gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: one ``host.gc`` span per collection.
        A collection runs on one thread with the GIL held, so a start and
        its stop never interleave with another's."""
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
            return
        t0, self._gc_t0 = self._gc_t0, None
        if t0 is None:
            return
        self._record("host.gc", "host", t0 // 1000,
                     (time.perf_counter_ns() - t0) // 1000, next(self._ids),
                     _current.get(),
                     {"generation": info.get("generation"),
                      "collected": info.get("collected")}, "X")

    def recorded(self) -> int:
        """Spans recorded since start (including overwritten ones)."""
        return self._recorded

    # --- recording ----------------------------------------------------

    def _record(self, name, cat, ts_us, dur_us, span_id, parent,
                attrs, ph) -> None:
        if not self.enabled:
            return  # stopped while the span was open
        tid = threading.get_ident()
        if tid not in self._tid_names:
            self._tid_names[tid] = threading.current_thread().name
        slot = next(self._slots)
        # ring write: a racing slot under heavy thread contention can
        # momentarily resurrect an older record — acceptable for a
        # diagnostic ring, and the GIL makes the list store atomic.
        # Snapshot the buffer and mod by ITS length: a concurrent
        # start() swapping in a different-capacity ring must never
        # index a pool thread out of bounds mid-record
        buf = self._buf
        if not buf:
            return
        buf[slot % len(buf)] = (
            name, cat, ts_us, dur_us, tid, span_id, parent, attrs, ph)
        self._recorded += 1

    def instant(self, name: str, attrs=None, cat: str = "host") -> None:
        """A zero-duration marker event (decision points, state flips)."""
        if not self.enabled:
            return
        self._record(name, cat, time.perf_counter_ns() // 1000, 0,
                     next(self._ids), _current.get(), attrs, "i")

    def span(self, name: str, attrs=None, parent=None, cat: str = "host"):
        if not self.enabled:
            return _NOP
        return _Span(self, name, attrs, parent, cat)

    # --- export -------------------------------------------------------

    def export(self) -> dict:
        """The capture as a Chrome trace-event / Perfetto JSON object."""
        total = self._recorded
        pid = os.getpid()
        proc = process_identity()
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "tid": 0, "args": {"name": proc["role"]}}]
        for tid, tname in sorted(self._tid_names.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        recs = [r for r in self._buf if r is not None]
        recs.sort(key=lambda r: r[2])  # ring order != time order
        for (name, cat, ts, dur, tid, span_id, parent, attrs, ph) in recs:
            args = {"id": span_id}
            if parent is not None:
                args["parent"] = parent
            if attrs:
                args.update(attrs)
            ev = {"name": name, "cat": cat, "ph": ph, "ts": ts,
                  "pid": pid, "tid": tid, "args": args}
            if ph == "X":
                ev["dur"] = dur
            elif ph == "i":
                ev["s"] = "t"
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "spacemesh_tpu_torch.utils.tracing",
                "captured_spans": len(recs),
                "dropped_spans": max(0, total - len(recs)),
                "capacity": self.capacity,
                "started_at_unix": self._started_at,
                "proc": proc,
            },
        }


TRACER = Tracer()


# --- module-level convenience API (what instrumented code calls) --------


def is_enabled() -> bool:
    return TRACER.enabled


def span(name: str, attrs=None, parent=None, cat: str = "host"):
    """A span context manager, or the no-op singleton when disabled.

    ``attrs`` is an optional dict the caller builds (kept positional so
    the disabled path never materializes a kwargs dict). ``parent``
    overrides the contextvar parent — for work crossing into long-lived
    pool threads, pair with ``current_id()``.
    """
    if not TRACER.enabled:
        return _NOP
    return _Span(TRACER, name, attrs, parent, cat)


def instant(name: str, attrs=None, cat: str = "host") -> None:
    if TRACER.enabled:
        TRACER.instant(name, attrs, cat)


def start(capacity: int | None = None,
          torch_bridge: bool | None = None) -> None:
    TRACER.start(capacity, torch_bridge)


def stop() -> int:
    return TRACER.stop()


def export() -> dict:
    return TRACER.export()


def export_json(path: str) -> dict:
    """Export and write to ``path``; returns the document."""
    doc = TRACER.export()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc


# --- federation: merge N process captures into one timeline -------------

# per-capture span-id offset: every process's ring counts ids from 1, so
# without rewriting, replica-r0's span 17 and replica-r2's span 17 would
# alias in the merged args graph
_MERGE_ID_STRIDE = 1 << 32


def merge_captures(captures) -> dict:
    """Combine N ``export()`` documents into ONE ``validate()``-clean
    timeline with per-process provenance.

    * Each capture gets a distinct merged ``pid`` (1..N) and a Perfetto
      ``process_name`` metadata event naming its role, so the merged
      file renders as per-process tracks and ``summarize()`` can build
      per-proc columns.
    * Span ``id``/``parent`` (and ``batch`` references) are rewritten
      with a per-capture offset — rings that each count from 1 must not
      collide in the merged graph.
    * A span whose args carry a ``link`` token (``"<role>/<id>"``, see
      ``link_token()``) gets its ``parent`` resolved to the merged id
      of the remote span; resolved/unresolved counts land in
      ``otherData["links"]`` — "zero unresolved" is the scenario-level
      assertion that no cross-process edge dangled.
    * Timed events are globally re-sorted by ``ts`` (validate requires
      one monotonic stream; metadata events are emitted first).
    """
    meta_events: list[dict] = []
    timed: list[tuple] = []  # (ts, seq, event) — seq keeps sort stable
    procs: list[dict] = []
    token_map: dict[str, int] = {}
    captured = dropped = 0
    seq = 0
    for idx, doc in enumerate(captures):
        off = (idx + 1) * _MERGE_ID_STRIDE
        mpid = idx + 1
        other = dict(doc.get("otherData") or {})
        proc = dict(other.get("proc") or {})
        role = str(proc.get("role") or f"proc-{idx}")
        proc_entry = {
            "role": role,
            "pid": proc.get("pid"),
            "merged_pid": mpid,
            "clock_domain": proc.get("clock_domain", "wall"),
            "captured_spans": int(other.get("captured_spans", 0)),
            "dropped_spans": int(other.get("dropped_spans", 0)),
        }
        procs.append(proc_entry)
        captured += proc_entry["captured_spans"]
        dropped += proc_entry["dropped_spans"]
        meta_events.append({"name": "process_name", "ph": "M",
                            "pid": mpid, "tid": 0, "args": {"name": role}})
        for ev in doc.get("traceEvents", ()):
            ev = dict(ev)
            ev["pid"] = mpid
            args = ev.get("args")
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    continue  # replaced by the role-named one above
                meta_events.append(ev)
                continue
            if args:
                args = dict(args)
                sid = args.get("id")
                if sid is not None:
                    token_map.setdefault(f"{role}/{sid}", sid + off)
                    args["id"] = sid + off
                for ref in ("parent", "batch"):
                    if args.get(ref) is not None:
                        args[ref] = args[ref] + off
                if args.get("members"):
                    args["members"] = [m + off for m in args["members"]]
                ev["args"] = args
            timed.append((ev.get("ts", 0), seq, ev))
            seq += 1
    resolved = unresolved = 0
    for _, _, ev in timed:
        args = ev.get("args")
        tok = args.get("link") if args else None
        if tok is None:
            continue
        target = token_map.get(tok)
        if target is not None:
            args["parent"] = target
            resolved += 1
        else:
            unresolved += 1
    timed.sort(key=lambda t: (t[0], t[1]))
    return {
        "traceEvents": meta_events + [ev for _, _, ev in timed],
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "spacemesh_tpu_torch.utils.tracing",
            "merged": True,
            "captured_spans": captured,
            "dropped_spans": dropped,
            "procs": procs,
            "links": {"resolved": resolved, "unresolved": unresolved},
        },
    }


def span_multiset_digest(doc) -> str:
    """sha256 over the merged capture's ``(proc role, span name, count)``
    multiset — the replay-stable identity of a capture. Timestamps, span
    ids and durations are wall/ordering artifacts and stay out, so the
    same seeded run gives the same digest (and the same digest as the
    JAX package's run over the span names both record)."""
    import hashlib

    roles = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            roles[ev["pid"]] = ev["args"]["name"]
    counts: dict[tuple, int] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") in ("X", "i"):
            key = (roles.get(ev["pid"], str(ev["pid"])), ev["name"])
            counts[key] = counts.get(key, 0) + 1
    h = hashlib.sha256()
    for (role, name), n in sorted(counts.items()):
        h.update(f"{role}\x00{name}\x00{n}\n".encode())
    return h.hexdigest()


# --- validation ---------------------------------------------------------

_PHASES = {"X", "B", "E", "i", "M", "s", "f"}
_REQUIRED = ("name", "ph", "pid", "tid")


def validate(doc) -> list[str]:
    """Raise ValueError unless ``doc`` is structurally valid trace-event
    JSON: required keys present, known phases, non-negative monotonic
    ``ts`` within the stream, ``dur`` on complete (X) events, and
    matched B/E pairs per (pid, tid) if any are used.

    Returns a list of non-fatal WARNINGS — today, ring-drop accounting:
    a capture whose ring evicted spans is structurally fine but
    analytically lossy, so every caller that prints gets told to raise
    ``trace_capacity`` / ``SPACEMESH_TRACE=<N>`` / ``?capacity=``."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace document must be {'traceEvents': [...]}")
    last_ts = None
    stacks: dict[tuple, list] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for k in _REQUIRED:
            if k not in ev:
                raise ValueError(f"event {i}: missing key {k!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph == "M":
            continue  # metadata events carry no timestamp contract
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if last_ts is not None and ts < last_ts:
            raise ValueError(f"event {i}: ts went backwards "
                             f"({ts} < {last_ts})")
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X event with bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault((ev["pid"], ev["tid"]), [])
            if not stack:
                raise ValueError(f"event {i}: E without matching B")
            stack.pop()
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed B events on {key}: {stack}")
    return drop_warnings(doc)


def drop_warnings(doc) -> list[str]:
    """Ring-eviction warnings for a capture (or each proc of a merged
    capture): non-empty means the timeline is missing spans and any
    span-count assertion on it is suspect."""
    other = doc.get("otherData") or {}
    warnings = []
    procs = other.get("procs")
    if procs:
        for p in procs:
            if p.get("dropped_spans"):
                warnings.append(
                    f"proc {p.get('role')}: ring dropped "
                    f"{p['dropped_spans']} spans — raise trace_capacity "
                    f"(script) / SPACEMESH_TRACE=<capacity> / "
                    f"?capacity= on /debug/trace/start")
    elif other.get("dropped_spans"):
        cap = other.get("capacity")
        warnings.append(
            f"ring dropped {other['dropped_spans']} spans"
            f"{f' (capacity {cap})' if cap else ''} — raise "
            f"trace_capacity (script) / SPACEMESH_TRACE=<capacity> / "
            f"?capacity= on /debug/trace/start")
    return warnings


# --- text flame summary -------------------------------------------------

_WAIT_MARKERS = ("wait", "stall", "queue", "idle", "block")


def summarize(doc, top: int = 20) -> dict:
    """Digest an exported trace: top spans by self-time (duration minus
    nested child spans on the same thread) and a per-stage queue-wait vs
    work split. The stage is the span name's dotted prefix ("prove" for
    "prove.read_wait"); wait spans are named with one of
    {wait, stall, queue, idle, block}.

    Merged captures additionally digest per-PROCESS: a ``procs`` table
    (spans + self-time per role: is every replica busy) and
    ``cross_proc_links`` counting parent edges that cross a process
    boundary, keyed "parent_span->child_span" (e.g. the
    ``fleet.remote->verifyd.request`` edges the fleet federation
    resolves). ``warnings`` carries ring-drop accounting."""
    proc_names: dict[int, str] = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            proc_names[ev["pid"]] = ev["args"]["name"]
    per_tid: dict[tuple, list] = {}
    id_home: dict[int, tuple[int, str]] = {}  # span id -> (pid, name)
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "X":
            per_tid.setdefault((ev["pid"], ev["tid"]), []).append(ev)
            sid = (ev.get("args") or {}).get("id")
            if sid is not None:
                id_home[sid] = (ev["pid"], ev["name"])
    totals: dict[str, dict] = {}
    stages: dict[str, dict] = {}
    procs: dict[int, dict] = {}
    link_pairs: dict[str, int] = {}
    for evs in per_tid.values():
        for ev in evs:
            parent = (ev.get("args") or {}).get("parent")
            home = id_home.get(parent)
            if home is not None and home[0] != ev["pid"]:
                pair = f"{home[1]}->{ev['name']}"
                link_pairs[pair] = link_pairs.get(pair, 0) + 1
    for evs in per_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []  # (end_ts, name, child_dur_acc as 1-item list)
        for ev in evs:
            ts, dur = ev["ts"], ev.get("dur", 0)
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                stack[-1][2][0] += dur
            stack.append((ts + dur, ev["name"], [0]))
            # self time settles when the span pops; accumulate eagerly
            # by recording the entry and fixing it up below
            ev["_children"] = stack[-1][2]
    for evs in per_tid.values():
        for ev in evs:
            name = ev["name"]
            dur = ev.get("dur", 0)
            self_us = max(dur - ev.pop("_children")[0], 0)
            t = totals.setdefault(name, {"count": 0, "total_us": 0,
                                         "self_us": 0})
            t["count"] += 1
            t["total_us"] += dur
            t["self_us"] += self_us
            p = procs.setdefault(ev["pid"], {"spans": 0, "self_us": 0})
            p["spans"] += 1
            p["self_us"] += self_us
            stage = name.split(".", 1)[0]
            s = stages.setdefault(stage, {"wait_us": 0, "work_us": 0})
            leaf = name.rsplit(".", 1)[-1]
            if any(m in leaf for m in _WAIT_MARKERS):
                s["wait_us"] += self_us
            else:
                s["work_us"] += self_us
    ranked = sorted(totals.items(), key=lambda kv: -kv[1]["self_us"])
    proc_rows = [
        {"proc": proc_names.get(pid, str(pid)), **v}
        for pid, v in sorted(procs.items())]
    return {
        "spans": len([1 for evs in per_tid.values() for _ in evs]),
        "top_self_time": [{"name": k, **v} for k, v in ranked[:top]],
        "stages": {k: {**v,
                       "wait_frac": round(v["wait_us"]
                                          / max(v["wait_us"] + v["work_us"],
                                                1), 3)}
                   for k, v in sorted(stages.items())},
        "procs": proc_rows,
        "cross_proc_links": {
            "total": sum(link_pairs.values()),
            "pairs": dict(sorted(link_pairs.items())),
        },
        "warnings": drop_warnings(doc),
    }


def render_summary(summary: dict) -> str:
    """A terminal-friendly flame digest of ``summarize()``'s output."""
    lines = [f"{'span':<36} {'count':>7} {'total ms':>10} {'self ms':>10}"]
    for row in summary["top_self_time"]:
        lines.append(f"{row['name']:<36} {row['count']:>7} "
                     f"{row['total_us'] / 1000:>10.2f} "
                     f"{row['self_us'] / 1000:>10.2f}")
    lines.append("")
    lines.append(f"{'stage':<12} {'work ms':>10} {'wait ms':>10} "
                 f"{'wait %':>7}")
    for stage, s in summary["stages"].items():
        lines.append(f"{stage:<12} {s['work_us'] / 1000:>10.2f} "
                     f"{s['wait_us'] / 1000:>10.2f} "
                     f"{100 * s['wait_frac']:>6.1f}%")
    proc_rows = summary.get("procs") or []
    if len(proc_rows) > 1:
        lines.append("")
        lines.append(f"{'proc':<24} {'spans':>8} {'self ms':>10}")
        for row in proc_rows:
            lines.append(f"{row['proc']:<24} {row['spans']:>8} "
                         f"{row['self_us'] / 1000:>10.2f}")
        links = summary.get("cross_proc_links") or {}
        lines.append("")
        lines.append(f"cross-process parent links: {links.get('total', 0)}")
        for pair, n in (links.get("pairs") or {}).items():
            lines.append(f"  {pair}: {n}")
    for warn in summary.get("warnings") or ():
        lines.append("")
        lines.append(f"WARNING: {warn}")
    return "\n".join(lines)


# --- capture-from-boot (SPACEMESH_TRACE) --------------------------------

_boot = os.environ.get("SPACEMESH_TRACE", "")
if _boot and _boot.lower() not in ("0", "off", "false", "none"):
    start(capacity=int(_boot) if _boot.isdigit() and int(_boot) > 1
          else None)
