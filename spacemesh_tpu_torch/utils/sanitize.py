"""Runtime sanitizers (port of ``spacemesh_tpu/utils/sanitize.py``).

``SPACEMESH_SANITIZE`` arms cheap, always-compiled-in checks for the
dynamic halves of the recurring defect classes.  The value is either
``1``/``on``/``all`` (everything) or a comma-separated subset of kinds:
``race``, ``slow-callback`` (alias ``slow``), ``registry-thread``
(``registry``), ``jit-shape`` (``shape``); ``enable(modes=...)`` arms the
same kinds from code:

1. **Slow-callback detection**: every asyncio callback/task step is
   timed; one that holds the loop longer than the threshold
   (``SPACEMESH_SANITIZE_SLOW_MS``, default 250) records a violation
   attributed to the tracing span that was current *inside* the
   callback's context, so the report says "farm.batch blocked the loop
   for 800ms", not just "something was slow". Violations are recorded
   and counted (``sanitize_violations_total``), never raised: raising
   inside ``Handle._run`` would take down an unrelated task.

2. **Registry thread-affinity**: metrics instruments must be created on
   the thread that built their Registry (module import, in practice). A
   worker thread minting an instrument mid-run races get-or-create with
   other creation sites, which is how a histogram ends up with a bucket
   layout its recorder never asked for. Creation off-thread raises
   :class:`SanitizeError`.

3. **Compile-explosion guard** (``jit-shape``): in the JAX package the
   fused label programs may only be dispatched at power-of-two lane
   buckets, and :func:`on_jit_shape` raises at the dispatch boundary on
   any other shape. The port compiles its kernels once per source, not
   per shape (no shape buckets, ROADMAP "Not ported, on purpose"), so no
   port path calls :func:`on_jit_shape`: the kind parses and arms, and
   the hook is here for the JAX package's contract and its tests.

4. **Eraser-style lockset race detection** (``race``).  Locks created
   through :func:`lock` / :func:`condition` maintain a per-thread
   held-lockset; objects declared shared through :class:`SharedField`
   (the scheduler's tenant tables, the ``LabelWriter`` cursor, the
   metrics registry's series maps, the HEALTH probe map, the breaker
   registries) shrink a per-field candidate lockset on each access: an
   empty intersection once a second thread is involved reports a race
   with BOTH threads' stacks, the current tracing span, and
   ``sanitize_violations_total{kind="race"}``.  ``mode="owner-write"``
   is the loop-affinity contract: any thread may read (the GIL-snapshot
   pattern), only the first writing thread may write.  Two side-checks
   ride along: a **lock-order watcher** records the acquisition graph as
   it happens and reports inversions; ``Handle._run`` reports a callback
   that RETURNS TO THE LOOP with a tracked ``threading`` lock still held
   (``with lock: await ...``, the event-loop-wedge class, detected at
   the first suspension); all are recorded, never raised.  Note:
   :func:`lock` / :func:`condition` decide at CONSTRUCTION time: arm the
   sanitizer before building the objects you want watched (the env var
   arms it at import).

The hooks cost one flag check each when the sanitizer is off, and
:func:`lock`/:func:`condition` hand back raw ``threading`` primitives
when race mode is off at construction.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time

from . import logging as slog
from . import tracing

_log = slog.get("sanitize")

ENV = "SPACEMESH_SANITIZE"
ENV_SLOW_MS = "SPACEMESH_SANITIZE_SLOW_MS"

_OFF = ("", "0", "off", "false", "none", "no")
_ALL = ("1", "on", "true", "all", "yes")

KIND_SLOW = "slow-callback"
KIND_REGISTRY = "registry-thread"
KIND_SHAPE = "jit-shape"
KIND_RACE = "race"
KINDS = (KIND_SLOW, KIND_REGISTRY, KIND_SHAPE, KIND_RACE)

# the race subsystem's sibling report kinds (armed together by the
# "race" mode token; distinct in violations() and the metrics label)
KIND_ORDER = "lock-order"
KIND_AWAIT = "lock-across-await"

_MODE_ALIASES = {
    "slow": KIND_SLOW, KIND_SLOW: KIND_SLOW,
    "registry": KIND_REGISTRY, KIND_REGISTRY: KIND_REGISTRY,
    "shape": KIND_SHAPE, KIND_SHAPE: KIND_SHAPE,
    "race": KIND_RACE, "lockset": KIND_RACE,
}

DEFAULT_SLOW_S = 0.25
MAX_VIOLATIONS = 256
_STACK_DEPTH = 8


class SanitizeError(RuntimeError):
    """A sanitizer contract was violated (raising kinds only)."""


@dataclasses.dataclass
class Violation:
    kind: str              # KINDS member, or KIND_ORDER / KIND_AWAIT
    detail: str
    span: int | None       # tracing span id current at the violation
    seconds: float | None = None
    thread: str | None = None        # reporting thread
    stack: str | None = None         # reporting thread's stack
    other_thread: str | None = None  # the racing peer, when known
    other_stack: str | None = None


def parse_modes(raw: str | None) -> frozenset[str]:
    """``SPACEMESH_SANITIZE`` value -> armed kind set (empty = off).
    Unknown tokens are logged and ignored, they never silently arm or
    disarm everything."""
    raw = (raw or "").strip().lower()
    if raw in _OFF:
        return frozenset()
    if raw in _ALL:
        return frozenset(KINDS)
    modes: set[str] = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        kind = _MODE_ALIASES.get(tok)
        if kind is None:
            _log.warning("sanitize: unknown %s kind %r ignored "
                         "(known: %s, or 1/on/all)", ENV, tok,
                         ",".join(KINDS))
            continue
        modes.add(kind)
    return frozenset(modes)


def parse_slow_threshold(raw: str | None) -> float | None:
    """``SPACEMESH_SANITIZE_SLOW_MS`` -> seconds. Garbage and
    non-positive values fall back to the default (None): a typo'd
    threshold must not silence — or spam — the slow-callback check."""
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        _log.warning("sanitize: bad %s=%r, using default %.0fms",
                     ENV_SLOW_MS, raw, DEFAULT_SLOW_S * 1000)
        return None
    if ms <= 0:
        _log.warning("sanitize: non-positive %s=%r, using default "
                     "%.0fms", ENV_SLOW_MS, raw, DEFAULT_SLOW_S * 1000)
        return None
    return ms / 1000.0


_enabled = False
_modes: frozenset[str] = frozenset()
_race = False
_slow_threshold_s = DEFAULT_SLOW_S
_violations: list[Violation] = []
_lock = threading.Lock()
_handle_patched = False
_orig_handle_run = None


def enabled(kind: str | None = None) -> bool:
    if kind is None:
        return _enabled
    return kind in _modes


def race_enabled() -> bool:
    return _race


def violations() -> list[Violation]:
    with _lock:
        return list(_violations)


def clear_violations() -> None:
    """Forget recorded violations AND the lock-order watcher's edge
    memory (tests isolate order-graph scenarios per case)."""
    with _lock:
        _violations.clear()
    with _order_lock:
        _order_edges.clear()


def _caller_stack(skip: int = 2) -> str:
    """A compact ``file:line fn`` stack of the caller, cheap enough to
    take on every sanitized access (no source-line loading)."""
    frames = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ""
    while f is not None and len(frames) < _STACK_DEPTH:
        code = f.f_code
        if "/utils/sanitize" not in code.co_filename:
            frames.append(f"{code.co_filename}:{f.f_lineno} "
                          f"{code.co_name}")
        f = f.f_back
    return " <- ".join(frames)


def _record(kind: str, detail: str, *, span: int | None = None,
            seconds: float | None = None, stack: str | None = None,
            other_thread: str | None = None,
            other_stack: str | None = None) -> Violation:
    v = Violation(kind, detail, span, seconds,
                  thread=threading.current_thread().name, stack=stack,
                  other_thread=other_thread, other_stack=other_stack)
    with _lock:
        if len(_violations) < MAX_VIOLATIONS:
            _violations.append(v)
    try:
        from . import metrics

        metrics.sanitize_violations.inc(kind=kind)
    except Exception:  # noqa: BLE001 — the sanitizer must never take
        pass           # down the code it watches
    _log.warning("sanitize[%s]: %s%s%s%s", kind, detail,
                 f" ({seconds * 1000:.0f}ms)" if seconds is not None else "",
                 f" [span {span}]" if span is not None else "",
                 f"\n  this thread ({v.thread}): {stack}"
                 + (f"\n  other thread ({other_thread}): {other_stack}"
                    if other_stack else "") if stack else "")
    return v


# --- 1. slow asyncio callbacks (+ lock-held-across-await) ---------------


def _patch_handle() -> None:
    """Wrap ``asyncio.events.Handle._run`` once per process; the wrapper
    is a single flag check when the sanitizer is disabled."""
    global _handle_patched, _orig_handle_run
    if _handle_patched:
        return
    import asyncio.events as aev

    _orig_handle_run = aev.Handle._run

    def _run(self):  # noqa: ANN001 — signature fixed by asyncio
        if not _enabled:
            return _orig_handle_run(self)
        # a callback step that ACQUIRES a tracked threading lock and
        # then returns control to the loop still holding it is a
        # coroutine suspended inside `with lock:` — every other
        # acquirer (loop callbacks included) parks until it resumes
        entry_held = frozenset(_held()) if _race else None
        t0 = time.perf_counter()
        try:
            return _orig_handle_run(self)
        finally:
            dt = time.perf_counter() - t0
            if entry_held is not None:
                leaked = [k for k in _held() if k not in entry_held]
                if leaked:
                    names = ", ".join(sorted(k[0] for k in leaked))
                    _record(KIND_AWAIT,
                            f"threading lock(s) {names} held across an "
                            "await: the callback returned to the event "
                            "loop still holding them",
                            span=tracing.current_id(),
                            stack=_caller_stack(1))
            if dt >= _slow_threshold_s and KIND_SLOW in _modes:
                # the span current INSIDE the callback's context — the
                # contextvars Context the loop ran it under — names the
                # work that held the loop
                span = None
                ctx = getattr(self, "_context", None)
                if ctx is not None:
                    try:
                        span = ctx.get(tracing._current)
                    except Exception:  # noqa: BLE001
                        span = None
                try:
                    what = repr(getattr(self, "_callback", self))
                except Exception:  # noqa: BLE001
                    what = "<unprintable callback>"
                _record(KIND_SLOW,
                        f"event-loop callback held the loop for "
                        f"{dt * 1000:.0f}ms (threshold "
                        f"{_slow_threshold_s * 1000:.0f}ms): {what:.200}",
                        span=span, seconds=dt)

    aev.Handle._run = _run
    _handle_patched = True


# --- 2. registry thread-affinity ----------------------------------------


def on_instrument_create(name: str, registry) -> None:
    """Called from ``metrics.Registry._get`` when a NEW instrument is
    about to be created. Raises off the registry's owning thread."""
    if KIND_REGISTRY not in _modes:
        return
    owner = getattr(registry, "_created_thread", None)
    if owner is None or owner == threading.get_ident():
        return
    _record(KIND_REGISTRY,
            f"instrument {name!r} created on thread "
            f"{threading.current_thread().name!r}, but its registry "
            "belongs to another thread: create instruments at module "
            "import, record from anywhere",
            span=tracing.current_id())
    raise SanitizeError(
        f"metrics instrument {name!r} created off the registry's owning "
        "thread (SPACEMESH_SANITIZE)")


# --- 3. compile-explosion guard -----------------------------------------


def on_jit_shape(fn_name: str, lanes: int) -> None:
    """The JAX package's jit dispatch boundary hook: off-bucket
    (non-power-of-two) lane counts raise. No port path calls it (the
    kernels compile once per source, whatever the lane count)."""
    if KIND_SHAPE not in _modes:
        return
    try:
        lanes = int(lanes)
    except (TypeError, ValueError):
        return  # symbolic/traced dim: not a host dispatch
    if lanes >= 1 and lanes & (lanes - 1) == 0:
        return
    _record(KIND_SHAPE,
            f"{fn_name} dispatched {lanes} lanes — outside the "
            "power-of-two bucket grid; some caller "
            "bypassed the pad-and-trim wrappers",
            span=tracing.current_id())
    raise SanitizeError(
        f"{fn_name}: off-bucket jit shape {lanes} (SPACEMESH_SANITIZE)")


# --- 4. lockset race detection ------------------------------------------
#
# Held-lockset entries are ``(name, id(raw lock))``: the ORDER watcher
# reasons over names (every LabelWriter's ``_lock`` is one node), the
# CANDIDATE locksets intersect over instances (another writer's lock
# does not protect this writer's cursor).

_tls = threading.local()


def _held() -> set:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = set()
    return held


_order_lock = threading.Lock()
# (held-name, acquired-name) -> stack text at first observation
_order_edges: dict[tuple[str, str], str] = {}
_in_report = threading.local()


def _order_reaches(src: str, dst: str) -> bool:
    seen: set[str] = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(b for (a, b) in _order_edges if a == n)
    return False


def _note_acquire(key: tuple) -> None:
    """Order check + held-set insert for a tracked lock acquisition."""
    held = _held()
    if held and not getattr(_in_report, "on", False):
        bn = key[0]
        stack = None
        for hk in held:
            an = hk[0]
            if an == bn:
                continue
            with _order_lock:
                known = (an, bn) in _order_edges
                if not known:
                    inversion = _order_reaches(bn, an)
                    other = _order_edges.get((bn, an))
                    if stack is None:
                        stack = _caller_stack(3)
                    _order_edges[(an, bn)] = stack
            if not known and inversion:
                _in_report.on = True
                try:
                    _record(KIND_ORDER,
                            f"lock-order inversion: {bn} acquired while "
                            f"holding {an}, but the opposite order was "
                            "observed earlier — two threads taking the "
                            "two paths deadlock",
                            span=tracing.current_id(), stack=stack,
                            other_stack=other)
                finally:
                    _in_report.on = False
    held.add(key)


class TrackedLock:
    """``threading.Lock`` twin feeding the per-thread held-lockset."""

    __slots__ = ("_raw", "name", "_key")

    def __init__(self, name: str, raw=None):
        self._raw = raw if raw is not None else threading.Lock()
        self.name = name
        self._key = (name, id(self._raw))

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._raw.acquire(blocking, timeout)
        if ok and _race:
            _note_acquire(self._key)
        return ok

    def release(self) -> None:
        _held().discard(self._key)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class TrackedCondition:
    """``threading.Condition`` twin; shares its root lock's held-set
    key, so ``with cond:`` counts as holding the lock it wraps (the
    ``Condition(self._lock)`` aliasing)."""

    __slots__ = ("_cond", "name", "_key")

    def __init__(self, name: str, lock=None):
        if isinstance(lock, TrackedLock):
            self._cond = threading.Condition(lock._raw)
            self._key = lock._key
        else:
            self._cond = threading.Condition(lock)
            self._key = (name, id(self._cond._lock))
        self.name = name

    def acquire(self, *a) -> bool:
        ok = self._cond.acquire(*a)
        if ok and _race:
            _note_acquire(self._key)
        return ok

    def release(self) -> None:
        _held().discard(self._key)
        self._cond.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: float | None = None) -> bool:
        # wait() drops the lock while parked and reacquires before
        # returning; the held-set must mirror that or every waiter
        # looks like it holds the lock across the whole wait
        held = _held()
        held.discard(self._key)
        try:
            return self._cond.wait(timeout)
        finally:
            if _race:
                held.add(self._key)

    def wait_for(self, predicate, timeout: float | None = None):
        held = _held()
        held.discard(self._key)
        try:
            return self._cond.wait_for(predicate, timeout)
        finally:
            if _race:
                held.add(self._key)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


def lock(name: str):
    """A lock for sanitizer-aware modules: tracked when race mode is
    armed at CONSTRUCTION, a raw ``threading.Lock`` (zero overhead)
    otherwise."""
    return TrackedLock(name) if _race else threading.Lock()


def condition(name: str, lock=None):
    """Condition twin of :func:`lock`; pass the owning tracked lock to
    share its critical-section identity."""
    if _race or isinstance(lock, TrackedLock):
        return TrackedCondition(name, lock)
    return threading.Condition(lock)


class SharedField:
    """One declared-shared object (a cursor, a table, a subscriber
    list).  ``touch(write=...)`` is the access hook — one module-level
    flag check when race mode is off.

    ``mode="lockset"``  Eraser: candidates := held at the first access
    after a second thread joins, then intersect on every access; an
    empty candidate set with a cross-thread write in play reports.
    ``mode="owner-write"``  the loop-affinity contract: any thread may
    read, only the first writing thread may write.
    """

    __slots__ = ("name", "mode", "_armed", "_threads", "_writer",
                 "_candidates", "_shared", "_written_shared",
                 "_last_by_thread", "_last_tid", "_reported",
                 "_state_lock")

    def __init__(self, name: str, mode: str = "lockset"):
        if mode not in ("lockset", "owner-write"):
            raise ValueError(f"unknown SharedField mode {mode!r}")
        self.name = name
        self.mode = mode
        # armed at CONSTRUCTION, like lock()/condition(): a field built
        # while race mode was off pairs with RAW locks the held-set
        # never sees — refining it later would only manufacture false
        # races (arm via the env var to watch import-time singletons)
        self._armed = _race
        self._threads: set[int] = set()
        self._writer: int | None = None
        self._candidates: set | None = None   # None = exclusive phase
        self._shared = False
        self._written_shared = False
        self._last_by_thread: dict[int, tuple[str, int | None]] = {}
        self._last_tid: int | None = None
        self._reported = False
        self._state_lock = threading.Lock()

    def reset(self) -> None:
        """Forget ownership/lockset history — for owners whose state is
        legitimately recreated (LaneGroup.bind() to a fresh event loop:
        the new loop may live on a different thread, and the dead
        loop's thread must not be remembered as the owner)."""
        with self._state_lock:
            self._threads = set()
            self._writer = None
            self._candidates = None
            self._shared = False
            self._written_shared = False
            self._last_by_thread = {}
            self._last_tid = None
            self._reported = False

    def touch(self, write: bool = True) -> None:
        if not _race or not self._armed:
            return
        tid = threading.get_ident()
        held = frozenset(_held())
        stack = _caller_stack(2)
        span = tracing.current_id()
        report = None
        with self._state_lock:
            self._threads.add(tid)
            if self.mode == "owner-write":
                if write:
                    if self._writer is None:
                        self._writer = tid
                    elif self._writer != tid and not self._reported:
                        self._reported = True
                        report = self._report_args(
                            tid, f"{self.name}: write from thread "
                            f"{threading.current_thread().name!r} but "
                            "the field is owner-write (loop-only): "
                            "first writer owns mutation")
            else:
                if len(self._threads) > 1:
                    if not self._shared:
                        self._shared = True
                        self._candidates = set(held)
                    else:
                        self._candidates &= held
                    if write:
                        self._written_shared = True
                    if (not self._candidates and self._written_shared
                            and not self._reported):
                        self._reported = True
                        report = self._report_args(
                            tid, f"{self.name}: no common lock protects "
                            "this field across its accessing threads "
                            "(candidate lockset is empty)")
            self._last_by_thread[tid] = (stack, span)
            self._last_tid = tid
        if report is not None:
            detail, other_thread, other_stack = report
            _record(KIND_RACE, detail, span=span, stack=stack,
                    other_thread=other_thread, other_stack=other_stack)

    # guarded by: self._state_lock — touch() is the only caller and holds it
    def _report_args(self, tid: int, detail: str):
        other_thread = other_stack = None
        for otid, (ostack, _ospan) in self._last_by_thread.items():
            if otid != tid:
                other_thread, other_stack = str(otid), ostack
        return detail, other_thread, other_stack


# --- lifecycle ----------------------------------------------------------


def enable(slow_threshold_s: float | None = None,
           modes=None) -> None:
    """Arm the sanitizer (``modes`` None = every kind).  Note that
    :func:`lock`/:func:`condition` decide at construction: objects
    built before ``enable()`` stay untracked."""
    global _enabled, _modes, _race, _slow_threshold_s
    if slow_threshold_s is not None:
        _slow_threshold_s = float(slow_threshold_s)
    if modes is None:
        _modes = frozenset(KINDS)
    else:
        kept: set[str] = set()
        for m in modes:
            kind = _MODE_ALIASES.get(m)
            if kind is None:
                # same contract as parse_modes: a typo'd token must
                # never SILENTLY disarm a check the caller believes on
                _log.warning("sanitize: unknown enable() mode %r "
                             "ignored (known: %s)", m, ",".join(KINDS))
                continue
            kept.add(kind)
        _modes = frozenset(kept)
    _race = KIND_RACE in _modes
    _patch_handle()
    _enabled = bool(_modes)


def disable() -> None:
    """Disarm (the Handle patch stays installed but inert)."""
    global _enabled, _modes, _race
    _enabled = False
    _race = False
    _modes = frozenset()


def _boot() -> None:
    modes = parse_modes(os.environ.get(ENV))
    if not modes:
        return
    enable(parse_slow_threshold(os.environ.get(ENV_SLOW_MS)), modes)


_boot()
