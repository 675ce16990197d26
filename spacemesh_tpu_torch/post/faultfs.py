"""Deterministic disk-fault injection for the PoST data plane.

Port of ``spacemesh_tpu/post/faultfs.py`` over the port's ``utils/fsio.py``.

A :class:`FaultFS` is a drop-in ``fs`` for post/data.py (LabelStore,
LabelWriter, PostMetadata via utils/fsio.py): it delegates every
primitive to the real filesystem while (a) counting operations and
(b) firing scripted faults at **exact operation counts** — same plan,
same op stream, same fault. No wall clock, no randomness outside
the plan's own seed.

Fault kinds (``FaultSpec.kind``):

* ``eio``      — the op raises ``OSError(EIO)`` once.
* ``enospc``   — the op raises ``OSError(ENOSPC)``; with ``hold_ops``
  every mutating op until the counter passes ``op + hold_ops`` also
  raises — "the disk stays full until the plan releases space".  The
  LabelWriter's degraded-mode retries advance the op counter, so the
  release point is deterministic in *operations*, not seconds.
* ``short``    — a ``pwrite`` persists only a seeded byte-prefix and
  returns the short count (POSIX allows this; callers must loop).
* ``torn``     — a ``pwrite`` persists a seeded byte-prefix and then
  the power fails (:class:`PowerCut`).
* ``powercut`` — the op raises :class:`PowerCut` before doing anything.

Power-cut semantics: the shim tracks, per file, the last **fsynced**
image (files that existed before the shim first touched them count as
durable).  ``reboot()`` rewinds the real directory to exactly that
durable state — un-fsynced bytes vanish, un-dir-fsynced renames and
unlinks roll back — which is the pessimistic-but-legal outcome a real
power cut may produce.  The harness then reopens the store and the
recovery path (post/data.py ``recover_store``) must converge.

The shadow images are whole-file copies, refreshed on every fsync:
this shim is for tests, not for production-sized stores.
"""

from __future__ import annotations

import dataclasses
import errno
import os
import random
import threading
from pathlib import Path

from ..utils import fsio, metrics

WRITE_KINDS = ("eio", "enospc", "short", "torn", "powercut")


class PowerCut(BaseException):
    """Simulated power loss. Derives from BaseException so it rips
    through ordinary ``except Exception`` recovery the way a real cord
    pull would; the crash harness catches it (or finds it behind a
    pool error's ``__cause__``) and calls ``FaultFS.reboot()``."""


def power_cut_behind(exc: BaseException) -> PowerCut | None:
    """The PowerCut hiding behind ``exc``'s cause/context chain, if
    any — writer-pool failures surface as LabelWriteError *from* the
    PowerCut that hit the pool thread."""
    seen: set[int] = set()
    node: BaseException | None = exc
    while node is not None and id(node) not in seen:
        if isinstance(node, PowerCut):
            return node
        seen.add(id(node))
        node = node.__cause__ or node.__context__
    return None


@dataclasses.dataclass
class FaultSpec:
    """One scripted fault: fire at mutating op number ``op`` (1-based,
    counted across the whole FaultFS lifetime, reboots included)."""

    op: int
    kind: str                 # one of WRITE_KINDS
    hold_ops: int = 0         # enospc: ops the disk stays full for
    on: str = "write"         # "write" | "read" (reads: eio only)

    def __post_init__(self):
        if self.kind not in WRITE_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """The seeded script a FaultFS executes. ``seed`` pins the torn/
    short prefix lengths; ``on_inject(spec, count)`` is a test hook
    called (on the faulting thread) each time a fault fires."""

    def __init__(self, faults=(), seed: int = 0, on_inject=None):
        self.faults = sorted((f if isinstance(f, FaultSpec)
                              else FaultSpec(**f) for f in faults),
                             key=lambda f: (f.on, f.op))
        self.seed = int(seed)
        self.on_inject = on_inject

    def prefix_len(self, op: int, total: int) -> int:
        """Deterministic torn/short prefix for the write at ``op``."""
        if total <= 1:
            return 0
        return random.Random(f"{self.seed}:{op}").randrange(0, total)


class FaultFS(fsio.RealFS):
    """fsio.RealFS with op counting, fault injection, and a durability
    shadow that makes power cuts rewindable. Thread-safe: writer-pool
    threads and the dispatch thread share one instance."""

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()
        self._lock = threading.Lock()
        self.write_ops = 0          # mutating ops performed or faulted
        self.read_ops = 0
        self.injected: list[dict] = []   # log: {"op","kind","path"}
        self._fd_paths: dict[int, str] = {}
        self._durable: dict[str, bytes | None] = {}  # path -> image
        # namespace ops (rename/unlink) waiting on their dir fsync:
        # dir -> [commit closure]
        self._pending_dir: dict[str, list] = {}
        self._enospc_until = 0

    # -- shadow-state helpers -------------------------------------------

    def _norm(self, path) -> str:
        return os.path.abspath(str(path))

    def _path_of(self, fd: int) -> str | None:
        with self._lock:
            return self._fd_paths.get(fd)

    # guarded by: self._lock — every caller holds it around the shadow-map update
    def _baseline(self, path: str) -> None:
        """First touch of a path: whatever is on disk NOW predates the
        plan and counts as durable. Directories are not shadowed — the
        shim rewinds file CONTENT; fsio.persist's directory payloads
        pass through uncorrupted but untracked."""
        if path in self._durable:
            return
        try:
            with open(path, "rb") as fh:
                self._durable[path] = fh.read()
        except FileNotFoundError:
            self._durable[path] = None
        except IsADirectoryError:
            pass

    # guarded by: self._lock — every caller holds it around the shadow-map update
    def _mark_durable(self, path: str) -> None:
        try:
            with open(path, "rb") as fh:
                self._durable[path] = fh.read()
        except FileNotFoundError:
            self._durable[path] = None
        except IsADirectoryError:
            pass

    # -- fault dispatch --------------------------------------------------

    def _next_op(self, on: str, path: str | None,
                 total: int | None = None,
                 can_partial: bool = False):
        """Advance the op counter; return None or a fired (spec, n,
        prefix) directive. Counter advances even on faulted ops, so an
        ENOSPC hold window measured in ops self-releases. Only pwrite
        sites (``can_partial``) can honor a byte-prefix directive — at
        every other op a torn/short spec degenerates to the power cut
        it models (an fsync or rename has no half-done return path)."""
        with self._lock:
            if on == "read":
                self.read_ops += 1
                n = self.read_ops
            else:
                self.write_ops += 1
                n = self.write_ops
            fired: FaultSpec | None = None
            if on == "write" and n < self._enospc_until:
                fired = FaultSpec(op=n, kind="enospc")
            else:
                for spec in self.plan.faults:
                    if spec.on == on and spec.op == n:
                        fired = spec
                        if spec.kind == "enospc" and spec.hold_ops:
                            self._enospc_until = n + spec.hold_ops
                        break
            if fired is None:
                return None
            entry = {"op": n, "on": on, "kind": fired.kind,
                     "path": os.path.basename(path) if path else None}
            self.injected.append(entry)
        metrics.post_store_fault_injections.inc(kind=fired.kind)
        if self.plan.on_inject is not None:
            self.plan.on_inject(fired, n)
        if fired.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO (op {n})", path)
        if fired.kind == "enospc":
            raise OSError(errno.ENOSPC,
                          f"injected ENOSPC (op {n})", path)
        if fired.kind == "powercut" or not can_partial:
            raise PowerCut(f"injected power cut (op {n}, "
                           f"{fired.kind}) at {path}")
        # short / torn at a pwrite: the caller performs the prefix write
        return fired, n, (self.plan.prefix_len(n, total or 0))

    # -- intercepted primitives ------------------------------------------

    def open(self, path, flags: int, mode: int = 0o644) -> int:
        p = self._norm(path)
        writable = flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)
        with self._lock:
            if writable:
                self._baseline(p)
        fd = os.open(p, flags, mode)
        with self._lock:
            self._fd_paths[fd] = p
        return fd

    def close(self, fd: int) -> None:
        with self._lock:
            self._fd_paths.pop(fd, None)
        os.close(fd)

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        self._next_op("read", self._path_of(fd))
        return os.pread(fd, n, offset)

    def pwrite(self, fd: int, data, offset: int) -> int:
        path = self._path_of(fd)
        data = bytes(data)
        directive = self._next_op("write", path, total=len(data),
                                  can_partial=True)
        if directive is not None:
            spec, n, prefix = directive
            if spec.kind == "short":
                # a POSIX short write is 1..len-1 bytes; zero would read
                # as "disk refused" and callers rightly error on it
                prefix = max(1, prefix)
            written = os.pwrite(fd, data[:prefix], offset)
            if spec.kind == "torn":
                raise PowerCut(
                    f"injected torn write (op {n}, {written}/{len(data)}"
                    f" bytes) at {path}")
            return written  # short write: POSIX-legal partial count
        return os.pwrite(fd, data, offset)

    def fsync(self, fd: int) -> None:
        path = self._path_of(fd)
        self._next_op("write", path)
        os.fsync(fd)
        if path is not None:
            with self._lock:
                self._mark_durable(path)

    def replace(self, src, dst) -> None:
        s, d = self._norm(src), self._norm(dst)
        self._next_op("write", d)
        with self._lock:
            self._baseline(s)
            self._baseline(d)
        os.replace(s, d)
        with self._lock:
            # the rename is volatile until the parent dir is fsynced
            self._pending_dir.setdefault(
                os.path.dirname(d), []).append(("rename", s, d))

    def truncate(self, path, length: int) -> None:
        p = self._norm(path)
        self._next_op("write", p)
        with self._lock:
            self._baseline(p)
        os.truncate(p, length)

    def unlink(self, path) -> None:
        p = self._norm(path)
        self._next_op("write", p)
        with self._lock:
            self._baseline(p)
        os.unlink(p)
        with self._lock:
            self._pending_dir.setdefault(
                os.path.dirname(p), []).append(("unlink", None, p))

    def fsync_dir(self, path) -> None:
        p = self._norm(path)
        self._next_op("write", p)
        fsio.REAL.fsync_dir(p)
        with self._lock:
            for kind, src, tgt in self._pending_dir.pop(p, ()):
                if kind == "rename":
                    self._mark_durable(tgt)
                    self._durable[src] = None
                else:
                    self._durable[tgt] = None

    # -- the crash/reboot cycle ------------------------------------------

    def reboot(self) -> list[str]:
        """Rewind the real tree to the durable shadow — every byte that
        was never fsynced (and every rename/unlink whose directory was
        never fsynced) vanishes, exactly once, deterministically.
        Returns the paths that changed. Op counters keep running so a
        multi-crash plan stays addressable across reboots."""
        changed: list[str] = []
        with self._lock:
            self._pending_dir.clear()
            images = dict(self._durable)
        for path, image in sorted(images.items()):
            try:
                current: bytes | None = Path(path).read_bytes()
            except (FileNotFoundError, IsADirectoryError):
                current = None
            if current == image:
                continue
            changed.append(path)
            if image is None:
                Path(path).unlink(missing_ok=True)
            else:
                with open(path, "wb") as fh:
                    fh.write(image)
                    fh.flush()
                    os.fsync(fh.fileno())
        return changed
