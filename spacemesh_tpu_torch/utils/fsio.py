"""Crash-safe persistence primitives: tmp + fsync + rename + dir-fsync.

Copy of ``spacemesh_tpu/utils/fsio.py``. A durable replace of a file is:

    1. write the payload to ``<dst>.tmp.<pid>``;
    2. ``fsync`` the tmp file;
    3. ``os.replace`` tmp -> dst;
    4. ``fsync`` the parent directory.

Every function takes an optional ``fs``: an object with the os-shaped
primitive methods of :class:`RealFS`, so the disk-fault shim
(``post/faultfs.py``) can fire EIO/ENOSPC/torn-write/power-cut faults at
exact operation counts underneath unmodified callers. ``None`` is the real
filesystem.
"""

from __future__ import annotations

import os
from pathlib import Path

TMP_MARK = ".tmp."


class RealFS:
    """The os-backed primitive set. One method per syscall, so a shim can
    intercept, count and fault each operation on its own."""

    def open(self, path, flags: int, mode: int = 0o644) -> int:
        return os.open(str(path), flags, mode)

    def close(self, fd: int) -> None:
        os.close(fd)

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        return os.pread(fd, n, offset)

    def pwrite(self, fd: int, data, offset: int) -> int:
        return os.pwrite(fd, data, offset)

    def fsync(self, fd: int) -> None:
        os.fsync(fd)

    def replace(self, src, dst) -> None:
        os.replace(str(src), str(dst))

    def truncate(self, path, length: int) -> None:
        os.truncate(str(path), length)

    def unlink(self, path) -> None:
        os.unlink(str(path))

    def fsync_dir(self, path) -> None:
        fd = os.open(str(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # metadata queries: passed through, never faulted

    def exists(self, path) -> bool:
        return os.path.exists(str(path))

    def getsize(self, path) -> int:
        return os.path.getsize(str(path))


REAL = RealFS()


def _resolve(fs) -> RealFS:
    return REAL if fs is None else fs


def tmp_path(path) -> Path:
    """The tmp sibling a durable write of ``path`` stages through."""
    p = Path(path)
    return p.with_name(f"{p.name}{TMP_MARK}{os.getpid()}")


def fsync_dir(path, fs=None) -> None:
    """Durably commit ``path``'s directory entries (renames/unlinks)."""
    _resolve(fs).fsync_dir(path)


def atomic_write_bytes(path, data: bytes, fs=None) -> None:
    """Durably replace ``path`` with ``data``. Raises OSError on any step;
    the destination is then untouched."""
    fs = _resolve(fs)
    p = Path(path)
    tmp = tmp_path(p)
    fd = fs.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC)
    try:
        try:
            view = memoryview(data)
            off = 0
            while off < len(view):
                n = fs.pwrite(fd, view[off:], off)
                if n <= 0:
                    raise OSError(f"zero-length write to {tmp}")
                off += n
            fs.fsync(fd)
        finally:
            fs.close(fd)
        fs.replace(tmp, p)
        fs.fsync_dir(p.parent)
    except BaseException:
        # the stage failed (or a simulated power cut): drop the tmp if the
        # rename did not happen; the destination is untouched
        try:
            if fs.exists(tmp):
                fs.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path, text: str, fs=None) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fs=fs)


def _fsync_file(path, fs) -> None:
    fd = fs.open(path, os.O_RDONLY)
    try:
        fs.fsync(fd)
    finally:
        fs.close(fd)


def persist(tmp, dst, fs=None) -> None:
    """Durably publish an already-written ``tmp`` (file or directory) at
    ``dst``: fsync the tmp, rename, fsync the parent. A directory payload
    fsyncs every regular file inside it before the rename, so the names
    never become durable ahead of the data."""
    fs = _resolve(fs)
    tmp, dst = Path(tmp), Path(dst)
    if tmp.is_dir():
        for sub in sorted(tmp.rglob("*")):
            if sub.is_dir():
                fs.fsync_dir(sub)
            elif sub.is_file():
                _fsync_file(sub, fs)
        fs.fsync_dir(tmp)
    else:
        _fsync_file(tmp, fs)
    fs.replace(tmp, dst)
    fs.fsync_dir(dst.parent)


def stale_tmps(path) -> list[Path]:
    """Tmp siblings a crashed earlier save of ``path`` may have left: the
    ``<name>.tmp.<pid>`` staging names plus the legacy ``<stem>.tmp``."""
    p = Path(path)
    if not p.parent.is_dir():
        return []
    out = [c for c in p.parent.iterdir()
           if c.name.startswith(p.name + TMP_MARK)]
    legacy = p.with_suffix(".tmp")
    if legacy != p and legacy.exists():
        out.append(legacy)
    return sorted(out)


def cleanup_stale_tmps(path, fs=None) -> int:
    """Delete crash-leftover tmp files beside ``path``; returns the count
    removed (their payload was never published)."""
    fs = _resolve(fs)
    n = 0
    for tmp in stale_tmps(path):
        try:
            fs.unlink(tmp)
            n += 1
        except OSError:
            pass
    return n
