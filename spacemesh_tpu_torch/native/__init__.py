"""Native runtime components (C++), loaded with ctypes (port of
``spacemesh_tpu/native/__init__.py``).

The node runtime's hot host-side ops: one-shot blake3 (``blake3.cpp``,
every id, address and merkle node) and ECVRF (``ecvrf.cpp``, every
eligibility, hare and beacon check). Both sources are the port's own
copies of the JAX package's. Each is compiled with ``g++ -O3 -shared
-fPIC`` into ``build/libsmtpu_<name>-<hash>.so`` under the package (the
gitignored directory ``ops/_build.py`` builds the CUDA kernels into),
the hash taken over the source and the flags, so an edited source never
loads a stale library; the library is published through
``utils/fsio.persist`` (a tmp file per pid, fsync, atomic rename), so
processes building at once never dlopen a half-written file. Nothing is
built at import: the first call builds what it needs, and
:func:`build_all` builds both at once for callers that want them up
front (``chip_smoke.py``).

As in the JAX package every native component has a pure-Python twin
(``core/hashing.py``, ``core/signing.py``) that answers when the build
fails, so a host without ``g++`` still runs. The fallback is made
visible: :func:`status` says which libraries loaded and why one did not,
and the callers count each one-shot blake3 and VRF call per path
(``native`` or ``python``, :func:`count` / :func:`counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..utils import fsio

SRC = Path(__file__).resolve().parent
BUILD = SRC.parent / "build"
NAMES = ("blake3", "ecvrf")
FLAGS = ("-O3", "-shared", "-fPIC")
KINDS = ("blake3", "vrf")
PATHS = ("native", "python")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}
_STATUS: dict[str, dict] = {}
# guards the per-path call counters: the farm's backends hash and verify
# from worker threads, and `n += 1` is not atomic across threads
_COUNT_LOCK = threading.Lock()
_COUNTS = {kind: dict.fromkeys(PATHS, 0) for kind in KINDS}


def library_path(name: str, src_dir: Path = SRC,
                 build_dir: Path | None = None) -> Path:
    """Where ``<src_dir>/<name>.cpp`` builds: named by a hash of the
    source and the flags."""
    h = hashlib.sha256()
    h.update(name.encode() + b"\0" + (Path(src_dir) / f"{name}.cpp")
             .read_bytes())
    h.update(" ".join(FLAGS).encode())
    return Path(build_dir or BUILD) / f"libsmtpu_{name}-{h.hexdigest()[:16]}.so"


def build(name: str, src_dir: Path = SRC,
          build_dir: Path | None = None) -> Path:
    """Compile ``<src_dir>/<name>.cpp`` unless its library exists; returns
    the library's path. Raises ``RuntimeError`` when g++ fails or is
    missing."""
    out = library_path(name, src_dir, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = fsio.tmp_path(out)
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(Path(src_dir) / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for native/{name}.cpp (rc="
                               f"{proc.returncode}): {proc.stderr[-2000:]}")
        fsio.persist(tmp, out)
    except (subprocess.SubprocessError, OSError) as exc:
        raise RuntimeError(f"g++ could not build native/{name}.cpp: "
                           f"{type(exc).__name__}: {exc}") from exc
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build_all(names=NAMES) -> dict[str, Path]:
    """Build every named library, one g++ each, all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL | None:
    """Build (if no library for this source exists) and dlopen
    ``libsmtpu_<name>``; ``None`` on any failure, recorded in
    :func:`status` — the caller's Python twin answers then."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib, path = None, None
        try:
            path = build(name)
            lib = ctypes.CDLL(str(path))
            why = "loaded"
        except (RuntimeError, OSError) as exc:
            why = f"{type(exc).__name__}: {exc}"
        _LIBS[name] = lib
        _STATUS[name] = dict(loaded=lib is not None,
                             path=str(path) if lib is not None else None,
                             why=why)
        return lib


def opt_out(name: str, why: str) -> None:
    """Record that a caller chose its Python twin without loading
    ``name`` (``SPACEMESH_NO_NATIVE_VRF``)."""
    with _LOCK:
        _STATUS[name] = dict(loaded=False, path=None, why=why)


def status() -> dict:
    """Per library: ``loaded``, the loaded ``path`` and ``why`` (
    ``"loaded"``, the build or dlopen error, an opt-out, or ``"not
    requested yet"``)."""
    with _LOCK:
        return {name: dict(_STATUS.get(name) or dict(
            loaded=False, path=None, why="not requested yet"))
            for name in NAMES}


def count(kind: str, path: str) -> None:
    """One one-shot call of ``kind`` (``blake3`` or ``vrf``) answered by
    ``path`` (``native`` or ``python``)."""
    with _COUNT_LOCK:
        _COUNTS[kind][path] += 1


def counts() -> dict:
    """The calls per kind and path since the last :func:`zero_counts`."""
    with _COUNT_LOCK:
        return {kind: dict(paths) for kind, paths in _COUNTS.items()}


def zero_counts() -> None:
    with _COUNT_LOCK:
        for paths in _COUNTS.values():
            for path in paths:
                paths[path] = 0
