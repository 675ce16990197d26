"""Builds the CUDA kernels under ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/lib<name>-<hash>.so`` for ``sm_90a``, then loaded with
``ctypes``; the hash is of the source, every header under ``csrc/`` it
includes (``#include "..."``, followed through headers), and the flags, so
an edited source or header never loads a stale library. Nothing is built
at import: the first call that launches a kernel builds what it needs, and
:func:`build_all` starts one nvcc per source, all at once, for callers
that want every kernel up front (``chip_smoke.py``). A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("romix", "proving_scan", "pbkdf2", "k2pow")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# guards the wrappers' launch counters: the scheduler's threads launch
# concurrently, and `count += 1` is not atomic across threads
count_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, the toolkit's usual home, or
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, directly or
    through another header, each once, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.is_file():
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_one(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns nvcc's
    output (ptxas register and spill lines), empty if nothing was built."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    proc = subprocess.run(
        [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named kernel, one nvcc each, all started together;
    returns nvcc's output per name."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(_build_one, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _build_one(name)
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
