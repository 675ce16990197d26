"""ROMix autotuner: race the candidates once, persist the winner.

Port of ``spacemesh_tpu/ops/autotune.py``. On the card the port has one
ROMix implementation, the kernel of ``csrc/romix.cu``; what is left to
tune is the JAX package's branch for platforms other than CPU and TPU:
the lane chunk (the wrapper's ``max_lanes``, ``ops/romix_cuda.py``: at
most that many lanes per launch, so only one chunk's V scratch is live)
and the device count (``parallel/``, the lanes striped over that many
devices). First use races those candidates on a calibration workload and
persists the winner per ``(platform, N, batch, device cap)``, so every
entry point (the label batches of ``ops/scrypt.py``, ``post/
initializer.py``, ``post/prover.py``, ``post/verifier.py``, the
scheduler's packs) picks it up with no configuration, and a second
process on the host skips the race.

Decision precedence (highest first):

1. the environment: ``SPACEMESH_ROMIX`` names the implementation (the
   port's names only: ``cuda``, the kernel, or ``plain``, its twin, which
   runs only on CPU tensors; the JAX package's ``xla``, ``xla-rows`` and
   ``pallas`` raise ``ValueError``), ``SPACEMESH_ROMIX_CHUNK`` the lanes
   per launch (``0``/``off`` = unchunked), ``SPACEMESH_MESH`` the device
   count (``0``/``off`` = 1, ``1``/``on`` = every visible device, an
   integer >= 2 = exactly that many); any of them beats a cached winner;
2. the persisted winner for ``(platform, N, batch, device cap)``;
3. a race (off with ``SPACEMESH_ROMIX_AUTOTUNE=off``), whose result is
   persisted;
4. the static default: the unchunked kernel on one device.

Against the JAX package:

* **No fallback that hides the kernel.** Every candidate is the same
  kernel, so a candidate that fails to build or launch raises, and the
  race writes nothing (the JAX race records a 0-rate row and moves on).
  The plain twin is never raced on a CUDA tensor: a CUDA race runs the
  kernel, a CPU race (the tests) the twin.
* **The calibration batch.** The JAX ``CAL_BATCH`` of 512 lanes is the
  CPU's. On the card 512 lanes fill 16 of 132 SMs and a row's labels/s is
  a latency; the race there runs at the lanes that fill the card
  (:data:`CUDA_CAL_BATCH`, ``csrc/romix.cu``), capped by what fits the
  free memory, and persists that batch as ``cal_batch``. The chunk grid
  keeps the JAX rule (:func:`chunk_candidates`, and ``chunk <`` the
  calibration batch).
* **Timing.** The first call of a row (its build, its scratch's first
  allocation) is its ``compile_s``, not a rep; each rep ends with
  ``torch.cuda.synchronize``.
* **One mesh shape.** The JAX grid has two mesh layouts for its two XLA
  kernels; the port's one kernel stripes the lane axis (``lane``).

Cache file: ``<cache root>/romix_autotune.json``, the root being
``$SPACEMESH_TORCH_CACHE`` or ``~/.cache/spacemesh_tpu_torch``
(``ops/_build.py``), never the JAX package's file. A corrupt or
unreadable file reads as empty: the race re-runs and rewrites it.

The race runs in a ``romix.race`` span with a ``romix.race_candidate``
span per row, and counts ``post_romix_autotune_races_total``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np

from . import _build

SCHEMA = 2  # the JAX package's: rows and winners carry a device count
IMPLS = ("cuda", "plain")
PLATFORM_IMPL = {"cuda": "cuda", "cpu": "plain"}
MAX_MESH_DEVICES = 8  # the raced device-count grid is {1, 2, 4, 8}

# the one mesh shape: the lane axis striped over ``data`` (the JAX grid's
# second shape, a V-sharded row layout, belongs to its row-major kernel)
MESH_SHAPES = ("lane",)


def shape_of(impl: str) -> str:
    """The mesh shape an impl uses when its lanes stripe over ``data``."""
    return "lane"


ENV_IMPL = "SPACEMESH_ROMIX"
ENV_CHUNK = "SPACEMESH_ROMIX_CHUNK"
ENV_AUTOTUNE = "SPACEMESH_ROMIX_AUTOTUNE"
ENV_CACHE = _build.ENV_CACHE  # moves the whole cache root
ENV_MESH = "SPACEMESH_MESH"  # shared with post/initializer.py + prover

# calibration workload: CAL_BATCH lanes on the CPU (the JAX package's);
# on the card the lanes that fill it, capped by the free memory
CAL_BATCH = 512
CUDA_CAL_BATCH = 32768
CAL_REPS = 2

_OFF = ("0", "off", "none", "false")


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Decision:
    """A resolved kernel choice for one (platform, N, batch) shape."""

    impl: str                 # "cuda" | "plain"
    chunk: int | None         # lanes per launch; None = the memory cap
    source: str               # "env" | "cache" | "race" | "default"
    labels_per_sec: float | None = None  # calibration rate, when raced
    devices: int = 1          # stripe the batch over this many devices
    #                           (parallel/mesh.py; 1 = single device)
    mesh_shape: str = "lane"

    def as_json(self) -> dict:
        return {"impl": self.impl, "chunk": self.chunk,
                "source": self.source, "devices": self.devices,
                "shape": self.mesh_shape,
                "labels_per_sec": self.labels_per_sec}


def cache_path() -> str:
    """The autotune winners file, in the port's cache root."""
    return str(_build.cache_root() / "romix_autotune.json")


def _key(platform: str, n: int, batch: int, dev_cap: int = 1) -> str:
    # dev_cap: the device budget the winner was selected under; the best
    # single-device row (d1, the per-batch dispatch's) and the best row
    # under the host's mesh cap never overwrite each other
    return f"v{SCHEMA}:{platform}:n{n}:b{batch}:d{dev_cap}"


def _shape_key(platform: str, n: int, batch: int, dev_cap: int,
               shape: str) -> str:
    return _key(platform, n, batch, dev_cap) + f":s{shape}"


def _load_cache(path: str | None = None) -> dict:
    path = path or cache_path()
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError("autotune cache root is not an object")
        return doc
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        # a corrupt winners file must never break labeling: re-race
        _log(f"romix autotune: ignoring unreadable cache {path} ({e})")
        return {}


def _store(key: str, entry: dict) -> None:
    _store_many({key: entry})


def _store_many(entries: dict) -> None:
    path = cache_path()
    doc = _load_cache(path)
    doc.update(entries)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # durable write (tmp + fsync + rename + dir-fsync): a power cut
        # never leaves a half-written winners file
        from ..utils import fsio

        fsio.atomic_write_text(
            path, json.dumps(doc, indent=1, sort_keys=True))
    except OSError as e:
        # persistence is an optimization (read-only HOME, sandboxed CI)
        _log(f"romix autotune: cannot persist winner ({e})")


def _entry_decision(entry: dict, batch: int, source: str) -> Decision | None:
    impl = entry.get("impl")
    chunk = entry.get("chunk")
    devices = entry.get("devices", 1)
    if impl not in IMPLS:
        return None
    if chunk is not None and (not isinstance(chunk, int) or chunk < 1):
        return None
    if not isinstance(devices, int) or isinstance(devices, bool) \
            or devices < 1:
        return None
    if chunk is not None and chunk >= batch:
        chunk = None
    shape = entry.get("shape") or shape_of(impl)
    if shape not in MESH_SHAPES:
        return None
    rate = entry.get("labels_per_sec")
    return Decision(impl, chunk, source,
                    rate if isinstance(rate, (int, float)) else None,
                    devices=devices, mesh_shape=shape)


def read_env() -> tuple[str | None, int | None, bool, bool]:
    """-> (impl override, chunk override, chunk was set, race disabled)."""
    impl = os.environ.get(ENV_IMPL) or None
    if impl is not None and impl not in IMPLS:
        raise ValueError(
            f"{ENV_IMPL}={impl!r}: expected one of {', '.join(IMPLS)} "
            "(the port's ROMix: the CUDA kernel, or its plain twin on CPU "
            "tensors)")
    chunk_raw = os.environ.get(ENV_CHUNK)
    chunk_set = chunk_raw is not None and chunk_raw != ""
    chunk: int | None = None
    if chunk_set and chunk_raw.lower() not in _OFF:
        chunk = int(chunk_raw)
        if chunk < 1:
            raise ValueError(f"{ENV_CHUNK}={chunk_raw!r}: must be >= 1")
    no_race = (os.environ.get(ENV_AUTOTUNE) or "").lower() in _OFF
    return impl, chunk, chunk_set, no_race


def read_mesh_env() -> int | None:
    """``SPACEMESH_MESH`` as a device count: None = auto (tuned),
    ``0``/``off`` = 1 (never stripe), ``1``/``on`` = every visible device,
    an integer >= 2 = exactly that many devices."""
    raw = os.environ.get(ENV_MESH)
    if raw is None:
        return None
    v = raw.strip().lower()
    if v in ("", "auto"):
        return None
    if v in _OFF:
        return 1
    if v in ("1", "on"):
        return _device_count()
    try:
        count = int(v)
    except ValueError:
        raise ValueError(
            f"{ENV_MESH}={raw!r}: expected off/on/auto or a device count")
    if count < 1:
        raise ValueError(f"{ENV_MESH}={raw!r}: device count must be >= 1")
    return count


def _topology():
    from ..parallel import topology

    return topology.get()


def _device_count() -> int:
    return _topology().device_count


def resolve_auto_mesh(n: int, batch: int, platform: str | None = None):
    """-> (device list | None, Decision) for a mesh-aware caller in
    ``auto`` mode: the one definition of the routing that post/
    initializer.py, post/prover.py, post/verifier.py and the scheduler's
    packs share.

    On the CPU the tuned mesh winner decides (devices > 1 only when the
    raced row says so and the topology has that many stripes). On the
    card the JAX package's whole-mesh default holds: every visible card,
    so with one card None and the caller stays on one device.
    ``SPACEMESH_MESH`` forces either way. ``platform`` is the caller's
    device type (default: the topology's); a caller on another device
    type than the topology's stays on one device."""
    topo = _topology()
    platform = platform or topo.platform
    if platform != topo.platform:
        return None, decide(n, batch, platform=platform)
    if platform != "cpu":
        forced = read_mesh_env()
        count = topo.device_count
        d = decide(n, batch, platform=platform)
        if forced == 1 or count <= 1:
            return None, d
        return list(topo.devices[:min(forced or count, count)]), d
    d = decide(n, batch, platform=platform, max_devices=None)
    if d.devices > 1 and topo.device_count >= d.devices:
        return list(topo.devices[:d.devices]), d
    return None, d


def _device_cap(max_devices: int | None) -> int:
    """The device budget for one decide() call: the caller's cap clipped
    to the topology and the raced grid. ``max_devices=1`` short-circuits
    without touching the topology."""
    if max_devices == 1:
        return 1
    cap = min(_device_count(), MAX_MESH_DEVICES)
    if max_devices is not None:
        cap = min(cap, max_devices)
    return max(cap, 1)


def chunk_candidates(n: int, batch: int,
                     targets: tuple[int, ...] = (256 << 20,)
                     ) -> list[int]:
    """Power-of-two lane chunks whose V working set (n * 128 bytes per
    lane) lands near each cache-capacity target, clipped to the batch."""
    row_bytes = 128  # one lane's (32,) u32 V row
    out = set()
    for t in targets:
        c = max(t // (n * row_bytes), 8)
        c = 1 << (int(c).bit_length() - 1)
        if c < batch:
            out.add(int(c))
    return sorted(out)


def default_decision(platform: str, n: int, batch: int) -> Decision:
    """Racing disabled or impossible: the unchunked kernel (the plain twin
    on the CPU) on one device, each launch capped by the free memory."""
    return Decision(PLATFORM_IMPL.get(platform, "cuda"), None, "default")


def mesh_candidates(device_count: int, cap: int = MAX_MESH_DEVICES
                    ) -> list[int]:
    """Power-of-two device counts to race the striped kernel over:
    {2, 4, 8} clipped to the visible devices and ``cap``."""
    out, d = [], 2
    while d <= min(device_count, cap):
        out.append(d)
        d *= 2
    return out


def candidates(platform: str, n: int, batch: int, mesh_cap: int = 1
               ) -> list[tuple[str, int | None, int]]:
    """The (impl, chunk, devices) grid raced for one shape: the JAX
    package's non-TPU branch, with the port's one implementation."""
    impl = PLATFORM_IMPL.get(platform, "cuda")
    chunks: list[int | None] = [None, *chunk_candidates(n, batch)]
    out = [(impl, c, 1) for c in chunks]
    if mesh_cap > 1:
        # no chunk on the mesh rows, as in the JAX grid
        out.extend((impl, None, d)
                   for d in mesh_candidates(_device_count(), mesh_cap))
    return out


def calibration_block(batch: int = CAL_BATCH, seed: int = 7) -> np.ndarray:
    """Deterministic (32, batch) u32 ROMix input, shared by the race and
    tools/profiler.py --romix so both measure the same workload."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**32, size=(32, batch),
                       dtype=np.uint64).astype(np.uint32)


def _nominal_cal(platform: str) -> int:
    return CUDA_CAL_BATCH if platform == "cuda" else CAL_BATCH


def _race_device(platform: str):
    import torch

    topo = _topology()
    return topo.devices[0] if topo.platform == platform \
        else torch.device(platform)


def cal_batch(platform: str, n: int) -> int:
    """The calibration lanes: :data:`CAL_BATCH` on the CPU; on the card
    :data:`CUDA_CAL_BATCH`, capped by the lanes whose V fits it now."""
    if platform != "cuda":
        return CAL_BATCH
    from . import romix_cuda

    fit = romix_cuda.lanes_that_fit(n, _race_device(platform))
    return max(1, min(CUDA_CAL_BATCH, fit))


# in-process memos. Race measurements are per (platform, n): one race
# serves every production batch size and is persisted, so a new process
# deriving a winner for a new batch size never races again. Resolved
# decisions are memoized per call signature (env included) so the steady
# dispatch path costs a dict lookup, not a cache-file parse per batch.
_race_memo: dict[tuple, list[dict]] = {}
_decision_memo: dict[tuple, Decision] = {}
# one race at a time: the scheduler's threads, the farm's and an init can
# all meet a cold shape together
_race_lock = threading.Lock()


def reset_memo() -> None:
    """Drop in-process memos (tests simulating fresh processes)."""
    _race_memo.clear()
    _decision_memo.clear()


def _meas_key(platform: str, n: int) -> str:
    return f"v{SCHEMA}:meas:{platform}:n{n}:cal{_nominal_cal(platform)}"


def _valid_rows(rows) -> list[dict]:
    out = []
    if not isinstance(rows, list):
        return out
    for r in rows:
        if (isinstance(r, dict) and r.get("impl") in IMPLS
                and (r.get("chunk") is None
                     or (isinstance(r.get("chunk"), int) and r["chunk"] >= 1))
                and isinstance(r.get("devices", 1), int)
                and not isinstance(r.get("devices", 1), bool)
                and r.get("devices", 1) >= 1
                and isinstance(r.get("labels_per_sec"), (int, float))):
            r.setdefault("devices", 1)
            if r.setdefault("shape", shape_of(r["impl"])) not in MESH_SHAPES:
                continue
            out.append(r)
    return out


def raced_rows(platform: str, n: int) -> list[dict]:
    """The race's measurements for (platform, n) as this process knows
    them (its memo, else the winners file); never races."""
    rows = _race_memo.get((platform, n))
    if rows is None:
        rows = _valid_rows(
            _load_cache().get(_meas_key(platform, n), {}).get("raced"))
    return rows


def _race_measurements(platform: str, n: int, mesh_cap: int = 1
                       ) -> list[dict]:
    """All calibration measurements for (platform, n), raced lazily: the
    single-device grid on first use, mesh rows the first time a caller
    with a device budget > 1 asks. Rows persist incrementally."""
    with _race_lock:
        rows = raced_rows(platform, n)
        cal = _nominal_cal(platform)
        missing = [c for c in candidates(platform, n, cal, mesh_cap)
                   if (c[1] is None or c[1] < cal)
                   and not any(r["impl"] == c[0] and r["chunk"] == c[1]
                               and r["devices"] == c[2] for r in rows)]
        if not missing:
            _race_memo[(platform, n)] = rows
            return rows
        from ..utils import metrics, tracing

        metrics.post_romix_autotune_races.inc()
        lanes = cal_batch(platform, n)
        with tracing.span("romix.race",
                          {"platform": platform, "n": n,
                           "mesh_cap": mesh_cap, "cal_batch": lanes}
                          if tracing.is_enabled() else None):
            rows = rows + _race_rows(platform, n, missing, lanes)
        _race_memo[(platform, n)] = rows
        _store(_meas_key(platform, n),
               {"raced": rows, "cal_batch": lanes,
                "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())})
        return rows


def _race_rows(platform: str, n: int,
               combos: list[tuple[str, int | None, int]],
               lanes: int | None = None) -> list[dict]:
    """Time each candidate on the calibration block. A candidate that
    fails raises: every row is the same kernel, so a failure is the
    kernel's, not a loss of the race."""
    import torch

    from ..utils import tracing
    from . import romix_cuda, u32

    dev = _race_device(platform)
    for impl, _, _ in combos:
        # the kernel on the card, the plain twin on the CPU, never crossed
        if impl != PLATFORM_IMPL.get(dev.type):
            raise ValueError(f"romix autotune: {impl!r} cannot run on "
                             f"{dev.type} tensors")
    lanes = lanes or cal_batch(platform, n)
    block = calibration_block(lanes)
    x = u32.from_numpy(block, dev)
    rows = []
    for impl, chunk, devices in combos:
        label = f"{impl}" + (f"/chunk={chunk}" if chunk else "") + (
            f"/devices={devices}" if devices > 1 else "")
        with tracing.span("romix.race_candidate",
                          {"impl": impl, "chunk": chunk, "devices": devices}
                          if tracing.is_enabled() else None) as csp:
            if devices > 1:
                from ..parallel import mesh as pmesh

                mesh = pmesh.data_mesh(_topology().devices[:devices])
                xs = pmesh.lane_sharding(mesh).put_lane(block)
                sync = sorted({str(d) for d in mesh.devices})

                def run(xs=xs, mesh=mesh, chunk=chunk):
                    return pmesh.romix_sharded(mesh, xs, n=n, chunk=chunk)
            else:
                sync = [str(dev)]

                def run(chunk=chunk):
                    return romix_cuda.romix(x, n, max_lanes=chunk)

            def timed() -> float:
                t0 = time.perf_counter()
                run()
                if dev.type == "cuda":
                    for d in sync:
                        torch.cuda.synchronize(d)
                return time.perf_counter() - t0

            compile_s = timed()
            best = min(timed() for _ in range(CAL_REPS))
            rate = lanes / best
            _log(f"romix autotune: {label}: {rate:,.0f} labels/s at "
                 f"{lanes} lanes (build+first {compile_s:.2f}s)")
            csp.set(labels_per_sec=round(rate, 1),
                    compile_s=round(compile_s, 3))
            rows.append({"impl": impl, "chunk": chunk, "devices": devices,
                         "shape": shape_of(impl),
                         "labels_per_sec": round(rate, 1),
                         "compile_s": round(compile_s, 3)})
    return rows


NOISE_BAND = 0.95  # rows within 5% of the best rate count as tied


def _select_winner(usable: list[dict]) -> dict:
    """The fastest row, except that among rows within the calibration
    noise band of the best rate, the one striped over the fewest devices
    wins (striping costs grow with the production batch)."""
    best = max(r["labels_per_sec"] for r in usable)
    near = [r for r in usable if r["labels_per_sec"] >= NOISE_BAND * best]
    return min(near, key=lambda r: (r["devices"], -r["labels_per_sec"]))


def race(platform: str, n: int, batch: int, dev_cap: int = 1,
         pin_devices: int | None = None) -> Decision | None:
    """Race (or reuse the measured race of) the candidates, then persist
    and return the winner for ``(platform, n, batch)`` under a
    ``dev_cap`` device budget. ``pin_devices`` restricts the selection
    to rows at exactly that device count (``SPACEMESH_MESH=<k>``); a
    pinned selection is not persisted and is None when no row has that
    count."""
    rows = _race_measurements(platform, n, mesh_cap=dev_cap)
    usable = [r for r in rows
              if (r["chunk"] is None or r["chunk"] < batch)
              and r["devices"] <= dev_cap
              and r["devices"] <= batch
              and r["labels_per_sec"] > 0]
    if pin_devices is not None:
        usable = [r for r in usable if r["devices"] == pin_devices]
        if not usable:
            return None
    if not usable:
        return default_decision(platform, n, batch)
    win = _select_winner(usable)
    chunk = win["chunk"]
    d = Decision(win["impl"], chunk, "race", win["labels_per_sec"],
                 devices=win["devices"], mesh_shape=win["shape"])
    if pin_devices is not None:
        return dataclasses.replace(d, source="env")
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    entries = {_key(platform, n, batch, dev_cap): {
        "impl": win["impl"], "chunk": chunk,
        "devices": win["devices"], "shape": win["shape"],
        "labels_per_sec": win["labels_per_sec"], "raced": rows,
        "tuned_at": stamp}}
    for shape in MESH_SHAPES:
        srows = [r for r in usable if r["shape"] == shape]
        if not srows:
            continue
        sw = _select_winner(srows)
        entries[_shape_key(platform, n, batch, dev_cap, shape)] = {
            "impl": sw["impl"], "chunk": sw["chunk"],
            "devices": sw["devices"], "shape": shape,
            "labels_per_sec": sw["labels_per_sec"], "tuned_at": stamp}
    _store_many(entries)
    _log(f"romix autotune: winner for {platform} n={n} b={batch} "
         f"(<= {dev_cap} devices): {win['impl']}"
         + (f"/chunk={chunk}" if chunk else "")
         + (f"/devices={win['devices']}" if win["devices"] > 1 else "")
         + f" ({win['labels_per_sec']:,.0f} labels/s, persisted)")
    return d


def _platform(platform: str | None) -> str:
    return platform or _topology().platform


def shape_winner(n: int, batch: int, shape: str, *,
                 platform: str | None = None,
                 max_devices: int | None = None) -> Decision | None:
    """The persisted winner for one mesh shape under the caller's device
    budget, or None when no race has measured it. A pure cache read."""
    if shape not in MESH_SHAPES:
        raise ValueError(
            f"mesh shape {shape!r}: expected one of {', '.join(MESH_SHAPES)}")
    platform = _platform(platform)
    dev_cap = _device_cap(max_devices)
    entry = _load_cache().get(
        _shape_key(platform, n, batch, dev_cap, shape), {})
    d = _entry_decision(entry, batch, "cache")
    if d is not None and d.mesh_shape != shape:
        return None  # hand-edited entry: its shape key disagrees
    return d


def decide(n: int, batch: int, *, platform: str | None = None,
           max_devices: int | None = 1) -> Decision:
    """Resolve the kernel choice for one shape (precedence in the module
    docstring). The steady dispatch path, one call per label batch, is a
    memoized dict lookup; the env values are part of the memo key.

    ``max_devices``: the caller's device budget. The default (1) serves
    the per-batch dispatch of ``ops/scrypt.py`` the best single-device
    row; mesh-aware callers pass None (up to min(visible devices, 8)) and
    stripe through ``parallel/mesh.py`` when the winning row says
    ``devices > 1``."""
    platform = _platform(platform)
    dev_cap = _device_cap(max_devices)
    memo_key = (platform, n, batch, dev_cap,
                os.environ.get(ENV_IMPL), os.environ.get(ENV_CHUNK),
                os.environ.get(ENV_AUTOTUNE), os.environ.get(ENV_CACHE),
                os.environ.get(ENV_MESH))
    hit = _decision_memo.get(memo_key)
    if hit is not None:
        return hit
    d = _decide(n, batch, platform, dev_cap)
    _decision_memo[memo_key] = d
    return d


def _decide(n: int, batch: int, platform: str, dev_cap: int) -> Decision:
    impl_env, chunk_env, chunk_set, no_race = read_env()
    if impl_env is not None and impl_env != PLATFORM_IMPL.get(platform):
        raise ValueError(
            f"{ENV_IMPL}={impl_env!r} cannot run on {platform}: the "
            f"{platform} ROMix is {PLATFORM_IMPL.get(platform)!r}")
    mesh_env = read_mesh_env() if dev_cap > 1 else None
    if mesh_env is not None:
        mesh_env = max(1, min(mesh_env, dev_cap, batch))
    if mesh_env == 1:
        # SPACEMESH_MESH=off: the whole decision collapses to the
        # single-device budget, the race's included
        dev_cap, mesh_env = 1, None
    cached = _entry_decision(
        _load_cache().get(_key(platform, n, batch, dev_cap), {}), batch,
        "cache")
    if cached is not None and cached.devices > min(dev_cap, batch):
        cached = None  # raced under a wider device budget than this call's
    if cached is not None and mesh_env is not None \
            and cached.devices != mesh_env:
        cached = None  # forced device count: the cached winner is moot
    if impl_env is not None:
        # explicit impl: env chunk > cached chunk > heuristic
        if chunk_set:
            chunk = chunk_env
        elif cached is not None and cached.impl == impl_env:
            chunk = cached.chunk
        else:
            chunk = default_decision(platform, n, batch).chunk
        if chunk is not None and chunk >= batch:
            chunk = None
        devices = mesh_env if mesh_env is not None else (
            cached.devices if cached is not None else 1)
        return Decision(impl_env, chunk, "env", devices=devices)
    if chunk_set:
        base = cached or default_decision(platform, n, batch)
        chunk = chunk_env if (chunk_env is None or chunk_env < batch) else None
        devices = mesh_env if mesh_env is not None else base.devices
        return Decision(base.impl, chunk, "env", devices=devices)
    if cached is not None:
        return cached
    if mesh_env is not None and mesh_env > 1:
        # forced device count: the best raced row at that count when
        # racing is allowed, the unchunked kernel otherwise
        if not no_race:
            pinned = race(platform, n, batch, dev_cap,
                          pin_devices=mesh_env)
            if pinned is not None:
                return pinned
        return Decision(PLATFORM_IMPL.get(platform, "cuda"), None, "env",
                        devices=mesh_env)
    if no_race:
        return default_decision(platform, n, batch)
    return race(platform, n, batch, dev_cap)
