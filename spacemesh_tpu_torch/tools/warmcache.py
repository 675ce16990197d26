"""Warm what a later process on this host can reuse: the kernel libraries
and the autotuned winners.

Port of ``spacemesh_tpu/tools/warmcache.py``. The JAX tool fills XLA's
persistent compile cache for the autotuned shapes. The port compiles no
program per shape; what persists across processes on the card's host is
(1) the four kernel libraries ``nvcc`` builds (``ops/_build.py``, under
``<cache root>/build`` when ``SPACEMESH_TORCH_CACHE`` is set) and (2) the
ROMix autotuner's winners file (``ops/autotune.py``). One run builds every
library, races the candidates for ``--n`` (one race per N serves every
batch) and persists a winner for each of ``--batches``, then runs each
shape's label programs and every registered runtime workload kind once
(``runtime/workloads.py``). A second run on the same cache root builds
nothing and races nothing.

The JSON document keeps the JAX tool's keys. On the card these mean:

* ``cache_dir`` — the kernel build directory (not an XLA cache);
* ``shapes[].programs`` — each program's first-call seconds in this
  process (a library's first load, PyTorch's lazy CUDA set-up, the ROMix
  scratch's first allocation), not compile seconds;
* ``shapes[].impl``/``chunk``/``devices`` — the autotuned decision for
  the shape (``cuda`` the kernel, ``plain`` its twin on the CPU);
  ``mesh_shapes`` has the one ``lane`` shape;
* ``prove`` — the scan step's first call at its batch (``compile_s`` is
  those seconds);
* ``runtime_kinds`` — each kind's warm recipe, ``{program: seconds}``.

and it adds ``compile_s`` (each library's build seconds; near 0 when it
was built already), ``built`` (the libraries this run compiled) and
``races`` (the autotune races this run made, the
``post_romix_autotune_races_total`` counter). ``--no-probe`` is accepted
and does nothing (the port has no accelerator probe). A failure (a build,
a launch) raises: nothing is recorded as a failed row.

Usage:
  python -m spacemesh_tpu_torch.tools.warmcache [--n 8192]
      [--batches 8192,4096,2048,1024,512] [--prove] [--no-mesh]
      [--no-probe] [--cached-shapes] [--no-runtime] [--pack-lanes 4096]
      [--device cuda]
  python -m spacemesh_tpu_torch.tools.profiler --warm   # same, via profiler

``--cached-shapes`` also warms every shape that has a persisted winner
for this platform.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _cached_shapes(platform: str) -> list[tuple[int, int]]:
    """(n, batch) pairs with a persisted autotune winner on this host."""
    from ..ops import autotune

    out = set()
    prefix = f"v{autotune.SCHEMA}:{platform}:"
    for key in autotune._load_cache():
        if not key.startswith(prefix):
            continue
        try:
            n_part, b_part = key[len(prefix):].split(":")[:2]
            out.add((int(n_part[1:]), int(b_part[1:])))
        except (ValueError, IndexError):
            continue
    return sorted(out)


def _races(metrics) -> float:
    return sum(metrics.post_romix_autotune_races.sample().values())


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _warm_shape(n: int, batch: int, mesh_ok: bool, dev) -> dict:
    """Run every label program one (n, batch) shape runs, once; returns
    per-program first-call seconds and the shape's decisions."""
    import numpy as np

    from ..ops import autotune, scrypt, u32

    commitment = hashlib.sha256(b"warmcache").digest()
    cw = scrypt.commitment_to_words(commitment)
    lo, hi = scrypt.split_indices(np.arange(batch, dtype=np.uint64))
    tcw, tlo, thi = (u32.from_numpy(a, dev) for a in (cw, lo, hi))

    doc: dict = {"n": n, "batch": batch, "programs": {}}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        doc["programs"][name] = round(time.perf_counter() - t0, 4)
        _log(f"  {name}: {doc['programs'][name]}s")

    # the single-device decision and its programs (the per-batch dispatch)
    d1 = autotune.decide(n, batch, platform=dev.type)
    doc["impl"] = d1.impl
    doc["chunk"] = d1.chunk
    timed("labels_fused", lambda: scrypt.scrypt_labels_words(
        tcw, tlo, thi, n=n))
    timed("labels_min_fused", lambda: scrypt.scrypt_labels_with_min(
        tcw, tlo, thi, u32.from_numpy(scrypt.vrf_carry_init(), dev), n=n))

    if not mesh_ok:
        return doc
    dm = autotune.decide(n, batch, platform=dev.type, max_devices=None)
    doc["devices"] = dm.devices
    if dm.devices <= 1:
        return doc
    from ..parallel import mesh as pmesh
    from ..parallel import topology

    mesh = pmesh.data_mesh(topology.get().devices[:dm.devices])

    def fetched(fn):
        # each stripe's part waits on its own stream
        return lambda: [hc.get() for hc in pmesh.host_copies(mesh, fn())
                        if hc is not None]

    timed(f"labels_sharded_d{dm.devices}", fetched(
        lambda: pmesh.scrypt_labels_sharded(mesh, cw, lo, hi, n=n,
                                            chunk=dm.chunk)))
    timed(f"labels_min_sharded_d{dm.devices}", fetched(
        lambda: pmesh.labels_with_min_sharded(
            mesh, cw, lo, hi, scrypt.vrf_carry_init(), n=n,
            chunk=dm.chunk)[0]))
    doc["mesh_shapes"] = {}
    for shape in autotune.MESH_SHAPES:
        sw = autotune.shape_winner(n, batch, shape, platform=dev.type,
                                   max_devices=None)
        if sw is not None and sw.devices > 1:
            doc["mesh_shapes"][shape] = {"impl": sw.impl,
                                         "devices": sw.devices}
    return doc


def _warm_prove(batch: int, dev) -> dict:
    """Run the prover's scan step once at its batch (a multiple of the
    scan's 64-lane segment)."""
    import numpy as np
    import torch

    from ..ops import proving, scrypt, u32

    seg = proving.HIT_SEGMENT
    b = -(-batch // seg) * seg
    ng, cap = 16, 37  # prover defaults (nonce_group, k2)
    lo, hi = scrypt.split_indices(np.arange(b, dtype=np.uint64))
    lw = torch.zeros((4, b), dtype=torch.int32, device=dev)
    counts, carry = proving.init_hit_state(ng, cap, dev)
    t0 = time.perf_counter()
    proving.prove_scan_step(
        proving.challenge_words(bytes(32)), 0, u32.from_numpy(lo, dev),
        u32.from_numpy(hi, dev), lw, 1 << 30, counts, carry, b, 0, 0,
        n_nonces=ng, max_hits=cap)
    _sync(dev)
    dt = round(time.perf_counter() - t0, 4)
    _log(f"  prove_scan_step b={b}: {dt}s")
    return {"batch": b, "nonce_group": ng, "compile_s": dt}


def _warm_runtime_kinds(n: int, batch: int, pack_lanes: int, dev) -> dict:
    """Run every registered runtime workload kind's recipe once: the
    packed init and verify kinds at the pack width, the rest at
    ``batch``."""
    from ..runtime import workloads

    out: dict = {}
    for kind in workloads.registered():
        b = pack_lanes if kind.name in ("init_pack", "verify") else batch
        _log(f"warming runtime kind {kind.name} (n={n} b={b}) ...")
        out[kind.name] = dict(kind.warm(n, b, device=dev), batch=b)
    return out


def warm(n: int = 8192, batches: list[int] | None = None, *,
         mesh: bool = True, prove: bool = False,
         cached_shapes: bool = False, probe: bool = True,
         runtime_kinds: bool = True, pack_lanes: int = 4096,
         device="cuda") -> dict:
    """Build, race and warm; returns a JSON-able report. ``probe`` is
    accepted for the JAX signature and does nothing."""
    from ..device import resolve
    from ..ops import _build, autotune
    from ..parallel import topology
    from ..utils import metrics

    dev = resolve(device)
    platform = dev.type
    races0 = _races(metrics)
    t0 = time.perf_counter()
    seconds: dict = {}
    built: list[str] = []
    if dev.type == "cuda":
        logs = _build.build_all(seconds=seconds)
        built = sorted(name for name, log in logs.items() if log)
    _log(f"kernel libraries in {_build.build_dir()}: built "
         f"{built or 'none'}")

    shapes = {(n, b) for b in (batches or [8192, 4096, 2048, 1024, 512])}
    if cached_shapes:
        shapes.update(_cached_shapes(platform))
    done = []
    for sn, sb in sorted(shapes):
        _log(f"warming n={sn} b={sb} ...")
        done.append(_warm_shape(sn, sb, mesh, dev))
    doc = {
        "platform": platform,
        "devices_visible": topology.get().device_count,
        "cache_dir": str(_build.build_dir()),
        "autotune_cache": autotune.cache_path(),
        "compile_s": {k: round(v, 3) for k, v in sorted(seconds.items())},
        "built": built,
        "shapes": done,
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }
    if prove:
        doc["prove"] = _warm_prove(1 << 14, dev)
    if runtime_kinds:
        primary = (batches or [8192])[0]
        doc["runtime_kinds"] = _warm_runtime_kinds(n, primary, pack_lanes,
                                                   dev)
    doc["races"] = int(_races(metrics) - races0)
    doc["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="warmcache",
        description="build the kernel libraries and persist the ROMix "
                    "autotuner's winners for a later process")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=8192, help="scrypt N")
    ap.add_argument("--batches", default="8192,4096,2048,1024,512",
                    help="comma-separated label batch sizes")
    ap.add_argument("--no-mesh", action="store_true",
                    help="skip the striped (multi-device) programs")
    ap.add_argument("--prove", action="store_true",
                    help="also run the prover's scan step")
    ap.add_argument("--cached-shapes", action="store_true",
                    help="also warm every shape with a persisted "
                    "autotune winner on this host")
    ap.add_argument("--no-probe", action="store_true",
                    help="accepted for the JAX package's command lines; "
                    "the port has no accelerator probe")
    ap.add_argument("--no-runtime", action="store_true",
                    help="skip the registered runtime workload kinds")
    ap.add_argument("--pack-lanes", type=int, default=4096,
                    help="pack width for the packed init/verify kinds")
    a = ap.parse_args(argv)
    from ..device import resolve

    try:
        resolve(a.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    doc = warm(a.n, [int(b) for b in a.batches.split(",") if b],
               mesh=not a.no_mesh, prove=a.prove,
               cached_shapes=a.cached_shapes, probe=not a.no_probe,
               runtime_kinds=not a.no_runtime, pack_lanes=a.pack_lanes,
               device=a.device)
    print(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
