#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PoST main path on one NVIDIA H100.

Run from the repository root with no arguments on a machine with one
card: ``python3 chip_smoke.py``. It imports nothing of JAX or of the JAX
package. Phases, each printed as it runs:

1. device: the card's name and power limit; build the four CUDA sources
   from ``spacemesh_tpu_torch/csrc`` (one nvcc each) and the two native
   host libraries from ``spacemesh_tpu_torch/native`` (one g++ each), all
   started together, and print each kernel's registers and spills;
   [native]: the native blake3 against its pure-Python twin across tree
   shapes (0 bytes to 2^20, keyed at 20/32/64 bytes out) and the native
   ECVRF's public keys, proofs, outputs and verdicts against the Python
   twin's on seeded keys, bit-flipped proofs, keys and messages rejected
   by both; VRF prove and verify timed per call on both paths; then wrap
   the plain twins
   ``salsa20_8``, ``blockmix_r1`` and ``sha256_compress`` so that a call
   on a CUDA tensor, or on a host tensor, while a path is driven is
   counted (the guard: every path below must count 0 of each);
2. ROMix: the kernel against its plain PyTorch version on the card (N=1024
   at a ragged batch, and N=8192 at the init batch of 32768 lanes), whole
   and fill phase only (``mix_phase=False``), and full labels against
   ``hashlib.scrypt``; exact equality; the fill/mix time split;
3. PBKDF2: both entry points of the envelope kernel against their plain
   versions at the init batch (32768 lanes, one shared commitment), at the
   packed init's batch (32768 lanes, per-lane commitments), at the
   verifyd farm's batch (9472 per-lane lanes) and at a ragged batch of
   per-lane commitments (the verifier's form); exact equality; timed by
   CUDA events around back-to-back wrapper calls (the wrapper's call rate)
   and by the profiler's kernel times;
   then the proving hash kernel against its plain twin (big-endian label
   words, per-lane and shared challenge and nonce) at 74, 37 and 9472
   lanes (no path launches it now); [finish_hash]: PBKDF2 finish with the
   proving hash as its epilogue against finish's plain twin then the
   hash's at 37, 1037 and 9472 per-lane lanes and 32768 shared ones,
   timed at 9472 with finish alone in turns (the hash's share); and
   [k2pow]: the search window (both forms of the rounds) against its
   plain twin and hashlib over 2^20 nonces with a winner inside, with no
   winner, and across nonce_hi = 1, and a window behind a winner; the
   window of 2^24 nonces with no winner timed, IMAD and plain forms in
   turns; one whole ``ops.pow.search`` (host clock, warm) at the default
   and mainnet difficulties, two window launches each; an empty kernel's
   time; the mask kernel against its plain twin over 2^16 nonces across
   nonce_hi = 1; the verify kernel at 64 and 4096 witnesses (against
   hashlib too), all timed;
4. proving scan: the kernel against its plain version, and one prove step
   through the kernel against the plain step, on random device-resident
   labels with 16 nonces, at the main path's prove batch (2^18 lanes, all
   valid) and at 2^24 lanes with a ragged ``valid``; exact equality; the
   kernel and its plain version timed at both shapes;
5. end to end at mainnet parameters (N=8192, k1=26, k2=37, k3=37, the
   default k2pow difficulty): ``initialize()`` 2^20 labels in batches of
   32768 lanes, ``Prover.prove()`` pipelined and ``prove_serial()``,
   ``verify_many()`` on the proof and on a tampered copy, each held
   against hashlib and the plain CPU path; the kernels' launch counts are
   zeroed just before and read just after (k2pow search windows at least
   one per proof, the verify's recompute one finish_hash, no standalone
   proving hash or mask search); the torch calls one init batch
   makes around the kernels, counted on the card; the first init batch's
   dispatch time apart from the others', beside one bare allocation of
   its 32 GiB V scratch;
6. [worker] the PoST worker as a smesher runs it: ``python -m
   spacemesh_tpu_torch.post init`` in a subprocess (2^18 labels, N=8192,
   batches of 32768, stage timings), 64 random stored labels against
   hashlib; ``benchmark`` at 32768 lanes in a subprocess; a
   ``PostSupervisor`` serving that store, whose ``info()`` and
   ``proof()`` (through ``RemotePostClient``) must equal the store's
   geometry and the in-process ``Prover``'s proof at window_groups 1 and
   4; the worker killed once, restarted by the supervisor on the same
   port with ``SPACEMESH_PROVE_WINDOW_GROUPS=4``, and the same proof
   again; ``verify`` in subprocesses, exit 0 on the proof and exit 1 on a
   copy with one index swapped for a non-qualifying one. The kernels'
   launch counts are zeroed before the in-process proves and verify and
   read after;
7. [tenants] many identities on one card through the multi-tenant
   ``TenantScheduler``: a solo ``initialize()`` of 2^20 labels, then 16
   identities x 2^16 labels of packed init (32768 lanes per pack), its
   aggregate rate against the solo one, pack occupancy and the host's VRF
   fold per pack; the device's idle share during a profiled packed init;
   64 sampled labels per identity against hashlib, two identities' stores
   sha256-equal to a solo ``initialize()``, each VRF nonce the stored
   minimum; 16 ``submit_prove`` equal to a solo ``Prover``'s proofs, their
   latency with the card idle and under a concurrent packed init; one
   ``submit_verify`` of the 16 proofs and a tampered one; 16 ``submit_pow``
   equal to ``ops.pow.search``, each nonce passing hashlib. The kernels'
   launch counts are zeroed before the packed init and proves and read
   after (k2pow search at least once per proof);
8. [verifyd] verification as a service, BASELINE's "batch of 10k NIPoST
   proofs" at N=8192 and mainnet k1/k2/k3: 10240 POST requests over the
   ``[tenants]`` identities (each proof with another valid k2pow witness
   per request, one in 8 with an index swapped for a non-qualifying one)
   and 152 sig/vrf/membership/pow items, from 4 clients through
   ``VerifydService.verify`` on the card with the service's defaults;
   every verdict held to ``post.verifier.verify`` one item per call on
   the card, honest True and tampered False, 32 sampled labels of the
   farm's recomputes against hashlib; proofs verified/s beside the serial
   rate of a 256-proof sample, request latency p50/p99, batches and
   occupancy, each POST dispatch's split (host stages, the three kernels'
   device time, the pow kind), the device's idle share over a profiled
   repeat of the load, peak memory. The kernels' launch counts are zeroed
   before the warm run and read after it (ROMix, PBKDF2 expand and
   finish_hash once per POST batch, finish alone and the standalone hash
   never, k2pow verify once per device pow batch); the cold run's taps ask
   finish_hash for the label words; the path's kernels are held to their
   plain twins on the widest recompute's real inputs and on its first
   proof's 37 lanes, a serial verify's shape;
9. [fleet] the verifyd fleet: three ``VerifydService`` replicas (shards
   r0-r2, each over a farm of 2 POST batches in flight) served by the
   port's HTTP server on their own 127.0.0.1 ports, behind one
   ``FleetVerifier`` from ``fleet_from_urls`` over the sockets with a
   local farm of 1; ``[verifyd]``'s load reused as requests of 256 from 4
   concurrent callers under the 16 identities. A clean run (proofs/s
   beside ``[verifyd]``'s, request p50/p99, requests per replica,
   ``fleet_desired_replicas`` from the windowed ``fleet_slis``) and a
   drill: r1's listener stopped at a quarter of the requests and back on
   its port at half, then all three stopped from 5/8 to 3/4 (the
   blackout). Every verdict of both runs held to ``[verifyd]``'s serial
   inline verdicts; r1's attempts while down bounded by its breaker; the
   blackout served wholly by the local farm; remote serving back after
   the restore. The kernels' launch counts are zeroed before the clean run
   and read after it: ROMix, expand and finish_hash once per POST batch
   of all farms, and k2pow verify once per device pow batch. Then
   the port's verifyd-outage, fleet and byzantine-verifyd drills, twice
   on the card (``ok``, the same digest; under the guard) and once on the
   host CPU (outside it);
10. [atx] ATX validation over the card's verify farm, at mainnet proof
   parameters (N=8192, k1=26, k2=37, k3=37, the default k2pow
   difficulty): 64 identities x 2^14 labels initialized on the card; a
   smeshing node with one ``Builder`` per identity over a ``PostClient`` on
   the card, one ``PoetService`` round per epoch with every identity
   registered first, 8 epochs of v1 ATXs and 16 merged v2 ATXs (married in
   fours) published on a ``LoopbackHub``, the node validating its own
   through a farm; one envelope in 8 tampered (signature, VRF key, a POST
   index whose label misses the threshold, the membership path, an unknown
   poet id, in turn), so every verdict is known by construction. A
   validating node (a file state DB in WAL mode, ``Handler`` and
   ``HandlerV2`` over one ``VerificationFarm(device="cuda")`` with its
   defaults) takes each epoch's envelopes at once through
   ``PubSub.deliver``, the epochs in order, on fresh DBs (the signature
   cache cleared) until 5 s are timed: ATXs validated/s, latency from
   delivery to verdict p50/p99; a traced pass (the handlers' host time:
   the wait on the farm, sqlite, decode), a profiled pass (the card's idle
   share), and inline ``process`` on the card one envelope at a time, whose
   verdicts, ``atxs`` rows and cache weights and heights must equal the
   farm's; two envelopes (valid, tampered index) through ``device="cpu"``
   in two worker processes; a double publish through the hub marks the
   identity malicious; InvalidPostIndex malfeasance condemns the tampered
   index and not a qualifying one; ``CertifierService`` on the card
   certifies a real proof and refuses a tampered one through
   ``CertifierDaemon``/``CertifierClient`` on 127.0.0.1. One more pass runs
   under ``cProfile`` enabled on the event loop's thread, its time split
   by where it went (blake3, codec, sqlite, the loop and its futures, the
   farm's submission, the handlers, the rest, the loop's idle wait);
   blake3 of the v1 encodings timed native against Python; the same farm
   passes with the one-shots on the native library and on the Python
   twin in turns (native, Python, Python, native); finish_hash
   held to its plain twins and timed at the phase's POST batch of 2368
   per-lane lanes. The launch counts are zeroed before the inits and
   before the validation and read after each; no plain twin may run, and
   no one-shot blake3 or VRF call may be answered by the Python twin (the
   native guard, over the whole phase);
10b. [consensus] eligibility, hare and beacon over ``[atx]``'s identities:
   the ``Oracle`` reads the smeshing node's ``AtxCache`` (64 identities
   and their weights); 8 ``PubSub`` nodes on a ``LoopbackHub`` with 8
   identities each; one beacon epoch (fastnet's kappa 40, 4 rounds and
   durations, the configured theta) with a ``ProtocolDriver`` per node;
   4 hare layers (mainnet's committee of 50, iteration limit 4, fastnet's
   0.7 s rounds after a 1.0 s preround delay, the layers 4 rounds apart)
   with one ``Hare`` per node over its 8 signers, one identity sending a
   conflicting preround in the first layer and a forged seat count
   offered first; one poet round through a ``python -m
   spacemesh_tpu_torch.tools.poet_server`` process on 127.0.0.1 read by
   ``MultiPoet``, its memberships checked through the farm's membership
   kind. Fails unless every node outputs the same set per layer, every
   driver decides one protocol beacon, each node reports the equivocator
   once, the forged count is refused, the memberships verify (a wrong
   member does not), no kernel launches and the native guard holds;
   reports VRF verifies and Ed25519 checks per layer, the loop's busy
   share, late, refused and dropped messages and the beacon's wall;
11. [trace] instrumentation and self-healing: (a) init of 2^19 labels at
   the main path's width with tracing off, on, and on with the
   ``torch.profiler`` bridge inside a profiler capture, twice each in the
   turns off, on, bridge, bridge, on, off after a warm-up, every store
   equal; (b) one capture of init -> prove -> verify_many -> one farm
   request with the bridge on: the capture validates, every span name of
   the JAX package's path appears, and every expand, ROMix, finish (and
   finish_hash), scan and search-window kernel event joins its launch by
   the profiler's correlation and the launch lies inside a host span of
   the launching thread (the profiler keeps ``record_function`` ranges of
   the main thread only, so three ``trace.clock`` spans put the ring on
   the profiler's clock and each other thread is matched to the tracer
   thread whose spans enclose its launches most tightly); the span counts
   and ``render_summary``'s top 20; (c) 2560 of ``[verifyd]``'s proofs
   through a fresh ``VerifydService`` under capture: verdicts == serial
   inline, the linkage verifyd.request -> verifyd.drain -> farm.request ->
   farm.batch for every request, and a POST batch broken down: its stages,
   its launch span and the CUDA runtime calls inside it, every runtime
   call of the farm's threads; (d) ``[fleet]``'s load through three
   ``python -m spacemesh_tpu_torch.verifyd`` processes on the card behind
   ``fleet_from_urls``, captures started and pulled over ``/debug/trace``
   and merged: it validates, one proc per replica role, every link token
   resolved into a ``fleet.remote -> verifyd.request`` edge, verdicts ==
   serial inline; (e) a ``HealthEngine`` with a flight spool over the main
   path's watchdogs while a prove's window is held on a gate: ``/readyz``
   of a verifyd server on the card goes 503 and back to 200, and the
   stall's flight bundle validates; (f) a packed init of 4 identities,
   their proves and k2pow and 1024 of ``[verifyd]``'s proofs with the
   race, registry-thread and slow-callback sanitizers armed: no race,
   lock-order or registry-thread violation, the slow callbacks counted;
   ``runtime_fallbacks_total`` 0 over the whole run;
12. a JSON line of per-kernel launches, times and bounds, each time taken
   at the shape the main path launches the kernel at (the scan's 2^24
   times beside it under ``full_width``, the PBKDF2 pair's packed-init
   shape under ``perlane``), with each later path's launches beside the
   main path's (``tenants_launches``, ``verifyd_launches``,
   ``fleet_launches``, ``atx_launches``: the inits, proves and validation
   of ``[atx]``). ``path`` names the path whose count ``launches``
   is: the main path's, but for k2pow verify, which only the verification
   paths run (``[verifyd]``'s warm run; ``main_launches`` 0), and
   ``none`` for the standalone proving hash and the k2pow mask search,
   which no path launches (0 on all four: the paths hash in finish_hash
   and search in windows). The k2pow search window's times are at 2^24
   nonces with no winner, each search's beside them (``searches``);
   finish_hash's also at ``[atx]``'s POST batch of 2368 lanes
   (``atx_batch``).

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero without it. Labels per unit are cut from mainnet's 2^32 to 2^20
(2^18 for the worker, 2^16 per identity for the tenants) for the time
limit (2^14 per identity for ``[atx]``); N, the label width and k1/k2/k3
are not cut.
"""

from __future__ import annotations

import collections
import contextlib
import cProfile
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from spacemesh_tpu_torch.tools.measure import (HBM_BYTES_PER_S, bound,
                                               cuda_ms, int_ops_per_s,
                                               kernel_ms, smi)

N_MAIN = 8192
INIT_BATCH = 1 << 15
UNIT_LABELS = 1 << 20
PROVE_BATCH = 1 << 18
SCAN_LANES = 1 << 24
SCAN_NONCES = 16
RAGGED_LANES = 1037
VERIFY_LANES = 256 * 37   # a verifyd farm batch: 256 proofs x k3 labels
SEARCH_BATCH = 1 << 16    # the mask kernel's checked batch (the JAX pass)
WINDOW_NONCES = 1 << 24   # ops.pow.search's window (ops/pow.py)
WINDOW_CHECK = 1 << 20    # nonces of each window held to its plain twin
# k2pow difficulties: the prover's and CLI's default (post/prover.py) and
# mainnet's (the node's config)
DEFAULT_DIFFICULTY = bytes([0, 255]) + bytes([255]) * 30
MAINNET_DIFFICULTY = bytes.fromhex("000dfb23b0979b4b" + "00" * 24)
SEARCH_REPS = 5           # timed searches per difficulty
POW_WITNESSES = (64, 4096)  # a farm pow batch; verify_many's widest
WORKER_LABELS = 1 << 18
WINDOW_REPS = 5       # in-process proves per window size and challenge
WINDOW_CANDIDATES = 24  # challenges tried for each winner group
TENANTS = 16          # identities of the [tenants] phase (BASELINE: 16)
TENANT_LABELS = 1 << 16  # labels per identity there
LOAD_LABELS = 1 << 18    # per identity of the init the proves run beside
# per identity of the profiled packed init: not a multiple of the pack
# width, so packs are cut across tenants at the main path's shape
MIX_LABELS = TENANT_LABELS // 2 + TENANT_LABELS // 8
# [verifyd]: BASELINE's "batch of 10k NIPoST proofs" through the service
VERIFYD_POSTS = 10240     # POST requests (at least 10,000), 640 per identity
VERIFYD_CLIENTS = 4
VERIFYD_REQUEST = 256     # POST items per request (one full farm batch)
VERIFYD_TAMPERED = 8      # one request in 8 carries a swapped index
VERIFYD_SEED = hashlib.sha256(b"chip-smoke-verifyd-k3-seed").digest()
SERIAL_SAMPLE = 256       # inline verifies timed for the serial rate
# [fleet]: three verifyd replicas over HTTP behind one FleetVerifier
FLEET_REPLICAS = 3
FLEET_INFLIGHT = 2        # POST batches in flight per replica's farm
FLEET_LOCAL_INFLIGHT = 1  # the node's local farm
FLEET_CALLERS = 4         # concurrent callers of the fleet
FLEET_DRILLS = ("verifyd-outage", "fleet", "byzantine-verifyd")
REPO = os.path.dirname(os.path.abspath(__file__))
CLI = [sys.executable, "-m", "spacemesh_tpu_torch.post"]


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over u32 values held as int32 bit patterns."""
    import torch

    mask = 0xFFFFFFFF
    da = a.to(torch.int64) & mask
    db = b.to(torch.int64) & mask
    return int((da - db).abs().max().item()) if a.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class PlainGuard:
    """Counts calls of the plain twins that no path may run on the card
    (``salsa20_8``, ``blockmix_r1``, ``sha256_compress``) while a path is
    driven (from :meth:`start` to :meth:`stop`): on CUDA tensors, and on
    host tensors, which a card path has no reason to make either (the
    k2pow search once compressed block 1 on a CPU tensor per search). The
    twin checks run outside; the script's own host checks inside a drive
    run under :meth:`paused`.
    :meth:`install` rebinds each name in every module of the port that
    holds it, the defining modules first, so later ``from`` imports get
    the counted one too. It also counts the ``ops.pow.verify_many`` calls
    that reach the device (at least ``min_device`` witnesses) and the
    batches they launch."""

    TWINS = {"salsa20_8": "spacemesh_tpu_torch.ops.salsa",
             "blockmix_r1": "spacemesh_tpu_torch.ops.salsa",
             "sha256_compress": "spacemesh_tpu_torch.ops.sha256"}

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.armed = False
        self.calls = {name: 0 for name in self.TWINS}
        self.host_calls = {name: 0 for name in self.TWINS}
        self.pow_batches = 0

    def install(self) -> None:
        import importlib

        import torch

        for mod in ("ops.salsa", "ops.sha256", "ops.romix_cuda",
                    "ops.proving_cuda", "ops.pbkdf2_cuda", "ops.pow_cuda",
                    "ops.pow", "ops.scrypt", "ops.proving",
                    "post.verifier", "verify.farm"):
            importlib.import_module(f"spacemesh_tpu_torch.{mod}")

        def counted(name, fn):
            def twin(*args, **kwargs):
                if self.armed:
                    tensors = [a for a in args if isinstance(a, torch.Tensor)]
                    with self.lock:
                        if any(t.is_cuda for t in tensors):
                            self.calls[name] += 1
                        elif tensors:
                            self.host_calls[name] += 1
                return fn(*args, **kwargs)
            return twin

        for name, home in self.TWINS.items():
            real = getattr(sys.modules[home], name)
            wrapped = counted(name, real)
            for key, mod in list(sys.modules.items()):
                if (key.startswith("spacemesh_tpu_torch")
                        and getattr(mod, name, None) is real):
                    setattr(mod, name, wrapped)
        k2pow = sys.modules["spacemesh_tpu_torch.ops.pow"]
        real_many = k2pow.verify_many

        def verify_many(items, *, batch=1 << 12, min_device=8, **kw):
            if self.armed and len(items) >= min_device:
                with self.lock:
                    self.pow_batches += -(-len(items) // batch)
            return real_many(items, batch=batch, min_device=min_device, **kw)

        k2pow.verify_many = verify_many

    def start(self) -> None:
        """Zero the counts and arm the guard: a path's drive begins."""
        with self.lock:
            for name in self.calls:
                self.calls[name] = self.host_calls[name] = 0
            self.pow_batches = 0
        self.armed = True

    @contextlib.contextmanager
    def paused(self):
        """Disarmed for the script's own host-side check inside a drive."""
        self.armed = False
        try:
            yield
        finally:
            self.armed = True

    def stop(self) -> dict:
        """Disarm; the counts since :meth:`start`: each twin's calls on CUDA
        tensors, on host tensors (``host``), and ``pow_batches``, the
        verify kernel launches the drive's device pow batches asked for."""
        self.armed = False
        with self.lock:
            return dict(self.calls, host=dict(self.host_calls),
                        pow_batches=self.pow_batches)


GUARD = PlainGuard()


def require_no_twins(counts: dict, path: str) -> None:
    twins = {k: counts[k] for k in PlainGuard.TWINS}
    host = counts["host"]
    require(sum(twins.values()) == 0, f"{path}: no plain twin ran on a CUDA "
            f"tensor ({json.dumps(twins)})")
    require(sum(host.values()) == 0, f"{path}: no plain twin ran on a host "
            f"tensor ({json.dumps(host)})")
    log(f"[guard] {path}: plain twins on CUDA tensors {json.dumps(twins)}, "
        f"on host tensors {json.dumps(host)}")


def phase_device(ctx: dict) -> None:
    import torch
    from spacemesh_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} visible, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    ctx["smi"] = smi("name,power.limit")
    log(ctx["smi"])
    ctx["int_ops_per_s"], sms, max_mhz = int_ops_per_s()
    log(f"[device] {sms} SMs, max SM clock {max_mhz:.0f} MHz -> integer "
        f"instruction peak {ctx['int_ops_per_s'] / 1e12:.2f} Top/s")
    from concurrent.futures import ThreadPoolExecutor

    from spacemesh_tpu_torch import native

    t0 = time.perf_counter()
    # the four CUDA sources (one nvcc each) and the two native host
    # libraries (one g++ each), all started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        cuda_job = pool.submit(_build.build_all)
        host_job = pool.submit(native.build_all)
        logs, host_libs = cuda_job.result(), host_job.result()
    log(f"[build] {', '.join(_build.library_path(n).name for n in logs)} "
        f"and {', '.join(p.name for p in host_libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"[build] {name}: {line.strip()}")


NATIVE_SIZES = (0, 1, 64, 1024, 1025, 1 << 16, 1 << 20)  # blake3 tree shapes
NATIVE_TRIALS = 8         # seeded VRF keys, each with a proof and flips


@contextlib.contextmanager
def python_oneshots(on: bool):
    """When ``on``, the port's one-shot blake3 and VRF answer from their
    Python twins for the block (the native libraries stay loaded)."""
    from spacemesh_tpu_torch.core import hashing, signing

    if not on:
        yield
        return
    saved = hashing._native, signing._NATIVE_VRF
    hashing._native, signing._NATIVE_VRF = False, None
    try:
        yield
    finally:
        hashing._native, signing._NATIVE_VRF = saved


def per_call_us(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def require_native(counts: dict, path: str) -> None:
    """The native guard: both libraries loaded from the port's build
    directory, and no one-shot blake3 or VRF call answered by the Python
    twin on ``path`` (``counts``: ``native.counts()`` over the path)."""
    from spacemesh_tpu_torch import native

    st = native.status()
    build = os.path.join(os.path.realpath(REPO), "spacemesh_tpu_torch",
                         "build") + os.sep
    for name, lib in st.items():
        require(lib["loaded"] and lib["path"].startswith(build),
                f"{path}: native {name} loaded from the port's build "
                f"directory ({json.dumps(lib)})")
    python = {kind: c["python"] for kind, c in counts.items()}
    require(sum(python.values()) == 0, f"{path}: no one-shot blake3 or VRF "
            f"call answered by the Python twin ({json.dumps(counts)})")
    log(f"[guard] {path}: native calls {json.dumps(counts)}; Python-twin "
        f"calls {json.dumps(python)}")


def phase_native(ctx: dict) -> None:
    """The native blake3 and ECVRF twins (built in [device]) against the
    port's pure-Python twins on seeded inputs: blake3 across tree shapes,
    keyed and at 20/32/64 bytes; VRF public key, prove, output and verify,
    bit-flipped proofs, keys and messages rejected by both; time per call
    of each path (VRF prove and verify; blake3 of a v1 ATX's encoding is
    timed in [atx], on the real encodings)."""
    import random

    from spacemesh_tpu_torch import native
    from spacemesh_tpu_torch.core import hashing, signing

    t0 = time.perf_counter()
    require(native.load("blake3") is not None
            and signing._native_vrf() is not None,
            f"both native libraries load ({json.dumps(native.status())})")
    rng = random.Random(0x11)
    key = rng.randbytes(32)
    for size in NATIVE_SIZES:
        data = rng.randbytes(size)
        want = hashing.Hasher().update(data).digest(32)
        require(hashing._hash_oneshot(data, None, 32) == want,
                f"blake3 native == Python at {size} bytes")
        if size <= 1 << 16:
            for length in (20, 32, 64):
                want = hashing.Hasher(key=key).update(data).digest(length)
                require(hashing._hash_oneshot(data, key, length) == want,
                        f"keyed blake3 native == Python at {size} bytes, "
                        f"{length} out")
    verifier = signing.VrfVerifier()
    rejected = 0
    for trial in range(NATIVE_TRIALS):
        seed = hashlib.sha256(b"chip-smoke-vrf-%d" % trial).digest()
        alpha = rng.randbytes(rng.randrange(1, 100))
        signer = signing.VrfSigner(seed)
        proof = signer.prove(alpha)
        out = signing.vrf_output(proof)
        with python_oneshots(True):
            py = signing.VrfSigner(seed)
            same = (py.public_key == signer.public_key
                    and py.prove(alpha) == proof
                    and signing.vrf_output(proof) == out
                    and verifier.verify(signer.public_key, alpha, proof))
        require(same and verifier.verify(signer.public_key, alpha, proof),
                f"VRF trial {trial}: public key, proof and output native == "
                f"Python, both verify")
        for what in range(3):
            pk, a, p = (bytearray(x) for x in (signer.public_key, alpha,
                                               proof))
            buf = (p, pk, a)[what]
            buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            pk, a, p = bytes(pk), bytes(a), bytes(p)
            with python_oneshots(True):
                py_ok = verifier.verify(pk, a, p)
            require(not verifier.verify(pk, a, p) and not py_ok,
                    f"VRF trial {trial}: a flipped "
                    f"{('proof', 'key', 'message')[what]} is rejected by both")
            rejected += 1
    seed = hashlib.sha256(b"chip-smoke-vrf-timing").digest()
    signer = signing.VrfSigner(seed)
    proof = signer.prove(b"timing")
    times = dict(
        vrf_verify_native_us=per_call_us(
            lambda: verifier.verify(signer.public_key, b"timing", proof), 200),
        vrf_prove_native_us=per_call_us(lambda: signer.prove(b"timing"), 200))
    with python_oneshots(True):
        times["vrf_verify_python_us"] = per_call_us(
            lambda: verifier.verify(signer.public_key, b"timing", proof), 5)
        times["vrf_prove_python_us"] = per_call_us(
            lambda: signer.prove(b"timing"), 5)
    log(f"[native] {', '.join(os.path.basename(v['path']) for v in native.status().values())}: "
        f"blake3 native == Python at {', '.join(map(str, NATIVE_SIZES))} "
        f"bytes (keyed at 20/32/64 bytes out up to 2^16); VRF public key, "
        f"proof, output and verdict native == Python over {NATIVE_TRIALS} "
        f"seeded keys, {rejected} flipped proofs, keys and messages rejected "
        f"by both")
    log(f"[native] per call: VRF verify native "
        f"{times['vrf_verify_native_us']:.1f} us, Python "
        f"{times['vrf_verify_python_us']:.1f} us "
        f"({times['vrf_verify_python_us'] / times['vrf_verify_native_us']:.1f}x); "
        f"VRF prove native {times['vrf_prove_native_us']:.1f} us, Python "
        f"{times['vrf_prove_python_us']:.1f} us "
        f"({times['vrf_prove_python_us'] / times['vrf_prove_native_us']:.1f}x); "
        f"phase {time.perf_counter() - t0:.1f} s")


def phase_romix(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import romix_cuda, scrypt, u32

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    x = u32.from_numpy(rng.integers(0, 2**32, (32, 300), dtype=np.uint32),
                       dev)
    got = romix_cuda.romix(x, 1024)
    want = romix_cuda.romix_r1(x, 1024)
    err = max_abs_err(got, want)
    require(err == 0, "ROMix kernel == plain at N=1024, 300 lanes")
    got = romix_cuda.romix(x, 1024, mix_phase=False)
    want = romix_cuda.romix_r1(x, 1024, mix_phase=False)
    fill_err = max_abs_err(got, want)
    require(fill_err == 0, "ROMix fill-only kernel == plain at N=1024")
    log(f"[romix] N=1024 B=300 kernel == plain (max_abs_err {err}), "
        f"fill only too (max_abs_err {fill_err})")

    commits = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    idx = rng.integers(0, 2**63, 32, dtype=np.uint64)
    labels = scrypt.scrypt_labels_multi(commits, idx, n=N_MAIN, device=dev)
    for i in range(32):
        want_b = hashlib.scrypt(bytes(commits[i]),
                                salt=int(idx[i]).to_bytes(8, "little"),
                                n=N_MAIN, r=1, p=1, dklen=16)
        require(bytes(labels[i]) == want_b, f"label {i} == hashlib.scrypt")
    log(f"[romix] N={N_MAIN}: 32 random (commitment, index) labels == "
        "hashlib.scrypt")

    # the init batch's shape: kernel vs plain, then their times
    x = u32.from_numpy(rng.integers(0, 2**32, (32, INIT_BATCH),
                                    dtype=np.uint32), dev)
    got = romix_cuda.romix(x, N_MAIN)
    ms = cuda_ms(lambda: romix_cuda.romix(x, N_MAIN), reps=3)
    fill = romix_cuda.romix(x, N_MAIN, mix_phase=False)
    fill_ms = cuda_ms(lambda: romix_cuda.romix(x, N_MAIN, mix_phase=False),
                      reps=3)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = romix_cuda.romix_r1(x, N_MAIN)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, want)
    require(err == 0, f"ROMix kernel == plain at N={N_MAIN}, "
                      f"{INIT_BATCH} lanes")
    del want
    torch.cuda.empty_cache()
    want = romix_cuda.romix_r1(x, N_MAIN, mix_phase=False)
    torch.cuda.synchronize()
    fill_err = max_abs_err(fill, want)
    require(fill_err == 0, f"ROMix fill-only kernel == plain at "
                           f"N={N_MAIN}, {INIT_BATCH} lanes")
    del want
    torch.cuda.empty_cache()
    ops = romix_cuda.int_ops(INIT_BATCH, N_MAIN)
    nbytes = romix_cuda.io_bytes(INIT_BATCH)
    scratch_ms = (romix_cuda.scratch_bytes(INIT_BATCH, N_MAIN)
                  / HBM_BYTES_PER_S * 1e3)
    ctx["romix"] = dict(
        ms=ms, plain_ms=plain_ms, max_abs_err=max(err, fill_err),
        shape=f"(32, {INIT_BATCH}) N={N_MAIN}", fill_ms=fill_ms,
        scratch_bound_ms=scratch_ms,
        **bound(ops, nbytes, ctx["int_ops_per_s"]))
    log(f"[romix] N={N_MAIN} B={INIT_BATCH} kernel == plain, whole and "
        f"fill only; kernel {ms:.2f} ms ({INIT_BATCH / ms * 1e3:.0f} "
        f"labels/s), plain {plain_ms:.0f} ms, bound "
        f"{ctx['romix']['bound_ms']:.2f} ms ({ctx['romix']['bound_by']}), "
        f"V scratch traffic floor {scratch_ms:.2f} ms")
    log(f"[romix] fill/mix split: fill {fill_ms:.2f} ms, mix "
        f"{ms - fill_ms:.2f} ms")


def pbkdf2_case(ctx: dict, b: int, per_lane: bool, seed: int) -> dict:
    """Both PBKDF2 entry points against their plain versions on ``b``
    random (commitment, index) lanes on the card, then both timed."""
    import numpy as np
    from spacemesh_tpu_torch.ops import pbkdf2_cuda, u32

    rng = np.random.default_rng(seed)
    dev = "cuda"
    cw = u32.from_numpy(rng.integers(0, 2**32, (8, b) if per_lane else (8,),
                                     dtype=np.uint32), dev)
    lo, hi = (u32.from_numpy(rng.integers(0, 2**32, b, dtype=np.uint32), dev)
              for _ in range(2))
    blk = pbkdf2_cuda.expand(cw, lo, hi)
    inner, outer, want = pbkdf2_cuda._expand(cw, lo, hi)
    out = {"expand": max_abs_err(blk, want)}
    b_le = u32.from_numpy(rng.integers(0, 2**32, (32, b), dtype=np.uint32),
                          dev)
    words = pbkdf2_cuda.finish(cw, b_le)
    out["finish"] = max_abs_err(
        words, pbkdf2_cuda._pbkdf2_second(inner, outer, b_le)[:4])
    form = "per-lane" if per_lane else "shared"
    for entry in ("expand", "finish"):
        require(out[entry] == 0, f"PBKDF2 {entry} kernel == plain at B={b} "
                                 f"({form} commitments)")
    calls = {"expand": (lambda: pbkdf2_cuda.expand(cw, lo, hi),
                        lambda: pbkdf2_cuda._expand(cw, lo, hi)),
             "finish": (lambda: pbkdf2_cuda.finish(cw, b_le),
                        lambda: pbkdf2_cuda._pbkdf2_second(
                            *pbkdf2_cuda._midstates(cw), b_le))}
    res = {}
    for entry, (kernel, plain) in calls.items():
        res[entry] = dict(
            ms=cuda_ms(kernel, reps=50), plain_ms=cuda_ms(plain, reps=2),
            kernel_ms=kernel_ms(kernel, f"{entry}_kernel", reps=50),
            max_abs_err=out[entry], shape=f"B={b} {form} commitment",
            **bound(pbkdf2_cuda.int_ops(b, entry, per_lane),
                    pbkdf2_cuda.io_bytes(b, entry, per_lane),
                    ctx["int_ops_per_s"]))
        k = res[entry]["kernel_ms"]
        log(f"[pbkdf2] {entry} B={b} ({form} commitments): kernel == plain; "
            f"wrapper call rate {res[entry]['ms']:.4f} ms, kernel time "
            f"{'not measured' if k is None else f'{k:.4f} ms'} (profiler), "
            f"plain {res[entry]['plain_ms']:.1f} ms, bound "
            f"{res[entry]['bound_ms']:.4f} ms ({res[entry]['bound_by']})")
    return res


def phase_pbkdf2(ctx: dict) -> None:
    # the init batch's shape (one commitment for every lane), the packed
    # init's (per-lane commitments at the same width), a verifyd farm
    # batch's, then a ragged batch of per-lane commitments as the verifier
    # sends
    main = pbkdf2_case(ctx, INIT_BATCH, per_lane=False, seed=6)
    packed = pbkdf2_case(ctx, INIT_BATCH, per_lane=True, seed=8)
    farm = pbkdf2_case(ctx, VERIFY_LANES, per_lane=True, seed=10)
    ragged = pbkdf2_case(ctx, RAGGED_LANES, per_lane=True, seed=7)
    keys = ("shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
    for entry in ("expand", "finish"):
        ctx[f"pbkdf2_{entry}"] = dict(
            main[entry],
            perlane={k: packed[entry][k] for k in keys},
            verify_width={k: farm[entry][k] for k in keys},
            ragged={k: ragged[entry][k] for k in keys})


def hash_case(ctx: dict, b: int, per_lane: bool, seed: int) -> dict:
    """The proving hash kernel against its plain twin on ``b`` random lanes
    with big-endian label words, as the verifier hands them over (and once
    little-endian), the challenge and nonce per lane or shared; then both
    timed."""
    import numpy as np
    from spacemesh_tpu_torch.ops import proving_cuda, u32

    rng = np.random.default_rng(seed)
    dev = "cuda"
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), dev))
    ch = rand(8, b) if per_lane else rand(8)
    nonce = rand(b) if per_lane else int(rng.integers(0, 2**32))
    lo, hi, words = rand(b), rand(b), rand(4, b)
    err = max(max_abs_err(
        proving_cuda.proving_hash(ch, nonce, lo, hi, words, big_endian=be),
        proving_cuda.proving_hash_plain(ch, nonce, lo, hi, words,
                                        big_endian=be)) for be in (True,
                                                                   False))
    form = "per-lane" if per_lane else "shared"
    require(err == 0, f"proving hash kernel == plain at B={b} ({form} "
                      f"challenge and nonce)")
    kernel = (lambda: proving_cuda.proving_hash(ch, nonce, lo, hi, words,
                                                big_endian=True))
    res = dict(
        ms=cuda_ms(kernel, reps=50),
        plain_ms=cuda_ms(lambda: proving_cuda.proving_hash_plain(
            ch, nonce, lo, hi, words, big_endian=True), reps=3),
        kernel_ms=kernel_ms(kernel, "hash_kernel", reps=50),
        max_abs_err=err, shape=f"B={b} {form} challenge and nonce",
        **bound(proving_cuda.hash_int_ops(b),
                proving_cuda.hash_io_bytes(b, per_lane),
                ctx["int_ops_per_s"]))
    log(f"[hash] B={b} ({form} challenge and nonce): kernel == plain (BE and "
        f"LE label words); wrapper call rate {res['ms']:.4f} ms, kernel "
        f"time {res['kernel_ms']} ms (profiler), plain "
        f"{res['plain_ms']:.2f} ms, bound {res['bound_ms']:.5f} ms "
        f"({res['bound_by']})")
    return res


def phase_proving_hash(ctx: dict) -> None:
    # the main path's verify (2 proofs x k3 lanes), a serial verify's k3
    # lanes, a verifyd farm batch; one shared challenge and nonce, as the
    # JAX function also takes
    keys = ("shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
    main = hash_case(ctx, 2 * 37, per_lane=True, seed=30)
    serial = hash_case(ctx, 37, per_lane=True, seed=31)
    farm = hash_case(ctx, VERIFY_LANES, per_lane=True, seed=32)
    shared = hash_case(ctx, VERIFY_LANES, per_lane=False, seed=33)
    ctx["proving_hash"] = dict(
        main, serial={k: serial[k] for k in keys},
        verify_width={k: farm[k] for k in keys},
        shared={k: shared[k] for k in keys},
        max_abs_err=max(c["max_abs_err"] for c in (main, serial, farm,
                                                   shared)))


def finish_hash_case(b: int, per_lane: bool, seed: int) -> tuple:
    """PBKDF2 finish with the proving hash as its epilogue against finish's
    plain twin then the hash's (big-endian words handed over) on ``b``
    random lanes: commitment, challenge and nonce per lane or shared; the
    words asked for and not. Returns (max_abs_err, the inputs)."""
    import numpy as np
    from spacemesh_tpu_torch.ops import pbkdf2_cuda, proving_cuda, u32

    rng = np.random.default_rng(seed)
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), "cuda"))
    cw = rand(8, b) if per_lane else rand(8)
    ch = rand(8, b) if per_lane else rand(8)
    nonce = rand(b) if per_lane else int(rng.integers(0, 2**32))
    lo, hi, blk = rand(b), rand(b), rand(32, b)
    args = (cw, blk, ch, nonce, lo, hi)
    values, words = pbkdf2_cuda.finish_hash(*args, words_out=True)
    only, none = pbkdf2_cuda.finish_hash(*args)
    want_words = pbkdf2_cuda._pbkdf2_second(*pbkdf2_cuda._midstates(cw),
                                            blk)[:4]
    want = proving_cuda.proving_hash_plain(ch, nonce, lo, hi, want_words,
                                           big_endian=True)
    err = max(max_abs_err(values, want), max_abs_err(only, want),
              max_abs_err(words, want_words))
    form = "per-lane" if per_lane else "shared"
    require(err == 0 and none is None, f"finish_hash == finish + proving "
            f"hash plain at B={b} ({form} commitment, challenge and nonce)")
    return err, args


def phase_finish_hash(ctx: dict) -> None:
    """finish_hash against its plain path at a serial verify's 37 lanes, a
    ragged 1037, the verifyd farm batch's 9472 (per lane) and 32768 shared
    lanes; timed at 9472 per-lane lanes, with finish alone in turns (the
    hash's share of the kernel) beside the hash's bound."""
    from spacemesh_tpu_torch.ops import pbkdf2_cuda, proving_cuda

    errs = {}
    for b, per_lane, seed in ((37, True, 50), (RAGGED_LANES, True, 51),
                              (32768, False, 53), (VERIFY_LANES, True, 52)):
        errs[f"B={b} {'per-lane' if per_lane else 'shared'}"], args = \
            finish_hash_case(b, per_lane, seed)
    cw, blk, ch, nonce, lo, hi = args  # the farm batch's shape
    b = VERIFY_LANES
    fh = (lambda: pbkdf2_cuda.finish_hash(cw, blk, ch, nonce, lo, hi))
    fin = (lambda: pbkdf2_cuda.finish(cw, blk))
    turns = [kernel_ms(f, "finish_kernel", reps=50)
             for f in (fin, fh, fh, fin)]
    hash_ms = (turns[1] + turns[2] - turns[0] - turns[3]) / 2
    hash_bound = bound(proving_cuda.hash_int_ops(b),
                       proving_cuda.hash_io_bytes(b, True),
                       ctx["int_ops_per_s"])["bound_ms"]
    ctx["pbkdf2_finish_hash"] = dict(
        ms=cuda_ms(fh, reps=50),
        plain_ms=cuda_ms(lambda: proving_cuda.proving_hash_plain(
            ch, nonce, lo, hi, pbkdf2_cuda._pbkdf2_second(
                *pbkdf2_cuda._midstates(cw), blk)[:4], big_endian=True),
            reps=2),
        kernel_ms=(turns[1] + turns[2]) / 2,
        finish_fh_fh_finish_ms=turns, hash_ms=hash_ms,
        hash_bound_ms=hash_bound, max_abs_err=max(errs.values()),
        shape=f"B={b} per-lane commitment, challenge and nonce",
        **bound(pbkdf2_cuda.int_ops(b, "finish_hash", True),
                pbkdf2_cuda.io_bytes(b, "finish_hash", True),
                ctx["int_ops_per_s"]))
    c = ctx["pbkdf2_finish_hash"]
    log(f"[finish_hash] == finish + proving hash plain at "
        f"{', '.join(errs)} (max_abs_err {c['max_abs_err']}); at B={b} "
        f"per-lane: kernel ms finish, finish_hash, finish_hash, finish "
        f"{json.dumps(turns)}: the hash adds {hash_ms:.5f} ms (its bound "
        f"alone {hash_bound:.5f} ms); wrapper call rate {c['ms']:.4f} ms, "
        f"plain {c['plain_ms']:.1f} ms, bound {c['bound_ms']:.5f} ms "
        f"({c['bound_by']})")


def first_hit(challenge: bytes, node: bytes, difficulty: bytes,
              start: int, count: int) -> int | None:
    """The smallest nonce of ``start .. start + count - 1`` below
    ``difficulty``, by hashlib; None when there is none."""
    prefix = challenge + node
    for n in range(start, start + count):
        if hashlib.sha256(prefix + n.to_bytes(8, "little")).digest() \
                < difficulty:
            return n
    return None


def window_cases(block1, ch: bytes, node: bytes) -> int:
    """The window kernel, both forms, against its plain twin on the card
    and hashlib over ``WINDOW_CHECK`` nonces: a winner inside, no winner
    (a zero target), and a window across nonce_hi = 1 whose winner is past
    it; and a window behind a winner, which leaves the cell. Returns the
    largest |kernel - plain| over the cells."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import pow_cuda

    dev = torch.device("cuda")
    hard = bytes([0, 4]) + bytes([255]) * 30
    carry = next(s for s in range((1 << 32) - 64, 1 << 32)
                 if (first_hit(ch, node, DEFAULT_DIFFICULTY, s, 4096) or 0)
                 >= 1 << 32)
    err = 0
    for name, diff, start in (("a winner inside", hard, 0),
                              ("no winner", bytes(32), 5),
                              ("across nonce_hi = 1", DEFAULT_DIFFICULTY,
                               carry)):
        tgt = np.frombuffer(diff, dtype=">u4").astype(np.uint32)
        want = pow_cuda.new_cell(dev)
        pow_cuda.search_window_plain(block1, tgt, start, WINDOW_CHECK, want,
                                     chunk=1 << 16)
        truth = first_hit(ch, node, diff, start,
                          WINDOW_CHECK if diff != bytes(32) else 0)
        plain = pow_cuda.cell_value(want.cpu())
        require(plain == (pow_cuda.NO_WINNER if truth is None else truth),
                f"window plain twin == hashlib ({name})")
        for imad in (True, False):
            got = pow_cuda.new_cell(dev)
            pow_cuda.search_window(block1, tgt, start, WINDOW_CHECK, got, dev,
                                   imad=imad)
            value = pow_cuda.cell_value(got.cpu())
            err = max(err, abs(value - plain))
            form = "IMAD" if imad else "plain"
            require(value == plain, f"window kernel ({form} form) == plain "
                    f"twin == hashlib ({name})")
            if truth is not None:
                pow_cuda.search_window(block1, tgt, start + WINDOW_CHECK,
                                       WINDOW_CHECK, got, dev, imad=imad)
                require(pow_cuda.cell_value(got.cpu()) == value,
                        f"a window behind the winner leaves the cell ({name})")
        log(f"[k2pow] window of {WINDOW_CHECK} nonces from {start} ({name}): "
            f"both forms == plain twin == hashlib "
            f"({'no winner' if truth is None else f'winner {truth}'})")
    return err


def phase_k2pow(ctx: dict) -> None:
    """The k2pow kernels against their plain twins and hashlib: the search
    window (both forms) in three cases, then timed at full width in turns,
    and one whole ``ops.pow.search`` at the default and mainnet
    difficulties; the mask kernel over ``SEARCH_BATCH`` nonces across
    nonce_hi = 1; the verify kernel on ``POW_WITNESSES`` random witnesses
    (valid, invalid and equal-to-target ones); an empty kernel's time."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import pow as k2pow
    from spacemesh_tpu_torch.ops import pow_cuda

    dev = torch.device("cuda")
    ch = hashlib.sha256(b"chip-smoke-k2pow-challenge").digest()
    node = hashlib.sha256(b"chip-smoke-k2pow-node").digest()
    block1 = np.frombuffer(ch + node, dtype=">u4").astype(np.uint32)
    ops_s = ctx["int_ops_per_s"]
    window_err = window_cases(block1, ch, node)

    # the window at full width, no winner: both forms in turns
    zero = np.zeros(8, dtype=np.uint32)

    def window(imad):
        return lambda: pow_cuda.search_window(
            block1, zero, 0, WINDOW_NONCES, pow_cuda.new_cell(dev), dev,
            imad=imad)

    turns = [kernel_ms(window(imad), "window_kernel", reps=10)
             for imad in (False, True, True, False)]
    imad_ms, plain_form_ms = (turns[1] + turns[2]) / 2, (turns[0]
                                                          + turns[3]) / 2
    blocks = pow_cuda.window_blocks(WINDOW_NONCES)
    t0 = time.perf_counter()
    cell = pow_cuda.new_cell(dev)
    pow_cuda.search_window_plain(block1, zero, 0, WINDOW_NONCES, cell,
                                 chunk=1 << 20)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ctx["k2pow_search"] = dict(
        ms=cuda_ms(window(True), reps=10), plain_ms=plain_ms,
        kernel_ms=imad_ms, plain_form_kernel_ms=plain_form_ms,
        plain_imad_imad_plain_ms=turns,
        nonces_per_s=WINDOW_NONCES / (imad_ms / 1e3),
        max_abs_err=window_err, blocks=blocks,
        shape=f"{WINDOW_NONCES} nonces, no winner (IMAD form)",
        **bound(pow_cuda.int_ops(WINDOW_NONCES, "window", blocks),
                pow_cuda.io_bytes(WINDOW_NONCES, "window"), ops_s))
    c = ctx["k2pow_search"]
    log(f"[k2pow] window of {WINDOW_NONCES} nonces, no winner, {blocks} "
        f"blocks: kernel ms plain, IMAD, IMAD, plain {json.dumps(turns)}; "
        f"IMAD {imad_ms:.4f} ms ({c['nonces_per_s'] / 1e9:.2f} G nonces/s, "
        f"{c['bound_ms'] / imad_ms:.0%} of the bound {c['bound_ms']:.4f} ms, "
        f"{c['bound_by']}), plain form {plain_form_ms:.4f} ms "
        f"({c['bound_ms'] / plain_form_ms:.0%}); wrapper call rate "
        f"{c['ms']:.4f} ms; plain twin {plain_ms:.0f} ms")

    # one whole search, host clock, warm, at both difficulties in turns
    runs = {name: (lambda diff=diff: k2pow.search(ch, node, diff, device=dev))
            for name, diff in (("default", DEFAULT_DIFFICULTY),
                               ("mainnet", MAINNET_DIFFICULTY))}
    wants = {name: first_hit(ch, node, diff, 0, 1 << 20)
             for name, diff in (("default", DEFAULT_DIFFICULTY),
                                ("mainnet", MAINNET_DIFFICULTY))}
    times = {name: [] for name in runs}
    launches = {name: set() for name in runs}
    for name, run in runs.items():
        require(run() == wants[name], f"ops.pow.search == hashlib ({name})")
    for _ in range(SEARCH_REPS):
        for name, run in runs.items():
            torch.cuda.synchronize()
            n0 = pow_cuda.search_launches
            t0 = time.perf_counter()
            nonce = run()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            launches[name].add(pow_cuda.search_launches - n0)
            require(nonce == wants[name], f"ops.pow.search == hashlib "
                    f"({name})")
    searches = {}
    for name, run in runs.items():
        want = wants[name]
        searches[name] = dict(
            nonce=want, ms=statistics.median(times[name]),
            ms_all=times[name], launches=sorted(launches[name]),
            kernel_ms=kernel_ms(run, "window_kernel", reps=5, per_call=True),
            # what this input needs: block 1 once, the nonces up to the
            # winner
            **bound(pow_cuda.int_ops(want + 1, "window", 1),
                    pow_cuda.io_bytes(want + 1, "window"), ops_s))
        r = searches[name]
        log(f"[k2pow] ops.pow.search at the {name} difficulty: nonce {want} "
            f"(== hashlib), {r['ms']:.3f} ms per search (host clock, median "
            f"of {SEARCH_REPS} in turns with the other difficulty: "
            f"{json.dumps([round(t, 3) for t in times[name]])}), "
            f"{r['launches']} window launches per search, kernel time "
            f"{r['kernel_ms']:.4f} ms per search; bound for the {want + 1} "
            f"nonces it needs {r['bound_ms']:.6f} ms")
        require(launches[name] == {2}, f"one window and the speculative one "
                f"behind it per search at the {name} difficulty "
                f"({sorted(launches[name])})")
    c["searches"] = searches

    # the empty kernel: the floor a launch costs
    empty = (lambda: pow_cuda.empty_launch(dev))
    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        empty()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    ctx["empty_kernel"] = dict(
        kernel_ms=kernel_ms(empty, "empty_kernel", reps=50),
        call_ms=cuda_ms(empty, reps=50),
        launch_to_done_ms=statistics.median(host))
    e = ctx["empty_kernel"]
    log(f"[k2pow] empty kernel: device {e['kernel_ms']} ms, back to back "
        f"{e['call_ms']:.4f} ms per wrapper call, launch to completion "
        f"{e['launch_to_done_ms']:.4f} ms (host clock, median of 50)")

    # the mask kernel, which no path launches, over a batch across
    # nonce_hi = 1
    diff = bytes([0, 4]) + bytes([255]) * 30
    pre = k2pow.prefix_state(ch, node)
    tgt = np.frombuffer(diff, dtype=">u4").astype(np.uint32)
    base = (1 << 32) - SEARCH_BATCH // 2
    got = pow_cuda.search_batch(pre, tgt, base, SEARCH_BATCH, dev)
    want = pow_cuda.search_plain(pre, tgt, base, SEARCH_BATCH, dev)
    err = max_abs_err(got.to(torch.int32), want.to(torch.int32))
    hits = torch.nonzero(got).flatten().tolist()
    require(err == 0, f"k2pow mask kernel == plain over {SEARCH_BATCH} "
                      "nonces")
    require(hits and all(k2pow.verify(ch, node, diff, base + h)
                         for h in hits), "every mask hit passes hashlib")
    miss = next(i for i in range(SEARCH_BATCH) if i not in set(hits))
    require(not k2pow.verify(ch, node, diff, base + miss),
            "a nonce the mask missed fails hashlib")
    search = (lambda: pow_cuda.search_batch(pre, tgt, 0, SEARCH_BATCH, dev))
    ctx["k2pow_search_mask"] = dict(
        ms=cuda_ms(search, reps=50),
        plain_ms=cuda_ms(lambda: pow_cuda.search_plain(
            pre, tgt, 0, SEARCH_BATCH, dev), reps=3),
        kernel_ms=kernel_ms(search, "search_kernel", reps=50),
        max_abs_err=err, shape=f"B={SEARCH_BATCH} nonces",
        **bound(pow_cuda.int_ops(SEARCH_BATCH, "search"),
                pow_cuda.io_bytes(SEARCH_BATCH, "search"), ops_s))
    c = ctx["k2pow_search_mask"]
    log(f"[k2pow] mask of {SEARCH_BATCH} nonces from {base}: kernel == "
        f"plain, {len(hits)} hits, each passing hashlib; wrapper call rate "
        f"{c['ms']:.4f} ms, kernel time {c['kernel_ms']} ms (profiler), plain "
        f"{c['plain_ms']:.1f} ms, bound {c['bound_ms']:.5f} ms "
        f"({c['bound_by']})")
    rng = np.random.default_rng(40)
    cases = {}
    for b in POW_WITNESSES:
        items = []
        for i in range(b):
            c_, n_ = (bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                      for _ in range(2))
            nonce = int(rng.integers(0, 2**64, dtype=np.uint64))
            d_ = bytes([int(rng.integers(0, 256))]) + bytes([255]) * 31
            if i % 7 == 0:  # a digest equal to its target is not below it
                d_ = k2pow.pow_hash(c_, n_, nonce)
            items.append((c_, n_, d_, nonce))
        block1 = u32_dev(np.stack([np.frombuffer(c_ + n_, dtype=">u4")
                                   for c_, n_, _, _ in items], axis=1))
        targets = u32_dev(np.stack([np.frombuffer(d_, dtype=">u4")
                                    for _, _, d_, _ in items], axis=1))
        lo, hi = pow_cuda.split_nonces(
            np.array([x[3] for x in items], dtype=np.uint64), dev)
        got = pow_cuda.verify_batch(block1, lo, hi, targets)
        want = pow_cuda.verify_plain(block1, lo, hi, targets)
        err = max_abs_err(got.to(torch.int32), want.to(torch.int32))
        truth = [k2pow.verify(*x[:3], x[3]) for x in items]
        require(err == 0 and got.cpu().tolist() == truth,
                f"k2pow verify kernel == plain == hashlib at {b} witnesses")
        require(0 < sum(truth) < b, "the witnesses are mixed")
        verify = (lambda: pow_cuda.verify_batch(block1, lo, hi, targets))
        cases[b] = dict(
            ms=cuda_ms(verify, reps=50),
            plain_ms=cuda_ms(lambda: pow_cuda.verify_plain(
                block1, lo, hi, targets), reps=3),
            kernel_ms=kernel_ms(verify, "verify_kernel", reps=50),
            max_abs_err=err, shape=f"B={b} witnesses",
            **bound(pow_cuda.int_ops(b, "verify"),
                    pow_cuda.io_bytes(b, "verify"), ops_s))
        c = cases[b]
        log(f"[k2pow] verify of {b} witnesses ({sum(truth)} valid): kernel "
            f"== plain == hashlib; wrapper call rate {c['ms']:.4f} ms, kernel "
            f"time {c['kernel_ms']} ms (profiler), plain {c['plain_ms']:.1f} "
            f"ms, bound {c['bound_ms']:.5f} ms ({c['bound_by']})")
    small, wide = POW_WITNESSES
    ctx["k2pow_verify"] = dict(cases[small], widest={
        k: cases[wide][k] for k in ("shape", "ms", "kernel_ms", "plain_ms",
                                    "bound_ms", "bound_by", "max_abs_err")},
        max_abs_err=max(c["max_abs_err"] for c in cases.values()))


def u32_dev(a):
    """A numpy u32 array on the card as int32 bit patterns."""
    import numpy as np
    from spacemesh_tpu_torch.ops import u32

    return u32.from_numpy(np.ascontiguousarray(a, dtype=np.uint32), "cuda")


def scan_case(b: int, valid: int, start: int, thr: int, seed: int,
              plain_reps: int) -> dict:
    """The scan kernel against its plain version, and one prove step through
    the kernel against the plain step, on ``b`` random device-resident
    labels at global indices ``start``.. with ``SCAN_NONCES`` nonces; then
    both timed on the same inputs."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import proving, proving_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ng = SCAN_NONCES
    lw = torch.randint(-2**31, 2**31, (4, b), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int32)
    idx = torch.arange(start, start + b, device=dev, dtype=torch.int64)
    # u32 halves as int32 bit patterns: shift [2^31, 2^32) down by 2^32
    lo = (((idx & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    hi = (idx >> 32).to(torch.int32)
    cw = np.frombuffer(hashlib.sha256(b"chip-smoke-scan").digest(),
                       dtype="<u4").astype(np.uint32)
    mask, seg = proving_cuda.scan(cw, 7, lo, hi, lw, thr, valid,
                                  n_nonces=ng)
    pmask, pseg = proving_cuda.scan_plain(cw, 7, lo, hi, lw, thr, valid,
                                          n_nonces=ng)
    require(torch.equal(mask, pmask), f"scan mask == plain at B={b}")
    require(torch.equal(seg, pseg), f"scan segment counts == plain at B={b}")
    hits = int(seg.sum().item())
    require(hits > 0, f"scan found hits at B={b}")

    counts, carry = proving.init_hit_state(ng, 37, dev)
    got = proving.prove_scan_step(cw, 7, lo, hi, lw, thr, counts, carry,
                                  valid, start & 0xFFFFFFFF, start >> 32,
                                  n_nonces=ng, max_hits=37)
    c, p, ok = proving.compact_hits(pmask.bool(), pseg, max_hits=37)
    want = proving.merge_hits(counts, carry, c, p, ok, start & 0xFFFFFFFF,
                              start >> 32)
    for g, w in zip(got, want):
        require(torch.equal(g, w), f"prove step via kernel == plain at B={b}")

    ms = cuda_ms(lambda: proving_cuda.scan(cw, 7, lo, hi, lw, thr, valid,
                                           n_nonces=ng), reps=10)
    plain_ms = cuda_ms(lambda: proving_cuda.scan_plain(
        cw, 7, lo, hi, lw, thr, valid, n_nonces=ng), reps=plain_reps)
    return dict(ms=ms, plain_ms=plain_ms, hits=hits,
                max_abs_err=max_abs_err(mask, pmask),
                ops=proving_cuda.int_ops(b, ng),
                nbytes=proving_cuda.io_bytes(b, ng))


def phase_scan(ctx: dict) -> None:
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import prover

    # the main path's shape: every prove batch is PROVE_BATCH lanes, full,
    # at the mainnet k1 threshold over the unit
    k1 = prover.ProofParams().k1
    m = scan_case(PROVE_BATCH, PROVE_BATCH, PROVE_BATCH,
                  proving.threshold_u32(k1, UNIT_LABELS), seed=4,
                  plain_reps=3)
    # full width: 2^24 lanes, a ragged valid, a window crossing idx_hi = 1
    f = scan_case(SCAN_LANES, SCAN_LANES - 1000, (1 << 32) - (1 << 20),
                  proving.threshold_u32(4096, SCAN_LANES), seed=2,
                  plain_reps=2)
    for key, b, c in (("scan", PROVE_BATCH, m),
                      ("scan_full", SCAN_LANES, f)):
        ctx[key] = dict(ms=c["ms"], plain_ms=c["plain_ms"],
                        max_abs_err=c["max_abs_err"],
                        shape=f"B={b} nonces={SCAN_NONCES}",
                        **bound(c["ops"], c["nbytes"], ctx["int_ops_per_s"]))
        rate = b * SCAN_NONCES / c["ms"] / 1e6
        log(f"[scan] B={b} nonces={SCAN_NONCES}: kernel == plain (mask, "
            f"segments; {c['hits']} hits), prove step via kernel == plain "
            f"step; kernel {c['ms']:.4f} ms ({rate:.2f} G label-nonces/s), "
            f"plain {c['plain_ms']:.1f} ms, bound "
            f"{ctx[key]['bound_ms']:.4f} ms")


def phase_main_path(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import initializer, prover, verifier
    from spacemesh_tpu_torch.post.data import LabelStore

    node = hashlib.sha256(b"chip-smoke-node").digest()
    commitment = hashlib.sha256(b"chip-smoke-commitment").digest()
    challenge = hashlib.sha256(b"chip-smoke-challenge").digest()
    params = prover.ProofParams()  # mainnet k1/k2/k3, default k2pow
    alloc_ms = v_alloc_ms()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as d:
        zero_launches()
        GUARD.start()
        t0 = time.perf_counter()
        meta, res = initializer.initialize(
            d, node_id=node, commitment=commitment, num_units=1,
            labels_per_unit=UNIT_LABELS, scrypt_n=N_MAIN,
            batch_size=INIT_BATCH, device="cuda")
        init_s = time.perf_counter() - t0
        pv = prover.Prover(d, params, batch_labels=PROVE_BATCH,
                           device="cuda")
        t0 = time.perf_counter()
        proof = pv.prove(challenge)
        prove_s = time.perf_counter() - t0
        swept = pv.last_stats.labels_swept
        t0 = time.perf_counter()
        serial = pv.prove_serial(challenge)
        serial_s = time.perf_counter() - t0
        bad = dataclasses.replace(proof, indices=list(proof.indices))
        total = meta.total_labels
        thr = proving.threshold_u32(params.k1, total)
        item = verifier.VerifyItem(proof=proof, challenge=challenge,
                                   node_id=node, commitment=commitment,
                                   scrypt_n=N_MAIN, total_labels=total)
        with GUARD.paused():  # the script's host check, not the path
            bad.indices[0] = replacement_index(proof, commitment, challenge,
                                               thr, total)
        bad_item = verifier.VerifyItem(proof=bad, challenge=challenge,
                                       node_id=node, commitment=commitment,
                                       scrypt_n=N_MAIN, total_labels=total)
        t0 = time.perf_counter()
        verdicts = verifier.verify_many([item, bad_item], params,
                                        device="cuda")
        verify_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        ctx["launches"] = launch_counts()
        guard = GUARD.stop()

        require(meta.labels_written == UNIT_LABELS, "init wrote every label")
        st = res.stats
        log(f"[init] {UNIT_LABELS} labels N={N_MAIN} batch={INIT_BATCH}: "
            f"{init_s:.2f} s, {res.labels_per_s:.0f} labels/s; stats "
            f"{json.dumps(st.as_dict())}")
        shares = {k: getattr(st, k) / res.elapsed_s for k in (
            "dispatch_s", "fetch_s", "write_stall_s", "save_s")}
        log(f"[init] share of the init time: " + ", ".join(
            f"{k} {v:.1%}" for k, v in shares.items()))
        calls = envelope_calls()
        rest = st.dispatch_s - st.first_dispatch_s
        log(f"[init] envelope: {calls} torch calls per batch around the "
            f"kernels (counted on the card); dispatch of the first batch "
            f"{st.first_dispatch_s * 1e3:.2f} ms (one bare allocation of "
            f"its V scratch: {alloc_ms:.2f} ms), of each later batch "
            f"{rest / max(st.batches - 1, 1) * 1e3:.2f} ms on average")
        store = LabelStore(d, meta)
        try:
            stored = np.frombuffer(store.read_labels(0, UNIT_LABELS),
                                   dtype=np.uint8).reshape(-1, 16)
        finally:
            store.close()
        rng = np.random.default_rng(3)
        for i in sorted(rng.choice(UNIT_LABELS, 16, replace=False).tolist()):
            want = hashlib.scrypt(commitment, salt=i.to_bytes(8, "little"),
                                  n=N_MAIN, r=1, p=1, dklen=16)
            require(bytes(stored[i]) == want, f"stored label {i} == hashlib")
        lo = stored[:, :8].copy().view("<u8").ravel()
        hi = stored[:, 8:].copy().view("<u8").ravel()
        vrf = int(np.lexsort((lo, hi))[0])
        require(meta.vrf_nonce == vrf, "VRF nonce is the stored minimum")
        require(bytes.fromhex(meta.vrf_nonce_value) == bytes(stored[vrf]),
                "VRF nonce value is its label")
        log(f"[init] 16 sampled stored labels == hashlib.scrypt; VRF nonce "
            f"{vrf} is the minimum of the store")

        require(proof == serial, "pipelined proof == serial proof")
        log(f"[prove] nonce {proof.nonce}, pow_nonce {proof.pow_nonce}: "
            f"pipelined {prove_s:.2f} s ({swept} labels swept, "
            f"{swept / prove_s:.0f} labels/s), serial {serial_s:.2f} s, "
            "identical proofs")

        require(verdicts == [True, False],
                f"verify_many verdicts {verdicts} == [True, False]")
        labels = np.stack([np.frombuffer(hashlib.scrypt(
            commitment, salt=i.to_bytes(8, "little"), n=N_MAIN, r=1, p=1,
            dklen=16), dtype=np.uint8) for i in proof.indices])
        vals = proving.proving_hashes(challenge, proof.nonce, proof.indices,
                                      labels, device="cpu")
        require(bool((vals < thr).all()), "hashlib + plain CPU path accept")
        log(f"[verify] verify_many -> {verdicts} in {verify_s:.2f} s; "
            "hashlib labels + plain CPU hashes agree")
    require_no_twins(guard, "main path")
    launches = ctx["launches"]
    for key, n in launches.items():
        if key in OFF_PATH:
            require(n == 0, f"main path launched no {key}")
        elif key != "k2pow_verify":  # witnesses are checked with hashlib
            require(n > 0, f"main path launched {key}")
    require(launches["pbkdf2_finish_hash"] == 1, "the verify's recompute "
            "is one finish_hash launch")
    require(launches["k2pow_search"] >= 2, "k2pow search launched at "
            "least one window per proof (pipelined and serial)")
    log(f"[launches] main path: {json.dumps(launches)}; k2pow windows "
        f"{launches['k2pow_search']} for 2 searches")


def run_cli(args: list, want_rc: int = 0) -> dict:
    """Run the port's CLI in a subprocess from the checkout; its last
    stdout line parsed as JSON. Fails unless it exits with ``want_rc``."""
    out = subprocess.run(CLI + args, cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    require(out.returncode == want_rc,
            f"`post {args[0]}` exited {out.returncode} (want {want_rc}): "
            f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def cli_verify_both(d: str, challenge: bytes, good, bad) -> list:
    """``post verify`` of the store at ``d`` on two proofs, in two
    subprocesses at once: [(exit code, JSON line)] for each."""
    procs = []
    try:
        for proof in (good, bad):
            path = os.path.join(os.path.dirname(d),
                                f"proof-{len(procs)}.json")
            with open(path, "w") as fh:
                json.dump(proof.to_dict(), fh)
            procs.append(subprocess.Popen(
                CLI + ["verify", "--data-dir", d, "--proof-file", path,
                       "--challenge-hex", challenge.hex()],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        res = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            require(p.returncode in (0, 1),
                    f"`post verify` exited {p.returncode}: {err[-2000:]}")
            res.append((p.returncode,
                        json.loads(out.strip().splitlines()[-1])))
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def wait_served(client, timeout: float) -> float:
    """Seconds until ``client.ping()`` answers again after a restart."""
    t0 = time.perf_counter()
    while True:
        try:
            client.ping()
            return time.perf_counter() - t0
        except (OSError, RuntimeError):
            require(time.perf_counter() - t0 < timeout,
                    "worker came back after the kill")
            time.sleep(0.2)


def phase_worker(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import prover, verifier
    from spacemesh_tpu_torch.post.data import LabelStore, PostMetadata
    from spacemesh_tpu_torch.post.remote import RemotePostClient
    from spacemesh_tpu_torch.post.supervisor import PostSupervisor

    node = hashlib.sha256(b"chip-smoke-worker-node").digest()
    commitment = hashlib.sha256(b"chip-smoke-worker-commitment").digest()
    challenge = hashlib.sha256(b"chip-smoke-worker-challenge").digest()
    params = prover.ProofParams()  # what the CLI and the worker default to
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    with tempfile.TemporaryDirectory(prefix="chip-smoke-worker-") as base:
        d = os.path.join(base, node.hex()[:16])
        t0 = time.perf_counter()
        init = run_cli(["init", "--data-dir", d, "--node-id-hex", node.hex(),
                        "--commitment-hex", commitment.hex(),
                        "--num-units", "1",
                        "--labels-per-unit", str(WORKER_LABELS),
                        "--scrypt-n", str(N_MAIN), "--batch", str(INIT_BATCH),
                        "--stage-timings"])
        init_cmd_s = time.perf_counter() - t0
        require(init["labels_written"] == WORKER_LABELS,
                "CLI init wrote every label")
        st = init["stages"]
        shares = {k: st[k] / init["elapsed_s"] for k in (
            "dispatch_s", "fetch_s", "write_stall_s", "save_s")}
        log(f"[worker] CLI init {WORKER_LABELS} labels N={N_MAIN} "
            f"batch={INIT_BATCH}: {json.dumps(init)} ({init_cmd_s:.1f} s of "
            "command time); share of the init time: " + ", ".join(
                f"{k} {v:.1%}" for k, v in shares.items()))
        meta = PostMetadata.load(d)
        store = LabelStore(d, meta)
        try:
            stored = np.frombuffer(store.read_labels(0, WORKER_LABELS),
                                   dtype=np.uint8).reshape(-1, 16)
        finally:
            store.close()
        rng = np.random.default_rng(5)
        for i in sorted(rng.choice(WORKER_LABELS, 64,
                                   replace=False).tolist()):
            want = hashlib.scrypt(commitment, salt=i.to_bytes(8, "little"),
                                  n=N_MAIN, r=1, p=1, dklen=16)
            require(bytes(stored[i]) == want,
                    f"CLI-initialized label {i} == hashlib")
        log("[worker] 64 random labels of the CLI's store == hashlib.scrypt")

        bench = run_cli(["benchmark", "--batch", str(INIT_BATCH),
                         "--scrypt-n", str(N_MAIN)])
        require(bench["labels_per_s"] > 0, "benchmark printed a rate")
        log(f"[worker] CLI benchmark: {json.dumps(bench)}")

        sup = PostSupervisor(base, device="cuda")
        t0 = time.perf_counter()
        addr = sup.start(timeout=300)
        ready_s = time.perf_counter() - t0
        times = {}
        try:
            client = RemotePostClient(addr, node, timeout=600)
            info = client.info()
            require((info.node_id, info.commitment, info.num_units,
                     info.labels_per_unit, info.scrypt_n,
                     info.labels_written, info.vrf_nonce) ==
                    (node, commitment, 1, WORKER_LABELS, N_MAIN,
                     WORKER_LABELS, meta.vrf_nonce),
                    "worker info() has the store's geometry")
            log(f"[worker] supervisor spawn to ready {ready_s:.2f} s; "
                f"info() == the store's geometry")
            worker = []
            for rep_ in range(2):  # a cold and a warm prove in the worker
                t0 = time.perf_counter()
                worker.append(client.proof(challenge)[0])
                times[f"worker_g1_{rep_}"] = time.perf_counter() - t0
            require(worker[0] == worker[1], "worker proofs agree")

            zero_launches()
            for g in (1, 4):
                pv = prover.Prover(d, params, window_groups=g, device="cuda")
                t0 = time.perf_counter()
                proof = pv.prove(challenge)
                times[f"inproc_g{g}"] = time.perf_counter() - t0
                require(proof == worker[0],
                        f"worker proof == in-process proof at G={g}")
            total = meta.total_labels
            thr = proving.threshold_u32(params.k1, total)
            bad = dataclasses.replace(worker[0],
                                      indices=list(worker[0].indices))
            bad.indices[0] = replacement_index(worker[0], commitment,
                                               challenge, thr, total)
            items = [verifier.VerifyItem(
                proof=p, challenge=challenge, node_id=node,
                commitment=commitment, scrypt_n=N_MAIN, total_labels=total)
                for p in (worker[0], bad)]
            verdicts = verifier.verify_many(items, params, device="cuda")
            torch.cuda.synchronize()
            launches = launch_counts()
            require(verdicts == [True, False],
                    f"in-process verdicts {verdicts} == [True, False]")
            for key, n in launches.items():
                if key in OFF_PATH:
                    require(n == 0, f"worker phase launched no {key}")
                elif key not in ("k2pow_verify", "pbkdf2_finish"):
                    # no init in process: finish runs only as finish_hash
                    require(n > 0, f"worker phase launched {key} in process")

            # kill the worker once: the supervisor restarts it on the same
            # port, this time proving 4 nonce groups per disk pass
            sup.env = dict(os.environ, SPACEMESH_PROVE_WINDOW_GROUPS="4")
            before = sup.restarts
            sup._proc.kill()
            back_s = wait_served(client, timeout=300)
            require(sup.restarts == before + 1 and sup.address == addr,
                    "supervisor restarted the worker on the same port")
            for rep_ in range(2):
                t0 = time.perf_counter()
                again = client.proof(challenge)[0]
                times[f"worker_g4_{rep_}"] = time.perf_counter() - t0
                require(again == worker[0],
                        "the restarted worker's proof (G=4) is the same")
        finally:
            sup.stop()
        require(not sup.alive(), "the supervisor stopped its worker")

        (rc_good, good), (rc_bad, badv) = cli_verify_both(
            d, challenge, worker[0], bad)
        require((rc_good, good) == (0, {"valid": True}),
                f"CLI verify accepted the proof ({rc_good}, {good})")
        require((rc_bad, badv) == (1, {"valid": False}),
                f"CLI verify rejected the tampered proof ({rc_bad}, {badv})")
        windows = window_medians(d, params)
    log(f"[worker] proof nonce {worker[0].nonce}: worker G=1 "
        f"{times['worker_g1_0']:.3f} s cold, {times['worker_g1_1']:.3f} s "
        f"warm; in-process G=1 {times['inproc_g1']:.3f} s, G=4 "
        f"{times['inproc_g4']:.3f} s; killed, back in {back_s:.2f} s, "
        f"worker G=4 {times['worker_g4_0']:.3f} s cold, "
        f"{times['worker_g4_1']:.3f} s warm; all the same proof")
    log(f"[worker] CLI verify: exit 0 {json.dumps(good)} on the proof, "
        f"exit 1 {json.dumps(badv)} on the tampered copy; in-process "
        f"launches {json.dumps(launches)}")
    for w in windows:
        log(f"[worker] window: challenge {w['challenge']} winner nonce "
            f"{w['nonce']} (group {w['group']}), in-process prove median of "
            f"{WINDOW_REPS} alternating reps: G=1 {w['g1_s']:.4f} s, G=4 "
            f"{w['g4_s']:.4f} s, G=4/G=1 {w['g4_s'] / w['g1_s']:.3f}; "
            f"samples G=1 {w['g1']}, G=4 {w['g4']}")
    ctx["worker"] = dict(init=init, bench=bench, ready_s=ready_s,
                         back_s=back_s, times=times, launches=launches,
                         windows=windows)
    log(f"[worker] {ctx['smi']}")


def window_medians(d: str, params) -> list:
    """In-process prove times at window_groups 1 and 4 on the store in
    ``d``: for the first challenge (of a fixed list) whose winning nonce is
    in the first group of 16, and the first whose winner is in a later
    group, since G=4 saves disk passes only in the second case. G=1 and
    G=4 alternate, each order in turn; every proof must equal G=1's first.
    Returns one dict per challenge with the medians in seconds."""
    from spacemesh_tpu_torch.post import prover

    provers = {g: prover.Prover(d, params, window_groups=g, device="cuda")
               for g in (1, 4)}
    picked = {}
    for i in range(WINDOW_CANDIDATES):
        challenge = hashlib.sha256(b"chip-smoke-window-%d" % i).digest()
        ref = provers[1].prove(challenge)
        first = ref.nonce < SCAN_NONCES
        if first not in picked:
            picked[first] = (i, challenge, ref)
        if len(picked) == 2:
            break
    require(len(picked) == 2, f"of {WINDOW_CANDIDATES} challenges one has "
            "its winner in the first nonce group and one in a later group")
    out = []
    for first in (True, False):
        i, challenge, ref = picked[first]
        samples = {1: [], 4: []}
        for rep in range(WINDOW_REPS):
            for g in ((1, 4) if rep % 2 == 0 else (4, 1)):
                t0 = time.perf_counter()
                proof = provers[g].prove(challenge)
                samples[g].append(round(time.perf_counter() - t0, 4))
                require(proof == ref, f"window G={g} proof == G=1's "
                        f"(challenge {i})")
        out.append(dict(challenge=i, nonce=ref.nonce,
                        group=ref.nonce // SCAN_NONCES,
                        g1_s=statistics.median(samples[1]),
                        g4_s=statistics.median(samples[4]),
                        g1=samples[1], g4=samples[4]))
    return out


def tenant_ids(salt: bytes) -> list:
    """(tenant id, node id, commitment) of the phase's identities."""
    return [(f"id{i:02d}",
             hashlib.sha256(b"chip-smoke-tenant-node-%d" % i + salt).digest(),
             hashlib.sha256(b"chip-smoke-tenant-commit-%d" % i + salt).digest())
            for i in range(TENANTS)]


def submit_inits(sched, base: str, ids: list, labels: int) -> list:
    """One packed init job per identity under ``base``; their handles."""
    return [sched.submit_init(tid, os.path.join(base, tid), node_id=node,
                              commitment=commit, num_units=1,
                              labels_per_unit=labels, scrypt_n=N_MAIN)
            for tid, node, commit in ids]


def stamped(handles: list) -> list:
    """Each handle's completion time (``time.perf_counter``), filled in by
    a done-callback of its future."""
    done = [None] * len(handles)
    for i, h in enumerate(handles):
        h.future.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
    return done


def stored_labels(d: str, meta):
    import numpy as np
    from spacemesh_tpu_torch.post.data import LabelStore

    store = LabelStore(d, meta)
    try:
        return np.frombuffer(store.read_labels(0, meta.total_labels),
                             dtype=np.uint8).reshape(-1, 16)
    finally:
        store.close()


def store_digests(d: str) -> dict:
    return {name: hashlib.sha256(open(os.path.join(d, name), "rb").read())
            .hexdigest() for name in sorted(os.listdir(d))
            if name.startswith("postdata_") and name.endswith(".bin")}


def check_hashlib(commitment: bytes, stored, picks) -> None:
    """Stored labels at ``picks`` against hashlib.scrypt, in threads
    (hashlib releases the interpreter lock while it hashes)."""
    from concurrent.futures import ThreadPoolExecutor

    def want(i):
        return hashlib.scrypt(commitment, salt=int(i).to_bytes(8, "little"),
                              n=N_MAIN, r=1, p=1, dklen=16)

    with ThreadPoolExecutor(8) as pool:
        for i, w in zip(picks, pool.map(want, picks)):
            require(bytes(stored[i]) == w, f"tenant label {i} == hashlib")


def first_min(stored) -> int:
    """Index of the smallest LE-u128 label, the first one on ties."""
    import numpy as np

    lo = stored[:, :8].copy().view("<u8").ravel()
    hi = stored[:, 8:].copy().view("<u8").ravel()
    return int(np.lexsort((np.arange(lo.shape[0]), lo, hi))[0])


def launch_counts() -> dict:
    from spacemesh_tpu_torch.ops import (pbkdf2_cuda, pow_cuda, proving_cuda,
                                         romix_cuda)

    return {"romix": romix_cuda.launches, "scan": proving_cuda.launches,
            "pbkdf2_expand": pbkdf2_cuda.expand_launches,
            "pbkdf2_finish": pbkdf2_cuda.finish_launches,
            "pbkdf2_finish_hash": pbkdf2_cuda.finish_hash_launches,
            "proving_hash": proving_cuda.hash_launches,
            "k2pow_search": pow_cuda.search_launches,
            "k2pow_search_mask": pow_cuda.mask_launches,
            "k2pow_verify": pow_cuda.verify_launches}


# kernels no path launches: the standalone proving hash (labels from the
# host, ops/proving.py:proving_hashes) and the k2pow mask search
OFF_PATH = ("proving_hash", "k2pow_search_mask")


def zero_launches() -> None:
    from spacemesh_tpu_torch.ops import (pbkdf2_cuda, pow_cuda, proving_cuda,
                                         romix_cuda)

    romix_cuda.launches = proving_cuda.launches = 0
    pbkdf2_cuda.expand_launches = pbkdf2_cuda.finish_launches = 0
    pbkdf2_cuda.finish_hash_launches = proving_cuda.hash_launches = 0
    pow_cuda.search_launches = pow_cuda.verify_launches = 0
    pow_cuda.mask_launches = 0


def quantiles(xs: list) -> str:
    return f"p50 {statistics.median(xs):.3f} s, max {max(xs):.3f} s"


def phase_tenants(ctx: dict) -> None:
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import pow as k2pow
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import initializer, prover, verifier
    from spacemesh_tpu_torch.runtime import TenantScheduler, scheduler
    from spacemesh_tpu_torch.tools.measure import busy_us, device_intervals
    from spacemesh_tpu_torch.utils import metrics

    dev = "cuda"

    def settle():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    params = prover.ProofParams()  # mainnet k1/k2/k3, default k2pow
    challenge = hashlib.sha256(b"chip-smoke-tenants-challenge").digest()
    ids = tenant_ids(b"")
    load_ids = tenant_ids(b"-load")
    rep_ids = tenant_ids(b"-rep")
    narrow_ids = tenant_ids(b"-narrow")
    mix_ids = tenant_ids(b"-mixed")
    total = TENANTS * TENANT_LABELS
    solo_s, packed_s = [], []

    def solo_init(d):
        # a solo init of the phase's label count, as the yardstick
        settle()
        t0 = time.perf_counter()
        initializer.initialize(
            d, node_id=ids[0][1], commitment=ids[0][2], num_units=1,
            labels_per_unit=total, scrypt_n=N_MAIN, batch_size=INIT_BATCH,
            device=dev)
        solo_s.append(time.perf_counter() - t0)
        shutil.rmtree(d)
        settle()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-tenants-") as base:
        solo_init(os.path.join(base, "solo"))
        sched = TenantScheduler(device=dev)
        try:
            for tid, _, _ in ids + load_ids + rep_ids + mix_ids:
                sched.register_tenant(tid)
            tenants_sample = metrics.runtime_pack_tenants.sample().get(
                (), ([], 0.0, 0))
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            # the tenants' path: packed init, proves idle and under load,
            # one verify, k2pow
            GUARD.start()
            t0 = time.perf_counter()
            metas = [h.result(timeout=600) for h in submit_inits(
                sched, base, ids, TENANT_LABELS)]
            packed_s.append(time.perf_counter() - t0)
            ps = dataclasses.replace(sched.pack_stats)
            tenants_after = metrics.runtime_pack_tenants.sample()[()]
            lat = {}
            for key, load_labels in (("idle", 0), ("load", LOAD_LABELS)):
                t0 = time.perf_counter()
                load = submit_inits(sched, os.path.join(base, "load"),
                                    load_ids, load_labels) \
                    if load_labels else []
                load_done = stamped(load)
                proves = [sched.submit_prove(tid, os.path.join(base, tid),
                                             challenge, params)
                          for tid, _, _ in ids]
                done = stamped(proves)
                lat[key] = [h.result(timeout=600) for h in proves]
                load_metas = [h.result(timeout=600) for h in load]
                lat[key] = (lat[key], [t - t0 for t in done])
            (proofs, idle_lat), (again, load_lat) = lat["idle"], lat["load"]
            load_s = max(load_done) - t0
            peak = torch.cuda.max_memory_allocated()
            thr = proving.threshold_u32(params.k1, TENANT_LABELS)
            items = [verifier.VerifyItem(
                proof=p, challenge=challenge, node_id=node, commitment=commit,
                scrypt_n=N_MAIN, total_labels=TENANT_LABELS)
                for p, (_, node, commit) in zip(proofs, ids)]
            bad = dataclasses.replace(proofs[0], indices=list(proofs[0].indices))
            with GUARD.paused():  # the script's host check, not the path
                bad.indices[0] = replacement_index(proofs[0], ids[0][2],
                                                   challenge, thr,
                                                   TENANT_LABELS)
            items.append(dataclasses.replace(items[0], proof=bad))
            t0 = time.perf_counter()
            verdicts = sched.submit_verify("id00", items, params).result(
                timeout=600)
            verify_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pows = [h.result(timeout=600) for h in [
                sched.submit_pow(tid, challenge, node, params.pow_difficulty)
                for tid, node, _ in ids]]
            pow_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = launch_counts()
            guard = GUARD.stop()
            # the second packed init of the comparison, then the second solo
            t0 = time.perf_counter()
            for h in submit_inits(sched, os.path.join(base, "rep"), rep_ids,
                                  TENANT_LABELS):
                h.result(timeout=600)
            packed_s.append(time.perf_counter() - t0)
            solo_init(os.path.join(base, "solo"))
            # the JAX package's pack width, for the rate at both widths
            with TenantScheduler(pack_lanes=scheduler.DEFAULT_PACK_LANES,
                                 device=dev) as narrow:
                for tid, _, _ in narrow_ids:
                    narrow.register_tenant(tid)
                t0 = time.perf_counter()
                for h in submit_inits(narrow, os.path.join(base, "narrow"),
                                      narrow_ids, TENANT_LABELS):
                    h.result(timeout=600)
                narrow_s = time.perf_counter() - t0
            # packs cut across tenants, and the device's idle share
            # during a packed init, profiled apart
            mix_sample = metrics.runtime_pack_tenants.sample()[()]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                mix_metas = [h.result(timeout=600) for h in submit_inits(
                    sched, os.path.join(base, "mix"), mix_ids, MIX_LABELS)]
                torch.cuda.synchronize()
                mix_s = time.perf_counter() - t0
            mix_after = metrics.runtime_pack_tenants.sample()[()]
        finally:
            sched.close()
        intervals = device_intervals(prof)

        require_no_twins(guard, "tenants")
        for key, n in launches.items():
            if key in OFF_PATH:
                require(n == 0, f"the tenants' path launched no {key}")
            elif key != "k2pow_verify":
                require(n > 0, f"the tenants' path launched {key}")
        require(launches["k2pow_search"] >= 3 * TENANTS,
                f"k2pow search launched at least one window per proof and "
                f"per submit_pow ({launches['k2pow_search']} for "
                f"{3 * TENANTS} searches)")
        for (tid, node, commit), meta in zip(ids, metas):
            require(meta.labels_written == TENANT_LABELS,
                    f"{tid}: packed init wrote every label")
        rng = np.random.default_rng(9)
        fold = []
        for (tid, node, commit), meta in zip(ids, metas):
            stored = stored_labels(os.path.join(base, tid), meta)
            check_hashlib(commit, stored, sorted(rng.choice(
                TENANT_LABELS, 64, replace=False).tolist()))
            t0 = time.perf_counter()
            vrf = first_min(stored)
            fold.append(time.perf_counter() - t0)
            require(meta.vrf_nonce == vrf, f"{tid}: VRF nonce is the stored "
                    "first-occurrence minimum")
            require(bytes.fromhex(meta.vrf_nonce_value) == bytes(stored[vrf]),
                    f"{tid}: VRF nonce value is its label")
        for (tid, node, commit), meta in zip(load_ids, load_metas):
            require(meta.labels_written == LOAD_LABELS,
                    f"{tid}: the concurrent packed init wrote every label")
            stored = stored_labels(os.path.join(base, "load", tid), meta)
            check_hashlib(commit, stored, sorted(rng.choice(
                LOAD_LABELS, 8, replace=False).tolist()))
        mix_tenants = ((mix_after[1] - mix_sample[1])
                       / max(mix_after[2] - mix_sample[2], 1))
        require(mix_tenants > 1, f"packs of {MIX_LABELS} labels per "
                f"identity mix tenants ({mix_tenants:.2f} per pack)")
        for (tid, node, commit), meta in zip(mix_ids, mix_metas):
            require(meta.labels_written == MIX_LABELS,
                    f"{tid}: the mixed packed init wrote every label")
            stored = stored_labels(os.path.join(base, "mix", tid), meta)
            check_hashlib(commit, stored, sorted(rng.choice(
                MIX_LABELS, 64, replace=False).tolist()))
            vrf = first_min(stored)
            require(meta.vrf_nonce == vrf
                    and bytes.fromhex(meta.vrf_nonce_value)
                    == bytes(stored[vrf]),
                    f"{tid}: mixed packs' VRF nonce is the stored first "
                    "minimum")
        log(f"[tenants] {TENANTS} x {TENANT_LABELS} packed labels and "
            f"{TENANTS} x {MIX_LABELS} in packs of {mix_tenants:.2f} "
            f"tenants: 64 sampled per identity == hashlib.scrypt; every VRF "
            f"nonce is its store's first minimum; the concurrent init's "
            f"{TENANTS} x {LOAD_LABELS} labels: 8 sampled per identity == "
            f"hashlib")
        for sub, pids, pmetas, labels in (("", ids, metas, TENANT_LABELS),
                                          ("mix", mix_ids, mix_metas,
                                           MIX_LABELS)):
            for tid, node, commit in pids[:2]:
                d = os.path.join(base, f"solo-{sub}{tid}")
                meta, _ = initializer.initialize(
                    d, node_id=node, commitment=commit, num_units=1,
                    labels_per_unit=labels, scrypt_n=N_MAIN,
                    batch_size=INIT_BATCH, device=dev)
                packed = pmetas[pids.index((tid, node, commit))]
                require(store_digests(d)
                        == store_digests(os.path.join(base, sub, tid))
                        and (meta.vrf_nonce, meta.vrf_nonce_value)
                        == (packed.vrf_nonce, packed.vrf_nonce_value),
                        f"{tid}: packed store ({labels} labels) sha256 == "
                        "solo initialize()")
        settle()
        solo_proofs = []
        t0 = time.perf_counter()
        for tid, _, _ in ids:
            solo_proofs.append(prover.Prover(
                os.path.join(base, tid), params, device=dev).prove(challenge))
        solo_prove_s = time.perf_counter() - t0
        require(proofs == solo_proofs, "submit_prove == solo Prover, idle")
        require(again == solo_proofs,
                "submit_prove == solo Prover, under a packed init")
        require(verdicts == [True] * TENANTS + [False],
                f"submit_verify verdicts {verdicts} == 16 True + 1 False")
        t0 = time.perf_counter()
        want = [k2pow.search(challenge, node, params.pow_difficulty,
                             device=dev) for _, node, _ in ids]
        solo_pow_s = time.perf_counter() - t0
        require(pows == want, "submit_pow == ops.pow.search")
        require(all(k2pow.verify(challenge, node, params.pow_difficulty, n)
                    for n, (_, node, _) in zip(pows, ids)),
                "every submit_pow nonce passes hashlib")
    solo_rate = [total / s for s in solo_s]
    packed_rate = [total / s for s in packed_s]
    ratio = statistics.mean(packed_rate) / statistics.mean(solo_rate)
    packs = max(ps.packs, 1)
    tenants_per_pack = ((tenants_after[1] - tenants_sample[1])
                        / max(tenants_after[2] - tenants_sample[2], 1))
    log(f"[tenants] in turns solo, packed, packed, solo: solo "
        f"initialize() of {total} labels {solo_s[0]:.3f} and "
        f"{solo_s[1]:.3f} s ({solo_rate[0]:.0f}, {solo_rate[1]:.0f} "
        f"labels/s); packed init of {TENANTS} identities x {TENANT_LABELS} "
        f"labels (pack width {sched.pack_lanes}) {packed_s[0]:.3f} and "
        f"{packed_s[1]:.3f} s ({packed_rate[0]:.0f}, {packed_rate[1]:.0f} "
        f"labels/s); packed/solo {ratio:.3f}x; at the JAX package's pack "
        f"width of {scheduler.DEFAULT_PACK_LANES} lanes {narrow_s:.3f} s, "
        f"{total / narrow_s:.0f} labels/s")
    log(f"[tenants] packs: {ps.packs}, {ps.lanes / packs:.0f} lanes and "
        f"{tenants_per_pack:.2f} tenants per pack; host per pack: VRF fold "
        f"{ps.fold_s / packs * 1e3:.3f} ms, store writes "
        f"{ps.write_s / packs * 1e3:.3f} ms, waiting on the copy "
        f"{ps.fetch_s / packs * 1e3:.3f} ms; a numpy first-min over one "
        f"identity's {TENANT_LABELS} stored labels "
        f"{statistics.median(fold) * 1e3:.3f} ms; peak device memory "
        f"allocated over the packed inits and proves {peak / 2**30:.2f} GiB")
    if intervals:
        busy = busy_us(intervals) / 1e6
        span = (max(e for _, e in intervals)
                - min(s for s, _ in intervals)) / 1e6
        idle = (f"device busy {busy:.3f} s; idle share {1 - busy / mix_s:.1%} "
                f"of the init's {mix_s:.3f} s wall (submit to the last "
                f"store and a synchronize), {1 - busy / span:.1%} of the "
                f"{span:.3f} s from the first device activity to the last")
    else:
        idle = "idle share not measured (the profiler recorded no device " \
               "activity)"
    log(f"[tenants] profiled packed init of {TENANTS} x {MIX_LABELS} "
        f"labels ({mix_tenants:.2f} tenants per pack), "
        f"{TENANTS * MIX_LABELS / mix_s:.0f} labels/s: {idle}")
    log(f"[tenants] {TENANTS} submit_prove == solo Prover proofs; latency "
        f"card idle: {quantiles(idle_lat)}; beside a packed init of "
        f"{TENANTS} x {LOAD_LABELS} labels submitted with them (done after "
        f"{load_s:.3f} s): {quantiles(load_lat)}; {TENANTS} solo proves in "
        f"series {solo_prove_s:.3f} s")
    log(f"[tenants] submit_verify of {TENANTS} proofs + 1 tampered -> "
        f"{sum(verdicts)} True, {len(verdicts) - sum(verdicts)} False in "
        f"{verify_s:.3f} s; {TENANTS} submit_pow == ops.pow.search: "
        f"{pow_s:.3f} s scheduled, {solo_pow_s:.3f} s in series")
    log(f"[tenants] launches: {json.dumps(launches)}; k2pow windows "
        f"{launches['k2pow_search']} for {3 * TENANTS} searches")
    log(f"[tenants] {ctx['smi']}")
    ctx["tenants"] = dict(
        launches=launches, solo_rate=solo_rate, packed_rate=packed_rate,
        ratio=ratio, narrow_rate=total / narrow_s, peak_bytes=peak,
        pack_stats=ps.as_dict(), tenants_per_pack=tenants_per_pack,
        idle_lat=idle_lat, load_lat=load_lat,
        # the identities and their proofs, which [verifyd] verifies
        ids=ids, proofs=proofs, challenge=challenge)


def pow_witnesses(challenge: bytes, node: bytes, difficulty: bytes,
                  count: int) -> list:
    """The ``count`` smallest valid k2pow nonces of (challenge, node): one
    search kernel launch over the first 2^18 nonces, each hit checked with
    hashlib. A proof with another valid witness is another honest,
    distinct request with the same device work."""
    import numpy as np
    from spacemesh_tpu_torch.ops import pow as k2pow
    from spacemesh_tpu_torch.ops import pow_cuda

    hits = np.nonzero(pow_cuda.search_batch(
        k2pow.prefix_state(challenge, node),
        np.frombuffer(difficulty, dtype=">u4").astype(np.uint32), 0, 1 << 18,
        "cuda").cpu().numpy())[0]
    found = [int(n) for n in hits[:count]]
    require(len(found) == count, f"{count} k2pow witnesses in 2^18 nonces")
    for n in found:
        require(k2pow.verify(challenge, node, difficulty, n),
                f"witness {n} passes hashlib")
    return found


def verifyd_load(ctx: dict) -> tuple:
    """The phase's requests: ``VERIFYD_POSTS`` POST requests over the
    ``[tenants]`` identities (each honest proof with another valid k2pow
    witness per request; one in ``VERIFYD_TAMPERED`` with an index swapped
    for a non-qualifying one), shuffled; and a mixed workload of the other
    kinds. Returns (posts, tampered flags, mixed workload)."""
    import random

    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import prover, verifier
    from spacemesh_tpu_torch.verify import workload
    from spacemesh_tpu_torch.verify.farm import PostRequest

    t = ctx["tenants"]
    params = prover.ProofParams()
    per_id = VERIFYD_POSTS // len(t["ids"])
    honest_per_id = per_id - per_id // VERIFYD_TAMPERED
    thr = proving.threshold_u32(params.k1, TENANT_LABELS)
    posts, flags = [], []
    for (_, node, commit), proof in zip(t["ids"], t["proofs"]):
        witnesses = pow_witnesses(t["challenge"], node, params.pow_difficulty,
                                  honest_per_id)
        require(proof.pow_nonce in witnesses, "the proof's own witness is "
                "among the smallest valid ones")
        bad = dataclasses.replace(proof, indices=list(proof.indices))
        bad.indices[0] = replacement_index(proof, commit, t["challenge"], thr,
                                           TENANT_LABELS)
        for j in range(per_id):
            tampered = j >= honest_per_id
            pr = dataclasses.replace(bad if tampered else proof,
                                     pow_nonce=witnesses[j % honest_per_id])
            posts.append(PostRequest(verifier.VerifyItem(
                proof=pr, challenge=t["challenge"], node_id=node,
                commitment=commit, scrypt_n=N_MAIN,
                total_labels=TENANT_LABELS)))
            flags.append(tampered)
    order = list(range(len(posts)))
    random.Random(11).shuffle(order)
    posts = [posts[i] for i in order]
    flags = [flags[i] for i in order]
    require(len({r.key() for r in posts}) == len(posts),
            "every POST request is distinct (no dedup)")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mix-") as d:
        mix = workload.build(d, sigs=64, vrfs=8, posts=0, memberships=16,
                             pows=64)
    return posts, flags, mix


async def drive_verifyd(svc, posts: list, mix) -> tuple:
    """Every request through ``VerifydService.verify`` from
    ``VERIFYD_CLIENTS`` clients at once: the POST load in requests of
    ``VERIFYD_REQUEST`` items round-robin over the clients, and one
    request per other kind. Returns (POST verdicts, mixed verdicts, each
    request's latency in seconds, wall seconds)."""
    import asyncio

    from spacemesh_tpu_torch.verify.farm import Lane

    clients = [f"node{c}" for c in range(VERIFYD_CLIENTS)]
    chunks = [posts[i:i + VERIFYD_REQUEST]
              for i in range(0, len(posts), VERIFYD_REQUEST)]
    by_kind: dict = {}
    for i, r in enumerate(mix.requests):
        by_kind.setdefault(r.kind, []).append(i)
    lat = []

    async def one(cid, reqs):
        t0 = time.perf_counter()
        got = await svc.verify(cid, reqs, lane=Lane.GOSSIP)
        lat.append(time.perf_counter() - t0)
        return got

    t0 = time.perf_counter()
    post_out = asyncio.gather(*(one(clients[k % len(clients)], c)
                                for k, c in enumerate(chunks)))
    mix_out = asyncio.gather(*(one(clients[k % len(clients)],
                                   [mix.requests[i] for i in idx])
                               for k, idx in enumerate(by_kind.values())))
    post_v, mix_v = await asyncio.gather(post_out, mix_out)
    wall = time.perf_counter() - t0
    verdicts = [v for part in post_v for v in part]
    mixed = [None] * len(mix.requests)
    for idx, part in zip(by_kind.values(), mix_v):
        for i, v in zip(idx, part):
            mixed[i] = v
    return verdicts, mixed, lat, wall


def run_verifyd(posts: list, mix, profile: bool) -> dict:
    """One fresh ``VerifydService`` on the card with its defaults (the
    farm's batches of 256, 4 in flight, 4 scheduler workers) serving the
    load; each client registered with a rate above the load. With
    ``profile``, under ``torch.profiler`` (the device split and idle
    share); else timed bare. Returns the verdicts and measurements."""
    import asyncio

    import torch
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.utils import metrics
    from spacemesh_tpu_torch.verifyd import VerifydService

    async def go():
        svc = VerifydService(post_params=prover.ProofParams(),
                             post_seed=VERIFYD_SEED)
        try:
            await svc.start()
            for c in range(VERIFYD_CLIENTS):
                svc.register_client(f"node{c}", rate=1e9, burst=1e9)
            out = await drive_verifyd(svc, posts, mix)
            return out, svc.farm
        finally:
            await svc.aclose()

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else None
    d0 = metrics.verify_farm_dispatch_seconds.sample()
    with prof or contextlib.nullcontext():
        (verdicts, mixed, lat, wall), farm = asyncio.run(go())
        torch.cuda.synchronize()
    # the closed farm's streams leave a batch's ROMix scratch each in the
    # allocator's cache: hand it back before the next service is made
    torch.cuda.empty_cache()
    per_kind = {}
    for key, (_, total_s, n) in metrics.verify_farm_dispatch_seconds \
            .sample().items():
        _, s0, n0 = d0.get(key, (None, 0.0, 0))
        if n - n0:
            per_kind[dict(key)["kind"]] = dict(batches=n - n0,
                                               dispatch_s=total_s - s0)
    return dict(verdicts=verdicts, mixed=mixed, lat=lat, wall=wall,
                post_timing=dict(farm.post_timing), per_kind=per_kind,
                farm=dict(farm.stats), prof=prof)


def serial_verdicts(posts: list) -> tuple:
    """``post.verifier.verify`` one item per call on the card with the
    service's K3 seed, in one thread: the reference the service's verdicts
    are held to. Returns (verdicts, seconds of the first
    ``SERIAL_SAMPLE``)."""
    import torch
    from spacemesh_tpu_torch.post import prover, verifier

    params = prover.ProofParams()
    out = []
    t0 = time.perf_counter()
    for i, r in enumerate(posts):
        if i == SERIAL_SAMPLE:
            torch.cuda.synchronize()
            sample_s = time.perf_counter() - t0
        out.append(verifier.verify(r.item, params, seed=VERIFYD_SEED))
    return out, sample_s


def phase_verifyd(ctx: dict) -> None:
    import importlib.util

    import torch
    from spacemesh_tpu_torch.core import signing
    from spacemesh_tpu_torch.ops import scrypt as tscrypt
    from spacemesh_tpu_torch.tools.measure import busy_us, device_intervals
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_setup = time.perf_counter()
    posts, flags, mix = verifyd_load(ctx)
    setup_s = time.perf_counter() - t_setup
    # taps on the verifier's recompute in the cold run: the label words
    # (asked of finish_hash there alone) of the first and last lane of each
    # batch, sampled against hashlib, and the inputs of the widest batch
    # (for path_twins), all kept on the card until after the run; the warm
    # run is timed untapped
    real_hash = tscrypt.scrypt_labels_hash
    taps = []
    widest: dict = {"b": 0}

    def tap_hash(cw, idx_lo, idx_hi, ch, nonce, *, n, words_out=False):
        values, words = real_hash(cw, idx_lo, idx_hi, ch, nonce, n=n,
                                  words_out=True)
        b = idx_lo.shape[0]
        ends = [torch.stack([t[..., 0], t[..., b - 1]], -1)
                for t in (cw, idx_lo, idx_hi, words)]
        with GUARD.lock:
            taps.append((n, *ends))
            if b > widest["b"]:
                widest.update(b=b, n=n, **{k: t.clone() for k, t in (
                    ("cw", cw), ("lo", idx_lo), ("hi", idx_hi), ("ch", ch),
                    ("nonce", nonce))})
        return values, (words if words_out else None)

    tscrypt.scrypt_labels_hash = tap_hash
    try:
        # a fresh service each time: the first pays each stream's first
        # scratch allocations, the second runs warm and is the one read
        cold = run_verifyd(posts, mix, profile=False)
    finally:
        tscrypt.scrypt_labels_hash = real_hash
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    GUARD.start()
    bare = run_verifyd(posts, mix, profile=False)
    launches = launch_counts()
    guard = GUARD.stop()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    GUARD.start()
    profiled = run_verifyd(posts, mix, profile=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serial, sample_s = serial_verdicts(posts)
    serial_s = time.perf_counter() - t0
    guard_rest = GUARD.stop()
    t0 = time.perf_counter()
    twins = path_twins(widest)
    twins_s = time.perf_counter() - t0
    picks = tap_labels(taps)
    mix_inline = mix.inline_all()

    for name, run in (("cold", cold), ("warm", bare),
                      ("profiled", profiled)):
        require(run["verdicts"] == serial, f"{name} run: every POST verdict "
                "== the serial inline verdict on the card")
        require(run["mixed"] == mix_inline, f"{name} run: sig/vrf/membership"
                "/pow verdicts == inline")
    require(serial == [not f for f in flags],
            "honest requests True, tampered ones False")
    require(0 < sum(mix_inline) < len(mix_inline), "the mix is mixed")
    require_no_twins(guard, "verifyd warm run")
    require_no_twins(guard_rest, "verifyd profiled run and serial verifies")
    post_b = bare["per_kind"]["post"]["batches"]
    for key in ("romix", "pbkdf2_expand", "pbkdf2_finish_hash"):
        require(launches[key] == post_b, f"the warm run launched {key} once "
                f"per POST batch ({launches[key]} launches, {post_b} "
                "batches)")
    for key in ("pbkdf2_finish", *OFF_PATH):
        require(launches[key] == 0, f"the warm run launched no {key}")
    require(guard["pow_batches"] > 0
            and launches["k2pow_verify"] == guard["pow_batches"],
            f"the warm run launched k2pow verify once per device pow batch "
            f"({launches['k2pow_verify']} launches, {guard['pow_batches']} "
            "batches)")
    require(launches["scan"] == launches["k2pow_search"] == 0,
            "verification launches no scan and no k2pow search")
    for shape, errs in twins.items():
        for key, err in errs.items():
            require(err == 0, f"{key} kernel == plain at the verifyd path's "
                              f"{shape}")
    check_taps(picks)

    branch = ("OpenSSL" if signing._HAVE_CRYPTOGRAPHY else "the "
              "pure-Python path (no cryptography here): the sig kind runs "
              "the Pippenger batch check")
    wire = ", ".join(
        f"{m} {'imports' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("aiohttp", "grpc"))
    n_posts = len(posts)
    lat = sorted(bare["lat"])
    rate = n_posts / bare["wall"]
    serial_rate = SERIAL_SAMPLE / sample_s
    pk = bare["per_kind"]
    n_ids = len(ctx["tenants"]["ids"])
    log(f"[verifyd] load: {n_posts} POST requests over {n_ids}"
        f" identities ({sum(flags)} tampered), N={N_MAIN}, k1/k2/k3 "
        f"mainnet, from {VERIFYD_CLIENTS} clients in requests of "
        f"{VERIFYD_REQUEST}, plus {len(mix.requests)} sig/vrf/membership/"
        f"pow items; made in {setup_s:.2f} s; ed25519 through {branch}; "
        f"for the server: {wire}")
    log(f"[verifyd] {rate:.0f} proofs verified/s through VerifydService "
        f"({n_posts} in {bare['wall']:.3f} s, warm run; the cold run before "
        f"it {n_posts / cold['wall']:.0f}/s, the profiled run after it "
        f"{n_posts / profiled['wall']:.0f}/s); serial inline "
        f"post.verifier.verify of a {SERIAL_SAMPLE}-proof sample "
        f"{serial_rate:.1f} proofs/s ({rate / serial_rate:.1f}x); all "
        f"{n_posts} serial verdicts in {serial_s:.1f} s")
    log(f"[verifyd] request latency (admission to verdicts, "
        f"{len(lat)} requests): p50 {statistics.median(lat):.3f} s, p99 "
        f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.3f} s, max "
        f"{lat[-1]:.3f} s")
    log(f"[verifyd] batches per kind: " + ", ".join(
        f"{k} {v['batches']}" for k, v in sorted(pk.items()))
        + f"; POST mean occupancy {n_posts / post_b:.1f} of 256; all kinds "
        f"{bare['farm']['items']} items in {bare['farm']['batches']} batches,"
        f" max occupancy {bare['farm']['max_occupancy']}")
    whole = pk["post"]["dispatch_s"] / post_b * 1e3
    log(f"[verifyd] POST dispatch split, host ms per batch (warm run; "
        f"batches overlap, up to 4 at once): " + ", ".join(
            f"{k} {v / post_b * 1e3:.2f} ({v / post_b * 1e3 / whole:.0%})"
            for k, v in bare["post_timing"].items())
        + f"; whole dispatch {whole:.2f} ms. prep: structure, k2pow, K3 and "
        f"the per-lane arrays; labels: the inputs' copies and the three "
        f"kernels' launches (finish hashes); hash: the wait for the three "
        f"kernels and the values' copy to the host")
    n_pow = sum(r.kind == "pow" for r in mix.requests)
    log("[verifyd] pow kind: " + ", ".join(
        f"{name} run {r['per_kind']['pow']['dispatch_s'] * 1e3:.1f} ms in "
        f"{r['per_kind']['pow']['batches']} batch(es)" for name, r in (
            ("cold", cold), ("warm", bare), ("profiled", profiled))
        if "pow" in r["per_kind"]) + f" for {n_pow} witnesses (the k2pow "
        f"verify kernel beside the POST batches)")
    prof = profiled["prof"]
    intervals = device_intervals(prof)
    kern = {"romix": 0.0, "expand_kernel": 0.0, "finish_kernel": 0.0,
            "verify_kernel": 0.0}
    total_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        total_us += e.time_range.elapsed_us()
        for k in kern:
            if k in e.name:
                kern[k] += e.time_range.elapsed_us()
    pb = profiled["per_kind"]["post"]["batches"]
    log(f"[verifyd] device time per POST batch (profiled run, {pb} "
        f"batches): ROMix {kern['romix'] / pb / 1e3:.2f} ms, PBKDF2 expand "
        f"{kern['expand_kernel'] / pb / 1e3:.4f} ms, finish with the "
        f"proving hash {kern['finish_kernel'] / pb / 1e3:.4f} ms; k2pow "
        f"verify "
        f"{kern['verify_kernel'] / 1e3:.4f} ms in all; every other device "
        f"activity (copies, fills) {(total_us - sum(kern.values())) / 1e3:.1f}"
        f" ms in all")
    if intervals:
        busy = busy_us(intervals) / 1e6
        idle = (f"device busy {busy:.3f} s, idle share "
                f"{1 - busy / profiled['wall']:.1%} of the profiled run's "
                f"{profiled['wall']:.3f} s wall")
    else:
        idle = "idle share not measured (no device activity recorded)"
    log(f"[verifyd] {idle}; peak device memory over the warm run: "
        f"allocated {peak / 2**30:.2f} GiB, reserved by the caching "
        f"allocator {peak_reserved / 2**30:.2f} GiB")
    log(f"[verifyd] {len(picks)} sampled labels of the farm's recomputes "
        f"(big-endian words read back from the card) == hashlib.scrypt; "
        f"every verdict == serial inline; launches in the warm run "
        f"{json.dumps(launches)}: ROMix, expand and finish_hash one each per "
        f"POST batch, k2pow verify one per device pow batch "
        f"({guard['pow_batches']})")
    log(f"[verifyd] kernels == plain on the widest recompute's inputs "
        f"({widest['b']} lanes, per-lane commitments, challenges and "
        f"nonces) and on its first proof's lanes (a serial verify's shape), "
        f"max_abs_err {json.dumps(twins)}, in {twins_s:.1f} s")
    log(f"[verifyd] {ctx['smi']}")
    # the load and its serial inline verdicts, reused by [fleet]
    ctx["verifyd"] = dict(launches=launches, twins=twins, posts=posts,
                          mix=mix, serial=serial, mix_inline=mix_inline,
                          rate=rate)


def fleet_requests(posts: list, mix, clients: list) -> list:
    """The ``[verifyd]`` load as the fleet's requests: the POST list in
    requests of ``VERIFYD_REQUEST`` and one request per other kind spread
    among them, each under one of ``clients`` in turn. Each entry is
    (client id, items, index of its first POST or None, mixed indices)."""
    out = []
    for k, i in enumerate(range(0, len(posts), VERIFYD_REQUEST)):
        out.append((clients[k % len(clients)], posts[i:i + VERIFYD_REQUEST],
                    i, None))
    by_kind: dict = {}
    for i, r in enumerate(mix.requests):
        by_kind.setdefault(r.kind, []).append(i)
    step = max(len(out) // max(len(by_kind), 1), 1)
    for j, idx in enumerate(by_kind.values()):
        out.insert(j * (step + 1) + step // 2,
                   (clients[j % len(clients)],
                    [mix.requests[i] for i in idx], None, idx))
    return out


class WatchedEndpoint:
    """A replica endpoint that counts the attempts made on it while its
    listener is down (each attempt registers or verifies, and fails
    there)."""

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.down = False
        self.calls_down = 0

    def __getattr__(self, name):
        return getattr(self.endpoint, name)

    async def register(self, client, **kwargs):
        self.calls_down += self.down
        return await self.endpoint.register(client, **kwargs)

    async def verify(self, reqs, **kwargs):
        self.calls_down += self.down
        return await self.endpoint.verify(reqs, **kwargs)


async def drive_fleet(requests: list, n_posts: int, n_mix: int, *,
                      params, seed: bytes, drill: bool,
                      device="cuda") -> dict:
    """``FLEET_REPLICAS`` in-process ``VerifydService`` replicas (shards
    r0.., each over an injected farm of ``FLEET_INFLIGHT`` POST batches in
    flight) served by the port's HTTP server on their own 127.0.0.1
    ports, behind one ``FleetVerifier`` from ``fleet_from_urls`` over the
    sockets with a local farm of ``FLEET_LOCAL_INFLIGHT``; ``requests``
    sent by ``FLEET_CALLERS`` concurrent callers. With ``drill``: r1's
    listener stops at a quarter of the requests and comes back on its
    port at half; all three stop from 5/8 to 3/4 (the blackout), and the
    next request waits until every replica's breaker lets its half-open
    probe out. Returns the verdicts, a record per request and the
    fleet's counters."""
    import asyncio
    import contextvars

    from spacemesh_tpu_torch.obs import sli
    from spacemesh_tpu_torch.utils import metrics
    from spacemesh_tpu_torch.verify.farm import Lane, VerificationFarm
    from spacemesh_tpu_torch.verifyd import (VerifydServer, VerifydService,
                                             fleet_from_urls)

    def farm(inflight):
        return VerificationFarm(post_params=params, post_seed=seed,
                                max_inflight=inflight, device=device)

    names = [f"r{i}" for i in range(FLEET_REPLICAS)]
    farms = [farm(FLEET_INFLIGHT) for _ in names]
    local = farm(FLEET_LOCAL_INFLIGHT)
    servers = [VerifydServer(service=VerifydService(
        farm=f, shard=name, device=device))
        for f, name in zip(farms, names)]
    served = contextvars.ContextVar("served")
    fv = None
    try:
        ports = [await s.start() for s in servers]
        fv = fleet_from_urls([f"http://127.0.0.1:{p}" for p in ports],
                             farm=local)
        fv.observer = lambda kind, **kw: (served.get().update(kw)
                                          if kind == "served" else None)
        fv.start()
        router = fv.router
        r1 = router.replicas["r1"]
        watched = r1.endpoint = WatchedEndpoint(r1.endpoint)
        sampler = sli.SliSampler(metrics.REGISTRY, window_s=3600.0)
        sampler.sample()
        n = len(requests)
        state = {"phase": "clean", "next": 0}
        marks: dict = {}
        lock = asyncio.Lock()

        async def fault(i: int) -> None:
            if i == n // 4:
                await servers[1].stop_listening()
                watched.down = True
                marks["r1_down"] = (r1.breaker.probes, i)
                state["phase"] = "r1_down"
            elif i == n // 2:
                await servers[1].resume_listening()
                watched.down = False
                marks["r1_up"] = (r1.breaker.probes, i)
                state["phase"] = "r1_back"
            elif i == 5 * n // 8:
                for srv in servers:
                    await srv.stop_listening()
                state["phase"] = "blackout"
            elif i == 3 * n // 4:
                for srv in servers:
                    await srv.resume_listening()
                wait = max(rep.breaker.retry_in() or 0.0
                           for rep in router.replicas.values())
                marks["probe_wait_s"] = wait
                await asyncio.sleep(wait + 0.01)
                state["phase"] = "restored"

        records = [None] * n

        async def caller() -> None:
            while True:
                async with lock:
                    i = state["next"]
                    if i >= n:
                        return
                    state["next"] += 1
                    if drill:
                        await fault(i)
                    phase = state["phase"]
                cid, reqs, _, _ = requests[i]
                holder: dict = {}
                served.set(holder)
                t0 = time.perf_counter()
                got = await fv.verify_batch(reqs, Lane.GOSSIP, client_id=cid)
                records[i] = dict(verdicts=got, phase=phase,
                                  lat=time.perf_counter() - t0,
                                  path=holder.get("path"),
                                  served_by=holder.get("served_by"))

        t0 = time.perf_counter()
        await asyncio.gather(*(caller() for _ in range(FLEET_CALLERS)))
        wall = time.perf_counter() - t0
        sampler.sample()
        signals = router.update_signals(sampler.values(sli.fleet_slis(names)))
        post_v, mix_v = [None] * n_posts, [None] * n_mix
        for (_, reqs, at, idx), rec in zip(requests, records):
            if at is not None:
                post_v[at:at + len(reqs)] = rec["verdicts"]
            else:
                for i, v in zip(idx, rec["verdicts"]):
                    mix_v[i] = v
        return dict(post=post_v, mixed=mix_v, records=records, wall=wall,
                    signals=signals, marks=marks, calls_down=watched.calls_down,
                    failure_budget=r1.breaker.failure_budget,
                    transitions=breaker_transitions(),
                    stats=dict(fv.stats),
                    batches={name: f.stats["batches"]
                             for name, f in zip(names + ["local"],
                                                farms + [local])})
    finally:
        if fv is not None:
            await fv.aclose()
        for srv in servers:
            await srv.close()
        for f in farms + [local]:
            await f.aclose()


def post_batches() -> int:
    """POST batches dispatched so far by every farm in the process."""
    from spacemesh_tpu_torch.utils import metrics

    return sum(n for key, (_, _, n) in
               metrics.verify_farm_dispatch_seconds.sample().items()
               if dict(key).get("kind") == "post")


def breaker_transitions() -> dict:
    """{replica: {state: transitions}} from the breakers' counter (its
    series go when the fleet closes: read it before)."""
    from spacemesh_tpu_torch.utils import metrics

    out: dict = {}
    for key, v in metrics.remediation_breaker_transitions.sample().items():
        lb = dict(key)
        comp = lb.get("component", "")
        if comp.startswith("verifyd.replica."):
            out.setdefault(comp.rsplit(".", 1)[1], {})[lb["to"]] = int(v)
    return out


def run_drills(device) -> dict:
    """The port's fleet drills on ``device``: {name: (ok, digest, s)}."""
    from spacemesh_tpu_torch.sim import scenarios

    out = {}
    for name in FLEET_DRILLS:
        t0 = time.perf_counter()
        r = scenarios.run(scenarios.builtin(name), device=device)
        out[name] = (r.ok, r.digest, time.perf_counter() - t0,
                     [a for a in r.asserts if not a["ok"]])
    return out


def phase_fleet(ctx: dict) -> None:
    import asyncio

    import torch
    from spacemesh_tpu_torch.post import prover

    v = ctx["verifyd"]
    posts, mix, serial, mix_inline = (v["posts"], v["mix"], v["serial"],
                                      v["mix_inline"])
    clients = [tid for tid, _, _ in ctx["tenants"]["ids"]]
    requests = fleet_requests(posts, mix, clients)
    params = prover.ProofParams()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    zero_launches()
    GUARD.start()
    b0 = post_batches()
    clean = asyncio.run(drive_fleet(requests, len(posts), len(mix.requests),
                                    params=params, seed=VERIFYD_SEED,
                                    drill=False))
    launches = launch_counts()
    guard = GUARD.stop()
    batches = post_batches() - b0
    GUARD.start()
    # the closed farms' streams leave their V scratch in the allocator's
    # cache: hand it back before the drill's farms are made
    torch.cuda.empty_cache()
    drill = asyncio.run(drive_fleet(requests, len(posts), len(mix.requests),
                                    params=params, seed=VERIFYD_SEED,
                                    drill=True))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    mem = torch.cuda.memory_stats()
    torch.cuda.empty_cache()
    fleet_s = time.perf_counter() - t_phase
    transitions = drill["transitions"]

    for name, run in (("clean", clean), ("drill", drill)):
        require(run["post"] == serial, f"{name} run: every POST verdict "
                "through the fleet == the serial inline verdict on the card")
        require(run["mixed"] == mix_inline, f"{name} run: sig/vrf/membership"
                "/pow verdicts through the fleet == inline")
    for key in ("romix", "pbkdf2_expand", "pbkdf2_finish_hash"):
        require(launches[key] == batches, f"the clean run launched {key} "
                f"once per POST batch of all farms ({launches[key]} "
                f"launches, {batches} batches): no ROMix launch was split")
    for key in ("pbkdf2_finish", *OFF_PATH):
        require(launches[key] == 0, f"the clean run launched no {key}")
    require(guard["pow_batches"] > 0
            and launches["k2pow_verify"] == guard["pow_batches"],
            f"the clean run launched k2pow verify once per device pow batch "
            f"({launches['k2pow_verify']} launches, {guard['pow_batches']} "
            "batches)")
    require(launches["scan"] == launches["k2pow_search"] == 0,
            "verification launches no scan and no k2pow search")
    recs = drill["records"]
    down = drill["marks"]
    probes = down["r1_up"][0] - down["r1_down"][0]
    require(drill["calls_down"] <= drill["failure_budget"] + probes,
            f"attempts on r1 while it was down ({drill['calls_down']}) <= "
            f"its failure budget ({drill['failure_budget']}) + the half-open "
            f"probes ({probes})")
    black = [r for r in recs if r["phase"] == "blackout"]
    require(black and all(r["path"] in ("local", "local_fastfail")
                          for r in black),
            f"the local farm served every request of the blackout "
            f"({[r['path'] for r in black]})")
    after = [r for r in recs if r["phase"] == "restored"]
    require(any(r["path"] == "remote" for r in after),
            f"remote serving came back after the restore "
            f"({[r['path'] for r in after]})")
    require(clean["stats"]["local"] + clean["stats"]["local_fastfail"] == 0,
            "the clean run was served by the replicas alone")

    t0 = time.perf_counter()
    card = [run_drills("cuda"), run_drills("cuda")]
    guard_rest = GUARD.stop()  # the host CPU's drills run the plain twins
    cpu = run_drills("cpu")
    drills_s = time.perf_counter() - t0
    require_no_twins(guard, "fleet clean run")
    require_no_twins(guard_rest, "fleet drill and the card's fleet drills")
    for name in FLEET_DRILLS:
        for run in card:
            require(run[name][0], f"drill {name} ok on the card "
                                  f"({run[name][3]})")
        require(card[0][name][1] == card[1][name][1],
                f"drill {name}: the same digest twice on the card")
        require(cpu[name][0], f"drill {name} ok on the host CPU")

    n_posts = len(posts)
    lat = sorted(r["lat"] for r in clean["records"])
    rate = n_posts / clean["wall"]
    by_rep: dict = {}
    for r in clean["records"]:
        by_rep[r["served_by"]] = by_rep.get(r["served_by"], 0) + 1
    log(f"[fleet] {FLEET_REPLICAS} VerifydService replicas (shards "
        f"r0..r{FLEET_REPLICAS - 1}, farms of {FLEET_INFLIGHT} POST batches "
        f"in flight) each on its own 127.0.0.1 HTTP port, behind "
        f"fleet_from_urls with a local farm of {FLEET_LOCAL_INFLIGHT}; the "
        f"[verifyd] load ({n_posts} POST requests, {len(mix.requests)} other "
        f"items) as {len(requests)} requests of up to {VERIFYD_REQUEST} from "
        f"{FLEET_CALLERS} callers under the {len(clients)} identities")
    log(f"[fleet] clean: {rate:.0f} proofs verified/s through the fleet "
        f"({n_posts} in {clean['wall']:.3f} s; [verifyd] in-process "
        f"{v['rate']:.0f}/s in this call); request latency p50 "
        f"{statistics.median(lat):.3f} s, p99 "
        f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.3f} s; requests per "
        f"replica {json.dumps(dict(sorted(by_rep.items())))}; farm batches "
        f"{json.dumps(clean['batches'])}; fleet_desired_replicas "
        f"{clean['signals']['desired_replicas']} (load scores "
        f"{json.dumps({k: round(x, 4) for k, x in clean['signals']['scores'].items()})})")
    paths: dict = {}
    for r in recs:
        key = f"{r['phase']}:{r['path']}"
        paths[key] = paths.get(key, 0) + 1
    log(f"[fleet] drill: served by phase and path {json.dumps(paths)}; "
        f"attempts on r1 while down {drill['calls_down']} (budget "
        f"{drill['failure_budget']} + {probes} probes); breaker transitions "
        f"{json.dumps(transitions, sort_keys=True)}; blackout "
        f"{len(black)} requests, all on the local farm; after the restore "
        f"(next request held {down['probe_wait_s']:.2f} s for the probes) "
        f"{sum(r['path'] == 'remote' for r in after)} of {len(after)} remote; "
        f"fleet stats {json.dumps(drill['stats'])}; proofs/s "
        f"{n_posts / drill['wall']:.0f}")
    log(f"[fleet] launches in the clean run {json.dumps(launches)}: "
        f"{batches} POST batches over the {FLEET_REPLICAS + 1} farms, "
        f"{guard['pow_batches']} device pow batches; peak "
        f"device memory over both runs: allocated {peak / 2**30:.2f} GiB, "
        f"reserved {peak_reserved / 2**30:.2f} GiB (V cap "
        f"{FLEET_REPLICAS * FLEET_INFLIGHT + FLEET_LOCAL_INFLIGHT} x 9.25 "
        f"GiB); allocator retries {mem.get('num_alloc_retries', 0)}, OOMs "
        f"{mem.get('num_ooms', 0)}")
    log("[fleet] drills on the card, twice: " + ", ".join(
        f"{n} ok {card[0][n][1]} == {card[1][n][1]} "
        f"({card[0][n][2]:.1f} s, {card[1][n][2]:.1f} s); host CPU digest "
        f"{cpu[n][1]} ({'equal' if cpu[n][1] == card[0][n][1] else 'DIFFERS'})"
        for n in FLEET_DRILLS) + f"; {drills_s:.1f} s")
    log(f"[fleet] phase {time.perf_counter() - t_phase:.1f} s (both fleet "
        f"runs {fleet_s:.1f} s, drills {drills_s:.1f} s)")
    log(f"[fleet] {ctx['smi']}")
    ctx["fleet"] = dict(launches=launches)


# --- [atx]: ATX validation over the card's verify farm ---------------------

ATX_GEN = b"atxv2-test-genesis!!"  # genesis as tests/test_atx_v2.py:32-35
ATX_IDS = 64              # identities, one unit each
ATX_LPU = 1 << 14         # labels per unit (mainnet 2^32), cut for time
ATX_EPOCHS = 8            # v1 epochs (64 ATXs each), then one merged epoch
ATX_MARRIED = 4           # identities per merged v2 ATX
ATX_TICKS = 64            # poet ticks per round
ATX_TAMPER = 8            # one envelope in 8 is tampered
ATX_KINDS = ("signature", "vrf_key", "post_index", "membership", "poet_id")
ATX_TIMED_S = 5.0         # the timed passes last at least this long
ATX_READ_POOL = 4         # the state DB's readers (the node's default)


def atx_golden() -> bytes:
    from spacemesh_tpu_torch.core.hashing import sum256

    return sum256(b"golden", ATX_GEN)


def atx_poet_service(poet_id: bytes):
    """A ``PoetService`` that signals when a round holds the members it
    expects (the merged epoch's identities register from their own tasks)."""
    import asyncio

    from spacemesh_tpu_torch.consensus import poet

    class RoundPoet(poet.PoetService):
        def __init__(self):
            super().__init__(poet_id=poet_id, ticks=ATX_TICKS)
            self.counts: dict = {}
            self.full: dict = {}

        def expect(self, round_id: str, n: int) -> asyncio.Event:
            self.full[round_id] = (n, asyncio.Event())
            return self.full[round_id][1]

        async def register(self, round_id, challenge, **kw):
            await super().register(round_id, challenge, **kw)
            self.counts[round_id] = self.counts.get(round_id, 0) + 1
            n, ev = self.full.get(round_id, (None, None))
            if ev is not None and self.counts[round_id] >= n:
                ev.set()

    return RoundPoet()


async def atx_build(signers: list, clients: dict, farm) -> dict:
    """The smeshing node: one ``Builder`` per identity over a ``PostClient``
    on the card, one poet round per epoch with every identity registered
    before it runs, ``ATX_EPOCHS`` epochs of v1 ATXs, then merged v2 ATXs
    of the identities married in fours. The node validates its own ATXs
    through ``farm`` (gossip's self-delivery); a recorder on the
    ``LoopbackHub`` keeps what the network carried, per epoch."""
    import asyncio

    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.consensus import activation_v2 as act2
    from spacemesh_tpu_torch.consensus.poet import PoetBlob
    from spacemesh_tpu_torch.core.hashing import sum256
    from spacemesh_tpu_torch.core.signing import EdVerifier
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.storage import atxs as atxstore
    from spacemesh_tpu_torch.storage import cache, db

    golden = atx_golden()
    hub = ps.LoopbackHub()
    node_db = db.open_state()
    node_ps = ps.PubSub(node_name=b"smesher")
    wire = ps.PubSub(node_name=b"recorder")
    hub.join(node_ps)
    hub.join(wire)
    recorded: list = []

    def recorder(topic):
        async def record(peer, data):
            recorded.append((topic, data))
            return True
        return record

    for topic in (ps.TOPIC_POET, ps.TOPIC_ATX, act2.TOPIC_ATX_V2):
        wire.register(topic, recorder(topic))
    common = dict(db=node_db, cache=cache.AtxCache(),
                  verifier=EdVerifier(prefix=ATX_GEN), golden_atx=golden,
                  post_params=prover.ProofParams(), labels_per_unit=ATX_LPU,
                  scrypt_n=N_MAIN, farm=farm)
    handler = act.Handler(pubsub=node_ps, **common)
    act2.HandlerV2(pubsub=node_ps, **common)
    p = atx_poet_service(sum256(b"poet", ATX_GEN))
    smeshers = [act.Builder(
        signer=s, db=node_db, pubsub=node_ps, poet=p,
        post_client=clients[s.node_id], golden_atx=golden,
        coinbase=bytes([i]) * 24, handler=handler, num_units=1)
        for i, s in enumerate(signers)]
    epochs, times = [], []
    for epoch in range(1, ATX_EPOCHS + 1):
        t0 = time.perf_counter()
        for b in smeshers:
            await b.register_challenge(epoch)
        await p.execute_round(str(epoch))
        atxs = await asyncio.gather(*(b.finish(epoch) for b in smeshers))
        await hub.drain()
        epochs.append(recorded[:])
        recorded.clear()
        times.append(time.perf_counter() - t0)
        require(sorted(d for t, d in epochs[-1] if t == ps.TOPIC_ATX)
                == sorted(a.to_bytes() for a in atxs),
                f"epoch {epoch}: the hub carried every ATX")
        require(atxstore.count_in_epoch(node_db, epoch) == ATX_IDS,
                f"epoch {epoch}: the smeshing node validated its own ATXs")
    t0 = time.perf_counter()
    epoch = ATX_EPOCHS + 1
    full = p.expect(str(epoch), ATX_IDS)
    tasks = [asyncio.ensure_future(act2.build_merged_atx(
        primary=signers[g], partners=signers[g + 1:g + ATX_MARRIED],
        db=node_db, poet=p, post_clients=clients, golden_atx=golden,
        coinbase=bytes([g]) * 24, publish_epoch=epoch))
        for g in range(0, ATX_IDS, ATX_MARRIED)]
    await asyncio.wait_for(full.wait(), 600)
    result = await p.execute_round(str(epoch))
    merged = await asyncio.gather(*tasks)
    await node_ps.publish(ps.TOPIC_POET, PoetBlob(
        proof=result.proof, member_count=len(result.members)).to_bytes())
    await asyncio.gather(*(node_ps.publish(act2.TOPIC_ATX_V2, a.to_bytes())
                           for a in merged))
    await hub.drain()
    require(atxstore.count_in_epoch(node_db, epoch) == ATX_IDS,
            "the smeshing node validated its merged ATXs")
    epochs.append(recorded[:])
    times.append(time.perf_counter() - t0)
    return dict(epochs=epochs, times=times, node_db=node_db,
                cache=common["cache"])


def atx_resign(atx, signer):
    from spacemesh_tpu_torch.core.signing import Domain

    atx = dataclasses.replace(atx, signature=bytes(64))
    return dataclasses.replace(
        atx, signature=signer.sign(Domain.ATX, atx.signed_bytes()))


def atx_tamper(kind: str, atx, signer, node_db):
    """``atx`` (v1 ``ActivationTx`` or merged ``ActivationTxV2``) with one
    fault of ``kind``, re-signed by its signer unless the signature is the
    fault: every tampered envelope must be rejected."""
    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.core.hashing import sum256
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.storage import misc

    v2 = hasattr(atx, "subposts")
    if kind == "signature":
        return dataclasses.replace(atx, signature=bytes(
            [atx.signature[0] ^ 1]) + atx.signature[1:])
    if kind == "vrf_key":  # v1 only: the VRF key must be the node id
        return atx_resign(dataclasses.replace(
            atx, vrf_public_key=sum256(b"another vrf key", atx.node_id)),
            signer)
    sp = atx.subposts[0] if v2 else atx
    nipost = sp.nipost
    if kind == "post_index":
        poet = misc.poet_proof(node_db, nipost.post_metadata.challenge)
        challenge = act.post_challenge(poet.root, act.nipost_challenge(
            sp.prev_atx, atx.publish_epoch))
        post = nipost.post
        thr = proving.threshold_u32(prover.ProofParams().k1,
                                    sp.num_units * ATX_LPU)
        bad = replacement_index(post, act.commitment_of(sp.node_id,
                                                        atx_golden()),
                                challenge, thr, sp.num_units * ATX_LPU)
        nipost = dataclasses.replace(nipost, post=dataclasses.replace(
            post, indices=[bad] + list(post.indices[1:])))
    elif kind == "membership":
        # a sibling flipped; a round of one member (every first ATX's
        # challenge is the same) has none, so its leaf index moves
        mp = nipost.membership
        if mp.nodes:
            nodes = list(mp.nodes)
            nodes[0] = bytes([nodes[0][0] ^ 1]) + nodes[0][1:]
            mp = dataclasses.replace(mp, nodes=nodes)
        else:
            mp = dataclasses.replace(mp, leaf_index=mp.leaf_index + 1)
        nipost = dataclasses.replace(nipost, membership=mp)
    else:  # poet_id: a poet proof no node holds
        nipost = dataclasses.replace(
            nipost, post_metadata=dataclasses.replace(
                nipost.post_metadata,
                challenge=sum256(b"unknown poet", atx.node_id)))
    if v2:
        atx = dataclasses.replace(atx, subposts=[dataclasses.replace(
            sp, nipost=nipost)] + list(atx.subposts[1:]))
    else:
        atx = dataclasses.replace(atx, nipost=nipost)
    return atx_resign(atx, signer)


def atx_plan(built: dict, signers: dict) -> dict:
    """The validating node's input: per epoch the poet blobs (each once)
    and the envelopes, one in ``ATX_TAMPER`` tampered with the kinds in
    turn (a merged ATX skips the VRF key, which it does not carry), each
    with its expected verdict."""
    from spacemesh_tpu_torch.core import types
    from spacemesh_tpu_torch.p2p import pubsub as ps

    epochs, k, turn = [], 0, 0
    for carried in built["epochs"]:
        blobs = list(dict.fromkeys(d for t, d in carried
                                   if t == ps.TOPIC_POET))
        items = []
        for topic, data in carried:
            if topic == ps.TOPIC_POET:
                continue
            v2 = topic != ps.TOPIC_ATX
            kind = None
            if k % ATX_TAMPER == ATX_TAMPER - 1:
                kind = ATX_KINDS[turn % len(ATX_KINDS)]
                turn += 1
                if v2 and kind == "vrf_key":
                    kind = ATX_KINDS[turn % len(ATX_KINDS)]
                    turn += 1
                cls = types.ActivationTxV2 if v2 else types.ActivationTx
                atx = cls.from_bytes(data)
                data = atx_tamper(kind, atx, signers[atx.node_id],
                                  built["node_db"]).to_bytes()
            items.append(dict(topic=topic, data=data, kind=kind,
                              want=kind is None))
            k += 1
        epochs.append(dict(blobs=blobs, items=items))
    return dict(epochs=epochs)


def atx_node(path, farm, device="cuda") -> dict:
    """A validating node: a file state DB (WAL, the node's read pool), the
    ATX cache, ``Handler`` and ``HandlerV2`` over ``farm`` (``None``:
    inline on ``device``) on a PubSub, and the node's poet-blob handler
    (JAX ``node/app.py:1039-1047``)."""
    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.consensus import activation_v2 as act2
    from spacemesh_tpu_torch.consensus.poet import PoetBlob
    from spacemesh_tpu_torch.core.signing import EdVerifier
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.storage import cache, db

    state = db.open_state(path, read_pool=ATX_READ_POOL)
    atx_cache = cache.AtxCache()
    node = ps.PubSub(node_name=b"validator")
    common = dict(db=state, cache=atx_cache,
                  verifier=EdVerifier(prefix=ATX_GEN),
                  golden_atx=atx_golden(), post_params=prover.ProofParams(),
                  labels_per_unit=ATX_LPU, scrypt_n=N_MAIN, farm=farm,
                  device=device)
    act.Handler(pubsub=node, **common)
    act2.HandlerV2(pubsub=node, **common)

    async def on_poet(peer: bytes, data: bytes) -> bool:
        try:
            blob = PoetBlob.from_bytes(data)
        except Exception:  # noqa: BLE001
            return False
        act.store_poet_blob(state, blob)
        return True

    node.register(ps.TOPIC_POET, on_poet)
    return dict(db=state, cache=atx_cache, pubsub=node)


def atx_state(node: dict) -> tuple:
    """The node's ``atxs`` rows (id, node, epoch, tick height) and its
    cache's (id, weight, base height, height) per target epoch."""
    rows = [tuple(r) for r in node["db"].all(
        "SELECT id, node_id, publish_epoch, tick_height FROM atxs"
        " ORDER BY id")]
    cached = {e: sorted((a, i.weight, i.base_height, i.height)
                        for a, i in node["cache"].iter_epoch(e))
              for e in range(2, ATX_EPOCHS + 3)}
    return rows, cached


async def atx_pass(plan: dict, path, farm, sequential: bool = False,
                   device="cuda") -> dict:
    """One validating node on a fresh state DB at ``path``: each epoch's
    poet blobs, then its envelopes through ``PubSub.deliver`` (the gossip
    entry point), all at once (as a gossip validator pool delivers them;
    the hub's inbox delivers one at a time) or ``sequential``; the epochs
    in order. Returns the verdicts, latencies from delivery to verdict,
    the wall time and the node."""
    import asyncio

    from spacemesh_tpu_torch.p2p import pubsub as ps

    node = atx_node(path, farm, device)
    bus = node["pubsub"]
    verdicts, lat = [], []

    async def one(item):
        t0 = time.perf_counter()
        ok = await bus.deliver(item["topic"], b"smesher", item["data"])
        lat.append(time.perf_counter() - t0)
        return ok

    t0 = time.perf_counter()
    for ep in plan["epochs"]:
        for blob in ep["blobs"]:
            require(await bus.deliver(ps.TOPIC_POET, b"smesher", blob),
                    "the validating node stored the poet blob")
        if sequential:
            for item in ep["items"]:
                verdicts.append(await one(item))
        else:
            verdicts += await asyncio.gather(*(one(i) for i in ep["items"]))
    wall = time.perf_counter() - t0
    return dict(verdicts=verdicts, lat=lat, wall=wall, node=node)


def atx_cpu_verdict(job: dict) -> tuple:
    """One envelope through the inline ``Handler`` on ``device="cpu"`` (the
    plain twins) on an in-memory state DB holding its poet blob; run in a
    worker process. Returns (verdict, seconds)."""
    import asyncio

    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    node = atx_node(":memory:", None, device="cpu")

    async def go():
        from spacemesh_tpu_torch.p2p import pubsub as ps

        require(await node["pubsub"].deliver(ps.TOPIC_POET, b"b",
                                             job["blob"]), "poet blob")
        return await node["pubsub"].deliver(job["topic"], b"b", job["data"])

    ok = asyncio.run(go())
    node["db"].close()
    return ok, time.perf_counter() - t0


def atx_post_checker(poet_of):
    """The node's InvalidPostIndex checker, ``node/app.py:266-290`` of the
    JAX package, with the device the malfeasance handler passes on: True
    when the ATX's POST index at ``index_pos`` fails its recompute."""
    from spacemesh_tpu_torch.consensus import activation
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.post import verifier as pv

    def post_checker(atx, index_pos: int, device) -> bool:
        poet = poet_of(atx.nipost.post_metadata.challenge)
        if poet is None:
            return False
        challenge = activation.nipost_challenge(atx.prev_atx,
                                                atx.publish_epoch)
        params = dataclasses.replace(prover.ProofParams(), k2=1, k3=1)
        item = pv.VerifyItem(
            proof=prover.Proof(
                nonce=atx.nipost.post.nonce,
                indices=[atx.nipost.post.indices[index_pos]],
                pow_nonce=atx.nipost.post.pow_nonce, k2=1),
            challenge=activation.post_challenge(poet.root, challenge),
            node_id=atx.node_id,
            commitment=activation.commitment_of(atx.node_id, atx_golden()),
            scrypt_n=N_MAIN, total_labels=atx.num_units * ATX_LPU)
        return not pv.verify(item, params, device=device)

    return post_checker


async def atx_checks(plan: dict, node: dict, signers: dict) -> dict:
    """On the last timed pass's node: a double publish through the hub,
    InvalidPostIndex malfeasance over the tampered index (and over a
    qualifying one), the certifier over 127.0.0.1."""
    import asyncio

    from spacemesh_tpu_torch.consensus import certifier
    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.consensus import malfeasance as mal
    from spacemesh_tpu_torch.core import types
    from spacemesh_tpu_torch.core.signing import EdSigner, EdVerifier
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.storage import misc

    out = {}
    state, atx_cache = node["db"], node["cache"]
    # a double publish: a second, validly signed ATX of a stored identity
    # in the same epoch, through the hub to the node's inbox
    first = next(i for i in plan["epochs"][0]["items"] if i["want"])
    atx = types.ActivationTx.from_bytes(first["data"])
    twin = atx_resign(dataclasses.replace(atx, vrf_nonce=atx.vrf_nonce + 1),
                      signers[atx.node_id])
    hub = ps.LoopbackHub()
    peer = ps.PubSub(node_name=b"peer", deliver_self=False)
    hub.join(peer)
    hub.join(node["pubsub"])
    require(not atx_cache.is_malicious(atx.node_id), "not yet malicious")
    await peer.publish(ps.TOPIC_ATX, twin.to_bytes())
    await hub.drain()
    hub.leave(node["pubsub"])
    require(atx_cache.is_malicious(atx.node_id),
            "a double publish marked the identity malicious")
    out["double_publish"] = atx.node_id.hex()[:16]

    # InvalidPostIndex over the tampered index; over a qualifying one first
    # (a condemned identity's later proofs count as already known)
    tampered = next(i for ep in plan["epochs"] for i in ep["items"]
                    if i["kind"] == "post_index"
                    and i["topic"] == ps.TOPIC_ATX)
    bad = types.ActivationTx.from_bytes(tampered["data"])
    m = mal.Handler(db=state, cache=atx_cache,
                    verifier=EdVerifier(prefix=ATX_GEN),
                    pubsub=ps.PubSub(node_name=b"mal"),
                    post_checker=atx_post_checker(
                        lambda ref: misc.poet_proof(state, ref)))
    good_proof = mal.proof_invalid_post(bad, 1)
    bad_proof = mal.proof_invalid_post(bad, 0)
    require(not m.process(good_proof), "InvalidPostIndex over a qualifying "
            "index is not condemned")
    require(not misc.is_malicious(state, bad.node_id), "not condemned")
    require(m.process(bad_proof), "InvalidPostIndex over the tampered "
            "index is condemned")
    require(misc.is_malicious(state, bad.node_id)
            and atx_cache.is_malicious(bad.node_id),
            "the identity is malicious in the DB and the cache")
    out["invalid_post_index"] = bad.node_id.hex()[:16]

    # the certifier on the card: one identity's real proof, a tampered one
    real = next(i for i in plan["epochs"][1]["items"] if i["want"]
                and i["topic"] == ps.TOPIC_ATX)
    atx = types.ActivationTx.from_bytes(real["data"])
    poet = misc.poet_proof(state, atx.nipost.post_metadata.challenge)
    kw = dict(challenge=act.post_challenge(poet.root, act.nipost_challenge(
                  atx.prev_atx, atx.publish_epoch)),
              node_id=atx.node_id,
              commitment=act.commitment_of(atx.node_id, atx_golden()),
              num_units=atx.num_units, labels_per_unit=ATX_LPU)
    p = atx.nipost.post
    proof = prover.Proof(nonce=p.nonce, indices=list(p.indices),
                         pow_nonce=p.pow_nonce, k2=prover.ProofParams().k2)
    bad_post = bad.nipost.post
    bad_proof = prover.Proof(nonce=bad_post.nonce,
                             indices=list(bad_post.indices),
                             pow_nonce=bad_post.pow_nonce, k2=proof.k2)
    bad_kw = dict(kw, node_id=bad.node_id, commitment=act.commitment_of(
        bad.node_id, atx_golden()), challenge=act.post_challenge(
        misc.poet_proof(state, bad.nipost.post_metadata.challenge).root,
        act.nipost_challenge(bad.prev_atx, bad.publish_epoch)))
    svc = certifier.CertifierService(
        EdSigner(seed=hashlib.sha256(b"chip-smoke-certifier").digest()),
        prover.ProofParams(), scrypt_n=N_MAIN)
    daemon = certifier.CertifierDaemon(svc, listen="127.0.0.1:0")
    addr = await daemon.start()
    try:
        client = certifier.CertifierClient(addr, timeout=300)
        t0 = time.perf_counter()
        cert = await asyncio.to_thread(
            lambda: client.certificate(proof=proof, **kw))
        cert_s = time.perf_counter() - t0
        require(certifier.verify_cert(cert, svc.pubkey, EdVerifier()),
                "the certificate verifies against the certifier's key")
        try:
            await asyncio.to_thread(
                lambda: client.certificate(proof=bad_proof, **bad_kw))
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        require(refused is not None and "failed verification" in refused,
                f"the certifier refused the tampered proof ({refused})")
    finally:
        await daemon.stop()
    out["certifier"] = dict(addr=f"{addr[0]}:{addr[1]}", cert_s=cert_s,
                            refused=refused)
    return out


def atx_host_split(doc: dict, sql_s: float, decode_s: float) -> dict:
    """A traced pass's host time: the ATX handlers' spans
    (``gossip.handler`` on ``ax1``/``ax2``) and within each the wait on the
    farm's verdicts (the union of its ``farm.request`` spans); on the event
    loop the sqlite reads and writes (``sql_state_query_seconds``) and the
    decode (the envelopes decoded again, timed alone); the farm's batches
    (``farm.batch``) by kind: count, requests and seconds."""
    from spacemesh_tpu_torch.consensus.activation_v2 import TOPIC_ATX_V2
    from spacemesh_tpu_torch.p2p.pubsub import TOPIC_ATX
    from spacemesh_tpu_torch.tools.measure import busy_us

    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    handlers = {e["args"]["id"]: e for e in spans
                if e["name"] == "gossip.handler"
                and e["args"].get("topic") in (TOPIC_ATX, TOPIC_ATX_V2)}
    waits: dict = {}
    batches: dict = {}
    for e in spans:
        if e["name"] == "farm.request" and e["args"].get("parent") \
                in handlers:
            waits.setdefault(e["args"]["parent"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
        elif e["name"] == "farm.batch":
            b = batches.setdefault(e["args"]["kind"], [0, 0, 0.0])
            b[0] += 1
            b[1] += e["args"]["n"]
            b[2] += e["dur"] / 1e6
    n = max(len(handlers), 1)
    return dict(handlers=len(handlers),
                handler_ms=sum(e["dur"] for e in handlers.values()) / n / 1e3,
                farm_ms=sum(busy_us(w) for w in waits.values()) / n / 1e3,
                sql_s=sql_s, decode_s=decode_s,
                batches={k: dict(batches=v[0], requests=v[1], s=v[2])
                         for k, v in sorted(batches.items())})


# the event loop's time by where it went, from the profiled thread's own
# (tottime) seconds per function: the first rule whose file or function
# name matches claims it
LOOP_SPLIT = (
    ("blake3", ("spacemesh_tpu_torch/core/hashing.py",)),
    ("codec decode/encode", ("spacemesh_tpu_torch/core/codec.py",
                             "spacemesh_tpu_torch/core/types.py")),
    ("sqlite", ("spacemesh_tpu_torch/storage/", "sqlite3")),
    ("loop idle (epoll wait)", ("select.epoll",)),
    ("future resolution and the loop", ("/asyncio/", "concurrent/futures",
                                        "_asyncio", "_contextvars")),
    ("verify farm (submit, coalesce)", ("spacemesh_tpu_torch/verify/",
                                        "spacemesh_tpu_torch/runtime/")),
    ("handlers", ("spacemesh_tpu_torch/consensus/",
                  "spacemesh_tpu_torch/p2p/")),
    ("signing (cache, dispatch)", ("spacemesh_tpu_torch/core/signing.py",)),
    ("metrics and tracing", ("spacemesh_tpu_torch/utils/",)),
)


def atx_loop_split(prof, wall: float) -> dict:
    """A cProfile'd pass's loop-thread seconds per ``LOOP_SPLIT`` category
    (and ``rest``), its total, and the pass's wall time (under the
    profiler's own overhead)."""
    import pstats

    split: dict = collections.Counter()
    rest: dict = collections.Counter()
    for (path, _line, func), row in pstats.Stats(prof).stats.items():
        tottime = row[2]
        where = f"{path}:{func}"
        for name, keys in LOOP_SPLIT:
            if any(k in where for k in keys):
                split[name] += tottime
                break
        else:
            split["rest"] += tottime
            rest[f"{os.path.basename(path)}:{func}"] += tottime
    return dict(seconds=dict(split.most_common()),
                total=sum(split.values()), wall=wall,
                rest_top=rest.most_common(8))


def phase_atx(ctx: dict) -> None:
    import asyncio
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from spacemesh_tpu_torch import native
    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.core import hashing, signing, types
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.post import initializer, prover, service
    from spacemesh_tpu_torch.tools.measure import busy_us, device_intervals
    from spacemesh_tpu_torch.utils import metrics, tracing
    from spacemesh_tpu_torch.verify.farm import VerificationFarm

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    # the earlier phases' closed farms leave their V scratch cached
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    log(f"[atx] reserved before the phase {reserved0 / 2**30:.2f} GiB, "
        f"{reserved1 / 2**30:.2f} GiB after handing back the earlier "
        f"farms' cached blocks")
    golden = atx_golden()
    signers = [signing.EdSigner(seed=hashlib.sha256(
        b"chip-smoke-atx-%d" % i).digest(), prefix=ATX_GEN)
        for i in range(ATX_IDS)]
    by_id = {s.node_id: s for s in signers}
    params = prover.ProofParams()
    native.zero_counts()
    zero_launches()
    GUARD.start()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-atx-") as d:
        t0 = time.perf_counter()
        clients = {}
        for s in signers:
            sd = os.path.join(d, s.node_id.hex()[:16])
            initializer.initialize(
                sd, node_id=s.node_id,
                commitment=act.commitment_of(s.node_id, golden), num_units=1,
                labels_per_unit=ATX_LPU, scrypt_n=N_MAIN,
                batch_size=ATX_LPU, device="cuda")
            clients[s.node_id] = service.PostClient(sd, params,
                                                    batch_labels=ATX_LPU,
                                                    device="cuda")
        init_s = time.perf_counter() - t0

        async def build():
            farm = VerificationFarm(
                ed_verifier=signing.EdVerifier(prefix=ATX_GEN),
                post_params=params, device="cuda")
            try:
                return await atx_build(signers, clients, farm)
            finally:
                await farm.aclose()

        t0 = time.perf_counter()
        built = asyncio.run(build())
        build_s = time.perf_counter() - t0
        build_launches = launch_counts()
        guard_build = GUARD.stop()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[atx] {ATX_IDS} identities x {ATX_LPU} labels (N={N_MAIN}) "
            f"initialized on the card in {init_s:.1f} s; {ATX_EPOCHS} epochs "
            f"of v1 ATXs and one of {ATX_IDS // ATX_MARRIED} merged v2 ATXs "
            f"(married in {ATX_MARRIED}s) built by {ATX_IDS} Builders over "
            f"PostClients on the card in {build_s:.1f} s (per epoch "
            + ", ".join(f"{t:.1f}" for t in built["times"]) + " s), "
            f"published on a LoopbackHub")
        log(f"[atx] build launches {json.dumps(build_launches)}")
        require_no_twins(guard_build, "atx build (init, proves, the smeshing "
                         "node's own validation)")
        t0 = time.perf_counter()
        plan = atx_plan(built, by_id)
        items = [i for ep in plan["epochs"] for i in ep["items"]]
        want = [i["want"] for i in items]
        n_v1 = sum(i["topic"] == ps.TOPIC_ATX for i in items)
        kinds = collections.Counter(i["kind"] for i in items if i["kind"])
        log(f"[atx] {len(items)} envelopes ({n_v1} v1), "
            f"{sum(kinds.values())} tampered: {json.dumps(dict(kinds))} "
            f"(made in {time.perf_counter() - t0:.1f} s)")

        # two envelopes through the plain twins on the host, in worker
        # processes, beside the card passes below
        sample = [next(i for i in plan["epochs"][0]["items"] if i["want"]),
                  next(i for ep in plan["epochs"] for i in ep["items"]
                       if i["kind"] == "post_index"
                       and i["topic"] == ps.TOPIC_ATX)]
        blob_of = {}
        for ep in plan["epochs"]:
            for item in ep["items"]:
                blob_of[id(item)] = ep["blobs"]
        pool = ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn"))
        t_cpu = time.perf_counter()
        try:
            cpu_jobs = [pool.submit(atx_cpu_verdict, dict(
                topic=i["topic"], data=i["data"],
                blob=blob_of[id(i)][0])) for i in sample]

            async def drive():
                farm = VerificationFarm(
                    ed_verifier=signing.EdVerifier(prefix=ATX_GEN),
                    post_params=params, device="cuda")
                out = {"passes": []}
                try:
                    n = 0
                    while (not out["passes"] or sum(
                            p["wall"] for p in out["passes"]) < ATX_TIMED_S):
                        signing.clear_verify_cache()
                        out["passes"].append(await atx_pass(
                            plan, os.path.join(d, f"state-{n}.sql"), farm))
                        n += 1
                    last = out["passes"][-1]
                    out["checks"] = await atx_checks(plan, last["node"],
                                                     by_id)
                    # one pass under cProfile, enabled on this thread: the
                    # event loop's, where every handler and callback runs
                    signing.clear_verify_cache()
                    cprof = cProfile.Profile()
                    cprof.enable()
                    try:
                        profiled_loop = await atx_pass(
                            plan, os.path.join(d, "state-cprofile.sql"), farm)
                    finally:
                        cprof.disable()
                    profiled_loop["node"]["db"].close()
                    out["loop_split"] = atx_loop_split(
                        cprof, profiled_loop["wall"])
                    out["cprofiled"] = profiled_loop
                    # one traced pass: the host time split
                    signing.clear_verify_cache()
                    sql = metrics.REGISTRY.histogram(
                        "sql_state_query_seconds")
                    s0 = sum(v[1] for v in sql.sample().values())
                    tracing.stop()
                    tracing.start(capacity=1 << 20)
                    try:
                        traced = await atx_pass(
                            plan, os.path.join(d, "state-traced.sql"), farm)
                        doc = tracing.export()
                    finally:
                        tracing.stop()
                    sql_s = sum(v[1] for v in sql.sample().values()) - s0
                    t0 = time.perf_counter()
                    decoded = [(types.ActivationTx
                                if item["topic"] == ps.TOPIC_ATX
                                else types.ActivationTxV2).from_bytes(
                                    item["data"]) for item in items]
                    decode_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    for atx in decoded:  # encode + blake3, as the handlers
                        atx.id
                    id_ms = (time.perf_counter() - t0) / len(decoded) * 1e3
                    out["split"] = atx_host_split(doc, sql_s, decode_s)
                    out["split"]["id_ms"] = id_ms
                    v1 = [i["data"] for i in items
                          if i["topic"] == ps.TOPIC_ATX]
                    t0 = time.perf_counter()
                    for raw in v1:
                        hashing.sum256(raw)
                    b3_native = (time.perf_counter() - t0) / len(v1) * 1e6
                    t0 = time.perf_counter()
                    for raw in v1[:64]:  # the Python twin, called directly
                        hashing.Hasher().update(raw).digest(32)
                    b3_python = (time.perf_counter() - t0) / 64 * 1e6
                    out["blake3_atx"] = dict(
                        bytes=statistics.median(len(r) for r in v1),
                        native_us=b3_native, python_us=b3_python)
                    out["traced"] = traced
                    traced["node"]["db"].close()
                    # one profiled pass: the card's idle share
                    signing.clear_verify_cache()
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    with prof:
                        profiled = await atx_pass(
                            plan, os.path.join(d, "state-prof.sql"), farm)
                        torch.cuda.synchronize()
                    profiled["node"]["db"].close()
                    out["profiled"], out["prof"] = profiled, prof
                    # inline process on the card, one envelope at a time
                    signing.clear_verify_cache()
                    inline = await atx_pass(
                        plan, os.path.join(d, "state-inline.sql"), None,
                        sequential=True)
                    out["inline"] = inline
                    # the native guard reads the path up to here; then the
                    # same farm passes with the one-shots on the native
                    # library and on the Python twin, in turns
                    out["native_counts"] = native.counts()
                    out["turns"] = []
                    for mode in ATX_TURNS:
                        with python_oneshots(mode == "python"):
                            signing.clear_verify_cache()
                            t = await atx_pass(plan, os.path.join(
                                d, f"state-turn-{len(out['turns'])}.sql"),
                                farm)
                        t["node"]["db"].close()
                        out["turns"].append((mode, t))
                finally:
                    await farm.aclose()
                return out

            zero_launches()
            GUARD.start()
            res = asyncio.run(drive())
            torch.cuda.synchronize()
            launches = launch_counts()
            guard = GUARD.stop()
            cpu_wait = time.perf_counter()
            cpu = [j.result(timeout=900) for j in cpu_jobs]
            cpu_s = time.perf_counter() - t_cpu
            cpu_waited = time.perf_counter() - cpu_wait
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()

        passes = res["passes"]
        for n, p in enumerate(passes + [res["traced"], res["profiled"],
                                        res["cprofiled"]]
                              + [t for _, t in res["turns"]]):
            require(p["verdicts"] == want, f"pass {n}: every verdict == the "
                    f"one expected by construction ({sum(want)} valid, "
                    f"{len(want) - sum(want)} tampered)")
        inline = res["inline"]
        require(inline["verdicts"] == want, "inline process on the card: "
                "every verdict as constructed")
        farm_state = atx_state(passes[0]["node"])
        inline_state = atx_state(inline["node"])
        require(farm_state == inline_state, "farm pass == inline pass: atxs "
                "rows (id, node, epoch, tick height) and AtxCache weights "
                "and heights")
        require(len(farm_state[0]) == sum(
            1 if i["topic"] == ps.TOPIC_ATX else ATX_MARRIED
            for i in items if i["want"]), "one row per valid v1 ATX and per "
                "identity of a valid merged ATX")
        require([ok for ok, _ in cpu] == [True, False],
                f"device='cpu' (the plain twins): {[ok for ok, _ in cpu]} "
                "== [True, False] on a valid and a tampered-index envelope")
        require_no_twins(guard, "atx validation")
        require_native(res["native_counts"], "atx (build and validation)")
        for key in ("romix", "pbkdf2_expand", "pbkdf2_finish_hash"):
            require(launches[key] > 0, f"atx validation launched {key}")
        for key in ("pbkdf2_finish", "scan", "k2pow_search", *OFF_PATH):
            require(launches[key] == 0, f"atx validation launched no {key}")

    for p in passes:
        p["node"]["db"].close()
    inline["node"]["db"].close()
    wall = sum(p["wall"] for p in passes)
    n_items = len(items) * len(passes)
    rate = n_items / wall
    inline_rate = len(items) / inline["wall"]
    lat = sorted(x for p in passes for x in p["lat"])
    log(f"[atx] validating node: a file state DB (WAL, {ATX_READ_POOL} "
        f"readers) per pass, Handler + HandlerV2 over one "
        f"VerificationFarm(device='cuda') with its defaults; each epoch's "
        f"envelopes delivered at once through PubSub.deliver, the epochs in "
        f"order; signature cache cleared between passes")
    log(f"[atx] {rate:.1f} ATXs validated/s through gossip over the farm "
        f"({len(passes)} timed pass(es), {n_items} envelopes in {wall:.3f} s; per "
        f"pass " + ", ".join(f"{p['wall']:.3f}" for p in passes) + " s); "
        f"inline process on the card {inline_rate:.1f}/s ({len(items)} in "
        f"{inline['wall']:.3f} s), {rate / inline_rate:.2f}x")
    log(f"[atx] latency from delivery to verdict: p50 "
        f"{statistics.median(lat) * 1e3:.1f} ms, p99 "
        f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms, max "
        f"{lat[-1] * 1e3:.1f} ms over {len(lat)} envelopes; inline p50 "
        f"{statistics.median(inline['lat']) * 1e3:.1f} ms")
    sp, tw = res["split"], res["traced"]["wall"]
    log(f"[atx] host time of a traced pass ({tw:.3f} s wall): an ATX's "
        f"handler (its gossip.handler span) {sp['handler_ms']:.1f} ms on "
        f"average, {sp['farm_ms']:.1f} ms of it ({sp['farm_ms'] / sp['handler_ms']:.1%}) "
        f"waiting on the farm's verdicts; on the event loop sqlite reads and "
        f"writes {sp['sql_s']:.3f} s ({sp['sql_s'] / tw:.1%} of the wall), "
        f"decode {sp['decode_s']:.3f} s ({sp['decode_s'] / tw:.1%}), one "
        f"ATX id (blake3 of its bytes in Python, timed alone) "
        f"{sp['id_ms']:.3f} ms; the farm's batches by kind: " + ", ".join(
            f"{k} {b['batches']} of {b['requests']} requests {b['s']:.3f} s"
            for k, b in sp["batches"].items()))
    prof, profiled = res["prof"], res["profiled"]
    intervals = device_intervals(prof)
    if intervals:
        busy = busy_us(intervals) / 1e6
        idle = (f"device busy {busy:.3f} s, idle share "
                f"{1 - busy / profiled['wall']:.1%} of the profiled pass's "
                f"{profiled['wall']:.3f} s wall")
    else:
        idle = "idle share not measured (no device activity recorded)"
    log(f"[atx] {idle}; peak device memory over the phase: allocated "
        f"{peak / 2**30:.2f} GiB, reserved {peak_reserved / 2**30:.2f} GiB")
    log(f"[atx] every verdict as constructed in {len(passes) + 3} farm "
        f"passes and the inline pass; farm == inline: {len(farm_state[0])} "
        f"atxs rows and the cache's weights and heights; device='cpu': "
        f"{[ok for ok, _ in cpu]} in {cpu_s:.1f} s in two worker processes "
        f"(the phase waited {cpu_waited:.1f} s for them)")
    ck = res["checks"]
    log(f"[atx] a double publish marked {ck['double_publish']} malicious; "
        f"InvalidPostIndex condemned {ck['invalid_post_index']} over the "
        f"tampered index and not over a qualifying one; the certifier on "
        f"the card at {ck['certifier']['addr']} certified a real proof in "
        f"{ck['certifier']['cert_s']:.2f} s and refused the tampered one "
        f"({ck['certifier']['refused']})")
    ls, cp = res["loop_split"], res["cprofiled"]
    busy = ls["total"] - ls["seconds"].get("loop idle (epoll wait)", 0.0)
    log(f"[atx] the event loop of a pass under cProfile ({cp['wall']:.3f} s "
        f"wall with the profiler's overhead, {len(cp['verdicts']) / cp['wall']:.1f} "
        f"ATXs/s; {ls['total']:.3f} s on the loop's thread, {busy:.3f} s "
        f"of it busy): " + ", ".join(
            f"{k} {v:.3f} s ({v / ls['total']:.1%})"
            for k, v in ls["seconds"].items()))
    log("[atx] the rest's largest: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in ls["rest_top"]))
    turns = res["turns"]
    by_mode = {m: [len(t["verdicts"]) / t["wall"] for mm, t in turns
                   if mm == m] for m in ("native", "python")}
    log(f"[atx] one-shot blake3 and VRF on the native library and on the "
        f"Python twin, the same farm passes in turns "
        f"{', '.join(m for m, _ in turns)}: " + ", ".join(
            f"{m} {len(t['verdicts']) / t['wall']:.1f}" for m, t in turns)
        + f" ATXs/s; native/Python "
        f"{statistics.mean(by_mode['native']) / statistics.mean(by_mode['python']):.2f}x; "
        f"latency p50 " + ", ".join(
            f"{statistics.median(t['lat']) * 1e3:.1f}" for _, t in turns)
        + " ms")
    b3 = res["blake3_atx"]
    log(f"[native] blake3 of a v1 ATX's encoding ({b3['bytes']:.0f} bytes, "
        f"the median): native {b3['native_us']:.2f} us, Python "
        f"{b3['python_us']:.1f} us per call "
        f"({b3['python_us'] / b3['native_us']:.0f}x); an ATX id (encode + "
        f"blake3) {res['split']['id_ms'] * 1e3:.1f} us")
    log(f"[atx] launches over the validation {json.dumps(launches)}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    fh = atx_finish_hash(ctx)
    log(f"[atx] {ctx['smi']}")
    ctx["atx"] = dict(launches={k: build_launches[k] + launches[k]
                                for k in launches}, rate=rate,
                      cache=built["cache"], seeds=[
                          hashlib.sha256(b"chip-smoke-atx-%d" % i).digest()
                          for i in range(ATX_IDS)], finish_hash=fh)


ATX_POST_LANES = ATX_IDS * 37  # a full [atx] POST batch: 64 proofs x k3
ATX_TURNS = ("native", "python", "python", "native")



def atx_finish_hash(ctx: dict) -> dict:
    """finish_hash at [atx]'s own POST batch shape (2368 per-lane lanes)
    against finish + the proving hash's plain twins, then timed with finish
    alone in turns, beside its bound (outside the guard: the check runs
    the plain twins)."""
    from spacemesh_tpu_torch.ops import pbkdf2_cuda

    b = ATX_POST_LANES
    err, (cw, blk, ch, nonce, lo, hi) = finish_hash_case(b, True, 54)
    fh = (lambda: pbkdf2_cuda.finish_hash(cw, blk, ch, nonce, lo, hi))
    fin = (lambda: pbkdf2_cuda.finish(cw, blk))
    turns = [kernel_ms(f, "finish_kernel", reps=50)
             for f in (fin, fh, fh, fin)]
    out = dict(max_abs_err=err, finish_fh_fh_finish_ms=turns,
               kernel_ms=(turns[1] + turns[2]) / 2, ms=cuda_ms(fh, reps=50),
               **bound(pbkdf2_cuda.int_ops(b, "finish_hash", True),
                       pbkdf2_cuda.io_bytes(b, "finish_hash", True),
                       ctx["int_ops_per_s"]))
    log(f"[atx] finish_hash at B={b} per-lane (a full POST batch of the "
        f"phase): == finish + proving hash plain (max_abs_err {err}); kernel "
        f"ms finish, finish_hash, finish_hash, finish {json.dumps(turns)}; "
        f"wrapper call rate {out['ms']:.4f} ms, bound {out['bound_ms']:.5f} "
        f"ms ({out['bound_by']})")
    return out


# --- [consensus]: eligibility, hare and beacon over [atx]'s identities -----

CONS_NODES = 8            # PubSub nodes on one LoopbackHub, 8 identities each
CONS_LPE = 4032           # mainnet layers per epoch (node/config.py:222)
CONS_COMMITTEE = 50       # mainnet's committee since layer 105720
                          # (node/config.py:205-206 committee_upgrade)
CONS_ITERATIONS = 4       # HareConfig.iteration_limit (leader_count 5 is
                          # not read by Hare)
CONS_ROUND_S = 0.7        # fastnet round_duration (mainnet 25 s)
CONS_PREROUND_S = 1.0     # fastnet preround_delay (mainnet 25 s)
CONS_LAYERS = 4           # hare layers run
CONS_STAGGER = 4          # rounds between two layers' starts
CONS_PROPOSALS = 5        # proposal ids per layer
CONS_THETA = 0.00004      # BeaconConfig.theta, the configured value
CONS_THETA_CUT = 0.25     # tests/test_beacon.py's, if no protocol beacon
CONS_BEACON = dict(kappa=40, rounds_number=4, grace_period=0.5,
                   proposal_duration=0.7, first_voting_round_duration=1.4,
                   voting_round_duration=0.7)  # fastnet (node/config.py:243)


def consensus_layout(ctx: dict) -> tuple:
    """[atx]'s 64 identities (the smeshing node's signers) with the epoch
    their ATXs target in its AtxCache, grouped 8 per node."""
    from spacemesh_tpu_torch.core import signing

    cache = ctx["atx"]["cache"]
    epoch = ATX_EPOCHS + 1  # the last v1 epoch's target: 64 validated ATXs
    atx_of = {info.node_id: atx_id for atx_id, info in cache.iter_epoch(epoch)}
    signers = [signing.EdSigner(seed=s, prefix=ATX_GEN)
               for s in ctx["atx"]["seeds"]]
    require(cache.epoch_count(epoch) == ATX_IDS
            and all(s.node_id in atx_of for s in signers),
            f"the AtxCache holds all {ATX_IDS} identities for epoch {epoch}")
    per = ATX_IDS // CONS_NODES
    groups = [signers[i:i + per] for i in range(0, ATX_IDS, per)]
    return cache, epoch, atx_of, groups


async def consensus_beacon(cache, epoch: int, atx_of: dict, groups: list,
                           theta: float) -> dict:
    """One beacon epoch: a ProtocolDriver per node (its own state DB) on
    one LoopbackHub, every identity proposing and voting with its weight."""
    import asyncio

    from spacemesh_tpu_torch.consensus import beacon, eligibility
    from spacemesh_tpu_torch.core.signing import EdVerifier
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.storage import db, misc

    hub = ps.LoopbackHub()
    drivers = []
    for k, group in enumerate(groups):
        node = ps.PubSub(node_name=b"consensus-%d" % k)
        hub.join(node)
        state = db.open_state(":memory:")
        drivers.append((beacon.ProtocolDriver(
            db=state, oracle=eligibility.Oracle(cache, CONS_LPE),
            pubsub=node, genesis_id=ATX_GEN,
            verifier=EdVerifier(prefix=ATX_GEN), theta=theta,
            **CONS_BEACON), state, node, group))
    t0 = time.perf_counter()
    beacons = await asyncio.gather(*(
        drv.run_epoch(epoch, None, None, None, participants=[
            (s, s.vrf_signer(), atx_of[s.node_id]) for s in group])
        for drv, _, _, group in drivers))
    wall = time.perf_counter() - t0
    sources = [misc.beacon_source(state, epoch) for _, state, _, _ in drivers]
    proposals = max(len(drv._states.get(epoch, beacon._EpochState()).proposals)
                    for drv, _, _, _ in drivers)
    return dict(beacons=beacons, sources=sources, wall=wall, hub=hub,
                drivers=drivers, proposals=proposals, theta=theta,
                protocol=all(src == misc.BEACON_PROTOCOL for src in sources))


async def consensus_hare(cache, epoch: int, atx_of: dict, groups: list,
                         beacon_run: dict) -> dict:
    """CONS_LAYERS hare layers on the beacon's nodes, staggered by
    CONS_STAGGER rounds as the node runs sessions beside its layer loop:
    one Hare per node over its 8 signers; identity X equivocates in the
    first layer's preround; a forged seat count is offered first."""
    import asyncio

    from spacemesh_tpu_torch.consensus import eligibility, hare
    from spacemesh_tpu_torch.core import signing
    from spacemesh_tpu_torch.core.hashing import sum256
    from spacemesh_tpu_torch.p2p import pubsub as ps
    from spacemesh_tpu_torch.utils import metrics

    drivers = beacon_run["drivers"]
    first = epoch * CONS_LPE
    layers = list(range(first, first + CONS_LAYERS))
    props = {layer: sorted(sum256(b"chip-smoke-proposal",
                                  layer.to_bytes(4, "little"), bytes([j]))
                           for j in range(CONS_PROPOSALS))
             for layer in layers}
    outs = [[] for _ in drivers]
    equivs = [[] for _ in drivers]
    late = [0]
    rejected = [0]
    hares, closed = [], []
    for k, (drv, _state, node, group) in enumerate(drivers):
        async def on_output(out, k=k):
            outs[k].append((out.layer, tuple(out.proposals), out.completed))

        h = hare.Hare(
            signers=group, verifier=signing.EdVerifier(prefix=ATX_GEN),
            oracle=eligibility.Oracle(cache, CONS_LPE), pubsub=node,
            committee_size=CONS_COMMITTEE, round_duration=CONS_ROUND_S,
            iteration_limit=CONS_ITERATIONS, preround_delay=CONS_PREROUND_S,
            layers_per_epoch=CONS_LPE, beacon_of=drv.get,
            atx_for=lambda e, node_id: atx_of.get(node_id),
            proposals_for=lambda layer: list(props.get(layer, [])),
            on_output=on_output, on_equivocation=equivs[k].append)
        done: set = set()

        def dispatch(msg, raw_signed=None, raw_full=None, _real=h._dispatch,
                     _done=done):
            if msg.layer in _done:  # its session here had closed
                late[0] += 1
            return _real(msg, raw_signed, raw_full)

        h._dispatch = dispatch
        handlers = node._handlers[ps.TOPIC_HARE]

        def counted(fn):
            async def handler(peer, data):
                ok = await fn(peer, data)
                if ok is False:
                    rejected[0] += 1
                return ok
            return handler

        node._handlers[ps.TOPIC_HARE] = [counted(fn) for fn in handlers]
        hares.append(h)
        closed.append(done)
    beacon = await drivers[0][0].get(epoch)
    # identity X: the first identity eligible in the first layer's preround
    oracle = hares[0].oracle
    who = [(s, oracle.hare_eligibility(
        s.vrf_signer(), beacon, first, 0, epoch, atx_of[s.node_id],
        CONS_COMMITTEE)) for group in groups for s in group]
    evil, (evil_proof, evil_count) = next((s, el) for s, el in who if el)

    def signed(signer, layer, values, proof, count):
        msg = hare.HareMessage(
            layer=layer, iteration=0, round=hare.PREROUND,
            values=sorted(values), eligibility_proof=proof,
            eligibility_count=count, atx_id=atx_of[signer.node_id],
            node_id=signer.node_id, cert_msgs=[], signature=bytes(64))
        msg.signature = signer.sign(signing.Domain.HARE, msg.signed_bytes())
        return msg.to_bytes()

    # a forged seat count is refused, the true one taken (for a layer no
    # session runs: it is buffered, then dropped)
    spare = first + 1000
    sp_signer, sp_el = next(
        (s, el) for group in groups for s in group
        if (el := oracle.hare_eligibility(
            s.vrf_signer(), beacon, spare, 0, epoch, atx_of[s.node_id],
            CONS_COMMITTEE)))
    forged = signed(sp_signer, spare, [sum256(b"x")], sp_el[0],
                    sp_el[1] + 1)
    honest = signed(sp_signer, spare, [sum256(b"x")], *sp_el)
    forged_ok = await hares[0]._gossip(b"forger", forged)
    honest_ok = await hares[0]._gossip(b"forger", honest)
    hares[0]._pending.pop(spare, None)

    evil_ps = ps.PubSub(node_name=b"equivocator")
    beacon_run["hub"].join(evil_ps)
    vrf_calls: dict = collections.Counter()
    ed_calls: dict = collections.Counter()
    real_vrf = signing.VrfVerifier.verify
    real_ed = signing.EdVerifier.verify

    def vrf_verify(self, public_key, alpha, proof):
        if alpha[:4] == b"HARE":
            vrf_calls[int.from_bytes(alpha[8:12], "little")] += 1
        return real_vrf(self, public_key, alpha, proof)

    def ed_verify(self, domain, public_key, msg, signature):
        if domain == signing.Domain.HARE:
            ed_calls[int.from_bytes(msg[:4], "little")] += 1
        return real_ed(self, domain, public_key, msg, signature)

    drops = metrics.pubsub_handler_drops
    drops0 = sum(drops.sample().values())
    start = time.time() + 0.5
    starts = {layer: start + i * CONS_STAGGER * CONS_ROUND_S
              for i, layer in enumerate(layers)}

    async def run(k, layer):
        out = await hares[k].run_layer(layer, layer_start=starts[layer])
        closed[k].add(layer)
        return out

    async def equivocate():
        await asyncio.sleep(starts[first] + CONS_PREROUND_S + 0.05
                            - time.time())
        await evil_ps.publish(ps.TOPIC_HARE, signed(
            evil, first, [sum256(b"chip-smoke-equivocation")], evil_proof,
            evil_count))

    signing.VrfVerifier.verify = vrf_verify
    signing.EdVerifier.verify = ed_verify
    try:
        t0, c0 = time.perf_counter(), time.thread_time()
        await asyncio.gather(*(run(k, layer) for layer in layers
                               for k in range(len(hares))), equivocate())
        wall, busy = time.perf_counter() - t0, time.thread_time() - c0
    finally:
        signing.VrfVerifier.verify = real_vrf
        signing.EdVerifier.verify = real_ed
    await beacon_run["hub"].drain()
    return dict(outs=outs, equivs=equivs, evil=evil.node_id, late=late[0],
                rejected=rejected[0],
                drops=sum(drops.sample().values()) - drops0,
                forged_ok=forged_ok, honest_ok=honest_ok, wall=wall,
                busy=busy, vrf=dict(vrf_calls), ed=dict(ed_calls),
                layers=layers, props=props,
                rounds=(wall - 0.5 - CONS_PREROUND_S) / CONS_ROUND_S)


async def consensus_poet(atx_of: dict) -> dict:
    """One round through a ``python -m spacemesh_tpu_torch.tools.poet_server``
    process on 127.0.0.1 read by ``MultiPoet``, every identity registered;
    its memberships (and a tampered one) checked through the farm's
    membership kind."""
    import asyncio

    from spacemesh_tpu_torch.consensus import poet_remote
    from spacemesh_tpu_torch.core.hashing import sum256
    from spacemesh_tpu_torch.core.signing import EdVerifier
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.verify import farm as farm_mod

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "spacemesh_tpu_torch.tools.poet_server",
         "--listen", "127.0.0.1:0", "--ticks", str(ATX_TICKS), "--id-seed",
         "chip-smoke-consensus"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=REPO)
    farm = None
    try:
        ev = json.loads(proc.stdout.readline())
        require(ev["event"] == "Serving", f"the poet server serves ({ev})")
        boot_s = time.perf_counter() - t0
        mp = poet_remote.MultiPoet([poet_remote.RemotePoetClient(
            (ev["host"], ev["port"]), timeout=60)])
        challenges = [sum256(b"chip-smoke-consensus-challenge", node_id)
                      for node_id in sorted(atx_of)]
        for ch in challenges:
            await mp.register("1", ch)
        result = await mp.execute_round("1")
        farm = farm_mod.VerificationFarm(
            ed_verifier=EdVerifier(prefix=ATX_GEN),
            post_params=prover.ProofParams(), device="cuda")
        n = len(result.members)
        reqs = [farm_mod.MembershipRequest(
            member=ch, proof=result.membership(ch), root=result.proof.root,
            leaf_count=n) for ch in challenges]
        bad = dataclasses.replace(reqs[0], member=sum256(b"not a member"))
        verdicts = await asyncio.gather(*(farm.submit(r)
                                          for r in reqs + [bad]))
    finally:
        if farm is not None:
            await farm.aclose()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return dict(boot_s=boot_s, members=n, ticks=result.proof.ticks,
                verdicts=verdicts, wall=time.perf_counter() - t0,
                addr=f"{ev['host']}:{ev['port']}")


def phase_consensus(ctx: dict) -> None:
    import asyncio

    from spacemesh_tpu_torch import native

    t_phase = time.perf_counter()
    cache, epoch, atx_of, groups = consensus_layout(ctx)
    weights = sorted(cache.get(epoch, a).weight for a in atx_of.values())
    log(f"[consensus] the Oracle reads [atx]'s AtxCache (the smeshing node's "
        f"own validated ATXs): epoch {epoch}, {len(atx_of)} identities, total "
        f"weight {cache.epoch_weight(epoch)} (each {weights[0]}-{weights[-1]}); "
        f"{CONS_NODES} PubSub nodes on a LoopbackHub with "
        f"{len(groups[0])} identities each")
    native.zero_counts()
    zero_launches()
    GUARD.start()

    async def drive():
        theta = CONS_THETA
        b = await consensus_beacon(cache, epoch, atx_of, groups, theta)
        cut = None
        if not b["protocol"]:
            cut = b
            b = await consensus_beacon(cache, epoch, atx_of, groups,
                                       CONS_THETA_CUT)
        h = await consensus_hare(cache, epoch, atx_of, groups, b)
        p = await consensus_poet(atx_of)
        return b, cut, h, p

    b, cut, h, p = asyncio.run(drive())
    guard = GUARD.stop()
    counts = native.counts()
    launches = launch_counts()
    require_no_twins(guard, "consensus")
    require_native(counts, "consensus (beacon, hare, poet)")
    require(not any(launches.values()), f"consensus launched no kernel "
            f"({json.dumps(launches)})")
    if cut is not None:
        log(f"[consensus] at theta {CONS_THETA} the beacon fell back "
            f"(sources {cut['sources']}, {cut['proposals']} proposals); "
            f"ran again at theta {CONS_THETA_CUT} (a cut)")
    require(len(set(b["beacons"])) == 1 and b["protocol"],
            f"every driver decided one protocol beacon ({b['beacons']}, "
            f"sources {b['sources']})")
    log(f"[consensus] beacon epoch {epoch}: {len(b['drivers'])} drivers "
        f"decided {b['beacons'][0].hex()} (source protocol on every node, "
        f"{b['proposals']} proposals, kappa {CONS_BEACON['kappa']}, "
        f"{CONS_BEACON['rounds_number']} rounds, theta {b['theta']}) in "
        f"{b['wall']:.3f} s wall")
    for layer in h["layers"]:
        got = {tuple(o[1:]) for outs in h["outs"] for o in outs
               if o[0] == layer}
        require(len(got) == 1 and all(
            sum(o[0] == layer for o in outs) == 1 for outs in h["outs"]),
            f"layer {layer}: every node output one hare set ({got})")
        (props, completed), = got
        require(completed and list(props) == h["props"][layer],
                f"layer {layer}: agreement on the layer's proposals")
    require(all([e.node_id for e in per] == [h["evil"]] for per in h["equivs"]),
            f"every node reported the equivocator once "
            f"({[[e.node_id.hex()[:8] for e in per] for per in h['equivs']]})")
    require(h["forged_ok"] is False and h["honest_ok"] is True,
            f"a forged seat count is refused ({h['forged_ok']}) and the true "
            f"one taken ({h['honest_ok']})")
    require(all(p["verdicts"][:-1]) and p["verdicts"][-1] is False,
            f"the poet's {p['members']} memberships verify through the "
            f"farm and a wrong member does not")
    n = len(h["layers"])
    log(f"[consensus] hare: {n} layers from {h['layers'][0]}, committee "
        f"{CONS_COMMITTEE}, {CONS_ITERATIONS} iterations at most, rounds "
        f"{CONS_ROUND_S} s after a {CONS_PREROUND_S} s preround delay, "
        f"layers {CONS_STAGGER} rounds apart: every node output the same "
        f"{CONS_PROPOSALS} proposals per layer; identity "
        f"{h['evil'].hex()[:16]}'s two prerounds reported once by each of "
        f"{len(h['equivs'])} nodes; a forged seat count refused")
    log(f"[consensus] hare per layer: VRF verifies "
        f"{json.dumps({k: h['vrf'].get(k, 0) for k in h['layers']})}, "
        f"Ed25519 checks "
        f"{json.dumps({k: h['ed'].get(k, 0) for k in h['layers']})}; the "
        f"event loop busy {h['busy']:.3f} s of {h['wall']:.3f} s "
        f"({h['busy'] / h['wall']:.1%}) over ~{h['rounds']:.0f} rounds; "
        f"messages after their session closed {h['late']}, refused "
        f"{h['rejected']}, dropped (pubsub_handler_drops_total) {h['drops']}")
    log(f"[consensus] poet: python -m spacemesh_tpu_torch.tools.poet_server "
        f"at {p['addr']} (served in {p['boot_s']:.2f} s), one round of "
        f"{p['members']} members and {p['ticks']} ticks through MultiPoet; "
        f"every membership verified through the farm's membership kind, a "
        f"wrong member refused; {p['wall']:.2f} s")
    log(f"[consensus] phase {time.perf_counter() - t_phase:.1f} s; "
        f"{ctx['smi']}")


# --- [trace]: instrumentation and self-healing on the card -----------------

TRACE_LABELS = 1 << 19    # (a)/(b): labels per init, at the main path's width
TRACE_ROUNDS = 2          # (a): rounds of the three modes, in turns
TRACE_POSTS = 2560        # (c): [verifyd]'s proofs under capture
TRACE_STALL_S = 2.0       # (e): the prove watchdog's deadline
SANITIZE_TENANTS = 4      # (f): identities of the sanitized scheduler run
SANITIZE_POSTS = 1024     # (f): [verifyd]'s proofs through a sanitized service
# the kernels of (b)'s path by the substring of their name the profiler
# records, and the wrappers' launch counters of each (finish_kernel covers
# finish and finish_hash): every launch and every event must lie inside a
# host span
TRACE_KERNELS = {"expand_kernel": ("pbkdf2_expand",),
                 "romix_kernel": ("romix",),
                 "finish_kernel": ("pbkdf2_finish", "pbkdf2_finish_hash"),
                 "scan_kernel": ("scan",),
                 "window_kernel": ("k2pow_search",)}
# the JAX package's span names on init -> prove -> verify + a farm run
# (tests/test_tracing.py:267), and the k2pow gate's
TRACE_SPANS = ("init.run", "init.dispatch", "init.fetch", "init.write",
               "prove.run", "prove.window", "prove.read_io",
               "prove.dispatch", "prove.retire", "romix.dispatch",
               "farm.request", "farm.batch", "prove.k2pow", "pow.dispatch")


def trace_ids() -> tuple:
    return (hashlib.sha256(b"chip-smoke-trace-node").digest(),
            hashlib.sha256(b"chip-smoke-trace-commitment").digest(),
            hashlib.sha256(b"chip-smoke-trace-challenge").digest())


def trace_init(d: str, mode: str):
    """One init of ``TRACE_LABELS`` at the main path's width with tracing
    ``off``, ``on``, or ``bridge`` (on, each span a ``record_function``,
    inside a ``torch.profiler`` capture of the CPU and the card)."""
    import torch
    from spacemesh_tpu_torch.post import initializer
    from spacemesh_tpu_torch.utils import tracing

    node, commitment, _ = trace_ids()
    prof = None
    if mode == "off":
        tracing.stop()
    else:
        tracing.start(capacity=1 << 16, torch_bridge=mode == "bridge")
    if mode == "bridge":
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    try:
        with prof or contextlib.nullcontext():
            meta, res = initializer.initialize(
                d, node_id=node, commitment=commitment, num_units=1,
                labels_per_unit=TRACE_LABELS, scrypt_n=N_MAIN,
                batch_size=INIT_BATCH, device="cuda")
            torch.cuda.synchronize()
    finally:
        tracing.stop()
    require(meta.labels_written == TRACE_LABELS, f"[trace] {mode} init "
            "wrote every label")
    return meta, res


def trace_cost() -> dict:
    """(a) init's rate with tracing off, on, and on with the bridge inside
    a profiler capture: after an untimed warm-up, ``TRACE_ROUNDS`` of each
    in the turns off, on, bridge, bridge, on, off; every store the same
    bytes."""
    rates: dict = {"off": [], "on": [], "bridge": []}
    with tempfile.TemporaryDirectory(prefix="chip-trace-") as d:
        _, warm = trace_init(d, "off")  # the process's first V at this size
        digest = store_digests(d)
    order = list(rates) + list(reversed(rates))
    for mode in order * (TRACE_ROUNDS // 2):
        with tempfile.TemporaryDirectory(prefix="chip-trace-") as d:
            _, res = trace_init(d, mode)
            got = store_digests(d)
        require(got == digest, f"[trace] the {mode} init's store == the "
                "untraced one's")
        rates[mode].append(res.labels_per_s)
    mean = {k: statistics.mean(v) for k, v in rates.items()}
    log(f"[trace] (a) init of {TRACE_LABELS} labels at N={N_MAIN}, batches "
        f"of {INIT_BATCH}, after an untimed warm-up ({warm.labels_per_s:.0f} "
        f"labels/s), in turns {', '.join(order)}: " + "; ".join(
            f"{k} {', '.join(f'{r:.0f}' for r in v)} labels/s (mean "
            f"{mean[k]:.0f}, {mean[k] / mean['off']:.4f}x off)"
            for k, v in rates.items()) + "; every store sha256-equal")
    return dict(rates=rates, ratio={k: mean[k] / mean["off"] for k in mean})


def chrome_trace(prof) -> list:
    """The profiler's events as Chrome trace-event dicts."""
    with tempfile.TemporaryDirectory(prefix="chip-trace-prof-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def clock_marks() -> None:
    """Three ``trace.clock`` spans on the main thread with the bridge on:
    each is in the ring and, as a ``record_function`` range, in the
    profiler's capture; :func:`profiler_offset_us` pairs them."""
    from spacemesh_tpu_torch.utils import tracing

    for _ in range(3):
        with tracing.span("trace.clock"):
            pass


def profiler_offset_us(events: list, doc: dict) -> tuple:
    """The profiler's clock minus the tracer's, in microseconds, and the
    slack a span's edges need on the profiler's clock, from the
    ``trace.clock`` spans (:func:`clock_marks`) paired in order with their
    ``record_function`` ranges. The range opens before the span reads its
    clock and closes after, so the offset is the median difference of
    their midpoints and the slack the largest half of their length
    difference, plus 2 us."""
    ours = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                   and e["name"] == "trace.clock"), key=lambda e: e["ts"])
    theirs = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e["name"] == "trace.clock"), key=lambda e: e["ts"])
    require(ours and len(ours) == len(theirs), f"[trace] the clock marks "
            f"pair ({len(ours)} spans, {len(theirs)} ranges)")
    off = statistics.median((t["ts"] + t["dur"] / 2) - (o["ts"] + o["dur"] / 2)
                            for t, o in zip(theirs, ours))
    slack = max(max(t["dur"] - o["dur"], 0) / 2
                for t, o in zip(theirs, ours)) + 2
    return off, slack


def path_launches(events: list) -> dict:
    """{correlation: the CUDA runtime or driver launch event} of every
    kernel event of ``TRACE_KERNELS``."""
    corrs = {(e.get("args") or {}).get("correlation") for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"
             and any(n in e["name"] for n in TRACE_KERNELS)}
    return {(e.get("args") or {}).get("correlation"): e for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("cuda_runtime", "cuda_driver")
            and (e.get("args") or {}).get("correlation") in corrs}


def span_threads(events: list, doc: dict) -> tuple:
    """The tracer's spans on the profiler's clock by thread, and which
    tracer thread each profiler thread that launched a path kernel is.
    The profiler names the thread that started it by its system id and
    others by an id of CUPTI's own, so such a thread is matched to the
    tracer thread whose spans enclose every one of its launches most
    tightly (the median length of the innermost enclosing span: a thread
    parked in a long span elsewhere encloses them too, loosely). The main
    thread goes by its system id. Returns ({tracer thread: [(t0, t1,
    name)]}, {profiler thread: tracer thread}); each span widened by the
    clock pairing's slack."""
    import threading

    off, slack = profiler_offset_us(events, doc)
    spans: dict = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] != "trace.clock":
            spans.setdefault(e["tid"], []).append(
                (e["ts"] + off - slack, e["ts"] + off + e["dur"] + slack,
                 e["name"], e["args"]["id"]))
    by_thread: dict = {}
    for e in path_launches(events).values():
        by_thread.setdefault(e["tid"], []).append(e)
    main = threading.main_thread()
    which = {main.native_id: main.ident}
    for tid, evs in by_thread.items():
        if tid in which:
            continue
        best, tightest = None, float("inf")
        for ident, sp in spans.items():
            if ident == main.ident:
                continue
            lengths = []
            for e in evs:
                inner = [s[1] - s[0] for s in sp if s[0] <= e["ts"]
                         and e["ts"] + e.get("dur", 0) <= s[1]]
                if not inner:
                    break
                lengths.append(min(inner))
            else:
                med = statistics.median(lengths)
                if med < tightest:
                    best, tightest = ident, med
        if best is not None:
            which[tid] = best
    return spans, which


def enclosing(spans: dict, which: dict, e: dict):
    """The innermost tracer span on ``e``'s thread that encloses it, or
    None."""
    t0, t1 = e["ts"], e["ts"] + e.get("dur", 0)
    inner = [s for s in spans.get(which.get(e["tid"]), ())
             if s[0] <= t0 and t1 <= s[1]]
    return min(inner, key=lambda s: s[1] - s[0]) if inner else None


class LaunchTap:
    """Stands in for ``ops._build.count_lock`` while (b) runs. Every
    wrapper takes that lock just where it counts a launch, and nowhere
    else, so on release the tap records which counter moved and the
    tracer's current span on the launching thread (the innermost span
    open there). Unlike the profiler's view, it misses no launch."""

    def __init__(self, lock):
        self.lock = lock
        self.taps: list = []
        self._last = launch_counts()

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        from spacemesh_tpu_torch.utils import tracing

        try:
            now = launch_counts()
            moved = [k for k in now if now[k] != self._last[k]]
            self._last = now
            self.taps.append((moved, tracing.current_id()))
        finally:
            self.lock.release()
        return False


def tapped_spans(tap: LaunchTap, doc: dict) -> dict:
    """{kernel of ``TRACE_KERNELS`` or counter name: [id of the span each
    launch was made in, None outside every span]}."""
    known = {e["args"]["id"] for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    out: dict = {}
    for moved, sid in tap.taps:
        key = moved[0] if len(moved) == 1 else "+".join(moved)
        kernel = next((n for n, keys in TRACE_KERNELS.items()
                       if key in keys), key)
        out.setdefault(kernel, []).append(sid if sid in known else None)
    return out


def span_label(doc: dict, sid: int) -> str:
    """``name #k under parent``: the span's place among its parent's
    children of its name (``#k`` counts from 0 in time order)."""
    spans = {e["args"]["id"]: e for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    e = spans[sid]
    par = e["args"].get("parent")
    sibs = sorted((x["ts"], i) for i, x in spans.items()
                  if x["name"] == e["name"] and x["args"].get("parent") == par)
    k = [i for _, i in sibs].index(sid)
    where = spans[par]["name"] if par in spans else "no span"
    return f"{e['name']} #{k} under {where}"


def join_kernels(events: list, doc: dict) -> dict:
    """Each of the paths' kernel events (``TRACE_KERNELS``) joined to its
    launch through the profiler's launch correlation, and the launch to
    the innermost host span of the tracer (``doc``) on the launching
    thread that encloses it. Per kernel: events, joined launches,
    launches inside a span, and those spans' names and ids."""
    launches = path_launches(events)
    spans, which = span_threads(events, doc)
    out: dict = {}
    for k in events:
        if k.get("ph") != "X" or k.get("cat") != "kernel":
            continue
        name = next((n for n in TRACE_KERNELS if n in k["name"]), None)
        if name is None:
            continue
        ent = out.setdefault(name, {"events": 0, "joined": 0, "in_span": 0,
                                    "spans": {}, "ids": []})
        ent["events"] += 1
        launch = launches.get((k.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        ent["joined"] += 1
        span = enclosing(spans, which, launch)
        if span is not None:
            ent["in_span"] += 1
            ent["spans"][span[2]] = ent["spans"].get(span[2], 0) + 1
            ent["ids"].append(span[3])
    return out


def trace_capture() -> dict:
    """(b) one capture of init -> prove -> verify (+ one farm request) with
    the bridge on inside a profiler capture, under the guard."""
    import asyncio

    import torch
    from spacemesh_tpu_torch.ops import proving
    from spacemesh_tpu_torch.post import initializer, prover, verifier
    from spacemesh_tpu_torch.utils import tracing
    from spacemesh_tpu_torch.verify.farm import PostRequest, VerificationFarm

    from spacemesh_tpu_torch.ops import _build

    node, commitment, challenge = trace_ids()
    params = prover.ProofParams()
    tracing.set_process_identity("chip-smoke")
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with tempfile.TemporaryDirectory(prefix="chip-trace-") as d:
        GUARD.start()
        tracing.start(capacity=1 << 17, torch_bridge=True)
        before = launch_counts()
        tap = _build.count_lock = LaunchTap(_build.count_lock)
        t0 = time.perf_counter()
        try:
            with prof:
                clock_marks()
                meta, _ = initializer.initialize(
                    d, node_id=node, commitment=commitment, num_units=1,
                    labels_per_unit=TRACE_LABELS, scrypt_n=N_MAIN,
                    batch_size=INIT_BATCH, device="cuda")
                pv = prover.Prover(d, params, batch_labels=PROVE_BATCH,
                                   device="cuda")
                proof = pv.prove(challenge)
                item = verifier.VerifyItem(
                    proof=proof, challenge=challenge, node_id=node,
                    commitment=commitment, scrypt_n=N_MAIN,
                    total_labels=meta.total_labels)
                with GUARD.paused():
                    bad = dataclasses.replace(proof,
                                              indices=list(proof.indices))
                    bad.indices[0] = replacement_index(
                        proof, commitment, challenge,
                        proving.threshold_u32(params.k1, TRACE_LABELS),
                        TRACE_LABELS)
                verdicts = verifier.verify_many(
                    [item, dataclasses.replace(item, proof=bad)], params,
                    device="cuda")

                async def farm_leg():
                    farm = VerificationFarm(post_params=params,
                                            device="cuda")
                    try:
                        return await farm.submit(PostRequest(item))
                    finally:
                        await farm.aclose()

                farm_ok = asyncio.run(farm_leg())
                torch.cuda.synchronize()
                clock_marks()
        finally:
            _build.count_lock = tap.lock
            tracing.stop()
        wall = time.perf_counter() - t0
        after = launch_counts()
        guard = GUARD.stop()
    require_no_twins(guard, "[trace] capture")
    require(verdicts == [True, False] and farm_ok, f"[trace] verdicts "
            f"{verdicts} + farm {farm_ok} == [True, False] + True")
    doc = tracing.export()
    problems = tracing.validate(doc)
    require(problems == [], f"[trace] the capture validates ({problems})")
    counts: dict = {}
    for e in doc["traceEvents"]:
        if e["ph"] in ("X", "i"):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    missing = [n for n in TRACE_SPANS if n not in counts]
    require(not missing, f"[trace] every span of the path recorded "
            f"(missing {missing})")
    tapped = tapped_spans(tap, doc)
    require(len(tap.taps) == sum(after[k] - before[k] for k in after),
            f"[trace] the tap saw every counted launch ({len(tap.taps)})")
    names = {e["args"]["id"]: e["name"] for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    outside = {k: v.count(None) for k, v in tapped.items() if None in v}
    require(not outside, f"[trace] every kernel launch lies inside a host "
            f"span (outside: {outside})")
    t1 = time.perf_counter()
    events = chrome_trace(prof)
    joined = join_kernels(events, doc)
    join_s = time.perf_counter() - t1
    for name, keys in TRACE_KERNELS.items():
        ent = joined.get(name)
        launched = sum(after[k] - before[k] for k in keys)
        require(launched > 0 and len(tapped.get(name, ())) == launched,
                f"[trace] the path launched {name} ({launched})")
        require(ent is not None and ent["events"] > 0,
                f"[trace] the profiler recorded {name} events")
        require(ent["joined"] == ent["events"], f"[trace] every {name} "
                f"event joins a launch by correlation ({ent})")
        require(ent["in_span"] == ent["events"], f"[trace] every {name} "
                f"event's launch lies inside a host span ({ent})")
        seen = collections.Counter(names[sid] for sid in tapped[name])
        seen.subtract(ent["spans"])
        require(min(seen.values()) >= 0, f"[trace] the profiler puts each "
                f"{name} launch in the span the tracer saw it in ({ent})")
        ent["launches"] = launched
        missed = collections.Counter(tapped[name])
        missed.subtract(ent["ids"])
        ent["missed"] = sorted(span_label(doc, sid)
                               for sid, v in missed.items() for _ in range(v))
    log(f"[trace] (b) one capture, bridge on inside torch.profiler: init "
        f"{TRACE_LABELS} labels -> prove (nonce {proof.nonce}) -> "
        f"verify_many {verdicts} -> one farm request ({farm_ok}) in "
        f"{wall:.2f} s; tracing.validate: no problems; "
        f"{sum(counts.values())} spans: {json.dumps(dict(sorted(counts.items())))}")
    log("[trace] (b) every kernel launch the wrappers counted, by the "
        "tracer's span on its thread: " + "; ".join(
            f"{n} {len(v)} in "
            f"{json.dumps(collections.Counter(names[i] for i in v), sort_keys=True)}"
            for n, v in sorted(tapped.items())))
    log("[trace] (b) kernel events joined to their launch (correlation) and "
        "the launch to its innermost host span: " + "; ".join(
            f"{n} {e['in_span']}/{e['events']} of {e['launches']} launches in "
            f"{json.dumps(e['spans'], sort_keys=True)}"
            + (f", not recorded by the profiler: {json.dumps(e['missed'])}"
               if e["missed"] else "")
            for n, e in sorted(joined.items())) + f" ({join_s:.1f} s)")
    log("[trace] (b) render_summary(summarize(doc)), top 20:\n"
        + tracing.render_summary(tracing.summarize(doc, top=20)))
    return dict(counts=counts, joined=joined)


def launch_span_calls(events: list, doc: dict) -> tuple:
    """The CUDA runtime calls of the threads that launched the path's
    kernels off the main thread (the farm's backend threads): those inside
    the ``romix.dispatch`` spans and all of them, each {API name: [calls,
    us]}, and the us inside the spans in all."""
    import threading

    spans, which = span_threads(events, doc)
    main = threading.main_thread().native_id
    calls: dict = {}
    on_thread: dict = {}
    inside_us = 0.0
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime",
                                                        "cuda_driver")
                or e["tid"] == main or e["tid"] not in which):
            continue
        c = on_thread.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += e.get("dur", 0)
        span = enclosing(spans, which, e)
        if span is not None and span[2] == "romix.dispatch":
            c = calls.setdefault(e["name"], [0, 0.0])
            c[0] += 1
            c[1] += e.get("dur", 0)
            inside_us += e.get("dur", 0)
    return calls, on_thread, inside_us


def trace_verifyd(ctx: dict) -> dict:
    """(c) ``TRACE_POSTS`` of ``[verifyd]``'s proofs through a fresh
    ``VerifydService`` with the bridge on inside a profiler capture: the
    request -> drain -> farm.request -> farm.batch linkage, the POST batch
    broken down by the spans and by the CUDA runtime calls inside the
    launch span, verdicts == ``[verifyd]``'s serial ones."""
    import asyncio

    import torch
    from spacemesh_tpu_torch.ops import _build
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.utils import tracing
    from spacemesh_tpu_torch.verifyd import VerifydService

    v = ctx["verifyd"]
    posts, serial = v["posts"][:TRACE_POSTS], v["serial"][:TRACE_POSTS]
    clients = [f"node{c}" for c in range(VERIFYD_CLIENTS)]
    chunks = [posts[i:i + VERIFYD_REQUEST]
              for i in range(0, len(posts), VERIFYD_REQUEST)]

    async def go():
        svc = VerifydService(post_params=prover.ProofParams(),
                             post_seed=VERIFYD_SEED)
        try:
            await svc.start()
            for c in clients:
                svc.register_client(c, rate=1e9, burst=1e9)
            t0 = time.perf_counter()
            got = await asyncio.gather(*(
                svc.verify(clients[k % len(clients)], c)
                for k, c in enumerate(chunks)))
            return got, time.perf_counter() - t0, dict(svc.farm.post_timing)
        finally:
            await svc.aclose()

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    GUARD.start()
    tracing.start(capacity=1 << 17, torch_bridge=True)
    before = launch_counts()
    tap = _build.count_lock = LaunchTap(_build.count_lock)
    try:
        with prof:
            clock_marks()
            got, wall, timing = asyncio.run(go())
            torch.cuda.synchronize()
            clock_marks()
    finally:
        _build.count_lock = tap.lock
        tracing.stop()
    after = launch_counts()
    guard = GUARD.stop()
    torch.cuda.empty_cache()
    require_no_twins(guard, "[trace] verifyd under capture")
    verdicts = [x for part in got for x in part]
    require(verdicts == serial, "[trace] verifyd under capture: every "
            "verdict == [verifyd]'s serial inline verdict")
    doc = tracing.export()
    problems = tracing.validate(doc)
    require(problems == [], f"[trace] the verifyd capture validates "
            f"({problems})")
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in evs}
    named = {}
    for e in evs:
        named.setdefault(e["name"], []).append(e)

    def parent(e):
        return by_id.get(e["args"].get("parent"), {}).get("name")

    reqs = named.get("verifyd.request", [])
    require(len(reqs) == len(chunks), f"[trace] one verifyd.request span per "
            f"request ({len(reqs)} of {len(chunks)})")
    require(all(parent(e) == "verifyd.request"
                for e in named.get("verifyd.drain", ())),
            "[trace] verifyd.drain under verifyd.request")
    fr = named.get("farm.request", [])
    require(len(fr) == len(posts)
            and all(parent(e) == "verifyd.drain" for e in fr),
            "[trace] every farm.request under verifyd.drain")
    require(all(by_id[e["args"]["batch"]]["name"] == "farm.batch"
                and e["args"]["id"] in by_id[e["args"]["batch"]]["args"][
                    "members"] for e in fr),
            "[trace] every farm.request linked to its farm.batch both ways")
    batches = [e for e in named["farm.batch"] if e["args"]["kind"] == "post"]
    nb = len(batches)
    romix = [e for e in named.get("romix.dispatch", ())
             if parent(e) == "farm.batch"]
    require(len(romix) == nb, f"[trace] one romix.dispatch per POST batch "
            f"under its farm.batch ({len(romix)} of {nb})")
    waits = [e["args"].get("queue_wait_ms", 0.0) for e in fr]
    batch_ms = sum(e["dur"] for e in batches) / nb / 1e3
    launch_ms = sum(e["dur"] for e in romix) / nb / 1e3
    calls, on_thread, inside_us = launch_span_calls(chrome_trace(prof), doc)
    annot_us = sum(a["dur"] for a in romix)
    # every launch the wrappers counted, by the span open on its thread (the
    # tap misses none; the profiler may drop a capture's first records, as
    # (b) shows, so its count of the launch calls is reported, not held)
    require(len(tap.taps) == sum(after[k] - before[k] for k in after),
            f"[trace] the tap saw every counted launch ({len(tap.taps)})")
    per_span = collections.Counter(sid for _, sid in tap.taps)
    in_spans = sum(per_span[e["args"]["id"]] for e in romix)
    require(len(tap.taps) == in_spans == 3 * nb
            and all(per_span[e["args"]["id"]] == 3 for e in romix),
            f"[trace] the three launches of every POST batch lie inside its "
            f"romix.dispatch span ({in_spans} of {len(tap.taps)} counted "
            f"launches, {3 * nb} expected)")
    launched = calls.get("cudaLaunchKernel", [0])[0]
    stages = {k: s / nb * 1e3 for k, s in timing.items()}
    top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:6]
    thread_top = sorted(on_thread.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"[trace] (c) {len(posts)} of [verifyd]'s proofs ({len(chunks)} "
        f"requests of {VERIFYD_REQUEST}, {VERIFYD_CLIENTS} clients) through "
        f"VerifydService under capture in {wall:.3f} s "
        f"({len(posts) / wall:.0f}/s with the profiler on); verdicts == "
        f"serial inline; linkage verifyd.request -> verifyd.drain -> "
        f"farm.request -> farm.batch holds for every request "
        f"({len(reqs)} requests, {len(fr)} farm requests, {nb} POST batches)"
        f"; every counted launch in its batch's romix.dispatch ({in_spans}), "
        f"the profiler's launch calls there {launched} of {3 * nb}")
    log(f"[trace] (c) per POST batch: farm.batch {batch_ms:.2f} ms host wall; "
        f"stages (verify_many timing) " + ", ".join(
            f"{k} {ms:.2f} ms" for k, ms in stages.items())
        + f"; the launch span romix.dispatch {launch_ms:.2f} ms, of which CUDA"
        f" runtime calls {inside_us / max(annot_us, 1e-9):.1%} ("
        + ", ".join(f"{n} x{c} {us / nb / 1e3:.3f} ms" for n, (c, us) in top)
        + f" per batch) and the rest Python under the interpreter lock; "
        f"waiting on the card (the hash stage: the kernels' wait and the "
        f"values' copy) {stages.get('hash', 0.0):.2f} ms; farm queue wait "
        f"p50 {statistics.median(waits):.2f} ms, max {max(waits):.2f} ms")
    log(f"[trace] (c) every CUDA runtime call of the farm's backend threads, "
        f"per POST batch: " + ", ".join(
            f"{n} x{c / nb:.1f} {us / nb / 1e3:.3f} ms"
            for n, (c, us) in thread_top)
        + f"; {sum(us for _, us in on_thread.values()) / nb / 1e3:.2f} ms "
        f"in all of the batch's {batch_ms:.2f} ms")
    return dict(batch_ms=batch_ms, launch_ms=launch_ms, stages=stages,
                runtime_share=inside_us / max(annot_us, 1e-9),
                calls={n: c for n, c in top})


def boot_replicas(n: int) -> list:
    """``n`` verifyd replicas of the port, each ``python -m
    spacemesh_tpu_torch.verifyd`` in its own process on the card (mainnet
    POST parameters), started together; [(process, url)]."""
    import threading

    procs = [subprocess.Popen(
        [sys.executable, "-m", "spacemesh_tpu_torch.verifyd", "--listen",
         "127.0.0.1:0", "--workers", "4", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO) for _ in range(n)]
    docs = [{} for _ in procs]

    def read(p, doc):
        line = p.stdout.readline()
        if line:
            doc.update(json.loads(line))

    readers = [threading.Thread(target=read, args=pd, daemon=True)
               for pd in zip(procs, docs)]
    for t in readers:
        t.start()
    for t in readers:
        t.join(120)
    if not all(docs):
        for p in procs:
            p.kill()
        raise RuntimeError("a verifyd replica did not boot in 120 s")
    return [(p, "http://" + d["listening"]) for p, d in zip(procs, docs)]


def trace_fleet(ctx: dict) -> dict:
    """(d) the fleet trace plane over ``FLEET_REPLICAS`` replicas in their
    own processes: captures started and pulled over ``/debug/trace``,
    ``[fleet]``'s requests from ``FLEET_CALLERS`` callers in between, one
    merged timeline with each replica's role and resolved links."""
    import asyncio

    from spacemesh_tpu_torch.obs.federate import FEDERATION
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.utils import tracing
    from spacemesh_tpu_torch.verify.farm import Lane, VerificationFarm
    from spacemesh_tpu_torch.verifyd import fleet_from_urls

    v = ctx["verifyd"]
    posts, mix = v["posts"], v["mix"]
    clients = [tid for tid, _, _ in ctx["tenants"]["ids"]]
    requests = fleet_requests(posts, mix, clients)
    t0 = time.perf_counter()
    replicas = boot_replicas(FLEET_REPLICAS)
    boot_s = time.perf_counter() - t0

    async def go():
        local = VerificationFarm(post_params=prover.ProofParams(),
                                 post_seed=VERIFYD_SEED,
                                 max_inflight=FLEET_LOCAL_INFLIGHT)
        fv = fleet_from_urls([u for _, u in replicas], farm=local)
        try:
            fv.start()
            started = await fv.router.start_captures(capacity=1 << 17)
            tracing.set_process_identity("fleet-parent")
            tracing.start(capacity=1 << 17, torch_bridge=False)
            out = [None] * len(requests)
            nxt = iter(range(len(requests)))

            async def caller():
                for i in nxt:
                    cid, reqs, _, _ = requests[i]
                    out[i] = await fv.verify_batch(reqs, Lane.GOSSIP,
                                                   client_id=cid)

            t1 = time.perf_counter()
            await asyncio.gather(*(caller() for _ in range(FLEET_CALLERS)))
            wall = time.perf_counter() - t1
            tracing.stop()
            pulled = await fv.router.pull_captures()
            merged = fv.router.merged_capture(parent=tracing.export())
            return started, pulled, merged, out, wall, dict(fv.stats)
        finally:
            tracing.stop()
            await fv.aclose()
            await local.aclose()

    try:
        started, pulled, merged, out, wall, stats = asyncio.run(go())
    finally:
        for p, _ in replicas:
            p.terminate()
        for p, _ in replicas:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        FEDERATION.clear()
    post_v, mix_v = [None] * len(posts), [None] * len(mix.requests)
    for (_, reqs, at, idx), got in zip(requests, out):
        if at is not None:
            post_v[at:at + len(reqs)] = got
        else:
            for i, x in zip(idx, got):
                mix_v[i] = x
    require(post_v == v["serial"] and mix_v == v["mix_inline"],
            "[trace] (d) every verdict through the replica processes == "
            "serial inline")
    names = [f"r{i}" for i in range(FLEET_REPLICAS)]
    require(sorted(started) == names and all(
        started[r] and started[r]["role"] == f"replica-{r}" for r in names),
        f"[trace] a capture started on every replica ({started})")
    require(sorted(pulled) == [f"replica-{r}" for r in names],
            f"[trace] every replica's capture pulled ({sorted(pulled)})")
    for proc, doc in pulled.items():
        require(doc["otherData"]["proc"]["role"] == proc,
                f"[trace] {proc} carries its own role")
    problems = tracing.validate(merged)
    od = merged["otherData"]
    roles = [p["role"] for p in od["procs"]]
    require(problems == [], f"[trace] the merged fleet capture validates "
            f"({problems})")
    require(roles == ["fleet-parent"] + [f"replica-{r}" for r in names],
            f"[trace] one proc per role ({roles})")
    links = od["links"]
    summary = tracing.summarize(merged)
    pairs = summary["cross_proc_links"]["pairs"]
    remote = stats["remote_ok"]
    require(links["unresolved"] == 0 and links["resolved"] >= remote,
            f"[trace] every link token resolved into a cross-replica parent "
            f"edge ({links}, {remote} remote batches)")
    require(pairs.get("fleet.remote->verifyd.request", 0) >= remote,
            f"[trace] fleet.remote -> verifyd.request edges ({pairs})")
    log(f"[trace] (d) {FLEET_REPLICAS} verifyd replicas in their own "
        f"processes on the card (booted together in {boot_s:.1f} s); "
        f"[fleet]'s {len(requests)} requests from {FLEET_CALLERS} callers "
        f"through fleet_from_urls in {wall:.3f} s "
        f"({len(posts) / wall:.0f} proofs/s, captures on); verdicts == "
        f"serial inline; fleet stats {json.dumps(stats)}")
    log(f"[trace] (d) merged capture validates: procs " + ", ".join(
        f"{p['role']} {p['captured_spans']} spans" for p in od["procs"])
        + f"; links {json.dumps(links)}; cross-process edges "
        f"{json.dumps(pairs)}")
    return dict(links=links, roles=roles, boot_s=boot_s)


def trace_health(ctx: dict) -> dict:
    """(e) a ``HealthEngine`` with a flight spool over the main path's
    watchdogs while a prove's window is held on a gate: the ``post.prove``
    stall flips ``/readyz`` of a verifyd server on the card to 503 and,
    after the gate opens, back to 200; the stall's flight bundle
    validates."""
    import asyncio
    import threading
    import urllib.request

    from spacemesh_tpu_torch.obs import flight as flight_mod
    from spacemesh_tpu_torch.obs import health as health_mod
    from spacemesh_tpu_torch.post import initializer, prover
    from spacemesh_tpu_torch.utils import tracing
    from spacemesh_tpu_torch.verifyd import VerifydServer

    node, commitment, challenge = trace_ids()
    gate = threading.Event()
    stall_seen = threading.Event()  # the ticking engine saw the stall
    seen = set()
    statuses = []
    with tempfile.TemporaryDirectory(prefix="chip-trace-health-") as d:
        spool = os.path.join(d, "flight")
        engine = health_mod.HealthEngine(spool_dir=spool)
        tracing.set_process_identity("chip-smoke")
        tracing.start(capacity=1 << 16, torch_bridge=False)
        stop = threading.Event()

        def ticker():
            while not stop.is_set():
                rep = engine.tick()
                seen.update(rep["components"])
                if rep["components"].get("post.prove", {}).get(
                        "healthy") is False:
                    stall_seen.set()
                stop.wait(0.1)

        tick_thread = threading.Thread(target=ticker, daemon=True)
        tick_thread.start()
        try:
            store = os.path.join(d, "post")
            initializer.initialize(
                store, node_id=node, commitment=commitment, num_units=1,
                labels_per_unit=TRACE_LABELS, scrypt_n=N_MAIN,
                batch_size=INIT_BATCH, device="cuda")
            pv = prover.Prover(store, prover.ProofParams(),
                               batch_labels=PROVE_BATCH, device="cuda")
            pv.stall_deadline_s = TRACE_STALL_S
            real_read = pv.store.read_labels

            def gated(start, count):
                gate.wait(120)
                return real_read(start, count)

            pv.store.read_labels = gated

            async def go():
                server = VerifydServer()
                server.health_engine.interval_s = 0.25
                port = await server.start()
                url = f"http://127.0.0.1:{port}/readyz"

                def readyz():
                    try:
                        with urllib.request.urlopen(url, timeout=10) as r:
                            return r.status, json.loads(r.read())
                    except urllib.error.HTTPError as e:
                        return e.code, json.loads(e.read())

                try:
                    prove = asyncio.ensure_future(
                        asyncio.to_thread(pv.prove, challenge))
                    t0 = time.perf_counter()
                    while time.perf_counter() - t0 < 60:
                        status, doc = await asyncio.to_thread(readyz)
                        statuses.append(status)
                        if status == 503:
                            reason = doc["components"]["post.prove"]
                            break
                        await asyncio.sleep(0.25)
                    else:
                        raise RuntimeError("check failed: /readyz never "
                                           "went 503 during the stall")
                    flipped = time.perf_counter() - t0
                    # the server's engine and the ticking one judge the
                    # stall on their own ticks: hold the window until the
                    # ticking engine (the one with the spool) has seen it
                    await asyncio.to_thread(stall_seen.wait, 10)
                    gate.set()
                    proof = await prove
                    t1 = time.perf_counter()
                    while time.perf_counter() - t1 < 60:
                        status, _ = await asyncio.to_thread(readyz)
                        statuses.append(status)
                        if status == 200:
                            break
                        await asyncio.sleep(0.25)
                    return (proof, reason, flipped,
                            time.perf_counter() - t1)
                finally:
                    gate.set()
                    await server.close()

            proof, reason, flipped_s, back_s = asyncio.run(go())
        finally:
            gate.set()
            stop.set()
            tick_thread.join(10)
            tracing.stop()
        require(statuses[-1] == 200, f"[trace] /readyz back to 200 after "
                f"the gate opened ({statuses})")
        require("stalled" in reason["reason"], f"[trace] the post.prove "
                f"reason names the stall ({reason})")
        want = {"post.init", "post.writer", "post.store", "post.prove"}
        require(want <= seen, f"[trace] the engine watched the main path's "
                f"probes ({sorted(seen)})")
        bundles = engine.recorder.bundles()
        require(bundles, "[trace] the stall spooled a flight bundle")
        bundle = flight_mod.read_bundle(bundles[-1])  # validates trace.json
        require("stall:post.prove" in bundle["manifest"]["reason"],
                f"[trace] the bundle's reason ({bundle['manifest']['reason']})")
        names = {e["name"] for e in bundle["trace"]["traceEvents"]}
        # spans record when they end: the stalled window's are still open
        require({"init.run", "init.dispatch", "prove.k2pow"} <= names,
                "[trace] the bundle's trace holds the path's spans")
        files = sorted(os.listdir(bundles[-1]))
        log(f"[trace] (e) HealthEngine over {sorted(seen)}: a prove's window "
            f"held on a gate with a {TRACE_STALL_S:.0f} s watchdog deadline; "
            f"verifyd /readyz on the card went 503 after {flipped_s:.2f} s "
            f"({reason['reason']}), and 200 again {back_s:.2f} s after the "
            f"gate opened (nonce {proof.nonce}; statuses {statuses}); flight "
            f"bundle {os.path.basename(bundles[-1])} ({', '.join(files)}) "
            f"validates: reason {bundle['manifest']['reason']!r}, "
            f"{len(bundle['trace']['traceEvents'])} trace events, "
            f"{bundle['metrics_samples']} metric samples")
    return dict(flipped_s=flipped_s, back_s=back_s)


def trace_sanitize(ctx: dict) -> dict:
    """(f) the ``[tenants]`` and ``[verifyd]`` share of ``[trace]`` with the
    sanitizers armed (race, registry-thread, slow-callback) before the
    objects are built: a packed init of ``SANITIZE_TENANTS`` identities,
    their proves and k2pow searches through the scheduler, and
    ``SANITIZE_POSTS`` of ``[verifyd]``'s proofs through a fresh service."""
    import asyncio

    import torch
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.runtime import TenantScheduler
    from spacemesh_tpu_torch.utils import metrics, sanitize
    from spacemesh_tpu_torch.verifyd import VerifydService

    v = ctx["verifyd"]
    posts, serial = v["posts"][:SANITIZE_POSTS], v["serial"][:SANITIZE_POSTS]
    ids = tenant_ids(b"sanitize")[:SANITIZE_TENANTS]
    params = prover.ProofParams()
    sanitize.clear_violations()
    sanitize.enable(modes=["race", "registry-thread", "slow-callback"])
    t0 = time.perf_counter()
    try:
        GUARD.start()
        with tempfile.TemporaryDirectory(prefix="chip-trace-san-") as d:
            with TenantScheduler(device="cuda") as sched:
                require(isinstance(sched._lock, sanitize.TrackedLock),
                        "[trace] the scheduler's lock is tracked")
                for tid, _, _ in ids:
                    sched.register_tenant(tid)
                metas = [h.result(timeout=600)
                         for h in submit_inits(sched, d, ids, TENANT_LABELS)]
                proofs = [h.result(timeout=600) for h in [
                    sched.submit_prove(tid, os.path.join(d, tid),
                                       ctx["tenants"]["challenge"], params)
                    for tid, _, _ in ids]]
                pows = [h.result(timeout=600) for h in [
                    sched.submit_pow(tid, ctx["tenants"]["challenge"], node,
                                     params.pow_difficulty)
                    for tid, node, _ in ids]]
                for tid, _, _ in ids:
                    sched.unregister_tenant(tid)

        async def go():
            svc = VerifydService(post_params=params, post_seed=VERIFYD_SEED)
            try:
                await svc.start()
                for c in range(VERIFYD_CLIENTS):
                    svc.register_client(f"node{c}", rate=1e9, burst=1e9)
                got = await asyncio.gather(*(
                    svc.verify(f"node{k % VERIFYD_CLIENTS}",
                               posts[i:i + VERIFYD_REQUEST])
                    for k, i in enumerate(range(0, len(posts),
                                                VERIFYD_REQUEST))))
                return [x for part in got for x in part]
            finally:
                await svc.aclose()

        verdicts = asyncio.run(go())
        torch.cuda.synchronize()
        guard = GUARD.stop()
    finally:
        sanitize.disable()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    found = sanitize.violations()
    sanitize.clear_violations()
    require_no_twins(guard, "[trace] sanitized tenants and verifyd")
    require(all(m.labels_written == TENANT_LABELS for m in metas)
            and all(p is not None for p in proofs)
            and all(p is not None for p in pows),
            "[trace] the sanitized scheduler run finished every job")
    require(verdicts == serial, "[trace] sanitized verifyd: every verdict "
            "== serial inline")
    kinds: dict = {}
    for x in found:
        kinds[x.kind] = kinds.get(x.kind, 0) + 1
    fatal = [x for x in found if x.kind != sanitize.KIND_SLOW]
    require(not fatal, "[trace] no race/registry-thread violation: " + "; ".join(
        f"{x.kind}: {x.detail} [{x.stack}]" for x in fatal[:5]))
    slow = [x for x in found if x.kind == sanitize.KIND_SLOW]
    log(f"[trace] (f) sanitizers race + registry-thread + slow-callback "
        f"armed: {SANITIZE_TENANTS} identities x {TENANT_LABELS} labels of "
        f"packed init, {len(proofs)} proves and {len(pows)} k2pow through "
        f"TenantScheduler, {len(posts)} of [verifyd]'s proofs through "
        f"VerifydService (verdicts == serial) in {secs:.1f} s: violations "
        f"{json.dumps(kinds)}; 0 race, 0 lock-order, 0 registry-thread; "
        f"slow-callback {len(slow)}"
        + (f" (longest {max(x.seconds for x in slow) * 1e3:.0f} ms: "
           f"{max(slow, key=lambda x: x.seconds).detail[:160]})"
           if slow else ""))
    return dict(violations=kinds, slow=len(slow))


def runtime_fallbacks() -> float:
    from spacemesh_tpu_torch.utils import metrics

    return sum(metrics.runtime_fallbacks.sample().values())


def phase_trace(ctx: dict) -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    parts = {}
    for key, fn in (("cost", lambda: trace_cost()),
                    ("capture", lambda: trace_capture()),
                    ("verifyd", lambda: trace_verifyd(ctx)),
                    ("fleet", lambda: trace_fleet(ctx)),
                    ("health", lambda: trace_health(ctx)),
                    ("sanitize", lambda: trace_sanitize(ctx))):
        t0 = time.perf_counter()
        parts[key] = fn()
        parts[key]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    fallbacks = runtime_fallbacks()
    require(fallbacks == 0, f"runtime_fallbacks_total reads 0 on every path "
            f"({fallbacks})")
    log(f"[trace] runtime_fallbacks_total {fallbacks:.0f} over every path "
        f"of the run; phase {time.perf_counter() - t_phase:.1f} s (" + ", ".join(
            f"{k} {p['s']:.1f} s" for k, p in parts.items()) + ")")
    log(f"[trace] {ctx['smi']}")
    ctx["trace"] = parts


def path_twins(widest: dict) -> dict:
    """The verify path's kernels against their plain twins at the
    ``[verifyd]`` path's two shapes, on the widest farm recompute's real
    inputs (as the cold run's taps kept them on the card): the whole
    recompute (per-lane commitments, challenges and nonces, k3 lanes per
    proof) and its first proof's k3 lanes (the shape of a serial verify):
    expand, ROMix, finish with the proving hash (and finish alone and the
    standalone hash over its words). One plain ROMix call covers both
    shapes' lanes (ROMix is lane-wise: each lane's output depends on that
    lane's input alone). Returns max_abs_err by shape and kernel."""
    import torch
    from spacemesh_tpu_torch.ops import pbkdf2_cuda, proving_cuda, romix_cuda
    from spacemesh_tpu_torch.post import prover

    k3 = prover.ProofParams().k3
    n = widest["n"]
    errs, blocks = {}, []
    for shape, sl in ((f"({widest['b']},)", slice(None)),
                      (f"({k3},)", slice(0, k3))):
        cw, lo, hi, ch, nonce = (widest[k][..., sl].contiguous() for k in (
            "cw", "lo", "hi", "ch", "nonce"))
        blk = pbkdf2_cuda.expand(cw, lo, hi)
        inner, outer, want = pbkdf2_cuda._expand(cw, lo, hi)
        mixed = romix_cuda.romix(blk, n)
        values, words = pbkdf2_cuda.finish_hash(cw, mixed, ch, nonce, lo, hi,
                                                words_out=True)
        plain_words = pbkdf2_cuda._pbkdf2_second(inner, outer, mixed)[:4]
        plain_values = proving_cuda.proving_hash_plain(
            ch, nonce, lo, hi, plain_words, big_endian=True)
        errs[shape] = {
            "pbkdf2_expand": max_abs_err(blk, want),
            "pbkdf2_finish": max_abs_err(pbkdf2_cuda.finish(cw, mixed),
                                         plain_words),
            "pbkdf2_finish_hash": max(max_abs_err(values, plain_values),
                                      max_abs_err(words, plain_words)),
            "proving_hash": max_abs_err(
                proving_cuda.proving_hash(ch, nonce, lo, hi, words,
                                          big_endian=True), plain_values)}
        blocks.append((shape, blk, mixed))
    plain = romix_cuda.romix_r1(torch.cat([b for _, b, _ in blocks], dim=1),
                                n)
    c0 = 0
    for shape, blk, mixed in blocks:
        c1 = c0 + blk.shape[1]
        errs[shape]["romix"] = max_abs_err(mixed, plain[:, c0:c1])
        c0 = c1
    return errs


def tap_labels(taps: list) -> list:
    """The cold run's taps -> up to 32 (commitment, index, N, label bytes)
    samples, spread over the run, read back from the card."""
    import numpy as np
    from spacemesh_tpu_torch.ops import scrypt, u32

    out = []
    for n, cw, lo, hi, words in taps[::max(len(taps) // 16, 1)][:16]:
        cw, lo, hi = (u32.to_numpy(t) for t in (cw, lo, hi))
        labels = scrypt.labels_to_bytes(words)
        for j in range(2):
            out.append((cw[:, j].astype(">u4").tobytes(),
                        int(lo[j]) | int(hi[j]) << 32, n,
                        labels[16 * j:16 * j + 16]))
    return out


def check_taps(picks: list) -> None:
    """Sampled (commitment, index, N, label) of the farm's recomputes
    against hashlib.scrypt, in threads."""
    from concurrent.futures import ThreadPoolExecutor

    def want(p):
        commit, idx, n, _ = p
        return hashlib.scrypt(commit, salt=idx.to_bytes(8, "little"), n=n,
                              r=1, p=1, dklen=16)

    require(len(picks) >= 8, f"sampled {len(picks)} recomputed labels")
    with ThreadPoolExecutor(8) as pool:
        for p, w in zip(picks, pool.map(want, picks)):
            require(p[3] == w, f"recomputed label {p[1]} == hashlib.scrypt")


def v_alloc_ms() -> float:
    """Host milliseconds of one allocation of an init batch's ROMix V
    scratch with the allocator's cache emptied first, as the main path's
    first batch finds it; the cache is emptied again after."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v = torch.empty((INIT_BATCH, N_MAIN, 32), dtype=torch.int32,
                    device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del v
    torch.cuda.empty_cache()
    return ms


def envelope_calls() -> int:
    """Torch calls one init batch makes around the kernels on the card:
    the wrappers of PBKDF2 expand, ROMix and PBKDF2 finish, and the VRF
    min-scan (the count does not depend on the batch size or N)."""
    import numpy as np
    import torch
    from spacemesh_tpu_torch.ops import scrypt, u32

    class Count(torch.overrides.TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    dev = "cuda"
    cw = u32.from_numpy(scrypt.commitment_to_words(bytes(32)), dev)
    lo = u32.from_numpy(np.arange(64, dtype=np.uint32), dev)
    hi = torch.zeros(64, dtype=torch.int32, device=dev)
    carry = u32.from_numpy(scrypt.vrf_carry_init(), dev)
    with Count():
        scrypt.scrypt_labels_with_min(cw, lo, hi, carry, n=16)
    torch.cuda.synchronize()
    return Count.calls


def replacement_index(proof, commitment, challenge, thr, total) -> int:
    """An index outside the proof whose proving hash misses the threshold
    (hashlib label, plain CPU hash), so the tampered proof must fail."""
    import numpy as np
    from spacemesh_tpu_torch.ops import proving

    cand = (proof.indices[0] + 1) % total
    while True:
        if cand not in proof.indices:
            label = np.frombuffer(hashlib.scrypt(
                commitment, salt=cand.to_bytes(8, "little"), n=N_MAIN, r=1,
                p=1, dklen=16), dtype=np.uint8)[None]
            val = proving.proving_hashes(challenge, proof.nonce, [cand],
                                         label, device="cpu")[0]
            if val >= thr:
                return cand
        cand = (cand + 1) % total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    ctx: dict = {}
    t0 = time.perf_counter()
    phase_device(ctx)
    phase_native(ctx)
    phase_romix(ctx)
    GUARD.install()
    phase_pbkdf2(ctx)
    phase_proving_hash(ctx)
    phase_finish_hash(ctx)
    phase_k2pow(ctx)
    phase_scan(ctx)
    phase_main_path(ctx)
    phase_worker(ctx)
    phase_tenants(ctx)
    phase_verifyd(ctx)
    phase_fleet(ctx)
    phase_atx(ctx)
    phase_consensus(ctx)
    phase_trace(ctx)
    extra = {"romix": {k: ctx["romix"][k] for k in ("fill_ms",
                                                     "scratch_bound_ms")},
             "scan": {"full_width": {k: ctx["scan_full"][k] for k in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by")}},
             "pbkdf2_expand": {k: ctx["pbkdf2_expand"][k] for k in (
                 "kernel_ms", "perlane", "verify_width", "ragged")},
             "pbkdf2_finish": {k: ctx["pbkdf2_finish"][k] for k in (
                 "kernel_ms", "perlane", "verify_width", "ragged")},
             "pbkdf2_finish_hash": {k: ctx["pbkdf2_finish_hash"][k] for k in (
                 "kernel_ms", "finish_fh_fh_finish_ms", "hash_ms",
                 "hash_bound_ms")},
             "proving_hash": {k: ctx["proving_hash"][k] for k in (
                 "kernel_ms", "serial", "verify_width", "shared")},
             "k2pow_search": {k: ctx["k2pow_search"][k] for k in (
                 "kernel_ms", "plain_form_kernel_ms",
                 "plain_imad_imad_plain_ms", "nonces_per_s", "blocks",
                 "searches")},
             "k2pow_search_mask": {
                 "kernel_ms": ctx["k2pow_search_mask"]["kernel_ms"]},
             "k2pow_verify": {k: ctx["k2pow_verify"][k] for k in (
                 "kernel_ms", "widest")}}
    for key in ("proving_hash", "k2pow_verify"):
        extra[key]["empty_kernel"] = ctx["empty_kernel"]
    extra["pbkdf2_finish_hash"]["atx_batch"] = {
        k: ctx["atx"]["finish_hash"][k] for k in (
            "kernel_ms", "ms", "bound_ms", "finish_fh_fh_finish_ms")}
    for key in extra:
        extra[key]["tenants_launches"] = ctx["tenants"]["launches"][key]
        extra[key]["verifyd_launches"] = ctx["verifyd"]["launches"][key]
        extra[key]["fleet_launches"] = ctx["fleet"]["launches"][key]
        extra[key]["atx_launches"] = ctx["atx"]["launches"][key]
        twins = ctx["verifyd"]["twins"]
        if all(key in errs for errs in twins.values()):
            extra[key]["verifyd_max_abs_err"] = {
                shape: errs[key] for shape, errs in twins.items()}
    envelope = ("spacemesh_tpu/ops/scrypt.py:440 (XLA-fused envelope, no "
                "Pallas kernel)")
    xla = " (XLA, no Pallas kernel)"
    kernels = []
    for key, name, source, replaces in (
            ("romix", "romix_r1", "spacemesh_tpu_torch/csrc/romix.cu",
             "spacemesh_tpu/ops/romix_pallas.py:96"),
            ("scan", "proving_scan", "spacemesh_tpu_torch/csrc/proving_scan.cu",
             "spacemesh_tpu/ops/proving_pallas.py:65"),
            ("pbkdf2_expand", "pbkdf2_expand",
             "spacemesh_tpu_torch/csrc/pbkdf2.cu", envelope),
            ("pbkdf2_finish", "pbkdf2_finish",
             "spacemesh_tpu_torch/csrc/pbkdf2.cu", envelope),
            ("pbkdf2_finish_hash", "pbkdf2_finish_hash",
             "spacemesh_tpu_torch/csrc/pbkdf2.cu",
             "spacemesh_tpu/ops/proving.py:60" + xla + " after " + envelope),
            ("proving_hash", "proving_hash",
             "spacemesh_tpu_torch/csrc/proving_scan.cu",
             "spacemesh_tpu/ops/proving.py:60" + xla),
            ("k2pow_search", "k2pow_search_window",
             "spacemesh_tpu_torch/csrc/k2pow.cu",
             "spacemesh_tpu/ops/pow.py:39" + xla),
            ("k2pow_search_mask", "k2pow_search_mask",
             "spacemesh_tpu_torch/csrc/k2pow.cu",
             "spacemesh_tpu/ops/pow.py:39" + xla),
            ("k2pow_verify", "k2pow_verify",
             "spacemesh_tpu_torch/csrc/k2pow.cu",
             "spacemesh_tpu/ops/pow.py:190" + xla)):
        m = ctx[key]
        path, launches = "main", ctx["launches"][key]
        if key in OFF_PATH:  # launched by no path: 0 on all four
            path = "none"
        if key == "k2pow_verify":
            path, launches = "verifyd", ctx["verifyd"]["launches"][key]
            extra[key]["main_launches"] = ctx["launches"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "shape": m["shape"], **extra[key]})
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(ctx["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
