"""Registry of device workload kinds, their warm-up recipes, and the host
helpers of packed init.

Port of ``spacemesh_tpu/runtime/workloads.py``. The kinds:

* ``init``         — single-identity label batches chained to the VRF
                     min-scan on the device (``post/initializer.py``).
* ``init_pack``    — the multi-tenant packed variant: one label batch over
                     many identities' lanes (per-lane commitment words), the
                     VRF minimum folded per tenant on the host
                     (``runtime/scheduler.py``).
* ``prove_scan``   — the prover's scan step (``post/prover.py``).
* ``verify``       — the batched verifier's label recompute (per-lane
                     commitments) and proving hash.
* ``k2pow``        — the SHA-256 nonce-search window (``ops/pow.py``).
* ``k2pow_verify`` — the per-item k2pow witness verification batch.

Each kind carries a ``warm(n, batch, device="cuda")`` recipe that runs
every kernel and PyTorch op the kind runs, once, at one (N, batch) shape,
and returns ``{program: seconds}``. XLA's compiles have no counterpart
here; what a first call pays on the card is building the four kernel
libraries (``ops/_build.py``) and PyTorch's lazy load of its own CUDA
kernels, which the first init batch of a process pays otherwise.

:func:`fold_min_host` is the per-tenant VRF running minimum over fetched
label bytes, bit-identical to the device min-scan's first-occurrence
LE-u128 argmin, and :class:`PackSegment` one tenant's lanes in a pack.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class WorkloadKind:
    """One registered device workload kind."""

    name: str
    description: str
    # warm(n, batch, device="cuda") -> {program name: seconds}
    warm: Callable[..., dict]


_REGISTRY: dict[str, WorkloadKind] = {}


def register(kind: WorkloadKind) -> WorkloadKind:
    if kind.name in _REGISTRY:
        raise ValueError(f"workload kind {kind.name!r} already registered")
    _REGISTRY[kind.name] = kind
    return kind


def registered() -> list[WorkloadKind]:
    """All registered kinds, in a stable order."""
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get(name: str) -> WorkloadKind:
    return _REGISTRY[name]


# --- warm recipes ---------------------------------------------------------


def _timed(doc: dict, name: str, dev, fn) -> None:
    import torch

    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    doc[name] = round(time.perf_counter() - t0, 4)


def _lanes(batch: int, dev):
    import numpy as np

    from ..ops import scrypt, u32

    lo, hi = scrypt.split_indices(np.arange(batch, dtype=np.uint64))
    return u32.from_numpy(lo, dev), u32.from_numpy(hi, dev)


def _perlane_commitments(batch: int, dev):
    """(8, batch) commitment words of two identities, half the lanes each:
    the packed program's distinguishing input."""
    import hashlib

    import numpy as np

    from ..ops import scrypt, u32

    cw = np.stack([
        scrypt.commitment_to_words(hashlib.sha256(b"warm-%d" % i).digest())
        for i in range(2)], axis=1)
    return u32.from_numpy(np.repeat(cw, (batch + 1) // 2, axis=1)[:, :batch],
                          dev)


def _warm_init(n: int, batch: int, device="cuda") -> dict:
    import hashlib

    from ..device import resolve
    from ..ops import scrypt, u32

    dev = resolve(device)
    cw = u32.from_numpy(scrypt.commitment_to_words(
        hashlib.sha256(b"warm-runtime").digest()), dev)
    lo, hi = _lanes(batch, dev)
    doc: dict = {}
    _timed(doc, "labels", dev,
           lambda: scrypt.scrypt_labels_words(cw, lo, hi, n=n))
    _timed(doc, "labels_min", dev, lambda: scrypt.scrypt_labels_with_min(
        cw, lo, hi, u32.from_numpy(scrypt.vrf_carry_init(), dev), n=n))
    return doc


def _warm_init_pack(n: int, batch: int, device="cuda") -> dict:
    from ..device import resolve
    from ..ops import scrypt

    dev = resolve(device)
    cw = _perlane_commitments(batch, dev)
    lo, hi = _lanes(batch, dev)
    doc: dict = {}
    _timed(doc, "labels_perlane", dev,
           lambda: scrypt.scrypt_labels_packed(cw, lo, hi, n=n))
    return doc


def _warm_prove_scan(n: int, batch: int, device="cuda") -> dict:
    import torch

    from ..device import resolve
    from ..ops import proving

    dev = resolve(device)
    seg = proving.HIT_SEGMENT
    b = -(-batch // seg) * seg
    ng, cap = 16, 37  # the prover's nonce group and mainnet k2
    lo, hi = _lanes(b, dev)
    lw = torch.zeros((4, b), dtype=torch.int32, device=dev)
    counts, carry = proving.init_hit_state(ng, cap, dev)
    doc: dict = {"batch": b}
    _timed(doc, "prove_scan_step", dev, lambda: proving.prove_scan_step(
        proving.challenge_words(bytes(32)), 0, lo, hi, lw, 1 << 30, counts,
        carry, b, 0, 0, n_nonces=ng, max_hits=cap))
    return doc


def _warm_verify(n: int, batch: int, device="cuda") -> dict:
    import numpy as np
    import torch

    from ..device import resolve
    from ..ops import proving, u32

    # the verifier's second pass: proving-hash values over recomputed labels
    # (its first pass is init_pack's per-lane label batch)
    dev = resolve(device)
    doc = _warm_init_pack(n, batch, device=dev)
    chal = np.broadcast_to(proving.challenge_words(bytes(32))[:, None],
                           (8, batch))
    lo, hi = _lanes(batch, dev)
    lw = torch.zeros((4, batch), dtype=torch.int32, device=dev)
    _timed(doc, "proving_hash", dev, lambda: proving.proving_hash(
        u32.from_numpy(chal, dev), u32.from_numpy(np.full(batch, 7), dev),
        lo, hi, lw))
    return doc


def _warm_k2pow(n: int, batch: int, device="cuda") -> dict:
    import numpy as np

    from ..device import resolve
    from ..ops import pow_cuda

    # one search window of ``batch`` nonces, its first nonce the winner
    dev = resolve(device)
    block1 = np.zeros(16, dtype=np.uint32)
    tgt = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
    doc: dict = {}
    _timed(doc, "pow_window", dev, lambda: pow_cuda.search_window(
        block1, tgt, 0, batch, pow_cuda.new_cell(dev), dev))
    return doc


def _warm_k2pow_verify(n: int, batch: int, device="cuda") -> dict:
    import hashlib

    import numpy as np

    from ..device import resolve
    from ..ops import pow as k2pow
    from ..ops import u32

    dev = resolve(device)
    block1 = np.stack([np.frombuffer(
        hashlib.sha256(b"warm-powv-%d" % i).digest() * 2,
        dtype=">u4").astype(np.uint32) for i in range(batch)], axis=1)
    targets = np.full((8, batch), 0xFFFFFFFF, dtype=np.uint32)
    lo, hi = _lanes(batch, dev)
    doc: dict = {"batch": batch}
    _timed(doc, "pow_verify_batch", dev, lambda: k2pow.pow_verify_batch(
        u32.from_numpy(block1, dev), lo, hi, u32.from_numpy(targets, dev)))
    return doc


INIT = register(WorkloadKind(
    "init", "label batch + on-device VRF min-scan", _warm_init))
INIT_PACK = register(WorkloadKind(
    "init_pack", "multi-tenant packed label batch (per-lane commitments)",
    _warm_init_pack))
PROVE_SCAN = register(WorkloadKind(
    "prove_scan", "prove scan step (compact+merge on device)",
    _warm_prove_scan))
VERIFY = register(WorkloadKind(
    "verify", "batched POST verify recompute (per-lane labels + hash)",
    _warm_verify))
K2POW = register(WorkloadKind(
    "k2pow", "SHA-256 k2pow nonce-search window", _warm_k2pow))
K2POW_VERIFY = register(WorkloadKind(
    "k2pow_verify", "per-item-prefix k2pow witness verification batch",
    _warm_k2pow_verify))


# --- packed-init host helpers ---------------------------------------------


@dataclasses.dataclass
class PackSegment:
    """One tenant's contiguous lane range inside a packed dispatch."""

    job: object          # scheduler _InitJob
    start: int           # global label index of the segment's first lane
    count: int           # lanes of the segment
    lane0: int           # first lane inside the packed batch


def fold_min_host(carry, label_bytes: bytes, start_index: int):
    """Fold one segment's labels into a per-tenant VRF running minimum.

    ``carry`` is ``None`` or ``(value_u128, index)``. Bit-identical to the
    device min-scan (``ops/scrypt.py:_minscan``): the label's 16 bytes read
    as a little-endian u128, ties keep the earlier index (``np.lexsort``
    puts the first occurrence first). A pack spans many tenants, so the
    single-carry device scan cannot fold it.
    """
    import numpy as np

    if not label_bytes:
        return carry
    halves = np.frombuffer(label_bytes, dtype="<u8").reshape(-1, 2)
    lo, hi = halves[:, 0], halves[:, 1]
    # primary key hi, then lo, then index: the first element of the
    # lexsort is the minimum with the smallest index
    best = int(np.lexsort((np.arange(lo.shape[0]), lo, hi))[0])
    value = (int(hi[best]) << 64) | int(lo[best])
    index = start_index + best
    if carry is None or value < carry[0] \
            or (value == carry[0] and index < carry[1]):
        return (value, index)
    return carry


def min_carry_to_meta(carry) -> tuple[int | None, str | None]:
    """(vrf_nonce, vrf_nonce_value hex) for PostMetadata: the byte layout
    ``post/initializer.py`` persists (lo u64 || hi u64, LE)."""
    if carry is None:
        return None, None
    value, index = carry
    lo = value & 0xFFFFFFFFFFFFFFFF
    hi = value >> 64
    return index, (lo.to_bytes(8, "little") + hi.to_bytes(8, "little")).hex()
