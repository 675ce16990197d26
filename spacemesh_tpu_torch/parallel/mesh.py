"""The POST pipeline striped over the process-wide topology.

Port of ``spacemesh_tpu/parallel/mesh.py``. One parallelism axis matters
for this workload: the label batch, spanning one identity's index range
or many identities' ranges (per-lane commitments). Everything is lane
arithmetic with no cross-lane dataflow except reductions (the init
statistics, the VRF min-scan, the prover's hit state), so the lane axis
is split into stripes (``parallel/topology.py``), each stripe runs the
kernel wrappers (``ops/{pbkdf2,romix,proving}_cuda.py``) on its own
device and stream, and the small results are combined on stripe 0's
stream, in lane order. No kernel is added.

The meshes and their layouts are not built here: ``parallel/topology.py``
builds each device list's once, and these entry points take them from
its catalog.

Results come back per stripe: the label entry points return one (4, b_k)
tensor per stripe in lane order (an empty stripe, when a batch has fewer
lanes than the mesh has stripes, gives a (4, 0) tensor), each living on
its stripe's device and stream; :func:`host_copies` fetches them. The
combined values (the VRF carry's snapshot, the init statistics, the hit
state) live on stripe 0's device and stream.

ROMix's scratch is N x 128 bytes a lane, and its wrapper caps a launch to
the free memory of its device. Stripes that share a device would each
count all of it, so the cap is read once per device and batch: when the
stripes' lanes fit it together, each stripe runs at once on its own
stream; when they do not, they run in turn on the first of them's
stream, each then capped as a single-device batch would be. A lane chunk
comes only from the caller's ``chunk`` (the autotuned decision,
``ops/autotune.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import proving, proving_cuda, romix_cuda, scrypt, u32
from ..ops.u32 import DTYPE, flip
from . import topology

DATA_AXIS = topology.DATA_AXIS
_U32 = 0xFFFFFFFF


def data_mesh(devices=None) -> topology.Mesh:
    """The topology's mesh over all (or the given) devices: the same Mesh
    object on every call for a given device list."""
    if devices is None:
        return topology.get().layouts().mesh
    return topology.get().layouts_for_devices(list(devices)).mesh


def _layouts(mesh: topology.Mesh) -> topology.MeshLayouts:
    return topology.get().layouts_for(mesh)


def lane_sharding(mesh: topology.Mesh) -> topology.MeshLayouts:
    """The layouts whose ``put_lane`` stripes a word-major (words, B)
    array's lane axis over ``mesh`` (the autotuner's mesh rows place
    their calibration block with it). Served from the topology's
    catalog, never built per call."""
    return _layouts(mesh)


def replicate(mesh: topology.Mesh, value) -> list[torch.Tensor]:
    """``value`` on every stripe's device; a no-op when it already lives
    there (``topology.MeshLayouts.replicate``)."""
    return _layouts(mesh).replicate(value)


def host_copies(mesh: topology.Mesh, parts) -> list:
    """One ``device.HostCopy`` per stripe's tensor, each enqueued on its
    stripe's stream (``None`` for an empty stripe)."""
    from ..device import HostCopy

    lay = _layouts(mesh)
    out = []
    for k, t in enumerate(parts):
        if t is None or t.shape[-1] == 0:
            out.append(None)
            continue
        with lay.stream(k):
            out.append(HostCopy(t))
    return out


# --- stream plumbing --------------------------------------------------------


def _join(lay: topology.MeshLayouts, k: int, tensors) -> list:
    """Stripe ``k``'s tensors on stripe 0's device, ready on stripe 0's
    stream (which must be current)."""
    s0, sk = lay.streams[0], lay.streams[k]
    cross = sk is not None and sk is not s0
    if cross:
        s0.wait_stream(sk)
    dev0 = lay.mesh.devices[0]
    out = []
    for t in tensors:
        if cross:
            t.record_stream(s0)
        out.append(t.to(dev0, non_blocking=True))
    return out


def _broadcast(lay: topology.MeshLayouts, t: torch.Tensor) -> list:
    """A tensor made on stripe 0's stream, on every stripe's device and
    ready on its stream: the replicated carry of the next batch."""
    s0 = lay.streams[0]
    out = []
    for k, dev in enumerate(lay.mesh.devices):
        sk = lay.streams[k]
        if sk is None or sk is s0:
            out.append(t)
            continue
        with lay.stream(k):
            sk.wait_stream(s0)
            t.record_stream(sk)
            out.append(t.to(dev, non_blocking=True))
    return out


def _romix_plan(lay: topology.MeshLayouts, n: int, sizes: list[int],
                chunk: int | None) -> list[tuple[int, int | None]]:
    """(stripe whose stream runs it, ROMix ``max_lanes``) per stripe.

    Stripes on one card run at once when their scratch fits the card's
    free memory together, each launch as wide as the decision says
    (``chunk``, else the whole stripe). Otherwise they run in turn on the
    first such stripe's stream, each launch then capped by the wrapper's
    own ``lanes_that_fit`` (a later stripe reuses the scratch an earlier
    one freed on that stream)."""
    plan: list[tuple[int, int | None]] = [(k, chunk) for k in range(len(sizes))]
    groups: dict[str, list[int]] = {}
    for k, dev in enumerate(lay.mesh.devices):
        if dev.type == "cuda" and sizes[k]:
            groups.setdefault(str(dev), []).append(k)
    for ks in groups.values():
        if len(ks) < 2:
            continue  # alone on its card: the wrapper's own cap holds
        fit = romix_cuda.lanes_that_fit(n, lay.mesh.devices[ks[0]])
        widths = [min(chunk or sizes[k], sizes[k]) for k in ks]
        if sum(widths) <= fit:
            for k, w in zip(ks, widths):
                plan[k] = (k, w)
        else:
            for k in ks:
                plan[k] = (ks[0], chunk)
    return plan


def _run_stripes(lay: topology.MeshLayouts, n: int, sizes: list[int],
                 chunk: int | None, inputs: list[tuple], fn) -> list:
    """``fn(k, max_lanes)`` for each non-empty stripe on the stream the
    ROMix plan gives it; its outputs end ready on the stripe's own
    stream. Returns each stripe's outputs (``None`` for an empty one)."""
    plan = _romix_plan(lay, n, sizes, chunk)
    out: list = []
    for k, (run, max_lanes) in enumerate(plan):
        if not sizes[k]:
            out.append(None)
            continue
        own, via = lay.streams[k], lay.streams[run]
        moved = via is not own
        if moved:  # in turn, on another stripe's stream of the same card
            via.wait_stream(own)
            for t in inputs[k]:
                t.record_stream(via)
        with lay.stream(run):
            res = fn(k, max_lanes)
        if moved:
            own.wait_stream(via)
            for t in res:
                if t is not None:
                    t.record_stream(own)
        out.append(res)
    return out


def _commitments(lay: topology.MeshLayouts, commitment_words) -> list:
    """(8,) shared commitment words on every stripe, or (8, B) per-lane
    words striped with the lanes."""
    cw = np.asarray(commitment_words, dtype=np.uint32)
    return lay.put_lane(cw) if cw.ndim == 2 else lay.replicate(cw)


def _empty_words(lay: topology.MeshLayouts, k: int) -> torch.Tensor:
    return torch.empty((4, 0), dtype=DTYPE, device=lay.mesh.devices[k])


# --- label entry points ------------------------------------------------------


def scrypt_labels_sharded(mesh: topology.Mesh, commitment_words, idx_lo,
                          idx_hi, *, n: int, chunk: int | None = None
                          ) -> list[torch.Tensor]:
    """A label batch striped over the mesh. ``commitment_words``: (8,)
    shared or (8, B) per-lane u32 words; ``idx_lo``/``idx_hi`` the (B,)
    u32 index halves. Returns one (4, b_k) int32 BE word tensor per
    stripe, in lane order."""
    lay = _layouts(mesh)
    cws = _commitments(lay, commitment_words)
    los, his = lay.put_batch(idx_lo), lay.put_batch(idx_hi)
    sizes = [int(t.shape[0]) for t in los]

    def stripe(k, max_lanes):
        return (scrypt.scrypt_labels_words(cws[k], los[k], his[k], n=n,
                                           chunk=max_lanes),)

    res = _run_stripes(lay, n, sizes, chunk,
                       [(cws[k], los[k], his[k]) for k in range(len(sizes))],
                       stripe)
    return [r[0] if r is not None else _empty_words(lay, k)
            for k, r in enumerate(res)]


def scrypt_labels_hash_sharded(mesh: topology.Mesh, commitment_words,
                               idx_lo, idx_hi, challenge_words, nonces, *,
                               n: int, chunk: int | None = None
                               ) -> list[torch.Tensor]:
    """The verifier's recompute striped over the mesh: each stripe's
    labels and the proving hash of each (``ops/scrypt.py:
    scrypt_labels_hash``, whose PBKDF2 finish hashes each label in the
    registers that hold it, so no label words leave a stripe).
    ``challenge_words`` (8, B) and ``nonces`` (B,) per lane. Returns one
    (b_k,) int32 hash tensor per stripe, in lane order."""
    lay = _layouts(mesh)
    cws = _commitments(lay, commitment_words)
    los, his = lay.put_batch(idx_lo), lay.put_batch(idx_hi)
    chs, ncs = lay.put_lane(challenge_words), lay.put_batch(nonces)
    sizes = [int(t.shape[0]) for t in los]

    def stripe(k, max_lanes):
        vals, _ = scrypt.scrypt_labels_hash(cws[k], los[k], his[k], chs[k],
                                            ncs[k], n=n, chunk=max_lanes)
        return (vals,)

    res = _run_stripes(
        lay, n, sizes, chunk,
        [(cws[k], los[k], his[k], chs[k], ncs[k]) for k in range(len(sizes))],
        stripe)
    return [r[0] if r is not None
            else torch.empty(0, dtype=DTYPE, device=lay.mesh.devices[k])
            for k, r in enumerate(res)]


def romix_sharded(mesh: topology.Mesh, block, *, n: int,
                  chunk: int | None = None) -> list[torch.Tensor]:
    """ROMix over a (32, B) u32 block striped over the mesh: the
    autotuner's mesh rows. ``block`` is a host array, or the stripes
    ``put_lane`` made of one. Returns one (32, b_k) tensor per stripe."""
    lay = _layouts(mesh)
    xs = list(block) if isinstance(block, (list, tuple)) \
        else lay.put_lane(block)
    sizes = [int(t.shape[1]) for t in xs]
    res = _run_stripes(lay, n, sizes, chunk, [(x,) for x in xs],
                       lambda k, m: (romix_cuda.romix(xs[k], n,
                                                      max_lanes=m),))
    return [r[0] if r is not None else xs[k] for k, r in enumerate(res)]


def _carry_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a < b`` on the LE-u128 keys of two (6,) VRF carries."""
    a3, a2, a1, a0 = flip(a[:4]).unbind(0)
    b3, b2, b1, b0 = flip(b[:4]).unbind(0)
    return ((a3 < b3)
            | ((a3 == b3) & ((a2 < b2)
               | ((a2 == b2) & ((a1 < b1)
                  | ((a1 == b1) & (a0 < b0)))))))


def labels_with_min_sharded(mesh: topology.Mesh, commitment_words, idx_lo,
                            idx_hi, carry, *, n: int,
                            chunk: int | None = None):
    """A striped label batch chained to the VRF min-scan.

    Each stripe folds its lanes into its copy of the replicated carry
    (``ops/scrypt.py:scrypt_labels_with_min``); stripe 0's stream then
    takes the stripes' carries in lane order, a later stripe winning only
    on a strictly smaller key, so a tie between stripes goes to the lower
    global index, as the single-device scan's first-occurrence rule does.
    Returns ``(words, new_carry, snapshot)``: one (4, b_k) word tensor per
    stripe, the next carry replicated on every stripe (pass it back as
    ``carry``; :func:`replicate` is then a no-op), and an independent (6,)
    copy of it on stripe 0's device."""
    lay = _layouts(mesh)
    cws = _commitments(lay, commitment_words)
    los, his = lay.put_batch(idx_lo), lay.put_batch(idx_hi)
    carries = lay.replicate(carry)
    sizes = [int(t.shape[0]) for t in los]

    def stripe(k, max_lanes):
        words, new, _ = scrypt.scrypt_labels_with_min(
            cws[k], los[k], his[k], carries[k], n=n, chunk=max_lanes)
        return words, new

    res = _run_stripes(
        lay, n, sizes, chunk,
        [(cws[k], los[k], his[k], carries[k]) for k in range(len(sizes))],
        stripe)
    with lay.stream(0):
        best = carries[0]
        for k, r in enumerate(res):
            if r is None:
                continue
            (new,) = _join(lay, k, (r[1],))
            best = torch.where(_carry_lt(new, best), new, best)
        snapshot = best.clone()
    words = [r[0] if r is not None else _empty_words(lay, k)
             for k, r in enumerate(res)]
    return words, _broadcast(lay, best), snapshot


def words_to_le(words):
    """(4, B) BE label words (one tensor, or one per stripe) -> the LE
    proving-hash words, on their devices: the device-side twin of the
    host's ``labels_to_bytes`` -> ``labels_to_words`` round trip."""
    if isinstance(words, (list, tuple)):
        return [u32.byteswap32(w) for w in words]
    return u32.byteswap32(words)


# --- prove -----------------------------------------------------------------


def prove_step_sharded(mesh: topology.Mesh, challenge_words, nonce_base,
                       idx_lo, idx_hi, label_words, threshold, hit_counts,
                       hit_carry, valid, start_lo, start_hi, *,
                       n_nonces: int, max_hits: int):
    """One striped prove step: the proving scan and its hit compaction on
    each stripe, then the stripes' hits merged in lane order into the
    running hit state on stripe 0's stream.

    Lanes are striped in whole 64-lane segments (the scan's unit). The
    hit state (``hit_counts``, ``hit_carry``) lives on stripe 0's device;
    a replicated list is taken at its stripe 0 entry. Each stripe's hits
    merge at their own first global index, whose hi u32 takes the carry
    of the lo half (``ops/proving.py:merge_hits``). Hits beyond
    ``max_hits`` per nonce drop as a whole-batch compaction would drop
    them, since the prover's carry holds ``max_hits`` slots. Returns
    ``(hit_counts', batch_counts, hit_carry')`` on stripe 0's device."""
    lay = _layouts(mesh)
    seg = proving.HIT_SEGMENT
    b = int(np.shape(idx_lo)[-1])
    bounds = lay.bounds(b, seg)
    los = lay.put_batch(idx_lo, seg)
    his = lay.put_batch(idx_hi, seg)
    lws = lay.put_lane(label_words, seg)
    start = (int(start_hi) << 32) | int(start_lo)
    valid = int(valid)
    parts = []
    for k, (first, m) in enumerate(bounds):
        if not m:
            continue
        with lay.stream(k):
            mask, segs = proving_cuda.scan(
                challenge_words, int(nonce_base), los[k], his[k], lws[k],
                int(threshold), max(0, min(valid - first, m)),
                n_nonces=n_nonces)
            parts.append((k, first, proving.compact_hits(
                mask.bool(), segs, max_hits=max_hits)))
    if isinstance(hit_counts, (list, tuple)):
        hit_counts = hit_counts[0]
    if isinstance(hit_carry, (list, tuple)):
        hit_carry = hit_carry[0]
    with lay.stream(0):
        total = torch.zeros(n_nonces, dtype=DTYPE, device=hit_counts.device)
        for k, first, hits in parts:
            counts, pos, ok = _join(lay, k, hits)
            s = start + first
            hit_counts, bc, hit_carry = proving.merge_hits(
                hit_counts, hit_carry, counts, pos, ok, s & _U32,
                (s >> 32) & _U32)
            total = total + bc
    return hit_counts, total, hit_carry


# --- init statistics ----------------------------------------------------------


def _stripe_stats(words: torch.Tensor, threshold: int) -> torch.Tensor:
    """(qualifying, min_hi, min_lo) of one stripe as a (3,) int64 tensor:
    the labels whose first BE word is under ``threshold``, the least top
    u32 of the LE-u128 keys, and the least next u32 among the lanes whose
    top u32 is that least one."""
    k_hi = u32.byteswap32(words[3]).long() & _U32
    k_lo = u32.byteswap32(words[2]).long() & _U32
    qualifying = ((words[0].long() & _U32) < threshold).sum()
    min_hi = k_hi.min()
    min_lo = torch.where(k_hi == min_hi, k_lo, _U32).min()
    return torch.stack([qualifying, min_hi, min_lo])


def init_step_sharded(mesh: topology.Mesh, commitment_words, idx_lo,
                      idx_hi, threshold: int, *, n: int,
                      chunk: int | None = None):
    """One striped init step: labels plus three statistics over every
    stripe. Returns ``(words, qualifying, min_hi, min_lo)``: one (4, b_k)
    word tensor per stripe, and 0-d int64 tensors on stripe 0's device:
    the count of labels whose first word is under ``threshold``, the
    least top u32 of the labels' LE-u128 keys, and the least next u32
    among only the lanes whose top u32 equals that global least."""
    lay = _layouts(mesh)
    words = scrypt_labels_sharded(mesh, commitment_words, idx_lo, idx_hi,
                                  n=n, chunk=chunk)
    stats = []
    for k, w in enumerate(words):
        if w.shape[1]:
            with lay.stream(k):
                stats.append((k, _stripe_stats(w, int(threshold))))
    with lay.stream(0):
        joined = torch.stack([_join(lay, k, (s,))[0] for k, s in stats])
        qualifying = joined[:, 0].sum()
        min_hi = joined[:, 1].min()
        min_lo = torch.where(joined[:, 1] == min_hi, joined[:, 2],
                             _U32).min()
    return words, qualifying, min_hi, min_lo
