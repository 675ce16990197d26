"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the ``cuda`` marker and skips without a card
(decided inside the fixture, never at import). The file imports no JAX,
so it also runs on a machine without it:

    python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import hashlib
import sys

import numpy as np
import pytest
import torch

from spacemesh_tpu_torch.ops import pbkdf2_cuda, pow_cuda, proving
from spacemesh_tpu_torch.ops import pow as k2pow
from spacemesh_tpu_torch.ops import proving_cuda, romix_cuda, scrypt, u32
from spacemesh_tpu_torch.post import initializer

pytestmark = pytest.mark.cuda

CH = hashlib.sha256(b"torch-cuda-ch").digest()
COMMIT = hashlib.sha256(b"torch-cuda-commit").digest()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _no_race(monkeypatch):
    """No ROMix autotune race inside a kernel test: a race's launches would
    land in the counts the tests read (the CPU suite's conftest sets the
    same, and ``--noconftest`` skips it). ``fresh_tuner`` turns it on."""
    from spacemesh_tpu_torch.ops import autotune

    monkeypatch.setenv(autotune.ENV_AUTOTUNE, "off")
    autotune.reset_memo()
    yield
    autotune.reset_memo()


def _rand_u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("n,b", [(16, 300), (1024, 257)])
def test_romix_kernel_matches_plain(dev, n, b):
    x = u32.from_numpy(_rand_u32((32, b), n), dev)
    before = romix_cuda.launches
    got = romix_cuda.romix(x, n, max_lanes=128)  # three lane chunks
    assert romix_cuda.launches == before + 3
    assert torch.equal(got, romix_cuda.romix_r1(x, n))


@pytest.mark.parametrize("n,b", [(16, 300), (1024, 257)])
def test_romix_fill_phase_kernel_matches_plain(dev, n, b):
    x = u32.from_numpy(_rand_u32((32, b), 50 + n), dev)
    before = romix_cuda.launches
    got = romix_cuda.romix(x, n, max_lanes=128, mix_phase=False)
    assert romix_cuda.launches == before + 3
    assert torch.equal(got, romix_cuda.romix_r1(x, n, mix_phase=False))


def test_lanes_that_fit_counts_free_and_cached_memory(dev):
    held = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    del held  # 256 MiB now cached by the allocator, not in use
    n = 8192
    free, _ = torch.cuda.mem_get_info(dev)
    cached = (torch.cuda.memory_reserved(dev)
              - torch.cuda.memory_allocated(dev))
    assert cached >= 1 << 28
    want = int((free + cached) * 0.9) // (n * 128)
    assert abs(romix_cuda.lanes_that_fit(n, dev) - want) <= 1


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("b", [1, 1000, 9472])
def test_pbkdf2_kernels_match_plain(dev, per_lane, b):
    rng = np.random.default_rng(b)
    idx = rng.integers(0, 2**64, b, dtype=np.uint64)
    idx[:min(b, 3)] = [2**32 - 1, 2**32, 2**63 + 1][:min(b, 3)]
    lo, hi = (u32.from_numpy(h, dev) for h in scrypt.split_indices(idx))
    cw = u32.from_numpy(_rand_u32((8, b) if per_lane else (8,), b + 1), dev)
    before = (pbkdf2_cuda.expand_launches, pbkdf2_cuda.finish_launches)
    blk = pbkdf2_cuda.expand(cw, lo, hi)
    inner, outer, want = pbkdf2_cuda._expand(cw, lo, hi)
    assert torch.equal(blk, want)
    b_le = u32.from_numpy(_rand_u32((32, b), b + 2), dev)
    got = pbkdf2_cuda.finish(cw, b_le)
    assert torch.equal(got, pbkdf2_cuda._pbkdf2_second(inner, outer,
                                                       b_le)[:4])
    assert (pbkdf2_cuda.expand_launches,
            pbkdf2_cuda.finish_launches) == (before[0] + 1, before[1] + 1)


def test_labels_through_the_kernel_match_hashlib(dev):
    idx = np.array([0, 1, 2**32 - 1, 2**32, 2**63 + 9], dtype=np.uint64)
    got = scrypt.scrypt_labels(COMMIT, idx, n=1024, device=dev)
    for i, ix in enumerate(idx):
        assert bytes(got[i]) == hashlib.scrypt(
            COMMIT, salt=int(ix).to_bytes(8, "little"), n=1024, r=1, p=1,
            dklen=16)


def test_labels_through_all_three_kernels_match_hashlib(dev):
    rng = np.random.default_rng(21)
    commits = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    idx = rng.integers(0, 2**64, 40, dtype=np.uint64)
    launches = (pbkdf2_cuda.expand_launches, romix_cuda.launches,
                pbkdf2_cuda.finish_launches)
    got = scrypt.scrypt_labels_multi(commits, idx, n=512, device=dev)
    assert (pbkdf2_cuda.expand_launches, romix_cuda.launches,
            pbkdf2_cuda.finish_launches) == tuple(c + 1 for c in launches)
    for i in range(40):
        assert bytes(got[i]) == hashlib.scrypt(
            bytes(commits[i]), salt=int(idx[i]).to_bytes(8, "little"),
            n=512, r=1, p=1, dklen=16)


def _scan_args(dev, count=700, batch=1024, start=2**32 - 300):
    idx = np.arange(start, start + batch, dtype=np.uint64)
    labels = scrypt.scrypt_labels(COMMIT, idx[:count], n=2, device="cpu")
    labels = np.concatenate([labels, np.zeros((batch - count, 16),
                                              np.uint8)])
    lo, hi = scrypt.split_indices(idx)
    return (proving.challenge_words(CH), u32.from_numpy(lo, dev),
            u32.from_numpy(hi, dev),
            u32.from_numpy(scrypt.labels_to_words(labels), dev),
            proving.threshold_u32(120, count), count, start)


def test_scan_kernel_matches_plain(dev):
    cw, lo, hi, lw, t, count, _ = _scan_args(dev)
    args = (cw, 2**32 - 2, lo, hi, lw, t, count)  # the nonce wraps
    before = proving_cuda.launches
    mask, seg = proving_cuda.scan(*args, n_nonces=5)
    assert proving_cuda.launches == before + 1
    pmask, pseg = proving_cuda.scan_plain(*args, n_nonces=5)
    assert torch.equal(mask, pmask) and torch.equal(seg, pseg)
    assert int(seg.sum()) > 0


def test_prove_step_through_the_kernel_matches_plain(dev):
    cw, lo, hi, lw, t, count, start = _scan_args(dev)
    counts, carry = proving.init_hit_state(4, 8, dev)
    got = proving.prove_scan_step(cw, 3, lo, hi, lw, t, counts, carry,
                                  count, start & 0xFFFFFFFF, start >> 32,
                                  n_nonces=4, max_hits=8)
    mask, seg = proving_cuda.scan_plain(cw, 3, lo, hi, lw, t, count,
                                        n_nonces=4)
    want = proving.merge_hits(counts, carry,
                              *proving.compact_hits(mask.bool(), seg,
                                                    max_hits=8),
                              start & 0xFFFFFFFF, start >> 32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_card_store_equals_cpu_store(dev, tmp_path):
    geom = dict(node_id=COMMIT, commitment=COMMIT, num_units=1,
                labels_per_unit=3000, scrypt_n=16, max_file_size=16 * 1024,
                batch_size=1200)
    digests = []
    for where in ("cuda", "cpu"):
        d = tmp_path / where
        meta, _ = initializer.initialize(d, device=where, **geom)
        digests.append((meta.vrf_nonce, meta.vrf_nonce_value, [
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.glob("postdata_*.bin"))]))
    assert digests[0] == digests[1]


def test_packed_init_on_the_card_equals_the_cpu_twin(dev, tmp_path):
    """Three identities at ragged totals through the multi-tenant scheduler:
    the card's packs (per-lane commitments, each thread on a stream of its
    own) write the CPU twin's stores, and every kernel of the path runs."""
    from spacemesh_tpu_torch.runtime import TenantScheduler

    totals = (100, 257, 700)
    stores = []
    before = (romix_cuda.launches, pbkdf2_cuda.expand_launches,
              pbkdf2_cuda.finish_launches)
    for where in ("cuda", "cpu"):
        with TenantScheduler(pack_lanes=256, autostart=False,
                             device=where) as sched:
            handles = []
            for i, total in enumerate(totals):
                tid = f"t{i}"
                sched.register_tenant(tid)
                handles.append(sched.submit_init(
                    tid, tmp_path / where / tid,
                    node_id=hashlib.sha256(b"n%d" % i).digest(),
                    commitment=hashlib.sha256(b"c%d" % i).digest(),
                    num_units=1, labels_per_unit=total, scrypt_n=16,
                    max_file_size=4096))
            sched.start()
            metas = [h.result(timeout=120) for h in handles]
        stores.append([(m.labels_written, m.vrf_nonce, m.vrf_nonce_value, [
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((tmp_path / where / f"t{i}").glob(
                "postdata_*.bin"))]) for i, m in enumerate(metas)])
    assert stores[0] == stores[1]
    after = (romix_cuda.launches, pbkdf2_cuda.expand_launches,
             pbkdf2_cuda.finish_launches)
    assert all(a >= b + 5 for a, b in zip(after, before))  # 1057 lanes / 256


@pytest.fixture(scope="module")
def verify_wl(tmp_path_factory):
    """A small mixed verification workload (scrypt N=2, malformed items
    included), made on the CPU: the card path is held to it."""
    from spacemesh_tpu_torch.verify import workload

    if not torch.cuda.is_available():  # module scope runs before ``dev``
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return workload.build(str(tmp_path_factory.mktemp("cuda-verify-wl")),
                          sigs=8, vrfs=2, posts=12, memberships=4, pows=16,
                          post_challenges=3, device="cpu")


def _farm_verdicts(wl, device, reqs, **kw):
    import asyncio

    from spacemesh_tpu_torch.verify.farm import VerificationFarm

    async def go():
        farm = VerificationFarm(ed_verifier=wl.ed, vrf_verifier=wl.vrf,
                                post_params=wl.post_params,
                                post_seed=wl.post_seed, device=device, **kw)
        try:
            return list(await asyncio.gather(
                *(farm.submit(r) for r in reqs))), farm
        finally:
            await farm.aclose()

    return asyncio.run(go())


def test_farm_batch_on_the_card_equals_the_cpu_twin(dev, verify_wl):
    """Every kind through the farm on the card (POST and k2pow batches on
    streams of the farm's pool) and on the CPU: equal verdicts, equal to
    inline verification; the POST batches launch all three kernels (PBKDF2
    expand, ROMix, PBKDF2 finish with the proving hash), every stream is
    back in the pool afterwards, and no device tensor outlives its
    batch."""
    before = (romix_cuda.launches, pbkdf2_cuda.expand_launches,
              pbkdf2_cuda.finish_hash_launches)
    allocated = torch.cuda.memory_allocated(dev)
    card, farm = _farm_verdicts(verify_wl, dev, verify_wl.requests,
                                max_batch=4)
    assert torch.cuda.memory_allocated(dev) <= allocated
    after = (romix_cuda.launches, pbkdf2_cuda.expand_launches,
             pbkdf2_cuda.finish_hash_launches)
    cpu, _ = _farm_verdicts(verify_wl, "cpu", verify_wl.requests)
    assert card == cpu == verify_wl.inline_all()
    assert all(a > b for a, b in zip(after, before))
    assert farm._streams.qsize() == farm.max_inflight
    assert set(farm.post_timing) == {"prep", "labels", "hash", "check"}


def test_farm_pow_batch_on_the_card_equals_the_cpu_twin(dev, verify_wl):
    from spacemesh_tpu_torch.verify.farm import PowRequest

    pows = [r for r in verify_wl.requests if isinstance(r, PowRequest)]
    pows += [PowRequest(r.challenge, r.node_id, r.difficulty, r.nonce + k)
             for k in range(1, 40) for r in pows[:4]]
    card, _ = _farm_verdicts(verify_wl, dev, pows)
    cpu, _ = _farm_verdicts(verify_wl, "cpu", pows)
    assert card == cpu == [verify_wl.inline_verify(r) for r in pows]


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("b", [37, 9472])
def test_proving_hash_kernel_matches_plain(dev, per_lane, b):
    """At a serial verify's 37 lanes and a verifyd farm batch's 9472: the
    challenge and nonce per lane or shared, the labels LE or BE."""
    rng = np.random.default_rng(b + per_lane)
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), dev))
    ch = rand(8, b) if per_lane else rand(8)
    nonce = rand(b) if per_lane else int(rng.integers(0, 2**32))
    lo, hi, words = rand(b), rand(b), rand(4, b)
    for big_endian in (False, True):
        before = proving_cuda.hash_launches
        got = proving_cuda.proving_hash(ch, nonce, lo, hi, words,
                                        big_endian=big_endian)
        assert proving_cuda.hash_launches == before + 1
        assert torch.equal(got, proving_cuda.proving_hash_plain(
            ch, nonce, lo, hi, words, big_endian=big_endian))


def test_k2pow_search_kernel_matches_plain_and_hashlib(dev):
    """A search batch of 2^16 nonces across nonce_hi = 1."""
    ch = hashlib.sha256(b"cuda-k2pow-ch").digest()
    node = hashlib.sha256(b"cuda-k2pow-node").digest()
    diff = bytes([0, 4]) + bytes([255]) * 30
    pre = k2pow.prefix_state(ch, node)
    tgt = np.frombuffer(diff, dtype=">u4").astype(np.uint32)
    base, count = 2**32 - 2**15, 2**16
    before = pow_cuda.mask_launches
    got = pow_cuda.search_batch(pre, tgt, base, count, dev)
    assert pow_cuda.mask_launches == before + 1
    assert torch.equal(got, pow_cuda.search_plain(pre, tgt, base, count, dev))
    hits = torch.nonzero(got).flatten().tolist()
    assert hits and all(k2pow.verify(ch, node, diff, base + h) for h in hits)


def _first_hit(ch, node, diff, start):
    return next(n for n in range(start, start + (1 << 20))
                if k2pow.pow_hash(ch, node, n) < diff)


@pytest.mark.parametrize("imad", [True, False])
def test_k2pow_window_kernel_matches_plain_and_hashlib(dev, imad):
    """Both forms of the window kernel against its plain twin on the card
    and hashlib: a winner inside a window of 2^20 nonces, no winner (a zero
    target), a window across nonce_hi = 1, and a window behind a winner
    (the cell stays)."""
    ch = hashlib.sha256(b"cuda-window-ch").digest()
    node = hashlib.sha256(b"cuda-window-node").digest()
    block1 = np.frombuffer(ch + node, dtype=">u4").astype(np.uint32)
    hard = bytes([0, 4]) + bytes([255]) * 30
    easy = bytes([0, 255]) + bytes([255]) * 30
    cases = [(hard, 0, 1 << 20), (bytes(32), 5, 1 << 20),
             (easy, 2**32 - 8, 1 << 20)]
    for diff, start, count in cases:
        tgt = np.frombuffer(diff, dtype=">u4").astype(np.uint32)
        got, want = pow_cuda.new_cell(dev), pow_cuda.new_cell(dev)
        before = pow_cuda.search_launches
        pow_cuda.search_window(block1, tgt, start, count, got, dev,
                               imad=imad)
        assert pow_cuda.search_launches == before + 1
        pow_cuda.search_window_plain(block1, tgt, start, count, want,
                                     chunk=1 << 16)
        assert torch.equal(got, want)
        value = pow_cuda.cell_value(got.cpu())
        if diff == bytes(32):
            assert value == pow_cuda.NO_WINNER
        else:
            assert value == _first_hit(ch, node, diff, start)
            # the window behind the winner leaves the cell as it is
            pow_cuda.search_window(block1, tgt, start + count, count, got,
                                   dev, imad=imad)
            assert pow_cuda.cell_value(got.cpu()) == value
    assert _first_hit(ch, node, easy, 2**32 - 8) >= 2**32


def test_search_on_the_card_matches_hashlib(dev):
    """``ops.pow.search`` at the prover's default difficulty: the smallest
    hit, in one window and the speculative one behind it."""
    ch = hashlib.sha256(b"cuda-search-ch").digest()
    diff = bytes([0, 255]) + bytes([255]) * 30
    before = pow_cuda.search_launches
    assert k2pow.search(ch, COMMIT, diff, device=dev) == _first_hit(
        ch, COMMIT, diff, 0)
    assert pow_cuda.search_launches == before + 2


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("b", [37, 9472])
def test_finish_hash_kernel_matches_plain(dev, per_lane, b):
    """PBKDF2 finish with the proving hash as its epilogue against finish's
    plain twin then the hash's, per-lane or shared commitment, challenge
    and nonce; the words out only when asked for."""
    rng = np.random.default_rng(100 + b + per_lane)
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), dev))
    cw = rand(8, b) if per_lane else rand(8)
    ch = rand(8, b) if per_lane else rand(8)
    nonce = rand(b) if per_lane else int(rng.integers(0, 2**32))
    lo, hi, blk = rand(b), rand(b), rand(32, b)
    words = pbkdf2_cuda._pbkdf2_second(*pbkdf2_cuda._midstates(cw), blk)[:4]
    want = proving_cuda.proving_hash_plain(ch, nonce, lo, hi, words,
                                           big_endian=True)
    before = pbkdf2_cuda.finish_hash_launches
    values, got_words = pbkdf2_cuda.finish_hash(cw, blk, ch, nonce, lo, hi,
                                                words_out=True)
    only, none = pbkdf2_cuda.finish_hash(cw, blk, ch, nonce, lo, hi)
    assert pbkdf2_cuda.finish_hash_launches == before + 2
    assert torch.equal(values, want) and torch.equal(only, want)
    assert torch.equal(got_words, words) and none is None


@pytest.mark.parametrize("b", [64, 4096])
def test_k2pow_verify_kernel_matches_plain_and_hashlib(dev, b):
    rng = np.random.default_rng(b)
    items = []
    for i in range(b):
        c, n = (bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                for _ in range(2))
        nonce = int(rng.integers(0, 2**64, dtype=np.uint64))
        d = bytes([int(rng.integers(0, 256))]) + bytes([255]) * 31
        if i % 9 == 0:
            d = k2pow.pow_hash(c, n, nonce)  # equal: not below
        items.append((c, n, d, nonce))
    block1 = u32.from_numpy(np.stack([np.frombuffer(c + n, dtype=">u4")
                                      for c, n, _, _ in items], 1), dev)
    tgt = u32.from_numpy(np.stack([np.frombuffer(d, dtype=">u4")
                                   for _, _, d, _ in items], 1), dev)
    lo, hi = pow_cuda.split_nonces(np.array([x[3] for x in items],
                                            dtype=np.uint64), dev)
    before = pow_cuda.verify_launches
    got = pow_cuda.verify_batch(block1, lo, hi, tgt)
    assert pow_cuda.verify_launches == before + 1
    assert torch.equal(got, pow_cuda.verify_plain(block1, lo, hi, tgt))
    assert got.cpu().tolist() == [k2pow.verify(*x) for x in items]


def _forbid_plain_twins(monkeypatch):
    """Make the plain twins (``salsa20_8``, ``blockmix_r1``,
    ``sha256_compress``) and the standalone proving hash raise wherever
    the port holds them."""
    from spacemesh_tpu_torch.ops import proving as tproving

    def forbid(name):
        def twin(*args, **kwargs):
            raise AssertionError(f"{name} ran on a card path")
        return twin

    for key, mod in list(sys.modules.items()):
        if key.startswith("spacemesh_tpu_torch"):
            for name in ("salsa20_8", "blockmix_r1", "sha256_compress"):
                if callable(getattr(mod, name, None)):
                    monkeypatch.setattr(mod, name, forbid(name))
    for mod in (proving_cuda, tproving):
        monkeypatch.setattr(mod, "proving_hash", forbid("proving_hash"))


def test_verify_many_and_search_on_the_card_never_reach_the_plain_twins(
        dev, verify_wl, monkeypatch):
    """With the plain twins and the standalone proving hash made to raise,
    verify_many (expand, ROMix, finish with the hash) and the k2pow search
    (the window kernel, block 1 included) still run on the card and give
    the CPU twin's answers."""
    from spacemesh_tpu_torch.post import verifier
    from spacemesh_tpu_torch.verify.farm import PostRequest

    items = [r.item for r in verify_wl.requests if isinstance(r, PostRequest)]
    want = verifier.verify_many(items, verify_wl.post_params,
                                seed=verify_wl.post_seed, device="cpu")
    diff = bytes([0, 8]) + bytes([255]) * 30
    want_nonce = k2pow.search(COMMIT, COMMIT, diff, batch=1 << 12,
                              device="cpu")

    _forbid_plain_twins(monkeypatch)
    before = pbkdf2_cuda.finish_hash_launches
    assert verifier.verify_many(items, verify_wl.post_params,
                                seed=verify_wl.post_seed, device=dev) == want
    assert pbkdf2_cuda.finish_hash_launches > before and any(want)
    before = pow_cuda.search_launches
    nonce = k2pow.search(COMMIT, COMMIT, diff, device=dev)
    assert pow_cuda.search_launches > before
    assert nonce == want_nonce
    assert k2pow.verify(COMMIT, COMMIT, diff, nonce)


# --- the span tracer's torch.profiler bridge on the card --------------------


def test_bridged_spans_enclose_the_label_launches(dev):
    """With the bridge on inside a profiler capture, each kernel of a label
    batch (expand, ROMix, finish) joins its launch by the profiler's
    correlation, and the launch lies inside the batch's ``romix.dispatch``
    range on the launching thread."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from spacemesh_tpu_torch.utils import tracing

    lo, hi = scrypt.split_indices(np.arange(512, dtype=np.uint64))
    cw = u32.from_numpy(scrypt.commitment_to_words(COMMIT), dev)
    args = (cw, u32.from_numpy(lo, dev), u32.from_numpy(hi, dev))
    scrypt.scrypt_labels_words(*args, n=1024)  # built and warm
    torch.cuda.synchronize()
    tracing.start(capacity=256, torch_bridge=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                scrypt.scrypt_labels_words(*args, n=1024)
            torch.cuda.synchronize()
    finally:
        tracing.stop()
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        events = json.load(open(f.name))["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and e["name"] == "romix.dispatch"]
    launches = {(e.get("args") or {}).get("correlation"): e for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    joined = 0
    for k in xs:
        if k.get("cat") != "kernel" or not any(
                n in k["name"] for n in ("expand_kernel", "romix_kernel",
                                         "finish_kernel")):
            continue
        launch = launches[k["args"]["correlation"]]
        assert any(r["tid"] == launch["tid"] and r["ts"] <= launch["ts"]
                   and launch["ts"] + launch["dur"] <= r["ts"] + r["dur"]
                   for r in ranges), launch
        joined += 1
    assert len(ranges) == 3 and joined == 9
    spans = [e for e in tracing.export()["traceEvents"]
             if e.get("name") == "romix.dispatch"]
    assert len(spans) == 3 and tracing.validate(tracing.export()) == []


# --- ATX validation on the card ---------------------------------------------

ATX_N = 16
ATX_LPU = 256
GOLDEN = hashlib.sha256(b"torch-cuda-golden").digest()


@pytest.fixture(scope="module")
def atx_world(tmp_path_factory):
    """Three identities initialized and proving on the card: a v1 ATX of
    the first (its own poet round) and a merged v2 ATX of the other two,
    each with the state DB of the node that built it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import asyncio

    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.consensus import activation_v2 as act2
    from spacemesh_tpu_torch.consensus import poet
    from spacemesh_tpu_torch.core.signing import EdSigner, EdVerifier
    from spacemesh_tpu_torch.p2p.pubsub import PubSub
    from spacemesh_tpu_torch.post import prover, service
    from spacemesh_tpu_torch.storage import cache, db

    tmp = tmp_path_factory.mktemp("cuda-atx")
    params = prover.ProofParams(k1=64, k2=8, k3=8,
                                pow_difficulty=b"\x20" + b"\xff" * 31)
    signers = [EdSigner(seed=hashlib.sha256(b"cuda-atx-%d" % i).digest())
               for i in range(3)]
    clients = {}
    for s in signers:
        d = tmp / s.node_id.hex()[:12]
        initializer.initialize(
            d, node_id=s.node_id, commitment=act.commitment_of(s.node_id,
                                                               GOLDEN),
            num_units=1, labels_per_unit=ATX_LPU, scrypt_n=ATX_N,
            batch_size=256, device="cuda")
        clients[s.node_id] = service.PostClient(d, params, device="cuda")

    async def build():
        state = db.open_state()
        bus = PubSub(deliver_self=False)
        p = poet.PoetService(poet_id=hashlib.sha256(b"cuda-poet").digest(),
                             ticks=8)
        handler = act.Handler(
            db=state, cache=cache.AtxCache(), verifier=EdVerifier(),
            golden_atx=GOLDEN, post_params=params, labels_per_unit=ATX_LPU,
            scrypt_n=ATX_N, pubsub=bus, device="cuda")
        b = act.Builder(signer=signers[0], db=state, pubsub=bus, poet=p,
                        post_client=clients[signers[0].node_id],
                        golden_atx=GOLDEN, coinbase=bytes(24),
                        handler=handler, num_units=1)
        v1 = await b.build_and_publish(1, execute_round=True)
        state2 = db.open_state()
        v2 = await act2.build_merged_atx(
            primary=signers[1], partners=[signers[2]], db=state2,
            poet=poet.PoetService(
                poet_id=hashlib.sha256(b"cuda-poet-2").digest(), ticks=8),
            post_clients=clients, golden_atx=GOLDEN, coinbase=bytes(24),
            publish_epoch=1, execute_round=True)
        return (v1, state), (v2, state2)

    (v1, state), (v2, state2) = asyncio.run(build())
    return dict(params=params, v1=v1, state=state, v2=v2, state2=state2,
                signers=signers)


def _out_of_range_post(nipost):
    import dataclasses

    return dataclasses.replace(nipost, post=dataclasses.replace(
        nipost.post, indices=[ATX_LPU + 1 + i for i in nipost.post.indices]))


def _atx_verdicts(world, handler_cls, db_key, envelopes, device,
                  farm: bool):
    """Verdicts of ``handler_cls`` over ``envelopes`` on a fresh copy of
    ``world[db_key]`` (its poet rows only), through a farm on ``device``
    or inline; the rows it stored."""
    import asyncio

    from spacemesh_tpu_torch.core.signing import EdVerifier
    from spacemesh_tpu_torch.p2p.pubsub import PubSub
    from spacemesh_tpu_torch.storage import cache, db
    from spacemesh_tpu_torch.verify.farm import VerificationFarm

    state = db.open_state()
    for table in ("poet_proofs", "active_sets"):
        for row in world[db_key].all(f"SELECT * FROM {table}"):
            state.exec(f"INSERT INTO {table} VALUES "
                       f"({','.join('?' * len(row))})", tuple(row))
    kw = dict(db=state, cache=cache.AtxCache(), verifier=EdVerifier(),
              golden_atx=GOLDEN, post_params=world["params"],
              labels_per_unit=ATX_LPU, scrypt_n=ATX_N, pubsub=PubSub(),
              device=device, now=lambda: 1.0)

    async def go():
        f = VerificationFarm(post_params=world["params"], device=device) \
            if farm else None
        h = handler_cls(farm=f, **kw)
        try:
            return [await h.process_async(e) for e in envelopes]
        finally:
            if f is not None:
                await f.aclose()

    verdicts = asyncio.run(go())
    rows = [tuple(r) for r in state.all(
        "SELECT id, node_id, publish_epoch, tick_height, data FROM atxs"
        " ORDER BY id")]
    return verdicts, rows


def _v1_envelopes(world):
    import dataclasses

    from spacemesh_tpu_torch.core.signing import Domain

    atx, s = world["v1"], world["signers"][0]
    bad = dataclasses.replace(atx, nipost=_out_of_range_post(atx.nipost),
                              signature=bytes(64))
    bad = dataclasses.replace(bad, signature=s.sign(Domain.ATX,
                                                    bad.signed_bytes()))
    return [atx, bad]


def test_farm_validates_a_v1_atx_on_the_card(atx_world, monkeypatch):
    """A v1 ATX and a tampered copy through the farm on the card, with the
    plain twins made to raise: the CPU's inline verdicts and rows."""
    from spacemesh_tpu_torch.consensus import activation as act

    envelopes = _v1_envelopes(atx_world)
    want = _atx_verdicts(atx_world, act.Handler, "state", envelopes, "cpu",
                         farm=False)
    _forbid_plain_twins(monkeypatch)
    before = pbkdf2_cuda.finish_hash_launches
    card = _atx_verdicts(atx_world, act.Handler, "state", envelopes, "cuda",
                         farm=True)
    inline = _atx_verdicts(atx_world, act.Handler, "state", envelopes,
                           "cuda", farm=False)
    assert pbkdf2_cuda.finish_hash_launches > before
    assert card == inline == want
    assert want[0] == [True, False] and len(want[1]) == 1


def test_farm_validates_a_merged_atx_on_the_card(atx_world, monkeypatch):
    import dataclasses

    from spacemesh_tpu_torch.consensus import activation_v2 as act2
    from spacemesh_tpu_torch.core.signing import Domain

    atx2, primary = atx_world["v2"], atx_world["signers"][1]
    sp = atx2.subposts[1]
    bad = dataclasses.replace(atx2, subposts=[
        atx2.subposts[0],
        dataclasses.replace(sp, nipost=_out_of_range_post(sp.nipost))],
        signature=bytes(64))
    bad = dataclasses.replace(bad, signature=primary.sign(
        Domain.ATX, bad.signed_bytes()))
    want = _atx_verdicts(atx_world, act2.HandlerV2, "state2", [atx2, bad],
                         "cpu", farm=False)
    _forbid_plain_twins(monkeypatch)
    before = romix_cuda.launches
    card = _atx_verdicts(atx_world, act2.HandlerV2, "state2", [atx2, bad],
                         "cuda", farm=True)
    assert romix_cuda.launches > before
    assert card == want
    assert want[0] == [True, False] and len(want[1]) == 2


def test_certifier_on_the_card(atx_world, monkeypatch):
    """CertifierService on the card certifies the v1 ATX's real proof and
    refuses a tampered one, the plain twins made to raise."""
    import dataclasses

    from spacemesh_tpu_torch.consensus import activation as act
    from spacemesh_tpu_torch.consensus import certifier
    from spacemesh_tpu_torch.core.signing import EdSigner, EdVerifier
    from spacemesh_tpu_torch.post import prover
    from spacemesh_tpu_torch.storage import misc

    atx, s = atx_world["v1"], atx_world["signers"][0]
    poet_proof = misc.poet_proof(atx_world["state"],
                                 atx.nipost.post_metadata.challenge)
    p = atx.nipost.post
    proof = prover.Proof(nonce=p.nonce, indices=list(p.indices),
                         pow_nonce=p.pow_nonce, k2=atx_world["params"].k2)
    kw = dict(challenge=act.post_challenge(
                  poet_proof.root, act.nipost_challenge(atx.prev_atx, 1)),
              node_id=s.node_id, commitment=act.commitment_of(s.node_id,
                                                              GOLDEN),
              num_units=1, labels_per_unit=ATX_LPU)
    svc = certifier.CertifierService(EdSigner(seed=bytes(32)),
                                     atx_world["params"], scrypt_n=ATX_N)
    assert svc.device.type == "cuda"
    _forbid_plain_twins(monkeypatch)
    cert = svc.certify(proof=proof, **kw)
    assert certifier.verify_cert(cert, svc.pubkey, EdVerifier())
    bad = dataclasses.replace(proof, indices=[ATX_LPU + 1 + i
                                              for i in proof.indices])
    with pytest.raises(ValueError, match="failed verification"):
        svc.certify(proof=bad, **kw)



@pytest.fixture
def fresh_tuner(dev, tmp_path, monkeypatch):
    """The autotuner over a private winners file, racing on (the kernel
    libraries stay where they are built)."""
    from spacemesh_tpu_torch.ops import autotune
    from spacemesh_tpu_torch.parallel import topology

    monkeypatch.setattr(autotune, "cache_path",
                        lambda: str(tmp_path / "romix_autotune.json"))
    for var in (autotune.ENV_IMPL, autotune.ENV_CHUNK, autotune.ENV_MESH,
                autotune.ENV_AUTOTUNE):
        monkeypatch.delenv(var, raising=False)
    autotune.reset_memo()
    topology.reset()
    yield autotune
    autotune.reset_memo()


def test_race_on_the_card(fresh_tuner, monkeypatch):
    """A race on the card at N=1024 (chunk rows 2048 and below the
    calibration batch): every row is the kernel's, the plain twins never
    run, and the labels under the winner equal hashlib."""
    autotune = fresh_tuner
    _forbid_plain_twins(monkeypatch)
    d = autotune.decide(1024, 4096, platform="cuda")
    rows = autotune.raced_rows("cuda", 1024)
    assert [(r["impl"], r["chunk"]) for r in rows] == [
        ("cuda", None), ("cuda", 2048)]
    assert d.impl == "cuda" and d.source == "race"
    got = scrypt.scrypt_labels(COMMIT, np.arange(4096, dtype=np.uint64),
                               n=1024, device="cuda")
    for i in (0, 2047, 2048, 4095):
        assert bytes(got[i]) == hashlib.scrypt(
            COMMIT, salt=int(i).to_bytes(8, "little"), n=1024, r=1, p=1,
            dklen=16)


def test_two_stripes_on_one_card_equal_one_device(dev, monkeypatch):
    """Two stripes of one card, each on its own stream: the striped labels
    and min-scan equal one device's, and the stripes' streams differ."""
    from spacemesh_tpu_torch.parallel import mesh as pmesh

    _forbid_plain_twins(monkeypatch)
    mesh = pmesh.data_mesh(["cuda:0", "cuda:0"])
    lay = pmesh.lane_sharding(mesh)
    assert lay.streams[0] is not lay.streams[1]
    idx = np.arange(3001, dtype=np.uint64)
    lo, hi = scrypt.split_indices(idx)
    cw = scrypt.commitment_to_words(COMMIT)
    carry = scrypt.vrf_carry_init()
    words, carries, snap = pmesh.labels_with_min_sharded(
        mesh, cw, lo, hi, carry, n=1024)
    one, _, want_snap = scrypt.scrypt_labels_with_min(
        u32.from_numpy(cw, dev), u32.from_numpy(lo, dev),
        u32.from_numpy(hi, dev), u32.from_numpy(carry, dev), n=1024,
        chunk=None)
    torch.cuda.synchronize()
    assert [w.shape[1] for w in words] == [1501, 1500]
    assert torch.equal(torch.cat(words, 1), one)
    assert torch.equal(snap, want_snap)
    assert all(torch.equal(c, want_snap) for c in carries)
