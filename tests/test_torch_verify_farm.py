"""The port's verification farm (``spacemesh_tpu_torch/verify/``) on the
CPU: twins of ``tests/test_verify_farm.py`` (adversarial batches, lanes,
dedup, cancellation, deadline expiry, backpressure, shutdown) on the
port's farm with ``device="cpu"``, plus what the port changed: no
power-of-two padding of POST batches, the stage timings, the device
rule, the pure-Python sig branch and the per-kind breaker.

The core property: a farm dispatch mixing valid, invalid and malformed
items resolves EVERY future with exactly the inline verifier's verdict.
"""

import asyncio
import threading
import time

import pytest
import torch

from spacemesh_tpu_torch.core import signing
from spacemesh_tpu_torch.core.signing import Domain, EdSigner
from spacemesh_tpu_torch.obs.remediate import BreakerOpen
from spacemesh_tpu_torch.post import verifier as post_verifier
from spacemesh_tpu_torch.verify import workload
from spacemesh_tpu_torch.verify.farm import (
    FarmClosed,
    Lane,
    PostRequest,
    PowRequest,
    SigRequest,
    VerificationFarm,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process (tier-1 runs files in
    parallel workers; torch's default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wl(tmp_path_factory, one_torch_thread):
    """One small mixed workload (malformed items included) per module."""
    d = tmp_path_factory.mktemp("torch-verify-wl")
    return workload.build(str(d), sigs=20, vrfs=6, posts=10,
                          memberships=8, pows=8, post_challenges=2,
                          device="cpu")


def _farm(wl=None, **kw):
    kw.setdefault("device", "cpu")
    if wl is not None:
        kw.setdefault("ed_verifier", wl.ed)
        kw.setdefault("vrf_verifier", wl.vrf)
        kw.setdefault("post_params", wl.post_params)
        kw.setdefault("post_seed", wl.post_seed)
    return VerificationFarm(**kw)


def _sig_reqs(n, valid=True, salt=b""):
    s = EdSigner(seed=bytes(31) + b"\x01")
    out = []
    for i in range(n):
        msg = b"m" + salt + i.to_bytes(4, "little")
        sig = s.sign(Domain.HARE, msg)
        if not valid:
            sig = bytes(64)
        out.append(SigRequest(int(Domain.HARE), s.public_key, msg, sig))
    return out


class _BlockingBackend:
    """Wrap farm._run_backend so the FIRST dispatch blocks on an event
    (a slow device pass) while later dispatches run live."""

    def __init__(self, farm, block_first=1, sleep_s=0.0):
        self.real = farm._run_backend
        self.gate = threading.Event()
        self.block_left = block_first
        self.sleep_s = sleep_s
        self.lock = threading.Lock()
        farm._run_backend = self

    def __call__(self, kind, reqs):
        with self.lock:
            blocked = self.block_left > 0
            self.block_left -= 1 if blocked else 0
        if blocked:
            assert self.gate.wait(30), "test gate never released"
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return self.real(kind, reqs)


# --- decision parity ------------------------------------------------------


def test_adversarial_batch_matches_inline(wl):
    expected = wl.inline_all()
    assert 0 < sum(expected) < len(expected), "workload must be mixed"
    assert {r.kind for r in wl.requests} == {"sig", "vrf", "post",
                                             "membership", "pow"}

    async def main():
        farm = _farm(wl)
        lanes = [Lane.BLOCK, Lane.GOSSIP, Lane.SYNC]
        got = await asyncio.gather(
            *(farm.submit(r, lane=lanes[i % 3])
              for i, r in enumerate(wl.requests)))
        await farm.aclose()
        return got, farm.post_timing

    got, timing = asyncio.run(main())
    assert got == expected
    # every POST batch reports its host stages (verify_many's timing)
    assert set(timing) == {"prep", "labels", "hash", "check"}
    assert all(v >= 0 for v in timing.values())


def test_parity_across_repeat_submission(wl):
    async def main():
        farm = _farm(wl)
        first = await asyncio.gather(*(farm.submit(r)
                                       for r in wl.requests))
        second = await asyncio.gather(*(farm.submit(r)
                                        for r in wl.requests))
        await farm.aclose()
        return first, second

    first, second = asyncio.run(main())
    assert first == second == wl.inline_all()


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_unpadded_post_batches_give_the_padded_verdicts(wl, n):
    """The JAX farm pads a POST batch to a power of two by repeating item
    0 (for XLA's per-shape compiles); the port does not. The K3 subset is
    keyed per item, so the verdicts of the first n items are the same
    with and without the pad, and equal the inline ones."""
    posts = [r for r in wl.requests if isinstance(r, PostRequest)][:n]
    items = [r.item for r in posts]
    pad = 1 << (n - 1).bit_length()
    padded = items + [items[0]] * (pad - n)
    plain = post_verifier.verify_many(items, wl.post_params,
                                      seed=wl.post_seed, device="cpu")
    assert plain == post_verifier.verify_many(
        padded, wl.post_params, seed=wl.post_seed, device="cpu")[:n]
    assert plain == [wl.inline_verify(r) for r in posts]

    async def main():
        farm = _farm(wl)
        got = await asyncio.gather(*(farm.submit(r) for r in posts))
        await farm.aclose()
        return got

    assert asyncio.run(main()) == plain


def test_pow_kind_runs_the_batched_branch(wl, monkeypatch):
    """A pow batch of at least ops.pow.verify_many's min_device items takes
    the tensor path (not hashlib) and matches inline k2pow.verify: the
    workload's witnesses and a burst of distinct ones, valid or not."""
    from spacemesh_tpu_torch.ops import pow as k2pow

    pows = [r for r in wl.requests if isinstance(r, PowRequest)]
    pows += [PowRequest(r.challenge, r.node_id, r.difficulty, r.nonce + k)
             for k in range(1, 5) for r in pows[:8]]
    seen = []
    real = k2pow.pow_verify_batch
    monkeypatch.setattr(k2pow, "pow_verify_batch",
                        lambda *a: seen.append(1) or real(*a))

    async def main():
        farm = _farm(wl)
        got = await asyncio.gather(*(farm.submit(r) for r in pows))
        await farm.aclose()
        return got

    assert asyncio.run(main()) == [wl.inline_verify(r) for r in pows]
    assert seen


def test_sig_kind_takes_the_batch_check_without_cryptography(monkeypatch):
    """On a host without cryptography the sig kind runs the pure-Python
    Pippenger batch check, with per-item verdicts."""
    monkeypatch.setattr(signing, "_HAVE_CRYPTOGRAPHY", False)
    signing.clear_verify_cache()
    reqs = _sig_reqs(10, salt=b"pp") + _sig_reqs(3, valid=False, salt=b"q")
    calls = []
    real = signing.ed25519_batch_verify
    monkeypatch.setattr(signing, "ed25519_batch_verify",
                        lambda items: calls.append(len(items))
                        or real(items))

    async def main():
        farm = _farm()
        got = await asyncio.gather(*(farm.submit(r) for r in reqs))
        await farm.aclose()
        return got

    try:
        assert asyncio.run(main()) == [True] * 10 + [False] * 3
    finally:
        signing.clear_verify_cache()
    assert sum(calls) == len(reqs)


def test_farm_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VerificationFarm()
    assert _farm().device == torch.device("cpu")


# --- scheduler behavior ---------------------------------------------------


def test_dedup_shares_one_verdict():
    async def main():
        farm = _farm()
        bb = _BlockingBackend(farm)
        [req] = _sig_reqs(1)
        t1 = asyncio.ensure_future(farm.submit(req))
        await asyncio.sleep(0.05)  # t1's batch is now blocked in dispatch
        t2 = asyncio.ensure_future(farm.submit(req))
        t3 = asyncio.ensure_future(farm.submit(req))
        await asyncio.sleep(0.05)
        bb.gate.set()
        got = await asyncio.gather(t1, t2, t3)
        stats = dict(farm.stats)
        await farm.aclose()
        return got, stats

    got, stats = asyncio.run(main())
    assert got == [True, True, True]
    assert stats["dedup_hits"] >= 2
    assert stats["items"] == 1  # one request ever reached a backend


def test_dedup_promotes_to_higher_priority_lane():
    async def main():
        farm = _farm(max_inflight=1)
        bb = _BlockingBackend(farm)
        first = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)  # dispatch blocked; cap=1 saturated
        [req] = _sig_reqs(1, salt=b"pm")
        sync_t = asyncio.ensure_future(farm.submit(req, lane=Lane.SYNC))
        await asyncio.sleep(0.02)  # queued, held by the in-flight cap
        t0 = time.perf_counter()
        ok = await asyncio.wait_for(farm.submit(req, lane=Lane.BLOCK), 5)
        latency = time.perf_counter() - t0
        bb.gate.set()
        assert await sync_t is True
        assert await first is True
        await farm.aclose()
        return ok, latency

    ok, latency = asyncio.run(main())
    assert ok is True
    assert latency < 1.0, latency


def test_deadline_dispatches_partial_batch():
    async def main():
        farm = _farm(max_batch=10_000)
        bb = _BlockingBackend(farm)
        first = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)  # first dispatch now blocked
        reqs = _sig_reqs(5, salt=b"dl")
        t0 = time.perf_counter()
        got = await asyncio.gather(*(farm.submit(r) for r in reqs))
        latency = time.perf_counter() - t0
        stats = dict(farm.stats)
        bb.gate.set()
        assert await first is True
        await farm.aclose()
        return got, latency, stats

    got, latency, stats = asyncio.run(main())
    assert got == [True] * 5
    assert latency < 5.0
    assert stats["max_occupancy"] >= 5  # the 5 coalesced into one batch


def test_block_lane_not_starved_by_sync_flood():
    async def main():
        farm = _farm(max_batch=8, max_inflight=2)
        _BlockingBackend(farm, block_first=0, sleep_s=0.15)
        flood = [asyncio.ensure_future(farm.submit(r, lane=Lane.SYNC))
                 for r in _sig_reqs(160, salt=b"fl")]
        await asyncio.sleep(0.05)  # flood is mid-dispatch, lanes deep
        t0 = time.perf_counter()
        ok = await farm.submit(_sig_reqs(1, salt=b"blk")[0],
                               lane=Lane.BLOCK)
        block_latency = time.perf_counter() - t0
        still_pending = sum(1 for f in flood if not f.done())
        await asyncio.gather(*flood)
        await farm.aclose()
        return ok, block_latency, still_pending

    ok, block_latency, still_pending = asyncio.run(main())
    assert ok is True
    assert block_latency < 1.0, block_latency
    assert still_pending > 16, still_pending


def test_sync_backpressure_bounds_queue():
    async def main():
        farm = _farm(lane_bounds={Lane.SYNC: 4})
        bb = _BlockingBackend(farm, block_first=100)
        tasks = [asyncio.ensure_future(farm.submit(r, lane=Lane.SYNC))
                 for r in _sig_reqs(12, salt=b"bp")]
        await asyncio.sleep(0.1)
        peak = farm.stats["queue_peak"]["sync"]
        bb.gate.set()
        bb.block_left = 0
        got = await asyncio.gather(*tasks)
        await farm.aclose()
        return peak, got

    peak, got = asyncio.run(main())
    assert peak <= 4
    assert got == [True] * 12


def test_cancelled_caller_leaves_batch_intact():
    async def main():
        farm = _farm()
        bb = _BlockingBackend(farm)
        first = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)
        reqs = _sig_reqs(3, salt=b"cx")
        tasks = [asyncio.ensure_future(farm.submit(r)) for r in reqs]
        await asyncio.sleep(0)
        tasks[1].cancel()
        bb.gate.set()
        results = await asyncio.gather(*tasks, return_exceptions=True)
        assert await first is True
        await farm.aclose()
        return results

    r = asyncio.run(main())
    assert r[0] is True and r[2] is True
    assert isinstance(r[1], asyncio.CancelledError)


def test_cancelled_waiter_hands_freed_slot_to_next():
    async def main():
        farm = _farm()
        assert await farm.submit(_sig_reqs(1, salt=b"w0")[0]) is True
        lane = Lane.SYNC
        group = farm._group
        group._count[lane] = farm.lane_bounds[lane]  # lane "full"
        b = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"wb")[0], lane=lane))
        c = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"wc")[0], lane=lane))
        for _ in range(3):
            await asyncio.sleep(0)
        assert len(group._waiters[lane]) == 2
        group.release(lane)       # frees one slot: resolves b's waiter
        b.cancel()                # ...which b will never consume
        with pytest.raises(asyncio.CancelledError):
            await b
        ok = await asyncio.wait_for(c, 5)  # hangs without the handoff
        await farm.aclose()
        return ok

    assert asyncio.run(main()) is True


def test_sync_shutdown_with_live_loop_fails_pending():
    async def main():
        farm = _farm(max_inflight=1, lane_bounds={Lane.SYNC: 1})
        bb = _BlockingBackend(farm)
        inflight = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)
        queued = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"q")[0], lane=Lane.SYNC))
        waiting = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"w")[0], lane=Lane.SYNC))
        await asyncio.sleep(0.02)
        farm.shutdown()  # the sync path, loop still running
        with pytest.raises(FarmClosed):
            await asyncio.wait_for(queued, 5)
        with pytest.raises(FarmClosed):
            await asyncio.wait_for(waiting, 5)
        bb.gate.set()  # already-dispatched work still completes
        assert await inflight is True
        await farm.aclose()

    asyncio.run(main())


def test_close_fails_pending_with_farm_closed():
    async def main():
        farm = _farm(max_inflight=1)
        bb = _BlockingBackend(farm)
        inflight = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)
        queued = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"q")[0]))
        await asyncio.sleep(0.02)
        closer = asyncio.ensure_future(farm.aclose())
        await asyncio.sleep(0.02)
        with pytest.raises(FarmClosed):
            await queued
        bb.gate.set()
        assert await inflight is True
        await closer
        with pytest.raises(FarmClosed):
            await farm.submit(_sig_reqs(1, salt=b"z")[0])

    asyncio.run(main())


def test_reset_lanes_fails_queued_and_keeps_serving():
    async def main():
        farm = _farm(max_inflight=1)
        bb = _BlockingBackend(farm)
        inflight = asyncio.ensure_future(farm.submit(_sig_reqs(1)[0]))
        await asyncio.sleep(0.05)
        queued = asyncio.ensure_future(
            farm.submit(_sig_reqs(1, salt=b"r")[0]))
        await asyncio.sleep(0.02)
        farm.reset_lanes()
        with pytest.raises(FarmClosed):
            await queued
        bb.gate.set()
        assert await inflight is True
        assert farm._group.total() == 0
        ok = await asyncio.wait_for(
            farm.submit(_sig_reqs(1, salt=b"after")[0]), 5)
        await farm.aclose()
        return ok

    assert asyncio.run(main()) is True


def test_failing_backend_opens_the_kind_breaker():
    """A backend that keeps raising fails its batches; after the failure
    budget the kind's breaker fails them fast with BreakerOpen, and the
    other kinds keep serving."""

    async def main():
        farm = _farm()
        real = farm._run_backend

        def broken(kind, reqs):
            if kind == "pow":
                raise RuntimeError("device lost")
            return real(kind, reqs)

        farm._run_backend = broken
        req = PowRequest(bytes(32), bytes(32), bytes([255]) * 32, 0)
        errors = []
        for i in range(6):
            try:
                await farm.submit(PowRequest(bytes(32), bytes(32),
                                             bytes([255]) * 32, i))
            except Exception as e:  # noqa: BLE001 — collected and asserted
                errors.append(type(e))
        ok = await farm.submit(_sig_reqs(1, salt=b"br")[0])
        state = farm._breakers["pow"].state
        await farm.aclose()
        return errors, ok, state, req

    errors, ok, state, _ = asyncio.run(main())
    assert errors[:5] == [RuntimeError] * 5
    assert errors[5] is BreakerOpen
    assert state == "open" and ok is True


# --- the obs pieces the farm stands on ----------------------------------


def test_breaker_backoff_and_watchdog_equal_the_jax_package():
    """The same scripted failures, probes and clock through both
    packages' CircuitBreaker (closed, open, half-open, an escalated
    reopen, the failure window), backoff_delay, Watchdog and health
    registry: identical states, delays and verdicts at every step."""
    from spacemesh_tpu.obs import health as jhealth
    from spacemesh_tpu.obs import remediate as jrem
    from spacemesh_tpu_torch.obs import health as thealth
    from spacemesh_tpu_torch.obs import remediate as trem

    steps = [(0, "f"), (1, "f"), (0.5, "a"), (2, "a"), (0, "a"), (0, "f"),
             (10, "a"), (0, "s"), (0, "f"), (0, "f"), (5, "a"), (0, "f"),
             (0, "a"), (20, "a"), (0, "f"), (50, "a"), (0, "f"), (0, "a"),
             (30, "a"), (0, "s"), (0, "f"), (11, "f"), (0, "a")]

    def breaker(rem):
        t = [0.0]
        br = rem.CircuitBreaker("x", failure_budget=2, window_s=10,
                                cooldown_s=1, cooldown_cap_s=8,
                                time_source=lambda: t[0])
        log = []
        for dt, op in steps:
            t[0] += dt
            if op == "a":
                log.append(br.allow())
            else:
                {"f": br.record_failure, "s": br.record_success}[op]()
            log.append((br.state, br.retry_in()))
        return log

    def watchdog(health):
        progress = [0]
        active = [True]
        w = health.Watchdog("w", progress=lambda: progress[0],
                            deadline_s=3.0, active=lambda: active[0])
        out = []
        for now, p, a in [(0, 0, True), (2, 0, True), (4, 0, True),
                          (5, 1, True), (9, 1, True), (10, 1, False),
                          (30, 1, True), (32, 1, True), (34, 1, True)]:
            progress[0], active[0] = p, a
            out.append(w.check(now))
        reg = health.HealthRegistry()
        probe = w.check
        reg.register("w", probe)
        reg.register("bad", lambda now: 1 / 0)
        out.append(sorted(reg.report(40.0).items()))
        reg.unregister("w", lambda now: (True, ""))  # not the same probe
        reg.unregister("bad")
        out.append(sorted(reg.report(41.0)))
        return out

    assert breaker(jrem) == breaker(trem)
    states = {s for s in breaker(trem) if isinstance(s, tuple)}
    assert {s for s, _ in states} == {"closed", "open", "half_open"}
    assert watchdog(jhealth) == watchdog(thealth)
    for attempt in range(6):
        for hint in (None, 0.01, 3.0):
            kw = dict(base_s=0.05, cap_s=2.0, retry_after_s=hint, seed=9)
            assert (trem.backoff_delay(attempt, **kw)
                    == jrem.backoff_delay(attempt, **kw))
