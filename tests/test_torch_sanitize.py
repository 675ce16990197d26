"""The port's runtime sanitizers (``spacemesh_tpu_torch/utils/sanitize.py``),
held to the JAX package's.

Twins of the runtime half of ``tests/test_racecheck.py`` (the static
spacecheck rules are not ported): mode parsing equal to the JAX parser's,
the env boot, a seeded cross-thread write with attribution, consistent
locking staying quiet, a seeded lock-order inversion, condition waits, a
lock held across an await, the owner-write handoff and the LaneGroup
rebind; plus the registry-thread and slow-callback kinds, and the port's
own paths (the multi-tenant scheduler, the farm under verifyd) staying
clean with ``race`` and ``registry-thread`` armed, as ``chip_smoke.py``
``[trace]`` runs them on the card.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest
import torch

from spacemesh_tpu_torch.utils import metrics, sanitize, tracing

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def race_mode():
    sanitize.clear_violations()
    sanitize.enable(modes=["race"])
    yield sanitize
    sanitize.disable()
    sanitize.clear_violations()


# --- modes + thresholds ---------------------------------------------------


@pytest.mark.parametrize("raw", [
    "1", "all", "race", "lockset", "slow, shape", "registry-thread",
    "registry", "", "off", None, "bogus", "race,bogus",
    "race,registry-thread"])
def test_mode_parsing_equals_the_jax_parser(raw):
    from spacemesh_tpu.utils import sanitize as jsanitize

    assert sanitize.parse_modes(raw) == jsanitize.parse_modes(raw)
    assert sanitize.KINDS == jsanitize.KINDS


def test_mode_parsing():
    assert sanitize.parse_modes("1") == frozenset(sanitize.KINDS)
    assert sanitize.parse_modes("race") == {sanitize.KIND_RACE}
    assert sanitize.parse_modes("slow, shape") == \
        {sanitize.KIND_SLOW, sanitize.KIND_SHAPE}
    assert sanitize.parse_modes("bogus") == frozenset()
    assert sanitize.parse_modes("race,bogus") == {sanitize.KIND_RACE}


def test_slow_threshold_parsing():
    assert sanitize.parse_slow_threshold(None) is None
    assert sanitize.parse_slow_threshold("") is None
    assert sanitize.parse_slow_threshold("250") == 0.25
    assert sanitize.parse_slow_threshold("1") == 0.001
    assert sanitize.parse_slow_threshold("0") is None
    assert sanitize.parse_slow_threshold("-10") is None
    assert sanitize.parse_slow_threshold("garbage") is None


def test_race_mode_arms_only_race(race_mode):
    assert sanitize.race_enabled()
    assert sanitize.enabled(sanitize.KIND_RACE)
    assert not sanitize.enabled(sanitize.KIND_SLOW)
    assert not sanitize.enabled(sanitize.KIND_SHAPE)
    sanitize.on_jit_shape("labels_fused", 7)  # dormant under race-only
    assert not sanitize.violations()


def test_jit_shape_kind_parses_arms_and_guards():
    """No port path calls on_jit_shape (the kernels compile once per
    source); the hook keeps the JAX contract for whoever arms it."""
    sanitize.clear_violations()
    sanitize.enable(modes=["shape"])
    try:
        sanitize.on_jit_shape("labels_fused", 4096)
        with pytest.raises(sanitize.SanitizeError, match="off-bucket"):
            sanitize.on_jit_shape("labels_fused", 4097)
        assert [v.kind for v in sanitize.violations()] == ["jit-shape"]
    finally:
        sanitize.disable()
        sanitize.clear_violations()
    src = "\n".join(p.read_text() for p in
                    (REPO / "spacemesh_tpu_torch").rglob("*.py")
                    if p.name != "sanitize.py")
    assert "on_jit_shape(" not in src


def _boot(env_value: str, code: str) -> subprocess.CompletedProcess:
    env = os.environ | {"SPACEMESH_SANITIZE": env_value}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)


def test_env_boot_race_mode():
    res = _boot("race", """
        from spacemesh_tpu_torch.utils import sanitize
        assert sanitize.enabled()
        assert sanitize.race_enabled()
        assert not sanitize.enabled(sanitize.KIND_SLOW)
        assert isinstance(sanitize.lock("x"), sanitize.TrackedLock)
        print("race boot ok")
    """)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "race boot ok" in res.stdout


def test_env_boot_garbage_mode_stays_off():
    res = _boot("bogus", """
        from spacemesh_tpu_torch.utils import sanitize
        assert not sanitize.enabled()
        print("off ok")
    """)
    assert res.returncode == 0, res.stdout + res.stderr


# --- seeded races ---------------------------------------------------------


def test_seeded_cross_thread_write_with_attribution(race_mode):
    tracing.start(capacity=64)
    try:
        field = sanitize.SharedField("test.cursor")
        lock = sanitize.lock("test.lock")
        with lock:
            field.touch()                      # thread A, locked
        seen = {}

        def racer():
            with tracing.span("racer.write") as sp:
                seen["span"] = sp.id
                field.touch()                  # thread B, bare

        t = threading.Thread(target=racer, name="racer")
        t.start()
        t.join()
    finally:
        tracing.stop()
    hits = [v for v in sanitize.violations() if v.kind == "race"]
    assert len(hits) == 1
    v = hits[0]
    assert "test.cursor" in v.detail
    assert v.thread == "racer" and v.stack and "racer" in v.stack
    assert v.other_stack
    assert v.span == seen["span"]


def test_consistent_locking_stays_quiet(race_mode):
    field = sanitize.SharedField("test.quiet")
    lock = sanitize.lock("test.quiet.lock")
    with lock:
        field.touch()

    def worker():
        for _ in range(50):
            with lock:
                field.touch()

    ts = [threading.Thread(target=worker) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not sanitize.violations()


def test_seeded_lock_order_inversion(race_mode):
    a = sanitize.lock("order.A")
    b = sanitize.lock("order.B")
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass

    t = threading.Thread(target=inverted, name="inverter")
    t.start()
    t.join()
    hits = [v for v in sanitize.violations() if v.kind == "lock-order"]
    assert len(hits) == 1
    assert "order.A" in hits[0].detail and "order.B" in hits[0].detail
    assert hits[0].stack and "inverted" in hits[0].stack
    assert hits[0].other_stack


def test_condition_wait_releases_held_key(race_mode):
    lock = sanitize.lock("cond.lock")
    cond = sanitize.condition("cond.idle", lock)
    woke = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            woke.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert woke and not sanitize.violations()


def test_lock_across_await_detected_at_runtime(race_mode):
    lk = sanitize.lock("held.lock")

    async def wedge():
        with lk:
            await asyncio.sleep(0.01)

    asyncio.run(wedge())
    hits = [v for v in sanitize.violations()
            if v.kind == "lock-across-await"]
    assert hits and "held.lock" in hits[0].detail


def test_owner_write_reset_allows_ownership_handoff(race_mode):
    f = sanitize.SharedField("test.handoff", mode="owner-write")
    f.touch()

    def rebound_owner():
        f.reset()
        f.touch()

    t = threading.Thread(target=rebound_owner)
    t.start()
    t.join()
    assert not sanitize.violations()
    # without the reset a second writer IS reported
    g = sanitize.SharedField("test.owner", mode="owner-write")
    g.touch()
    t = threading.Thread(target=g.touch)
    t.start()
    t.join()
    assert [v.kind for v in sanitize.violations()] == ["race"]


def test_lanegroup_rebind_resets_owner(race_mode):
    import enum

    from spacemesh_tpu_torch.runtime.queue import LaneGroup

    class L(enum.IntEnum):
        ONLY = 0

    group = LaneGroup(L, {L.ONLY: 4})

    async def drive():
        group.bind(asyncio.get_running_loop())
        group.add(L.ONLY)
        group.release(L.ONLY)

    asyncio.run(drive())

    def second_loop():
        asyncio.run(drive())

    t = threading.Thread(target=second_loop)
    t.start()
    t.join()
    assert not sanitize.violations(), sanitize.violations()


def test_enable_unknown_mode_token_is_ignored_not_fatal():
    sanitize.clear_violations()
    try:
        sanitize.enable(modes=["bogus", "race"])
        assert sanitize.race_enabled()
        assert not sanitize.enabled(sanitize.KIND_SLOW)
        sanitize.enable(modes=["slowcallback"])
        assert not sanitize.enabled()
    finally:
        sanitize.disable()


def test_tracked_primitives_off_by_default():
    sanitize.disable()
    assert isinstance(sanitize.lock("x"), type(threading.Lock()))
    assert isinstance(sanitize.condition("x"), threading.Condition)
    f = sanitize.SharedField("off.field")
    f.touch()
    assert not sanitize.violations()


# --- registry-thread and slow-callback -----------------------------------


def test_registry_thread_affinity_raises_off_thread():
    sanitize.clear_violations()
    sanitize.enable(modes=["registry-thread"])
    try:
        reg = metrics.Registry()
        reg.counter("made_on_owner_total")  # the owning thread: fine
        err = []

        def minting():
            try:
                reg.counter("minted_off_thread_total")
            except sanitize.SanitizeError as e:
                err.append(e)
            reg.counter("made_on_owner_total").inc()  # recording: fine

        t = threading.Thread(target=minting)
        t.start()
        t.join()
        assert err and "minted_off_thread_total" in str(err[0])
        assert [v.kind for v in sanitize.violations()] == \
            ["registry-thread"]
        assert metrics.sanitize_violations.sample()[
            (("kind", "registry-thread"),)] >= 1
    finally:
        sanitize.disable()
        sanitize.clear_violations()


def test_slow_callback_attributed_to_its_span():
    sanitize.clear_violations()
    sanitize.enable(slow_threshold_s=0.02, modes=["slow-callback"])
    tracing.start(capacity=64)
    try:
        async def hog():
            with tracing.span("farm.batch") as sp:
                await asyncio.sleep(0)
                # this step holds the loop inside the span, on purpose
                time.sleep(0.05)  # spacecheck: ok=SC002 the violation the sanitizer must report
                await asyncio.sleep(0)
                return sp.id

        span_id = asyncio.run(hog())
    finally:
        tracing.stop()
        sanitize.disable()
    hits = [v for v in sanitize.violations() if v.kind == "slow-callback"]
    sanitize.clear_violations()
    assert hits and hits[0].seconds >= 0.02
    assert hits[0].span == span_id


# --- the port's paths stay clean ------------------------------------------


@pytest.fixture
def race_and_registry():
    sanitize.clear_violations()
    sanitize.enable(modes=["race", "registry-thread"])
    yield
    sanitize.disable()
    sanitize.clear_violations()


def test_clean_scheduler_e2e_stays_quiet(race_and_registry, tmp_path):
    """The multi-tenant path (packed init through the scheduler's tracked
    locks, the writers' declared cursors, the engine's shared gauge map)
    reports nothing, as in the JAX package's run."""
    from spacemesh_tpu_torch.runtime import TenantScheduler

    ids = [(f"t{i}", hashlib.sha256(b"rc-n%d" % i).digest(),
            hashlib.sha256(b"rc-c%d" % i).digest()) for i in range(2)]
    with TenantScheduler(workers=2, pack_lanes=128, writer_threads=1,
                         device="cpu") as sched:
        assert isinstance(sched._lock, sanitize.TrackedLock)
        handles = []
        for tid, node, commit in ids:
            sched.register_tenant(tid)
            handles.append(sched.submit_init(
                tid, tmp_path / tid, node_id=node, commitment=commit,
                num_units=1, labels_per_unit=160, scrypt_n=2,
                max_file_size=1 << 20))
        for h in handles:
            h.result(timeout=300)
        for tid, _, _ in ids:
            sched.unregister_tenant(tid)
    bad = sanitize.violations()
    assert not bad, "\n".join(f"{v.kind}: {v.detail}\n  {v.stack}"
                              for v in bad)


def test_clean_verifyd_e2e_stays_quiet(race_and_registry):
    """verifyd's admission, the scheduler's quanta, the farm's lanes and
    its owner-write stats under race + registry-thread: no violation."""
    from spacemesh_tpu_torch.core.signing import EdSigner
    from spacemesh_tpu_torch.verify.farm import SigRequest
    from spacemesh_tpu_torch.verifyd.service import VerifydService

    signer = EdSigner(hashlib.sha256(b"sanitize").digest())
    reqs = [SigRequest(1, signer.public_key, b"m%d" % i,
                       signer.sign(1, b"m%d" % i)) for i in range(12)]

    async def go():
        svc = VerifydService(device="cpu")
        await svc.start()
        try:
            for c in ("a", "b"):
                svc.register_client(c)
            return await asyncio.gather(svc.verify("a", reqs[:6]),
                                        svc.verify("b", reqs[6:]))
        finally:
            await svc.aclose()

    got = asyncio.run(go())
    assert got == [[True] * 6, [True] * 6]
    bad = sanitize.violations()
    assert not bad, "\n".join(f"{v.kind}: {v.detail}\n  {v.stack}"
                              for v in bad)


def test_violation_counter_survives_flight_bundle(race_mode, tmp_path):
    from spacemesh_tpu_torch.obs import flight as flight_mod

    before = metrics.sanitize_violations.sample().get(
        (("kind", "race"),), 0.0)
    field = sanitize.SharedField("test.flight")
    lock = sanitize.lock("test.flight.lock")
    with lock:
        field.touch()
    t = threading.Thread(target=field.touch)
    t.start()
    t.join()
    assert [v for v in sanitize.violations() if v.kind == "race"]
    after = metrics.sanitize_violations.sample()[(("kind", "race"),)]
    assert after == before + 1
    rec = flight_mod.FlightRecorder(tmp_path / "spool",
                                    time_source=lambda: 1000.0)
    path = rec.dump("test:race", now=1000.0, force=True)
    assert path is not None
    bundle = flight_mod.read_bundle(path)
    prom = (path / "metrics.prom").read_text()
    assert f'sanitize_violations_total{{kind="race"}} {after}' in prom
    kinds = {v["kind"] for v in bundle["manifest"]["sanitize_violations"]}
    assert "race" in kinds
