"""The port's priority-lane admission primitives
(``spacemesh_tpu_torch/runtime/queue.py``) against the JAX package's.

The same scripted operations go through both packages' ``LaneGroup`` and
``KindLanes``; counts, wake-ups, drain order and closed-queue errors must
agree step for step, including the cancelled-waiter slot handoff.
"""

import asyncio
import enum

import pytest

from spacemesh_tpu.runtime import queue as jq
from spacemesh_tpu_torch.runtime import queue as tq

PACKAGES = pytest.mark.parametrize("q", [jq, tq], ids=["jax", "torch"])


class Lane(enum.IntEnum):
    HI = 0
    MID = 1
    LO = 2


class Entry:
    def __init__(self, lane, deadline, tag):
        self.lane, self.deadline, self.tag = lane, deadline, tag


def _group(q, bound=2, depths=None):
    return q.LaneGroup(
        Lane, {lane: bound for lane in Lane},
        on_depth=(None if depths is None
                  else lambda lane, d: depths.append((lane.name, d))))


def test_scripted_accounting_is_identical_across_packages():
    """add/release/take/remove/drain through both packages: every count,
    depth-hook call and drained entry order is the same."""

    def script(q):
        depths = []
        g = _group(q, bound=3, depths=depths)
        kl = q.KindLanes(g)
        log = []
        entries = [Entry(Lane(i % 3), 10.0 - i, i) for i in range(9)]
        for e in entries:
            log.append(("append", kl.append(e)))
        log.append(("count", kl.count(), g.total()))
        log.append(("deadline", kl.earliest_deadline()))
        log.append(("remove", kl.remove(entries[4]), kl.remove(entries[4])))
        taken = kl.take(4)
        log.append(("take", [e.tag for e in taken]))
        for e in taken:
            g.release(e.lane)
        log.append(("after", {lane.name: g.count(lane) for lane in Lane}))
        log.append(("drain", [e.tag for e in kl.drain_all()], kl.count()))
        return log, depths

    assert script(jq) == script(tq)
    log, _ = script(tq)
    # highest-priority lane drains first, FIFO within a lane
    assert log[-3] == ("take", [0, 3, 6, 1])


@PACKAGES
def test_acquire_blocks_at_bound_and_release_wakes_one(q):
    async def main():
        g = _group(q, bound=1)
        g.bind(asyncio.get_running_loop())
        g.add(Lane.LO)
        order = []

        async def waiter(tag):
            await g.acquire(Lane.LO)
            order.append(tag)
            g.add(Lane.LO)

        tasks = [asyncio.ensure_future(waiter(t)) for t in "ab"]
        for _ in range(3):
            await asyncio.sleep(0)
        assert order == [] and len(g._waiters[Lane.LO]) == 2
        # a full LO lane never blocks another lane's submitters
        await asyncio.wait_for(g.acquire(Lane.HI), 1)
        g.release(Lane.LO)
        await asyncio.sleep(0)
        assert order == ["a"]
        g.release(Lane.LO)
        await asyncio.wait_for(asyncio.gather(*tasks), 1)
        return order

    assert asyncio.run(main()) == ["a", "b"]


@PACKAGES
def test_cancelled_waiter_hands_the_slot_on(q):
    async def main():
        g = _group(q, bound=1)
        g.bind(asyncio.get_running_loop())
        g.add(Lane.MID)
        b = asyncio.ensure_future(g.acquire(Lane.MID))
        c = asyncio.ensure_future(g.acquire(Lane.MID))
        for _ in range(3):
            await asyncio.sleep(0)
        g.release(Lane.MID)  # resolves b's waiter...
        b.cancel()           # ...which b never consumes
        with pytest.raises(asyncio.CancelledError):
            await b
        await asyncio.wait_for(c, 1)  # hangs without the handoff
        return True

    assert asyncio.run(main())


@PACKAGES
def test_closed_group_fails_waiters_with_its_exception(q):
    class Closed(q.QueueClosed):
        pass

    async def main():
        g = q.LaneGroup(Lane, {lane: 1 for lane in Lane},
                        make_exc=lambda: Closed("closed"))
        g.bind(asyncio.get_running_loop())
        g.add(Lane.HI)
        w = asyncio.ensure_future(g.acquire(Lane.HI))
        await asyncio.sleep(0)
        g.closed = True
        g.fail_waiters()
        with pytest.raises(Closed):
            await w
        # a woken waiter that finds the group closed raises too
        g.closed = False
        w2 = asyncio.ensure_future(g.acquire(Lane.HI))
        await asyncio.sleep(0)
        g.closed = True
        g.release(Lane.HI)
        with pytest.raises(Closed):
            await w2

    asyncio.run(main())


@PACKAGES
def test_rebinding_to_a_new_loop_drops_state(q):
    g = _group(q)

    async def first():
        assert g.bind(asyncio.get_running_loop()) is True
        assert g.bind(asyncio.get_running_loop()) is False
        g.add(Lane.LO)
        g.dedup["k"] = object()

    asyncio.run(first())
    assert g.total() == 1

    async def second():
        assert g.bind(asyncio.get_running_loop()) is True

    asyncio.run(second())
    assert g.total() == 0 and g.dedup == {}
