"""Virtual-clock asyncio event loop for deterministic time-driven tests (port of
``spacemesh_tpu/utils/vclock.py``).

The reference injects fake clocks everywhere (clockwork in
timesync/clock_test.go and throughout the Go test suite — SURVEY.md
§4.3) so consensus tests are machine-load independent. asyncio needs the
equivalent at the LOOP level: every `asyncio.sleep`, `wait_for`, and
`call_later` resolves against `loop.time()`, so virtualizing that one
clock virtualizes the whole timing model.

Mechanics: `loop.time()` returns virtual time, and the selector is
wrapped so that whenever the loop would block waiting for a timer with
no ready IO, the virtual clock JUMPS to the timer's deadline instead of
sleeping. Logical ordering of every callback is exactly preserved; wall
time spent is proportional to work done, not to configured durations.
A 14-layer consensus scenario with 2 s layers runs in however long the
hashing takes, identically on an idle or a loaded machine.

Two interactions with external reality:
- Executor threads (`asyncio.to_thread`, `run_in_executor`): virtual
  time FREEZES while any executor future is outstanding — otherwise the
  clock would leap over consensus deadlines (or a wait_for timeout)
  while a POST init is still crunching in a worker thread. The loop
  polls real IO briefly instead; the thread's completion callback wakes
  it via the self-pipe.
- No timers at all: the loop is waiting on pure external IO (a
  subprocess pipe, a real socket) — fall back to a short real wait
  instead of spinning.
- With a `time_governor` attached (sharded scenario fabric), executor
  completions are additionally SEQUENCED: each future completes at a
  loop-idle point, in submission order, one per idle. Raw completion
  order is an OS-scheduling race, and the governor's real-time pipe
  round-trips make that race actually flip between runs; since virtual
  time is frozen anyway, picking the deterministic schedule is always
  legal and makes sharded replay byte-identical.

Components must read time from the loop for this to work: `App`
accepts `time_source` and wires it through to LayerClock, hare, and
beacon, so tests pass `time_source=loop.time`.
"""

from __future__ import annotations

import asyncio

START = 1_700_000_000.0  # arbitrary fixed epoch so layer math looks real


class VirtualClockLoop(asyncio.SelectorEventLoop):
    """SelectorEventLoop whose clock jumps over idle waits."""

    def __init__(self, start: float = START):
        super().__init__()
        self._vtime = start
        self._busy_threads = 0
        self._io_streak = 0
        # Sequenced executor releases (governor mode only): real threads
        # finish in OS-scheduling order, and WHICH ready batch their
        # wake-up lands in is a wall-clock race. Single-process sims are
        # stable because nothing else perturbs real timing, but a shard
        # governor blocks the loop on worker pipes for real milliseconds,
        # so completions bunch and the race starts flipping replay runs.
        # Under a governor every executor future is therefore completed
        # at a loop-idle point, in submission order, one per idle — a
        # deterministic schedule that is always legal because virtual
        # time freezes while any thread is outstanding.
        self._exec_seq = 0              # next submission id
        self._exec_next = 0             # next id allowed to complete
        self._exec_results: dict[int, tuple] = {}   # id -> (result, exc)
        self._exec_futs: dict[int, asyncio.Future] = {}
        # Optional conservative-window governor (sim/shard.py): called as
        # governor(now, proposed) -> target before any idle time jump.
        # Returning a target < proposed holds the clock at a barrier (a
        # cross-shard window edge); returning None falls back to a short
        # real wait (external IO pending). The hook lives HERE so
        # ChaosClockLoop's extra select wrapper composes with it.
        self.time_governor = None
        # CRITICAL: asyncio fires a timer when `when < time() + resolution`.
        # The default resolution (1 ns) is BELOW one float64 ulp at
        # unix-epoch magnitudes (~4.8e-7 at 1.7e9), so `time() + 1e-9`
        # rounds back to time() and a timer scheduled exactly AT the
        # current virtual instant never fires — the loop spins forever
        # with timeout=0. Resolution must exceed the clock's ulp.
        self._clock_resolution = 1e-6
        orig_select = self._selector.select

        def select(timeout):
            events = orig_select(0)
            if not events:
                self._io_streak = 0
                if self._exec_next < self._exec_seq:
                    # sequenced executor work in flight: time stays
                    # frozen, and the next completion (in submission
                    # order) is released only at a true idle point —
                    # never while ready callbacks are pending
                    if not self._ready:
                        entry = self._exec_results.pop(
                            self._exec_next, None)
                        if entry is not None:
                            fut = self._exec_futs.pop(self._exec_next)
                            self._exec_next += 1
                            result, exc = entry
                            if not fut.done():
                                if exc is not None:
                                    fut.set_exception(exc)
                                else:
                                    fut.set_result(result)
                        else:
                            events = orig_select(0.002)
                    return events
                if self._busy_threads > 0:
                    # real work in flight: do NOT advance virtual time —
                    # wait for the thread's wake-up on the self-pipe
                    events = orig_select(0.002)
                elif timeout is None:
                    # no timers scheduled at all: waiting on external IO —
                    # but a governor may install fresh timers (cross-shard
                    # frames arriving at a window barrier)
                    if self.time_governor is not None:
                        target = self.time_governor(self._vtime, None)
                        if target is not None and target > self._vtime:
                            self._vtime = target + 1e-6
                            return events
                    events = orig_select(0.005)
                elif timeout > 0:
                    # the 1 µs overshoot matters: _run_once fires timers
                    # strictly below time()+clock_resolution (~1 ns), and
                    # at unix-epoch magnitudes (1.7e9) one float64 ulp is
                    # ~4.8e-7 — landing EXACTLY on the deadline rounds the
                    # comparison into a never-firing busy spin
                    proposed = self._vtime + timeout + 1e-6
                    if self.time_governor is not None:
                        target = self.time_governor(self._vtime, proposed)
                        if target is not None:
                            proposed = max(
                                self._vtime, min(target + 1e-6, proposed))
                    self._vtime = proposed
            else:
                # timer-starvation guard: an fd that stays ready without
                # its callback making progress (e.g. a half-closed
                # socket) would freeze virtual time forever — after a
                # long all-IO streak, trickle time forward so timers
                # can't starve. 1 ms/iteration bounds the skew a LEGIT
                # burst (a large transfer) can accumulate.
                self._io_streak += 1
                if self._io_streak > 256 and timeout is not None \
                        and timeout > 0:
                    self._vtime += 0.001
            return events

        self._selector.select = select

    def time(self) -> float:
        return self._vtime

    def advance(self, dt: float) -> None:
        """Manual jump (rarely needed: idle waits auto-advance)."""
        self._vtime += dt

    def run_in_executor(self, executor, func, *args):
        if self.time_governor is None:
            fut = super().run_in_executor(executor, func, *args)
            self._busy_threads += 1

            def _done(_):
                self._busy_threads -= 1

            fut.add_done_callback(_done)
            return fut
        # governor mode: park the raw completion and let select()
        # release it at an idle point, in submission order
        seq = self._exec_seq
        self._exec_seq += 1
        fut = self.create_future()
        self._exec_futs[seq] = fut

        def _job():
            try:
                entry = (func(*args), None)
            except BaseException as exc:   # delivered via the future
                entry = (None, exc)
            self._exec_results[seq] = entry
            self.call_soon_threadsafe(self._exec_wake)

        super().run_in_executor(executor, _job)
        return fut

    def _exec_wake(self) -> None:
        """No-op loop wake so a parked completion is noticed promptly
        even while select() is in a real 2 ms poll."""


class ChaosClockLoop(VirtualClockLoop):
    """VirtualClockLoop that PERTURBS ready-callback ordering with a
    seeded RNG — the asyncio analogue of the reference's race detector
    plus schedule fuzzing (`go test -race` over randomized goroutine
    interleavings, SURVEY §5.2).

    asyncio's cooperative model rules out data races inside one loop,
    but ORDERING bugs survive: code that accidentally depends on two
    tasks resuming in FIFO order (who observes a shared dict first, a
    publish racing a subscribe) behaves identically on every normal run
    and breaks only under real-world timing. Shuffling the ready queue
    each iteration (timers still respect their deadlines — only
    already-runnable callbacks are reordered, so time causality is
    preserved) surfaces those dependencies deterministically: any
    failure replays exactly from its seed."""

    def __init__(self, seed: int, start: float = START):
        super().__init__(start=start)
        import random

        self._chaos_rng = random.Random(seed)
        # VirtualClockLoop already wrapped select for the time-jump; we
        # wrap once more so the shuffle runs every loop iteration,
        # before the loop drains self._ready
        inner = self._selector.select

        def chaotic_select(timeout):
            if len(self._ready) > 1:
                ready = list(self._ready)
                self._chaos_rng.shuffle(ready)
                self._ready.clear()
                self._ready.extend(ready)
            return inner(timeout)

        self._selector.select = chaotic_select


async def cancel_all_tasks() -> None:
    """Cancel every task but the caller and await them (teardown helper —
    must run INSIDE the loop so gather binds to it)."""
    tasks = [t for t in asyncio.all_tasks()
             if t is not asyncio.current_task()]
    for t in tasks:
        t.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)


def run_virtual(coro, *, start: float = START, timeout: float | None = None):
    """asyncio.run() on a VirtualClockLoop. ``timeout`` is VIRTUAL time."""
    loop = VirtualClockLoop(start=start)
    try:
        if timeout is not None:
            coro = asyncio.wait_for(coro, timeout)
        return loop.run_until_complete(coro)
    finally:
        try:
            loop.run_until_complete(cancel_all_tasks())
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            asyncio.set_event_loop(None)
            loop.close()
