"""The verifyd failover client: remote service first, local farm always
(port of ``spacemesh_tpu/verifyd/failover.py``).

:class:`FailoverVerifier` exposes the farm's own submission surface
(``await submit(req, lane) -> bool`` plus a batch form), so every
handler seam that takes ``farm=`` can take the failover verifier
instead (the JAX node wires its own behind ``SPACEMESH_VERIFYD_URL``):

* **Remote path** — batches go to a verifyd endpoint (any object with
  ``async verify(reqs, lane=..., deadline_s=...)``: the cookbook
  :class:`~.client.VerifydClient` in production, an in-process
  transport in the sim).  Verdicts are bit-identical to the farm's by
  the verifyd contract (admission is scheduling, never semantics).
* **Breaker** — typed sheds, transport errors and deadline misses trip
  a :class:`~..obs.remediate.CircuitBreaker`; once open, requests go
  STRAIGHT to the local farm without re-paying the failing round trip.
  A shed's ``retry_after_s`` floors the half-open probe timing (the
  shared :func:`~..obs.remediate.backoff_delay` rule), so a service
  that said "come back in 30s" is probed then, not sooner.
* **Local path** — the node's in-process farm (verify/farm.py) carries
  the load during the outage; when a half-open probe finds the service
  back, traffic fails back to remote.

Every routing decision is visible: ``failover_requests_total
{path,lane}``, the ``failover_verify_seconds{path,lane}`` latency
histogram (the BLOCK-lane SLO signal that must stay green THROUGH an
outage — the verifyd-outage drill asserts it), the breaker's
``state_doc``, and an optional observer callback the drill uses to build
its replay-stable event digest.

Each remote attempt is a ``failover.remote`` span and each local answer a
``failover.local`` span. Left out against the JAX package: the event bus
(``node/events.py``, not ported): ``bus=`` stays in the signature and is
ignored.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

import logging

from ..obs import remediate as remediate_mod
from ..utils import metrics, tracing
from ..verify.farm import Lane
from .service import Shed

_log = logging.getLogger("spacemesh_tpu_torch.failover")

# shed reasons that mean "this request is malformed / this client is
# misconfigured", not "the service is unhealthy": they do NOT trip the
# breaker (failing over would just re-verify locally forever while the
# real bug — an unregistered client id — goes unnoticed) but the single
# request still falls back to the farm for an answer
_NON_TRIPPING_SHEDS = frozenset({"unregistered", "registry_full"})

PATH_REMOTE = "remote"
PATH_LOCAL = "local"
PATH_LOCAL_FASTFAIL = "local_fastfail"  # breaker open: no remote attempt


class FailoverVerifier:
    """Remote verifyd with transparent local-farm fallback.

    Lifecycle: construct → :meth:`start` (registers the breaker on the
    global registry) → ``submit``/``verify_batch`` → :meth:`aclose`
    (unregisters the breaker, closes an owned remote client).
    """

    def __init__(self, *, remote, farm,
                 breaker: remediate_mod.CircuitBreaker | None = None,
                 component: str = "verifyd.remote",
                 deadline_s: float | None = None,
                 own_remote: bool = False,
                 bus=None,
                 observer: Optional[Callable[..., None]] = None,
                 time_source: Callable[[], float] = time.monotonic):
        self.remote = remote
        self.farm = farm
        self.component = component
        self.deadline_s = deadline_s
        self._own_remote = own_remote
        self.bus = bus
        self.observer = observer
        self._now = time_source
        self.breaker = breaker if breaker is not None else \
            remediate_mod.CircuitBreaker(
                component, failure_budget=3, window_s=60.0,
                cooldown_s=5.0, cooldown_cap_s=120.0,
                time_source=time_source)
        self._registered = False
        self._remote_registered = False
        self.stats = {"remote_ok": 0, "remote_failed": 0,
                      "local": 0, "local_fastfail": 0,
                      "remote_attempts": 0, "failbacks": 0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Register the breaker (idempotent)."""
        if not self._registered:
            remediate_mod.BREAKERS.register(self.breaker)
            self._registered = True

    async def aclose(self) -> None:
        self.shutdown()
        if self._own_remote:
            aclose = getattr(self.remote, "aclose", None)
            if aclose is not None:
                await aclose()

    def shutdown(self) -> None:
        """Synchronous teardown half (for an embedder that closes after
        its loop has exited): drop the breaker's registry entry and its
        per-component metric series; an owned remote client's transport
        needs the loop, so only :meth:`aclose` can close it."""
        if self._registered:
            remediate_mod.BREAKERS.unregister(self.breaker)
            self._registered = False

    # -- the farm-compatible surface -------------------------------------

    async def submit(self, req, lane: Lane = Lane.GOSSIP) -> bool:
        """One request, one verdict — the handler seam (same signature
        as ``VerificationFarm.submit``)."""
        return (await self.verify_batch([req], lane))[0]

    async def verify_batch(self, reqs: list,
                           lane: Lane = Lane.GOSSIP) -> list[bool]:
        """Verify a batch: remote while the breaker allows, local farm
        otherwise — ALWAYS an answer, never an error, for every failure
        mode the breaker models (a farm failure still propagates: when
        the local path is broken there is nothing left to fall back
        to)."""
        lane = Lane(lane)
        lname = lane.name.lower()
        t0 = self._now()
        attempted_remote = False
        if self.breaker.allow():
            attempted_remote = True
            was_probe = self.breaker.state == remediate_mod.HALF_OPEN
            self.stats["remote_attempts"] += 1
            try:
                async with tracing.span(
                        "failover.remote", {"lane": lname, "n": len(reqs)}
                        if tracing.is_enabled() else None):
                    verdicts = await self._remote_verify(reqs, lane)
            except Shed as e:
                if e.reason in _NON_TRIPPING_SHEDS:
                    # a config problem, not an outage: answer locally,
                    # force re-registration before the next remote
                    # attempt, and RELEASE a held probe slot — this
                    # outcome says nothing about the peer's health, and
                    # a probe that neither succeeds nor fails would
                    # wedge the breaker half-open forever
                    self._remote_registered = False
                    self.breaker.abort_probe()
                    _log.warning("verifyd shed %s (%s); serving locally "
                                 "without tripping the breaker",
                                 e.reason, e.detail)
                else:
                    self._trip(f"shed:{e.reason}",
                               retry_after_s=e.retry_after_s)
            except (asyncio.TimeoutError, TimeoutError) as e:
                self._trip(f"deadline:{e!r}")
            except Exception as e:  # noqa: BLE001 — any transport/protocol failure fails over
                self._trip(f"transport:{e!r}")
            except BaseException:
                # cancelled mid-attempt: no verdict either way — the
                # probe slot must not stay held
                self.breaker.abort_probe()
                raise
            else:
                self.stats["remote_ok"] += 1
                if was_probe:
                    self.stats["failbacks"] += 1
                    _log.info("verifyd probe ok: failing back to remote")
                self.breaker.record_success()
                return self._done(PATH_REMOTE, lname, t0, len(reqs),
                                  verdicts)
        # local farm fallback (or fast-fail: breaker open, no attempt)
        path = PATH_LOCAL if attempted_remote else PATH_LOCAL_FASTFAIL
        self.stats["local" if attempted_remote else "local_fastfail"] += 1
        async with tracing.span("failover.local",
                                {"lane": lname, "n": len(reqs),
                                 "fastfail": not attempted_remote}
                                if tracing.is_enabled() else None):
            verdicts = list(await asyncio.gather(
                *(self.farm.submit(r, lane) for r in reqs)))
        return self._done(path, lname, t0, len(reqs), verdicts)

    # -- internals -------------------------------------------------------

    async def _remote_verify(self, reqs: list, lane: Lane) -> list[bool]:
        if (not self._remote_registered
                and hasattr(self.remote, "register")):
            await self.remote.register()
            self._remote_registered = True
        lname = lane.name.lower()
        if self.deadline_s is not None:
            return await asyncio.wait_for(
                self.remote.verify(reqs, lane=lname,
                                   deadline_s=self.deadline_s),
                timeout=self.deadline_s)
        return await self.remote.verify(reqs, lane=lname)

    def _trip(self, why: str, retry_after_s: float | None = None) -> None:
        self.stats["remote_failed"] += 1
        before = self.breaker.state
        self.breaker.record_failure(retry_after_s=retry_after_s)
        after = self.breaker.state
        if self.observer is not None:
            self.observer("remote_failure", why=why, state=after)
        if after != before and after in (remediate_mod.OPEN,):
            _log.warning("verifyd remote unhealthy (%s): breaker open, "
                         "verifying on the local farm", why)
            metrics.remediation_actions.inc(
                component=self.component, action="failover_remote",
                outcome="ok")

    def _done(self, path: str, lname: str, t0: float, n: int,
              verdicts: list[bool]) -> list[bool]:
        metrics.failover_requests.inc(path=path, lane=lname)
        metrics.failover_verify_seconds.observe(
            max(self._now() - t0, 0.0), path=path, lane=lname)
        if self.observer is not None:
            self.observer("served", path=path, lane=lname, n=n)
        return verdicts

    def state_doc(self) -> dict:
        return {"component": self.component,
                "breaker": self.breaker.state_doc(),
                "stats": dict(self.stats)}
