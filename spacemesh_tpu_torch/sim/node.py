"""Sim node factories: hundreds of light relays + a few full Apps (port
of ``spacemesh_tpu/sim/node.py``; a :class:`FullNode` runs its App's POST
init, proofs and verification on ``device``, default ``"cuda"``).

All nodes share ONE event loop (a VirtualClockLoop — sim/scenario.py)
and one process. Two weights:

* :class:`LightNode` — a PubSub endpoint on the MeshHub: it relays
  every topic (an empty handler set accepts) and counts what it saw.
  Hundreds of these give partitions/storms a real multi-hop fabric at
  ~zero cost per node.
* :class:`FullNode` — a real :class:`node.app.App` (consensus, mesh,
  tortoise, verify farm, health engine) with DETERMINISTIC identities
  derived from the scenario seed, its clock driven by the injected
  virtual time source. These carry the consensus assertions.

Identity seeds, data dirs, and genesis are all functions of the
scenario seed and the node's logical name — never of wall time — so the
same seed boots byte-identical networks.
"""

from __future__ import annotations

import hashlib
import pathlib
from typing import Callable

from ..core.hashing import sum256
from ..core.signing import EdSigner
from ..node import clock as clock_mod
from ..node.app import App
from ..node.config import load
from ..p2p.pubsub import PubSub
from .net import MeshHub, SimNet

# ONE fixed genesis placeholder: genesis_id (signature prefix, golden
# ATX) derives from it, so per-run values would put every run on a
# different network. The LayerClock is rebased onto virtual time at
# scenario start.
GENESIS_PLACEHOLDER = 1_700_000_900.0

STORM_TOPIC = "storm"


def light_name(seed: int, index: int) -> bytes:
    return hashlib.sha256(f"sim-{seed}-light-{index}".encode()).digest()


class LightNode:
    """PubSub relay endpoint; observes (and counts) what it sees."""

    def __init__(self, seed: int, index: int, hub: MeshHub):
        self.index = index
        self.name = light_name(seed, index)
        self.pubsub = PubSub(node_name=self.name, deliver_self=False)
        self.storm_seen = 0

        async def on_storm(peer: bytes, data: bytes) -> bool:
            self.storm_seen += 1
            return True

        self.pubsub.register(STORM_TOPIC, on_storm)
        # light=True: on the event fabric the node runs no gossipsub
        # control plane, just the sparse relay set (legacy hub ignores it)
        hub.join(self.pubsub, light=True)


def _full_config(data_dir: pathlib.Path, *, layer_sec: float, lpe: int,
                 num_identities: int, hdist: int = 4,
                 smeshing: bool = True):
    return load("standalone", overrides={
        "data_dir": str(data_dir),
        "layer_duration": layer_sec,
        "layers_per_epoch": lpe,
        "slots_per_layer": 2,
        "genesis": {"time": GENESIS_PLACEHOLDER},
        "post": {"labels_per_unit": 256, "scrypt_n": 2, "k1": 64, "k2": 8,
                 "k3": 4, "min_num_units": 1,
                 "pow_difficulty": "20" + "ff" * 31},
        "smeshing": {"start": smeshing, "num_units": 1, "init_batch": 128,
                     "num_identities": num_identities},
        "hare": {"committee_size": 20, "round_duration": 0.2,
                 "preround_delay": 0.5, "iteration_limit": 2},
        "beacon": {"proposal_duration": 0.2},
        "tortoise": {"hdist": hdist, "zdist": 2, "window_size": 50},
    })


class FullNode:
    """One real App on the sim fabric, deterministically seeded."""

    def __init__(self, seed: int, index: int, *, tmp: pathlib.Path,
                 hub: MeshHub, simnet: SimNet,
                 loop_time: Callable[[], float],
                 layer_sec: float, lpe: int, num_identities: int = 1,
                 smeshing: bool = True, device="cuda"):
        self.index = index
        self.device = device
        self.seed = seed
        self.layer_sec = layer_sec
        self.skew = 0.0     # timeskew fault: virtual seconds of offset
        self._loop_time = loop_time
        self.alive = True
        cfg = _full_config(tmp / f"full{index:03d}", layer_sec=layer_sec,
                           lpe=lpe, num_identities=num_identities,
                           smeshing=smeshing)
        # deterministic identities (the reference pins test keys the
        # same way): every VRF roll — eligibility, leaders, weak coins —
        # replays identically from the scenario seed
        key_dir = pathlib.Path(cfg.data_dir) / "identities"
        key_dir.mkdir(parents=True, exist_ok=True)
        signers = []
        for i in range(num_identities):
            kseed = hashlib.sha256(
                f"sim-{seed}-full-{index}-{i}".encode()).digest()
            s = EdSigner(seed=kseed, prefix=cfg.genesis.genesis_id)
            fname = "local.key" if i == 0 else f"local_{i:02d}.key"
            (key_dir / fname).write_text(s.private_bytes().hex())
            signers.append(s)
        self.signer = signers[0]
        self.name = self.signer.node_id
        self._cfg = cfg
        self.pubsub = PubSub(node_name=self.name)
        hub.join(self.pubsub)
        self.hub = hub
        self.simnet = simnet
        self.app = App(cfg, signer=self.signer, pubsub=self.pubsub,
                       time_source=self._time, device=device)
        # the scenario engine owns SLI sampling and SLO verdicts
        # (obs/sli.py over the shared registry); per-App tick loops
        # would only burn wall clock spooling flight bundles mid-fault
        # (breaching by design) and add thread-completion jitter
        self.app.health_engine.close()
        self.app.connect_network(simnet)
        self._tasks: list = []

    def _time(self) -> float:
        return self._loop_time() + self.skew

    # --- lifecycle -----------------------------------------------------

    async def prepare(self) -> None:
        await self.app.prepare()

    def rebase_clock(self, genesis: float) -> None:
        self.genesis = genesis
        self.app.clock = clock_mod.LayerClock(
            genesis, self.layer_sec, time_source=self._time)

    def start(self, until_layer: int, *, sync_interval: float = 2.0):
        import asyncio

        self._tasks = [
            asyncio.ensure_future(self.app.run(until_layer=until_layer)),
            asyncio.ensure_future(self.app.syncer.run(sync_interval)),
        ]
        return self._tasks[0]

    @property
    def run_task(self):
        return self._tasks[0] if self._tasks else None

    def kill(self) -> None:
        """SIGKILL analogue: drop off the fabric, cancel everything.
        Storage is left on disk (a later restart recovers from it)."""
        self.alive = False
        self.hub.suspend(self.name)
        self.app.syncer.stop()
        for t in self._tasks:
            t.cancel()
        for t in self.app._tasks:
            t.cancel()
        self.close()

    async def restart(self, until_layer: int, *,
                      sync_interval: float = 2.0) -> None:
        """Crash recovery: rebuild the App over the surviving on-disk
        stores (the faultfs recovery path), rejoin the fabric,
        and resume consensus. A FRESH PubSub is built — register()
        appends, so reusing the crashed App's handler table would
        double-deliver every topic."""
        assert not self.alive, "restart() follows kill()"
        self._closed = False
        self.pubsub = PubSub(node_name=self.name)
        self.hub.join(self.pubsub)
        self.app = App(self._cfg, signer=self.signer, pubsub=self.pubsub,
                       time_source=self._time, device=self.device)
        self.app.health_engine.close()
        self.app.connect_network(self.simnet)
        await self.app.prepare()
        self.app.clock = clock_mod.LayerClock(
            self.genesis, self.layer_sec, time_source=self._time)
        self.alive = True
        self.hub.resume(self.name)
        self.start(until_layer, sync_interval=sync_interval)

    async def stop(self) -> None:
        """Graceful stop: cancel the run loop, close the app."""
        import asyncio

        self.app.syncer.stop()
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self.close()

    def close(self) -> None:
        if not getattr(self, "_closed", False):
            self._closed = True
            try:
                self.app.close()
            except Exception:  # noqa: BLE001 — teardown must not mask results
                pass

    # --- state inspection (assertions) ---------------------------------

    def applied_record(self, lo: int, hi: int) -> list[tuple[int, bytes]]:
        """(layer, applied block id or EMPTY) over [lo, hi] — the
        consensus record the event digest covers."""
        from ..storage import layers as layerstore

        out = []
        for lyr in range(lo, hi + 1):
            block = layerstore.applied_block(self.app.state, lyr)
            out.append((lyr, block or bytes(32)))
        return out

    def state_root(self, layer: int) -> bytes | None:
        from ..storage import layers as layerstore

        return layerstore.state_hash(self.app.state, layer)

    def last_applied(self) -> int:
        from ..storage import layers as layerstore

        return layerstore.last_applied(self.app.state)


def storm_payload(seed: int, index: int, size: int = 200) -> bytes:
    """Deterministic storm traffic body."""
    base = sum256(b"storm", seed.to_bytes(8, "little"),
                  index.to_bytes(8, "little"))
    reps = (size + 31) // 32
    return (base * reps)[:size]
