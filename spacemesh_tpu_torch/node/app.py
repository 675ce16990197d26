"""App: the composition root wiring every service (port of
``spacemesh_tpu/node/app.py``; reference node/node.go:583 initServices —
the ONLY place cross-component wiring happens — and :2091
startSynchronous for the lifecycle; --standalone runs an in-proc poet +
post worker, node.go:1293 launchStandalone).

``device`` (default ``"cuda"``, resolved at construction, so a node
without a card raises before it opens a store) reaches every component
that touches the card: the verification farm, POST init, the identities'
``PostClient``s, the ATX handlers, malfeasance's ``post_checker``
(called ``(atx, index_pos, device)``) and the JSON-RPC worker. Nothing on
the node's path falls back to the host.

The outward seams are the JAX node's: ``start_network`` opens the TCP or
QUIC-lite transport (``p2p/transport.py``, ``p2p/quic.py``) on the node's
injected clock (``connect_network`` joins a ``LoopbackNet`` instead),
``start_api`` the JSON API (``api/http.py``), ``start_grpc_api`` and
``start_public_grpc_api`` the private and public gRPC listeners
(``api/rpc.py``, ``api/rpc_v2.py``); with ``smeshing.worker_grpc`` the
node hosts ``spacemesh.v1.PostService`` and the worker, spawned on the
node's device, dials in and registers each identity.

Layer cadence (one asyncio task):
  layer tick
    ├─ epoch start?  -> beacon.run_epoch, atx builder for the next epoch
    ├─ miner.build(layer)          (proposal gossip)
    ├─ hare.run_layer(layer)       (rounds; output -> block -> certify)
    └─ mesh.process_layer(layer)   (tortoise tally + state application)
"""

from __future__ import annotations

import asyncio
import os
import time
from pathlib import Path

from ..consensus import activation, beacon as beacon_mod, blocks, eligibility
from ..consensus import malfeasance as malfeasance_mod
from ..consensus import hare as hare_mod
from ..consensus import mesh as mesh_mod
from ..consensus import miner as miner_mod
from ..consensus import poet as poet_mod
from ..consensus import tortoise as tortoise_mod
from ..core.hashing import sum256
from ..core.signing import Domain, EdSigner, EdVerifier
from ..core.types import Address
from ..device import resolve
from ..p2p.pubsub import PubSub
from ..post import initializer as post_init
from ..post.prover import ProofParams
from ..post.service import PostClient, PostService
from ..storage import db as dbmod
from ..storage.cache import AtxCache
from ..txs import ConservativeState
from ..utils import tracing
from ..vm import VM
from ..vm import sdk as vm_sdk
from . import clock as clock_mod
from . import events as events_mod
from .config import Config


class App:
    def __init__(self, cfg: Config, *, signer: EdSigner | None = None,
                 pubsub: PubSub | None = None,
                 time_source=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        # mutable skew over real time (chaos timeskew scenarios,
        # reference systest/chaos/timeskew.go:12); explicit time_source
        # injection (virtual-clock tests, the sim scenario engine)
        # bypasses it
        self.time_offset = 0.0
        self._time_injected = time_source is not None
        if time_source is None:
            time_source = lambda: time.time() + self.time_offset  # noqa: E731
        self.time_source = time_source
        self.data = Path(cfg.data_dir)
        self.data.mkdir(parents=True, exist_ok=True)
        prefix = cfg.genesis.genesis_id
        self.signers = self._load_or_create_identities(
            prefix, cfg.smeshing.num_identities, primary=signer)
        self.signer = self.signers[0]
        self.verifier = EdVerifier(prefix=prefix)
        self.events = events_mod.EventBus()
        self.clock = clock_mod.LayerClock(cfg.genesis.time, cfg.layer_duration,
                                          time_source=time_source)
        self.pubsub = pubsub or PubSub(node_name=self.signer.node_id)
        self.state = dbmod.open_state(self.data / "state.db",
                                      read_pool=cfg.db_read_pool)
        self.local = dbmod.open_local(self.data / "local.db")
        self.cache = AtxCache()
        self.golden_atx = sum256(b"golden", prefix)
        self._wire()
        self._tasks: list[asyncio.Task] = []
        self._hare_tasks: dict[int, asyncio.Task] = {}  # layer -> session
        self.stopped = asyncio.Event()
        self._recover_state()

    def _load_or_create_identities(self, prefix: bytes, n: int,
                                   primary: EdSigner | None = None
                                   ) -> list[EdSigner]:
        """Persisted node identities (reference node/node_identities.go:
        ed25519 keys live in the data dir and survive restarts; one node
        may host many smeshers). local.key is the primary; extras are
        local_01.key, local_02.key, ..."""
        key_dir = self.data / "identities"
        key_dir.mkdir(parents=True, exist_ok=True)
        signers: list[EdSigner] = []
        for i in range(max(n, 1)):
            if i == 0 and primary is not None:
                signers.append(primary)
                continue
            name = "local.key" if i == 0 else f"local_{i:02d}.key"
            key_file = key_dir / name
            if key_file.exists():
                signers.append(EdSigner(
                    seed=bytes.fromhex(key_file.read_text().strip()),
                    prefix=prefix))
            else:
                s = EdSigner(prefix=prefix)
                key_file.write_text(s.private_bytes().hex())
                key_file.chmod(0o600)
                signers.append(s)
        return signers

    def _wire(self) -> None:
        cfg = self.cfg
        self.oracle = eligibility.Oracle(
            self.cache, cfg.layers_per_epoch,
            slots_per_layer=cfg.slots_per_layer,
            min_weight_table=[tuple(x) for x in cfg.min_active_set_weight])
        from ..consensus.activeset import ActiveSetGenerator

        self.activeset_gen = ActiveSetGenerator(
            self.state, self.local, self.cache,
            layers_per_epoch=cfg.layers_per_epoch,
            layer_duration=cfg.layer_duration,
            genesis_time=lambda: self.clock.genesis_time,
            network_delay=cfg.activeset.network_delay,
            good_atx_percent=cfg.activeset.good_atx_percent)
        self.vm = VM(self.state, self.verifier)
        self.cstate = ConservativeState(self.state, self.vm)
        self.tortoise = tortoise_mod.Tortoise(
            self.cache, cfg.layers_per_epoch, hdist=cfg.tortoise.hdist,
            zdist=cfg.tortoise.zdist, window=cfg.tortoise.window_size,
            tracer=self._tortoise_tracer())
        self.proposal_store = mesh_mod.ProposalStore()
        self.executor = mesh_mod.Executor(self.state, self.vm, self.cstate)
        self.mesh = mesh_mod.Mesh(
            db=self.state, tortoise=self.tortoise, executor=self.executor,
            proposals=self.proposal_store, cache=self.cache)
        self.beacon = beacon_mod.ProtocolDriver(
            db=self.state, oracle=self.oracle, pubsub=self.pubsub,
            genesis_id=cfg.genesis.genesis_id, verifier=self.verifier,
            proposal_duration=cfg.beacon.proposal_duration,
            first_voting_round_duration=cfg.beacon.first_voting_round_duration,
            voting_round_duration=cfg.beacon.voting_round_duration,
            rounds_number=cfg.beacon.rounds_number,
            grace_period=cfg.beacon.grace_period,
            kappa=cfg.beacon.kappa, theta=cfg.beacon.theta,
            wall=self.time_source,
            on_fallback_used=lambda epoch, reason: self.events.emit(
                events_mod.BeaconFallback(epoch=epoch, reason=reason)))
        self.post_params = ProofParams(
            k1=cfg.post.k1, k2=cfg.post.k2, k3=cfg.post.k3,
            pow_difficulty=cfg.post.pow_difficulty_bytes)
        # ONE verification farm per node: every hot verification path
        # (ATX/ballot/certificate/malfeasance ingest, sync backfill)
        # submits to it and the scheduler coalesces device-wide batches
        # (verify/farm.py)
        from ..verify.farm import VerificationFarm

        self.verify_farm = VerificationFarm(
            ed_verifier=self.verifier, post_params=self.post_params,
            device=self.device)
        # node-wide health & SLO engine (obs/health.py): windowed SLIs
        # over the metrics registry, stall watchdogs the pipelines and
        # the farm register on obs.health.HEALTH, flight bundles spooled
        # under the data dir; served as /healthz + /readyz (api/http.py)
        from ..obs.health import HealthEngine

        # with an injected time source the engine's windows/burn math
        # follow it too (deterministic SLO evaluation on a virtual
        # clock); production keeps the monotonic default
        self.health_engine = HealthEngine(
            bus=self.events, spool_dir=self.data / "flight",
            **({"time_source": self.time_source}
               if self._time_injected else {}))
        # the layer that ACTS on health verdicts (obs/remediate.py,
        # the event bus): SloBreach/ComponentHealth events map
        # through the recovery policy onto the hooks components
        # registered beside their watchdogs; its snapshot rides into
        # every flight bundle
        from ..obs.remediate import RemediationEngine

        self.remediation = RemediationEngine(
            bus=self.events,
            **({"time_source": self.time_source}
               if self._time_injected else {}))
        self.health_engine.remediation = self.remediation
        # the failover seam: SPACEMESH_VERIFYD_URL routes
        # this node's verification through a remote verifyd service,
        # with breaker-guarded transparent fallback to the local farm
        # (verifyd/failover.py). SPACEMESH_VERIFYD_URLS (comma-
        # separated) generalizes that to a FLEET: consistent-hash
        # placement across the listed replicas, remote→remote failover
        # down the ring, local farm last (verifyd/fleet.py). Both
        # unset = exactly the local farm.
        self.failover_verifier = None
        self.fleet_verifier = None
        verify_router = self.verify_farm
        # the deadline bounds a BLACK-HOLED service (drop-everything
        # partition): without it each remote attempt would ride
        # aiohttp's default multi-minute timeout while BLOCK-lane
        # handlers wait, which is exactly the availability the
        # failover exists to protect.
        verifyd_deadline_s = float(os.environ.get(
            "SPACEMESH_VERIFYD_DEADLINE_S", "5.0"))
        verifyd_urls = os.environ.get("SPACEMESH_VERIFYD_URLS")
        verifyd_url = os.environ.get("SPACEMESH_VERIFYD_URL")
        if verifyd_urls:
            from ..verifyd.fleet import fleet_from_urls

            self.fleet_verifier = fleet_from_urls(
                [u.strip() for u in verifyd_urls.split(",")
                 if u.strip()],
                farm=self.verify_farm,
                client_id=self.signer.node_id.hex()[:16],
                deadline_s=verifyd_deadline_s, bus=self.events,
                **({"time_source": self.time_source}
                   if self._time_injected else {}))
            verify_router = self.fleet_verifier
        elif verifyd_url:
            from ..verifyd.client import VerifydClient
            from ..verifyd.failover import FailoverVerifier

            # retry=None: the breaker owns retry policy here — the
            # client's own shed-retry sleeps would stack a second
            # backoff layer in front of it and delay failover.
            self.failover_verifier = FailoverVerifier(
                remote=VerifydClient(verifyd_url,
                                     self.signer.node_id.hex()[:16],
                                     retry=None),
                farm=self.verify_farm, own_remote=True, bus=self.events,
                deadline_s=verifyd_deadline_s,
                **({"time_source": self.time_source}
                   if self._time_injected else {}))
            verify_router = self.failover_verifier
        self.verify_router = verify_router
        self.atx_handler = activation.Handler(
            db=self.state, cache=self.cache, verifier=self.verifier,
            golden_atx=self.golden_atx, post_params=self.post_params,
            labels_per_unit=cfg.post.labels_per_unit,
            scrypt_n=cfg.post.scrypt_n, pubsub=self.pubsub,
            on_atx=self._on_atx, now=self.time_source,
            farm=self.verify_router, device=self.device)
        from ..consensus import activation_v2

        self.atx_handler_v2 = activation_v2.HandlerV2(
            db=self.state, cache=self.cache, verifier=self.verifier,
            golden_atx=self.golden_atx, post_params=self.post_params,
            labels_per_unit=cfg.post.labels_per_unit,
            scrypt_n=cfg.post.scrypt_n, pubsub=self.pubsub,
            now=self.time_source, farm=self.verify_router,
            device=self.device)
        self.generator = blocks.Generator(
            mesh=self.mesh, proposals=self.proposal_store, cache=self.cache,
            layers_per_epoch=cfg.layers_per_epoch)
        self.certifier = blocks.Certifier(
            db=self.state, signer=self.signer, verifier=self.verifier,
            pubsub=self.pubsub, oracle=self.oracle,
            committee_size=cfg.hare.committee_size,
            threshold=cfg.hare.committee_size // 2 + 1,
            layers_per_epoch=cfg.layers_per_epoch,
            beacon_getter=self.beacon.get, farm=self.verify_router)

        self.certifier.on_certificate = self._adopt_full_certificate
        self.miners = [miner_mod.ProposalBuilder(
            signer=s, db=self.state, cache=self.cache,
            oracle=self.oracle, tortoise=self.tortoise, cstate=self.cstate,
            pubsub=self.pubsub, layers_per_epoch=cfg.layers_per_epoch,
            beacon_getter=self.beacon.get,
            activeset_gen=self.activeset_gen) for s in self.signers]
        self.miner = self.miners[0]
        def post_checker(atx, index_pos: int, device) -> bool:
            """True when the ATX's POST index at ``index_pos`` fails its
            recompute on ``device`` (InvalidPostIndex validation)."""
            import dataclasses as _dc

            from ..post import verifier as pv
            from ..post.prover import Proof as _Proof
            from ..storage import misc as _misc

            poet = _misc.poet_proof(self.state,
                                    atx.nipost.post_metadata.challenge)
            if poet is None:
                return False
            challenge = activation.nipost_challenge(atx.prev_atx,
                                                    atx.publish_epoch)
            params = _dc.replace(self.post_params, k2=1, k3=1)
            item = pv.VerifyItem(
                proof=_Proof(
                    nonce=atx.nipost.post.nonce,
                    indices=[atx.nipost.post.indices[index_pos]],
                    pow_nonce=atx.nipost.post.pow_nonce, k2=1),
                challenge=activation.post_challenge(poet.root, challenge),
                node_id=atx.node_id,
                commitment=activation.commitment_of(atx.node_id,
                                                    self.golden_atx),
                scrypt_n=cfg.post.scrypt_n,
                total_labels=atx.num_units * cfg.post.labels_per_unit)
            return not pv.verify(item, params, device=device)

        self.malfeasance = malfeasance_mod.Handler(
            db=self.state, cache=self.cache, verifier=self.verifier,
            pubsub=self.pubsub, tortoise=self.tortoise,
            post_checker=post_checker, farm=self.verify_router,
            device=self.device,
            on_malicious=lambda nid: self.events.emit(
                events_mod.Malfeasance(node_id=nid)))

        def on_double_ballot(node_id, b1, b2):
            proof = malfeasance_mod.proof_from_ballots(b1, b2)
            # track the task: the loop keeps only weak refs, and a dropped
            # publish would silently swallow the malfeasance proof
            task = asyncio.ensure_future(self.malfeasance.publish(proof))
            self._tasks.append(task)
            task.add_done_callback(
                lambda t: self._tasks.remove(t) if t in self._tasks else None)

        self.proposal_handler = miner_mod.ProposalHandler(
            db=self.state, cache=self.cache, oracle=self.oracle,
            tortoise=self.tortoise, store=self.proposal_store,
            verifier=self.verifier, pubsub=self.pubsub,
            layers_per_epoch=cfg.layers_per_epoch,
            beacon_getter=self.beacon.get,
            on_malfeasance=on_double_ballot, farm=self.verify_router)
        self.hare = hare_mod.Hare(
            signers=self.signers, verifier=self.verifier, oracle=self.oracle,
            pubsub=self.pubsub, committee_size=cfg.hare.committee_size,
            round_duration=cfg.hare.round_duration,
            iteration_limit=cfg.hare.iteration_limit,
            preround_delay=cfg.hare.preround_delay,
            layers_per_epoch=cfg.layers_per_epoch,
            beacon_of=self.beacon.get, atx_for=self._atx_of,
            proposals_for=self.proposal_store.ids_in_layer,
            on_output=self._on_hare_output, compact=cfg.hare.compact,
            committee_upgrade=cfg.hare.committee_upgrade,
            compact_enable_layer=cfg.hare.compact_enable_layer,
            wall=self.time_source)
        if cfg.poet_servers:
            # external poet daemons (reference activation/poet.go client;
            # multi-poet best-by-ticks, nipost.go getBestProof)
            from ..consensus.poet_remote import MultiPoet, RemotePoetClient

            clients = []
            for spec in cfg.poet_servers:
                host, _, port = spec.rpartition(":")
                clients.append(RemotePoetClient((host, int(port))))
            self.poet = clients[0] if len(clients) == 1 else MultiPoet(clients)
        else:
            self.poet = poet_mod.PoetService(
                poet_id=sum256(b"poet", cfg.genesis.genesis_id), ticks=64)
        self.post_service = PostService()
        self.atx_builders: list[activation.Builder] = []
        self.post_supervisor = None
        from ..p2p.pubsub import TOPIC_POET, TOPIC_TX

        self.pubsub.register(TOPIC_TX, self._on_tx)
        self.pubsub.register(TOPIC_POET, self._on_poet)
        self.server = None
        self.fetch = None
        self.syncer = None

    def _recover_state(self) -> None:
        """Warm the in-RAM caches from storage after a restart (reference
        atxsdata warmup node.go:1963 setupDBs + tortoise.Recover
        tortoise/recover.go:20): the ATX cache, then the tortoise rebuilt
        through Tortoise.recover."""
        from ..storage import atxs as atxstore
        from ..storage import misc as miscstore
        from ..storage.cache import AtxInfo

        ticks_by_id: dict[bytes, int] = {}
        for row in atxstore.all_rows(self.state):
            v = atxstore._view(row)
            if v is None:
                continue
            prev_height = ticks_by_id.get(v.prev_atx, 0)
            height = row["tick_height"]
            ticks_by_id[row["id"]] = height
            self.cache.add(v.target_epoch(), row["id"], AtxInfo(
                node_id=v.node_id,
                weight=v.num_units * max(height - prev_height, 0),
                base_height=prev_height, height=height,
                num_units=v.num_units, vrf_nonce=v.vrf_nonce,
                vrf_public_key=v.vrf_public_key))
        for node_id in miscstore.all_malicious(self.state):
            self.cache.set_malicious(node_id)

        self.tortoise = tortoise_mod.Tortoise.recover(
            self.state, self.cache, self.oracle,
            layers_per_epoch=self.cfg.layers_per_epoch,
            hdist=self.cfg.tortoise.hdist, zdist=self.cfg.tortoise.zdist,
            window=self.cfg.tortoise.window_size,
            tracer=self._tortoise_tracer())
        self._rewire_tortoise()

    def _tortoise_tracer(self):
        """One shared tracer per App: __init__ builds a tortoise in _wire
        and immediately replaces it in _recover_state — both must share
        the file handle (and replay treats the LAST init event as the
        live one, so the discarded instance's init line is harmless)."""
        if not self.cfg.tortoise.trace:
            return None
        if getattr(self, "_tracer_fn", None) is None:
            # App-lifetime handle, closed in close()
            fh = self._tracer_fh = open(
                self.data / "tortoise_trace.jsonl", "a")

            def write(line: str) -> None:
                fh.write(line + "\n")
                fh.flush()

            self._tracer_fn = write
        return self._tracer_fn

    def _rewire_tortoise(self) -> None:
        """Point every service that captured the tortoise at the recovered
        instance (recovery replaces the object built in _wire)."""
        self.mesh.tortoise = self.tortoise
        for m in self.miners:
            m.tortoise = self.tortoise
        self.proposal_handler.tortoise = self.tortoise
        self.malfeasance.tortoise = self.tortoise

    # --- networking (request/response + fetch + sync) -------------------

    def connect_network(self, net) -> None:
        """Join a transport (LoopbackNet in tests; QUIC later): exposes the
        local databases to peers and gains fetch/sync (reference
        node.go:1166-1211 wires fetch validators the same way)."""
        import struct as _struct

        from ..consensus.poet import PoetBlob
        from ..core.types import ActivationTx, Ballot, Block
        from ..p2p import fetch as fetch_mod
        from ..p2p.server import Server
        from ..p2p.sync import Syncer
        from ..storage import atxs as atxstore
        from ..storage import ballots as ballotstore
        from ..storage import blocks as blockstore
        from ..storage import layers as layerstore
        from ..storage import misc as miscstore

        self.server = Server(self.signer.node_id)
        net.join(self.server)
        self.fetch = fetch_mod.Fetch(self.server)

        # blob readers (serve our stores to peers)
        def _r(getter, encode=lambda v: v.to_bytes()):
            return lambda h: (lambda v: encode(v) if v is not None else None)(
                getter(self.state, h))

        # get_blob, not get: v2 (merged) envelope rows must be servable too
        self.fetch.set_reader(fetch_mod.HINT_ATX,
                              lambda h: atxstore.get_blob(self.state, h))
        self.fetch.set_reader(fetch_mod.HINT_BALLOT, _r(ballotstore.get))
        self.fetch.set_reader(fetch_mod.HINT_BLOCK, _r(blockstore.get))

        from ..storage import transactions as txstore_mod

        def read_tx(h: bytes):
            tx = txstore_mod.get_tx(self.state, h)
            return tx.raw if tx is not None else None

        self.fetch.set_reader(fetch_mod.HINT_TX, read_tx)

        def read_malfeasance(node_id: bytes):
            proof = miscstore.malfeasance_proof(self.state, node_id)
            return proof.to_bytes() if proof is not None else None

        self.fetch.set_reader(fetch_mod.HINT_MALFEASANCE, read_malfeasance)

        def read_active_set(set_id: bytes):
            ids = miscstore.active_set(self.state, set_id)
            return b"".join(ids) if ids is not None else None

        self.fetch.set_reader(fetch_mod.HINT_ACTIVESET, read_active_set)

        def read_poet(ref: bytes):
            proof = miscstore.poet_proof(self.state, ref)
            if proof is None:
                return None
            row = self.state.one("SELECT data FROM active_sets WHERE id=?",
                                 (b"poetcnt!" + ref[:24],))
            count = int.from_bytes(row["data"], "little") if row else 0
            return PoetBlob(proof=proof, member_count=count).to_bytes()

        self.fetch.set_reader(fetch_mod.HINT_POET, read_poet)

        # validators (ingest fetched blobs through the SAME gossip paths).
        # Every validator first checks the blob's content hash equals the
        # requested id — else one malicious peer could satisfy a fetch with
        # a different (valid-looking) object and the real one is never
        # retried from honest peers.
        from ..verify.farm import Lane

        async def v_atx(h: bytes, blob: bytes) -> bool:
            from ..core.types import ActivationTxV2

            try:
                atx = ActivationTx.from_bytes(blob)
            except Exception:  # noqa: BLE001
                atx = None
            if atx is not None and atx.id == h:
                # backfill rides the farm's SYNC lane: floods coalesce
                # into device-wide batches without starving live gossip
                return await self.atx_handler.process_async(
                    atx, lane=Lane.SYNC)
            try:  # v2: the id must be one of the envelope's identity ids
                atx2 = ActivationTxV2.from_bytes(blob)
            except Exception:  # noqa: BLE001
                return False
            if h not in {atx2.identity_atx_id(sp.node_id)
                         for sp in atx2.subposts}:
                return False
            return await self.atx_handler_v2.process_async(
                atx2, lane=Lane.SYNC)

        async def v_ballot(h: bytes, blob: bytes) -> bool:
            try:
                ballot = Ballot.from_bytes(blob)
            except Exception:  # noqa: BLE001
                return False
            if ballot.id != h:
                return False
            return await self.proposal_handler.ingest_ballot(
                ballot, lane=Lane.SYNC)

        async def v_block(h: bytes, blob: bytes) -> bool:
            try:
                block = Block.from_bytes(blob)
            except Exception:  # noqa: BLE001
                return False
            if block.id != h:
                return False
            # data availability: the executor needs the block's txs at
            # apply time — backfill best-effort now. The BLOB itself
            # is exactly what was requested, so the serving peer earns a
            # success either way; apply-time deferral (process_synced_
            # layer) guards against executing with txs still missing.
            missing = [t for t in block.tx_ids
                       if not txstore_mod.has_tx(self.state, t)]
            if missing:
                await self.fetch.get_hashes(fetch_mod.HINT_TX, missing)
            self.mesh.add_block(block)
            return True

        async def v_tx(h: bytes, blob: bytes) -> bool:
            from ..core.types import Transaction

            tx = Transaction(raw=blob)
            if tx.id != h:
                return False
            if self.vm.parse(tx) is None:
                return False
            # store for block application; historical txs may no longer be
            # mempool-admissible (nonce consumed), so storage is enough
            txstore_mod.add_tx(self.state, tx)
            self.cstate.add(tx)
            return True

        async def v_malfeasance(node_id: bytes, blob: bytes) -> bool:
            from ..core.types import MalfeasanceProof

            try:
                proof = MalfeasanceProof.from_bytes(blob)
            except Exception:  # noqa: BLE001
                return False
            # a married member's malice is proven by the OFFENDER's proof
            # (the whole equivocation set shares one proof) — accept when
            # processing it actually condemns the requested identity
            if not await self.malfeasance.process_async(proof,
                                                        lane=Lane.SYNC):
                return False
            return (proof.node_id == node_id
                    or miscstore.is_malicious(self.state, node_id))

        async def v_active_set(set_id: bytes, blob: bytes) -> bool:
            if len(blob) % 32:
                return False
            ids = [blob[i:i + 32] for i in range(0, len(blob), 32)]
            from ..consensus.miner import active_set_root

            if active_set_root(ids) != set_id:  # content-addressed
                return False
            # members we don't know yet are fetched like the reference's
            # handleSet (proposals/handler.go:225) — the declared set's
            # weight is only computable once every member resolves
            missing = [a for a in ids
                       if atxstore.get(self.state, a) is None]
            if missing:
                got = await self.fetch.get_hashes(fetch_mod.HINT_ATX,
                                                  missing)
                if not all(got.get(a) for a in missing):
                    # partial member fetch must REJECT the set blob:
                    # storing it would make fetch_active_set treat the
                    # root as resolved and never re-fetch, wedging ref-
                    # ballot validation until epoch ATX sync happens to
                    # deliver the stragglers. Returning
                    # False leaves the root unresolved so the next
                    # ballot retries the whole fetch+validate.
                    return False
            # epoch unknown at fetch time: -1 keeps the row out of the
            # pruner's epoch-horizon deletes (it prunes epoch>=0 only)
            miscstore.add_active_set(self.state, set_id, -1, ids)
            return True

        async def v_poet(h: bytes, blob: bytes) -> bool:
            from ..consensus.poet import PoetBlob

            try:
                if PoetBlob.from_bytes(blob).proof.id != h:
                    return False
            except Exception:  # noqa: BLE001
                return False
            return await self._on_poet(b"sync", blob)

        self.fetch.set_validator(fetch_mod.HINT_ATX, v_atx)
        self.fetch.set_validator(fetch_mod.HINT_BALLOT, v_ballot)
        self.fetch.set_validator(fetch_mod.HINT_BLOCK, v_block)
        self.fetch.set_validator(fetch_mod.HINT_POET, v_poet)
        self.fetch.set_validator(fetch_mod.HINT_TX, v_tx)
        self.fetch.set_validator(fetch_mod.HINT_MALFEASANCE, v_malfeasance)
        self.fetch.set_validator(fetch_mod.HINT_ACTIVESET, v_active_set)

        async def fetch_active_set(root: bytes) -> bool:
            got = await self.fetch.get_hashes(fetch_mod.HINT_ACTIVESET,
                                              [root])
            return bool(got.get(root))

        async def fetch_ballot(ballot_id: bytes) -> bool:
            got = await self.fetch.get_hashes(fetch_mod.HINT_BALLOT,
                                              [ballot_id])
            return bool(got.get(ballot_id))

        # ballots declare active sets by root; eligibility validation
        # resolves the declared set (fetching it if unseen) so nodes
        # with divergent ATX views agree on slot counts, and secondary
        # ballots fetch a missing ref ballot instead of letting gossip
        # order decide validity
        self.proposal_handler.fetch_active_set = fetch_active_set
        self.proposal_handler.fetch_ballot = fetch_ballot

        # index endpoints
        async def serve_epoch(peer: bytes, data: bytes) -> bytes:
            epoch = _struct.unpack("<I", data)[0]
            return b"".join(atxstore.ids_in_epoch(self.state, epoch))

        async def serve_layer(peer: bytes, data: bytes) -> bytes:
            layer = _struct.unpack("<I", data)[0]
            cert = miscstore.certified_block(self.state, layer)
            applied = layerstore.applied_block(self.state, layer)
            return fetch_mod.LayerData(
                ballots=ballotstore.ids_in_layer(self.state, layer),
                blocks=blockstore.ids_in_layer(self.state, layer),
                certified=cert or applied or bytes(32)).to_bytes()

        async def serve_poet_refs(peer: bytes, data: bytes) -> bytes:
            epoch = _struct.unpack("<I", data)[0]
            rows = self.state.all(
                "SELECT ref FROM poet_proofs WHERE round_id=?", (str(epoch),))
            return b"".join(r["ref"] for r in rows)

        async def serve_beacon(peer: bytes, data: bytes) -> bytes:
            epoch = _struct.unpack("<I", data)[0]
            if epoch <= 1:
                return self.beacon.get_now(epoch)  # protocol-defined bootstrap
            stored = miscstore.get_beacon(self.state, epoch)
            return stored or b""  # never serve a fabricated fallback

        async def serve_certificate(peer: bytes, data: bytes) -> bytes:
            layer = _struct.unpack("<I", data)[0]
            cert = miscstore.certificate(self.state, layer)
            return cert.to_bytes() if cert is not None else b""

        async def serve_malicious_ids(peer: bytes, data: bytes) -> bytes:
            return b"".join(miscstore.all_malicious(self.state))

        async def serve_layer_hash(peer: bytes, data: bytes) -> bytes:
            layer = _struct.unpack("<I", data)[0]
            if layer == 0xFFFFFFFF:
                # tip probe: (u32 layer, hash) of our highest aggregated
                # layer — fork finders anchor at the COMMON frontier
                tip = layerstore.last_applied(self.state)
                h = layerstore.aggregated_hash(self.state, tip)
                if tip < 0 or h is None:
                    return b""
                return _struct.pack("<I", tip) + h
            return layerstore.aggregated_hash(self.state, layer) or b""

        if self.cfg.hare.compact:
            # hare4 full exchange rides the req/resp server
            from ..consensus.hare import P_FULL_EXCHANGE

            self.hare.server = self.server
            self.server.register(P_FULL_EXCHANGE, self.hare._serve_full)

        self.server.register(fetch_mod.P_EPOCH, serve_epoch)
        self.server.register(fetch_mod.P_LAYER, serve_layer)
        self.server.register("pt/1", serve_poet_refs)
        self.server.register("bk/1", serve_beacon)
        self.server.register("ct/1", serve_certificate)
        self.server.register("ml/1", serve_malicious_ids)
        self.server.register("lh/1", serve_layer_hash)

        # sync2 rangesync: fingerprint-bisection set reconciliation over
        # per-epoch ATX ids and malfeasance ids (p2p/rangesync.py;
        # reference sync2/rangesync — there a standalone subsystem, here
        # one stateless responder on the same req/resp server)
        from ..p2p import rangesync as rangesync_mod

        # short-TTL cache: one reconciliation issues O(diff*log n)
        # request frames — rebuilding the set (DB scan + Fenwick) per
        # frame would make server work O(n) per frame;
        # a few seconds of staleness only means a second pass picks up
        # the newest ids
        rs_cache: dict[str, tuple[float, object]] = {}

        def set_for(name: str):
            now = self.time_source()  # TTL follows the node clock
            hit = rs_cache.get(name)
            if hit is not None and hit[0] > now:
                return hit[1]
            if name.startswith("atx/"):
                try:
                    epoch = int(name[4:])
                except ValueError:
                    return None
                oset = rangesync_mod.OrderedSet(
                    atxstore.ids_in_epoch(self.state, epoch))
            elif name == "malfeasance":
                oset = rangesync_mod.OrderedSet(
                    miscstore.all_malicious(self.state))
            else:
                return None
            if len(rs_cache) > 64:
                rs_cache.clear()
            rs_cache[name] = (now + 5.0, oset)
            return oset

        self.server.register(rangesync_mod.P_RANGESYNC,
                             rangesync_mod.RangeSyncResponder(set_for).handle)

        async def adopt_certificate(layer: int, block_id: bytes) -> bool:
            """Fetch + VERIFY the full certificate before trusting a
            peer-reported hare output (a majority of layer-data answers
            plus a threshold of validated certifier signatures)."""
            from ..core.types import Certificate
            from ..p2p.server import RequestError as _RE

            if miscstore.certified_block(self.state, layer) == block_id:
                return True
            for peer in self.fetch.peers()[:3]:
                try:
                    blob = await self.server.request(
                        peer, "ct/1", _struct.pack("<I", layer))
                except (_RE, asyncio.TimeoutError):
                    self.fetch.report_failure(peer)
                    continue
                if not blob:
                    continue
                try:
                    cert = Certificate.from_bytes(blob)
                except Exception:  # noqa: BLE001
                    self.fetch.report_failure(peer, 3)
                    continue
                if cert.block_id != block_id:
                    continue
                if await self.certifier.validate_certificate(layer, cert):
                    with self.state.tx():
                        miscstore.add_certificate(self.state, layer, cert)
                    self._adopt_full_certificate(layer, block_id)
                    return True
                self.fetch.report_failure(peer, 3)
            return False

        async def process_synced_layer(layer: int, data) -> None:
            async with tracing.span("sync.apply_layer", {"layer": layer}
                                    if tracing.is_enabled() else None):
                await _process_synced_layer(layer, data)

        async def _process_synced_layer(layer: int, data) -> None:
            from ..storage import blocks as bs

            # candidates vote-ordered; certificate VALIDATION picks the
            # real one when peers disagree (a forged cert cannot verify)
            candidates = []
            if data is not None:
                candidates = list(getattr(data, "cert_candidates", []))
                if data.certified != bytes(32) and \
                        data.certified not in candidates:
                    candidates.insert(0, data.certified)
            async def txs_ready(block) -> bool:
                # never execute a block whose txs are still missing —
                # a divergent state root is silent; defer the layer
                # so the next sync pass retries the txs
                missing = [t for t in block.tx_ids
                           if not txstore_mod.has_tx(self.state, t)]
                if missing:
                    got = await self.fetch.get_hashes(
                        fetch_mod.HINT_TX, missing)
                    return all(got.values())
                return True

            for cand in candidates:
                if await adopt_certificate(layer, cand):
                    block = bs.get(self.state, cand)
                    if block is None:
                        continue
                    if not await txs_ready(block):
                        return
                    self.mesh.process_hare_output(block, layer)
                    return
            # no validatable certificate: fall back to TORTOISE validity
            # (reference syncer/state_syncer.go processLayers applies
            # tortoise opinions when certificates are absent) — a block
            # the network applied without certifying, e.g. hare output
            # minted at a partition-merge instant, still propagates via
            # the votes of later ballots
            self.mesh.process_layer(int(self.clock.current_layer()))
            for vb in self.mesh.tortoise.valid_blocks(layer):
                block = bs.get(self.state, vb)
                if block is not None:
                    if not await txs_ready(block):
                        return
                    self.mesh.process_hare_output(block, layer)
                    return
            self.mesh.process_hare_output(None, layer)

        async def derive_beacon(epoch: int, ballot_ids: list[bytes]) -> None:
            """Beacon from ballots (reference: ballots carry the beacon in
            EpochData and the network's weight majority defines it): fetch
            raw ballot blobs WITHOUT ingestion, verify signatures and ATX
            binding, and adopt the ATX-weight-majority beacon. A lying
            peer cannot forge this — it has no weighty identities."""
            from ..core.signing import Domain as _Domain
            from ..core.types import Ballot as _Ballot

            if epoch <= 1 or miscstore.get_beacon(self.state, epoch) \
                    is not None:
                return
            votes: dict[bytes, int] = {}
            seen_nodes: set[bytes] = set()
            req = fetch_mod.HashRequest(
                hint=fetch_mod.HINT_BALLOT,
                hashes=list(dict.fromkeys(ballot_ids))[:256])
            for peer in self.fetch.peers()[:3]:
                try:
                    resp = fetch_mod.HashResponse.from_bytes(
                        await self.server.request(peer, fetch_mod.P_HASH,
                                                  req.to_bytes()))
                except Exception:  # noqa: BLE001
                    continue
                for blob in resp.blobs:
                    if not blob:
                        continue
                    try:
                        b = _Ballot.from_bytes(blob)
                    except Exception:  # noqa: BLE001
                        continue
                    if (b.epoch_data is None
                            or b.layer // self.cfg.layers_per_epoch != epoch
                            or b.node_id in seen_nodes):
                        continue
                    from ..verify.farm import SigRequest as _SigReq

                    if not await self.verify_router.submit(
                            _SigReq(int(_Domain.BALLOT), b.node_id,
                                    b.signed_bytes(), b.signature),
                            lane=Lane.SYNC):
                        continue
                    info = self.cache.get(epoch, b.atx_id)
                    if info is None or info.node_id != b.node_id:
                        continue
                    seen_nodes.add(b.node_id)
                    beacon = b.epoch_data.beacon
                    votes[beacon] = votes.get(beacon, 0) + info.weight
            if votes:
                best = max(votes.items(), key=lambda kv: kv[1])[0]
                self.beacon.on_fallback(epoch, best)

        def resume_point() -> int:
            # a crash can leave processed ahead of applied; resync from the
            # lower of the two so the state gap backfills
            return min(layerstore.processed(self.state),
                       layerstore.last_applied(self.state))

        self.syncer = Syncer(
            fetch=self.fetch, current_layer=lambda: int(self.clock.current_layer()),
            processed_layer=resume_point,
            process_layer=process_synced_layer,
            layers_per_epoch=self.cfg.layers_per_epoch,
            store_beacon=self.beacon.on_fallback,
            layer_hash=lambda lyr: layerstore.aggregated_hash(self.state, lyr),
            on_fork=self._on_fork, derive_beacon=derive_beacon,
            # client side of the rs/1 responder above: fingerprint
            # reconciliation backfills ATX ids the bulk epoch pull
            # missed; fetched blobs ingest through v_atx on the farm's
            # SYNC lane
            rangesync_sets=set_for)

    async def start_network(self) -> tuple[str, int]:
        """Open the real transport (TCP by default; QUIC-lite when
        cfg.p2p.transport == "quic" — reference p2p/host.go:166
        EnableQUICTransport) on cfg.p2p.listen, bootstrap-dial
        cfg.p2p.bootnodes, and run the syncer in the background.
        Returns the bound (host, port)."""
        if self.cfg.p2p.transport == "quic":
            from ..p2p.quic import QuicHost as Host
        else:
            from ..p2p.transport import Host

        cfg = self.cfg.p2p
        self.host = Host(
            signer=self.signer,
            genesis_id=self.cfg.genesis.genesis_id,
            listen=cfg.listen or "127.0.0.1:0",
            bootstrap=cfg.bootnodes,
            min_peers=cfg.min_peers, max_peers=cfg.max_peers,
            # ban windows / dial pacing / gossip heartbeats follow the
            # node clock, so sim/chaos timeskew reaches the transport
            time_source=self.time_source)
        addr = await self.host.start()
        self.host.join_pubsub(self.pubsub)
        self.connect_network(self.host)
        self._tasks.append(asyncio.ensure_future(self.syncer.run()))
        from .peersync import PeerSync
        from . import events as _ev

        # wall rides the node's time source: under a virtual clock the
        # drift rounds measure SIM offsets (and a scripted timeskew
        # really registers); in production this is wall time + chaos
        # offset, exactly what peers observe of us
        self.peersync = PeerSync(
            self.server, self.fetch, wall=self.time_source,
            on_drift=lambda off: self.events.emit(
                _ev.ClockDrift(offset=off)))
        self._tasks.append(asyncio.ensure_future(self.peersync.run()))
        self._register_network_probes()
        return addr

    def _register_network_probes(self) -> None:
        """Sync + clock-drift liveness on the global health registry
        (obs/health.py): while catching up, the processed frontier (or
        the sync state itself) must advance; the clock probe reports the
        peersync median offset against its tolerance."""
        from ..obs import health as health_mod
        from ..storage import layers as layerstore

        sync_wd = health_mod.Watchdog(
            "sync",
            progress=lambda: (self.syncer.state.value,
                              layerstore.processed(self.state)),
            deadline_s=120.0,
            active=lambda: (self.syncer is not None
                            and not self.syncer.is_synced()
                            and self.clock.genesis_reached()))

        def clock_probe(now: float):
            ps = getattr(self, "peersync", None)
            offset = ps.last_offset if ps is not None else None
            if offset is None:
                return True, "no quorum yet"
            tolerance = ps.max_drift
            if abs(offset) > tolerance:
                return False, (f"clock drift {offset:.2f}s exceeds "
                               f"tolerance {tolerance:.2f}s")
            return True, f"offset={offset:.3f}s"

        # keep the probe objects: unregister must be equality-checked so
        # tearing down THIS node never evicts another in-process node's
        # live probes from the shared registry (multi-App test clusters)
        self._sync_probe = sync_wd.check
        self._clock_probe = clock_probe
        health_mod.HEALTH.register("sync", self._sync_probe)
        health_mod.HEALTH.register("clock", self._clock_probe)
        # recovery hook beside the sync watchdog (obs/remediate.py): a
        # stalled-sync verdict kicks one immediate synchronize pass —
        # the restart a stuck syncer usually needs — instead of waiting
        # out its background cadence
        from ..obs import remediate as remediate_mod

        self._sync_restart = self._kick_sync
        remediate_mod.ACTIONS.register("sync", "restart_component",
                                       self._sync_restart)

    def _kick_sync(self) -> None:
        if self.syncer is None:
            return
        task = asyncio.ensure_future(self.syncer.synchronize())
        self._tasks.append(task)
        task.add_done_callback(
            lambda t: self._tasks.remove(t) if t in self._tasks else None)

    async def stop_network(self) -> None:
        # the failover/fleet verifiers' owned remote clients hold
        # aiohttp sessions and server-side registrations — both need a
        # live loop to release (the sync App.close() can only drop the
        # breaker registrations), so the async teardown path owns them
        if self.failover_verifier is not None:
            await self.failover_verifier.aclose()
        if self.fleet_verifier is not None:
            await self.fleet_verifier.aclose()
        if getattr(self, "host", None) is not None:
            from ..obs import health as health_mod
            from ..obs import remediate as remediate_mod

            if getattr(self, "_sync_probe", None) is not None:
                health_mod.HEALTH.unregister("sync", self._sync_probe)
            if getattr(self, "_clock_probe", None) is not None:
                health_mod.HEALTH.unregister("clock", self._clock_probe)
            if getattr(self, "_sync_restart", None) is not None:
                remediate_mod.ACTIONS.unregister(
                    "sync", "restart_component", self._sync_restart)
                self._sync_restart = None
            if self.syncer is not None:
                self.syncer.stop()
            if getattr(self, "peersync", None) is not None:
                self.peersync.stop()
                self.peersync = None
            await self.host.stop()
            self.host = None

    def _adopt_full_certificate(self, layer: int, block_id: bytes) -> None:
        """A threshold certificate is the committee's decision for the
        layer; a node whose own hare missed it (clock skew, late join)
        must ADOPT it or diverge permanently when the tortoise margin
        never crosses on a small committee (a chaos-test flake). Fires
        on gossip-assembled AND sync-fetched certificates."""
        self.mesh.adopt_certified(layer, block_id)

    def _on_fork(self, divergent_layer: int) -> None:
        """Fork finder hit (reference syncer/find_fork.go): a peer's
        aggregated mesh hash diverges from ours at ``divergent_layer``
        and its chain data has been ingested. Arbitration belongs to the
        TORTOISE: tally with everything known; if the vote weight favors
        the other chain, the mesh reverts + reapplies the flipped layers
        (reference mesh.go:302 ProcessLayer reverts on opinion change).
        No blind rollback — a peer without ballot weight behind its
        chain cannot move our applied state."""
        self.mesh.process_layer(int(self.clock.current_layer()))

    # --- handlers ------------------------------------------------------

    async def _on_poet(self, peer: bytes, data: bytes) -> bool:
        from ..consensus.poet import PoetBlob

        try:
            blob = PoetBlob.from_bytes(data)
        except Exception:  # noqa: BLE001
            return False
        activation.store_poet_blob(self.state, blob)
        return True

    def _atx_of(self, epoch: int, node_id: bytes):
        """The ATX a local identity holds for ``epoch`` (cache lookup)."""
        for atx_id, info in self.cache.iter_epoch(epoch):
            if info.node_id == node_id:
                return atx_id
        return None

    def _on_atx(self, atx) -> None:
        self.events.emit(events_mod.AtxEvent(
            atx_id=atx.id, node_id=atx.node_id, epoch=atx.publish_epoch))

    async def _on_tx(self, peer: bytes, data: bytes) -> bool:
        from ..core.types import Transaction
        from ..vm.vm import TxValidity

        validity = self.cstate.add(Transaction(raw=data))
        self.events.emit(events_mod.TxEvent(
            tx_id=Transaction(raw=data).id,
            valid=validity == TxValidity.VALID))
        return validity == TxValidity.VALID

    async def _on_hare_output(self, out: hare_mod.ConsensusOutput) -> None:
        if out.coin is not None:
            self.tortoise.on_weak_coin(out.layer, out.coin)
        if not out.completed:
            # hare FAILED (iteration limit, no agreement): the layer is
            # undecided and belongs to the tortoise — recording a
            # positive "empty" decision here would poison every vote
            # within hdist (reference: no hare output; layerpatrol
            # leaves the layer to the syncer/tortoise)
            self.events.emit(events_mod.LayerUpdate(layer=out.layer,
                                                    status="hare_failed"))
            return
        async with tracing.span("mesh.hare_output", {"layer": out.layer}
                                if tracing.is_enabled() else None):
            block = self.generator.process_hare_output(out)
            self.events.emit(events_mod.LayerUpdate(layer=out.layer,
                                                    status="hare_done"))
            if block is not None:
                epoch = out.layer // self.cfg.layers_per_epoch
                for s in self.signers:
                    await self.certifier.certify_if_eligible(
                        out.layer, block.id, self._atx_of(epoch, s.node_id),
                        signer=s)

    # --- smeshing ------------------------------------------------------

    async def start_smeshing(self) -> None:
        """POST-init every identity and build one ATX Builder per signer
        (reference activation.Builder.Register, activation.go:218;
        BASELINE config 5: N smeshers in one node). With
        smeshing.external_worker, proofs come from the out-of-process
        worker via PostSupervisor + RemotePostClient."""
        cfg = self.cfg
        post_base = self.data / "post"
        for s in self.signers:
            post_dir = post_base / s.node_id.hex()[:16]
            commitment = activation.commitment_of(s.node_id, self.golden_atx)
            self.events.emit(events_mod.PostEvent(node_id=s.node_id,
                                                  kind="init_start"))
            await asyncio.to_thread(
                post_init.initialize, post_dir,
                node_id=s.node_id, commitment=commitment,
                num_units=cfg.smeshing.num_units,
                labels_per_unit=cfg.post.labels_per_unit,
                scrypt_n=cfg.post.scrypt_n,
                batch_size=cfg.smeshing.init_batch, device=self.device)
            self.events.emit(events_mod.PostEvent(node_id=s.node_id,
                                                  kind="init_complete"))
        clients = {}
        if cfg.smeshing.external_worker and cfg.smeshing.worker_grpc:
            # reference topology: node hosts PostService, worker dials in
            # and Registers each identity (post_service.go:91, supervisor
            # passes the node address like post_supervisor.go does); the
            # worker proves on the node's device
            from ..post.supervisor import PostSupervisor

            port = await self.start_grpc_api()
            self.post_supervisor = PostSupervisor(
                post_base, params=self.post_params,
                node_address=f"127.0.0.1:{port}", device=str(self.device))
            await asyncio.to_thread(self.post_supervisor.start)
            svc = self.grpc_api.post_service
            await svc.wait_registered([s.node_id for s in self.signers],
                                      timeout=120.0)
            for s in self.signers:
                clients[s.node_id] = svc.client(s.node_id)
        elif cfg.smeshing.external_worker:
            from ..post.supervisor import PostSupervisor
            from ..post.remote import RemotePostClient

            self.post_supervisor = PostSupervisor(
                post_base, params=self.post_params,
                device=str(self.device))
            addr = await asyncio.to_thread(self.post_supervisor.start)
            for s in self.signers:
                clients[s.node_id] = RemotePostClient(addr, s.node_id)
        else:
            for s in self.signers:
                clients[s.node_id] = PostClient(
                    post_base / s.node_id.hex()[:16], self.post_params,
                    device=self.device)
        self.atx_builders = []
        for s in self.signers:
            client = clients[s.node_id]
            self.post_service.register(s.node_id, client)
            coinbase = (Address.decode(cfg.smeshing.coinbase).raw
                        if cfg.smeshing.coinbase
                        else vm_sdk.wallet_address(s.public_key).raw)
            self.atx_builders.append(activation.Builder(
                signer=s, db=self.state, pubsub=self.pubsub,
                poet=self.poet, post_client=client,
                golden_atx=self.golden_atx, coinbase=coinbase,
                handler=self.atx_handler,
                num_units=cfg.smeshing.num_units))
        if cfg.poet_certifier:
            await self._certify_identities(cfg.poet_certifier)

    async def _certify_identities(self, addr_spec: str) -> None:
        """Obtain one poet certificate per identity from the configured
        certifier (reference activation/certifier.go:246 Certify): prove
        the POST once over a canonical per-identity challenge, submit,
        store the cert on the builder for every poet registration."""
        from ..consensus.certifier import CertifierClient

        host, _, port = addr_spec.rpartition(":")
        certifier = CertifierClient((host or "127.0.0.1", int(port)),
                                    time_source=self.time_source)
        for b in self.atx_builders:
            node_id = b.signer.node_id
            challenge = sum256(b"poet-cert-challenge", node_id)
            proof, _meta = await asyncio.to_thread(b.post_client.proof,
                                                   challenge)
            info = await asyncio.to_thread(b.post_client.info)
            b.poet_cert = await asyncio.to_thread(
                certifier.certificate, proof=proof, challenge=challenge,
                node_id=node_id, commitment=info.commitment,
                num_units=info.num_units,
                labels_per_unit=info.labels_per_unit)
            self.events.emit(events_mod.PostEvent(
                node_id=node_id, kind="certified"))

    @property
    def atx_builder(self):
        return self.atx_builders[0] if self.atx_builders else None

    async def publish_atx(self, publish_epoch: int) -> None:
        if not self.atx_builders:
            return
        from ..storage import atxs as atxstore

        # restart safety: publishing a SECOND (different) ATX for an epoch
        # already covered would be self-equivocation -> malfeasance
        builders = [b for b in self.atx_builders
                    if atxstore.by_node_in_epoch(
                        self.state, b.signer.node_id, publish_epoch) is None]
        if not builders:
            return
        # phase 0 for EVERY identity before the round runs, then one
        # builder drives the in-proc poet round (standalone) while the
        # rest await its result
        for b in builders:
            await b.register_challenge(publish_epoch)
        results = await asyncio.gather(
            builders[0].finish(publish_epoch,
                               execute_round=self.cfg.standalone),
            *(b.finish(publish_epoch) for b in builders[1:]))
        for atx in results:
            self.events.emit(events_mod.AtxPublished(
                atx_id=atx.id, node_id=atx.node_id, epoch=publish_epoch))

    # --- lifecycle -----------------------------------------------------

    async def prepare(self) -> None:
        """Smeshing setup + first ATX (targets epoch 1). Idempotent; may be
        called before run() so slow POST init/compiles don't eat layers."""
        if self.cfg.smeshing.start and self.atx_builder is None:
            await self.start_smeshing()
            await self.publish_atx(0)

    def start_ops(self) -> None:
        """Bootstrap updater + pruner background loops (reference
        bootstrap/updater.go, prune/prune.go), driven by config."""
        from . import bootstrap as bootstrap_mod
        from ..storage import misc as miscstore
        from ..consensus.miner import active_set_root

        if self.cfg.bootstrap_source:
            def on_activeset(epoch: int, ids: list[bytes]) -> None:
                miscstore.add_active_set(self.state, active_set_root(ids),
                                         epoch, ids)
                # trusted fallback feeds the generator too
                # (miner/active_set_generator.go:78 updateFallback)
                self.activeset_gen.update_fallback(epoch, ids)

            self.bootstrap = bootstrap_mod.BootstrapUpdater(
                self.cfg.bootstrap_source,
                on_beacon=self.beacon.on_fallback,
                on_activeset=on_activeset,
                cache_dir=self.data / "bootstrap")
            self._tasks.append(asyncio.ensure_future(self.bootstrap.run()))
        if self.cfg.prune_retention_layers > 0:
            self.pruner = bootstrap_mod.Pruner(
                self.state,
                retention_layers=self.cfg.prune_retention_layers,
                current_layer=lambda: int(self.clock.current_layer()),
                layers_per_epoch=self.cfg.layers_per_epoch)
            self._tasks.append(asyncio.ensure_future(self.pruner.run()))

    async def start_api(self) -> int:
        """Start the JSON API (reference startAPIServices, node.go:1603)."""
        from ..api import ApiServer

        self.api = ApiServer(self, listen=self.cfg.api.private_listener)
        self.health_engine.ensure_running()
        self.remediation.start()
        if self.failover_verifier is not None:
            self.failover_verifier.start()
        if self.fleet_verifier is not None:
            self.fleet_verifier.start()
        return await self.api.start()

    async def start_grpc_api(self) -> int:
        """Start the PRIVATE gRPC listener (loopback post_listener): the
        full spacemesh.v1 surface incl. the PostService Register seam,
        Admin, and Smesher (reference api/grpcserver/grpc.go private +
        post listeners, config.go:31-57)."""
        from ..api.rpc import GrpcApiServer

        if getattr(self, "grpc_api", None) is None:
            self.grpc_api = GrpcApiServer(
                self, listen=self.cfg.api.post_listener,
                post_query_interval=max(self.cfg.layer_duration / 20, 0.1))
            self.grpc_port = await self.grpc_api.start()
        return self.grpc_port

    async def start_public_grpc_api(self, listen: str | None = None) -> int:
        """Start the PUBLIC gRPC listener: query surface only —
        Node/Mesh/GlobalState/Transaction + all v2alpha1 services. No
        Admin (Recover wipes state), no Smesher, no PostService seam
        (reference public-services set, api/grpcserver/config.go:31-40)."""
        from ..api.rpc import GrpcApiServer

        if getattr(self, "grpc_public_api", None) is None:
            self.grpc_public_api = GrpcApiServer(
                self, listen=listen or self.cfg.api.public_listener,
                public_only=True)
            self.grpc_public_port = await self.grpc_public_api.start()
        return self.grpc_public_port

    async def stop_grpc_api(self) -> None:
        if getattr(self, "grpc_api", None) is not None:
            await self.grpc_api.stop()
            self.grpc_api = None
        if getattr(self, "grpc_public_api", None) is not None:
            await self.grpc_public_api.stop()
            self.grpc_public_api = None

    async def run(self, until_layer: int | None = None) -> None:
        """The main layer loop (callers wanting the API call start_api()
        first, as __main__ --api does)."""
        cfg = self.cfg
        if cfg.smeshing.start and self.atx_builder is None:
            await self.prepare()
        from ..storage import layers as layerstore

        self.health_engine.ensure_running()
        self.remediation.start()
        if self.failover_verifier is not None:
            self.failover_verifier.start()
        if self.fleet_verifier is not None:
            self.fleet_verifier.start()
        seen_epochs = {0}
        async for layer in self.clock.ticks():
            if layer <= layerstore.processed(self.state):
                # already processed (restart replay / clock anomalies):
                # re-running hare would overwrite the recorded opinion with
                # an empty one and trigger a bogus revert
                continue
            epoch = cfg.epoch_of(layer)
            if epoch not in seen_epochs:
                seen_epochs.add(epoch)
                # tracked so close()/kill cancels it — an untracked epoch
                # task outliving state.close() would block forever on the
                # drained read pool
                et = asyncio.ensure_future(self._epoch_start(epoch))
                self._tasks.append(et)
                et.add_done_callback(
                    lambda t: self._tasks.remove(t) if t in self._tasks
                    else None)
            # hare sessions run CONCURRENTLY with the layer loop — the
            # graded protocol's 8-round iterations legitimately outlive a
            # layer (reference runs per-layer sessions the same way);
            # proposal building must finish before the preround snapshot,
            # which preround_delay covers
            ht = asyncio.ensure_future(
                self.hare.run_layer(layer, self.clock.time_of(layer)))
            self._hare_tasks[layer] = ht
            ht.add_done_callback(self._reap_hare(layer))
            async with tracing.span("layer.build", {"layer": layer}
                                    if tracing.is_enabled() else None):
                await asyncio.gather(*(m.build(layer) for m in self.miners))
            with tracing.span("mesh.process_layer", {"layer": layer}
                              if tracing.is_enabled() else None):
                self.mesh.process_layer(layer)
            # report the frontier that is ACTUALLY applied — with hare
            # running concurrently, layer L's block typically lands after
            # this tick, and the event stream must not claim otherwise
            self.events.emit(events_mod.LayerUpdate(
                layer=self.mesh.latest_applied, status="applied"))
            if until_layer is not None and layer >= until_layer:
                break
        # drain in-flight sessions so the final layers still get their
        # hare outputs (callers stopping hard cancel via stop()/close())
        if self._hare_tasks:
            await asyncio.gather(*list(self._hare_tasks.values()),
                                 return_exceptions=True)
            self.mesh.process_layer(int(self.clock.current_layer()))
        self.stopped.set()

    def _reap_hare(self, layer: int):
        def _done(task: asyncio.Task) -> None:
            self._hare_tasks.pop(layer, None)
            if not task.cancelled() and task.exception() is not None:
                import logging

                logging.getLogger("hare").error(
                    "layer %d session failed: %r", layer, task.exception())
        return _done

    async def _epoch_start(self, epoch: int) -> None:
        participants = [
            (s, s.vrf_signer(), atx) for s in self.signers
            if (atx := self._atx_of(epoch, s.node_id)) is not None]
        await self.beacon.run_epoch(epoch, self.signer,
                                    self.signer.vrf_signer(),
                                    participants[0][2] if participants
                                    else None,
                                    participants=participants)
        if self.cfg.smeshing.start:
            await self.publish_atx(epoch)  # targets epoch+1

    def close(self) -> None:
        for t in self._hare_tasks.values():
            t.cancel()
        self._hare_tasks.clear()
        # epoch-start/background futures must die WITH the stores: one
        # surviving get_beacon() against a closed Database blocks its
        # caller forever on the drained reader pool
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        self.remediation.close()
        if self.failover_verifier is not None:
            self.failover_verifier.shutdown()
        if self.fleet_verifier is not None:
            self.fleet_verifier.shutdown()
        self.health_engine.close()
        self.verify_farm.shutdown()
        if self.post_supervisor is not None:
            self.post_supervisor.stop()
        self.state.close()
        self.local.close()
        if getattr(self, "_tracer_fh", None) is not None:
            self._tracer_fh.close()
            self._tracer_fh = None
            self._tracer_fn = None
