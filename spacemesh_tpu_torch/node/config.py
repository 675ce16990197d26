"""Configuration tree + presets (port of
``spacemesh_tpu/node/config.py``).

Mirrors the reference's config package (reference config/config.go: every
subsystem owns a Config struct embedded in the root; config/presets
register whole profiles — fastnet/testnet/standalone; genesis id =
hash(time || extra) per config/genesis.go). JSON files merge over a preset;
explicit kwargs merge over both.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..core.hashing import sum256


@dataclasses.dataclass
class GenesisConfig:
    time: float = 0.0            # unix seconds
    extra_data: str = "tpu-mainnet"

    @property
    def genesis_id(self) -> bytes:
        """20-byte network id (reference config/genesis.go GenesisID)."""
        return sum256(str(int(self.time)).encode(), self.extra_data.encode())[:20]


@dataclasses.dataclass
class PostConfig:
    """Protocol POST params; the defaults ARE the mainnet values
    (reference config/mainnet.go:184-190 — including K3=1, which
    overrides activation/post.go's library default of 37)."""

    min_num_units: int = 4
    max_num_units: int = 1 << 20
    labels_per_unit: int = 4294967296
    scrypt_n: int = 8192
    k1: int = 26
    k2: int = 37
    k3: int = 1
    pow_difficulty: str = "000dfb23b0979b4b" + "00" * 24  # hex, 32 bytes

    @property
    def pow_difficulty_bytes(self) -> bytes:
        return bytes.fromhex(self.pow_difficulty)


@dataclasses.dataclass
class SmeshingConfig:
    start: bool = False
    coinbase: str = ""           # bech32
    data_dir: str = "post-data"
    num_units: int = 4
    init_batch: int = 1 << 13
    num_identities: int = 1      # signers per node (reference
                                 # node_identities.go multi-smesher)
    external_worker: bool = False  # prove via the out-of-proc POST worker
                                   # (PostSupervisor + RemotePostClient)
    worker_grpc: bool = False      # reference topology: worker dials the
                                   # node's gRPC PostService and Registers
                                   # (api/grpcserver/post_service.go:91)


@dataclasses.dataclass
class HareConfig:
    committee_size: int = 800
    leader_count: int = 5
    round_duration: float = 25.0
    preround_delay: float = 25.0
    iteration_limit: int = 4
    compact: bool = False        # hare4-style compact proposal ids (b4)
    committee_upgrade: list | None = None   # [layer, size] — committee
                                 # switches at that layer (reference
                                 # hare4/hare.go:52 CommitteeUpgrade)
    compact_enable_layer: int | None = None  # layer-gated plain->compact
                                 # protocol switch (node.go:915-943)


@dataclasses.dataclass
class BeaconConfig:
    kappa: int = 40
    q: str = "1/3"
    rounds_number: int = 300
    grace_period: float = 10.0
    proposal_duration: float = 30.0
    first_voting_round_duration: float = 210.0
    voting_round_duration: float = 30.0
    weak_coin_round_duration: float = 30.0
    theta: float = 0.00004
    votes_limit: int = 100


@dataclasses.dataclass
class TortoiseConfig:
    hdist: int = 10              # hare result trust distance
    zdist: int = 8
    window_size: int = 1000
    delay_layers: int = 10
    trace: bool = False          # record a replayable JSON trace
                                 # (reference node.go:688 EnableTracer)


@dataclasses.dataclass
class ActiveSetConfig:
    """Active-set generation knobs (reference miner config: networkDelay,
    goodAtxPercent; mainnet uses 30 min delay)."""

    network_delay: float = 1800.0
    good_atx_percent: int = 50


@dataclasses.dataclass
class P2PConfig:
    listen: str = "0.0.0.0:7513"
    bootnodes: list[str] = dataclasses.field(default_factory=list)
    min_peers: int = 20
    max_peers: int = 100
    network_cookie: str = ""
    transport: str = "tcp"       # "tcp" | "quic" (reference
                                 # p2p/host.go:166 EnableQUICTransport)


@dataclasses.dataclass
class APIConfig:
    public_listener: str = "0.0.0.0:9092"
    private_listener: str = "127.0.0.1:9093"
    post_listener: str = "127.0.0.1:0"


@dataclasses.dataclass
class Config:
    preset: str = ""
    data_dir: str = "data"
    layer_duration: float = 300.0          # mainnet: 5 min layers
    layers_per_epoch: int = 4032           # 2 weeks
    slots_per_layer: int = 50              # proposal slots (epoch total / lpe)
    db_read_pool: int = 4                  # read-only sqlite connections
    # (WAL snapshot readers — API/sync reads don't serialize behind the
    #  writer lock; 0 disables, :memory: databases never pool)
    min_active_set_weight: list = dataclasses.field(default_factory=list)
    # ^ [(epoch, weight)] ascending — reference miner/minweight table
    #   (config/mainnet.go MinimalActiveSetWeight).
    #   CONSENSUS PARAMETER: it enters the eligibility
    #   denominator (num_eligible_slots), so every node on a network
    #   must run the same table — like genesis config, a mismatch splits
    #   validate_slot's j >= num_slots check and partitions the network.
    activeset: ActiveSetConfig = dataclasses.field(
        default_factory=ActiveSetConfig)
    genesis: GenesisConfig = dataclasses.field(default_factory=GenesisConfig)
    post: PostConfig = dataclasses.field(default_factory=PostConfig)
    smeshing: SmeshingConfig = dataclasses.field(default_factory=SmeshingConfig)
    hare: HareConfig = dataclasses.field(default_factory=HareConfig)
    beacon: BeaconConfig = dataclasses.field(default_factory=BeaconConfig)
    tortoise: TortoiseConfig = dataclasses.field(default_factory=TortoiseConfig)
    p2p: P2PConfig = dataclasses.field(default_factory=P2PConfig)
    api: APIConfig = dataclasses.field(default_factory=APIConfig)
    poet_servers: list[str] = dataclasses.field(default_factory=list)
    poet_certifier: str = ""     # host:port of a certifier daemon; when
                                 # set, identities obtain a poet cert at
                                 # smeshing start (consensus/certifier.py)
    poet_cycle_gap: float = 43200.0        # 12 h
    standalone: bool = False
    bootstrap_source: str = ""             # file path or URL of epoch
                                           # fallback docs (bootstrap/)
    prune_retention_layers: int = 0        # 0 = pruning disabled

    def epoch_of(self, layer: int) -> int:
        return layer // self.layers_per_epoch


def _merge(obj, overrides: dict):
    for key, val in overrides.items():
        if not hasattr(obj, key):
            raise ValueError(f"unknown config key: {key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _merge(cur, val)
        else:
            setattr(obj, key, val)


PRESETS = {}


def preset(name):
    def deco(fn):
        PRESETS[name] = fn
        return fn
    return deco


@preset("mainnet")
def _mainnet() -> Config:
    """Mainnet shape (reference config/mainnet.go): 5-minute layers,
    two-week epochs, 64 GiB space units at scrypt N=8192, nonzero
    min-active-set-weight floor (the dust-set defense — mainnet.go:139),
    and the historical hare committee downgrade 400 -> 50
    (mainnet.go:70-75 CommitteeUpgrade)."""
    c = Config(preset="mainnet")
    c.layer_duration = 300.0               # mainnet.go:91
    c.layers_per_epoch = 4032              # mainnet.go:93
    # PostConfig defaults ARE the mainnet values (mainnet.go:184-190)
    c.hare = HareConfig(committee_size=400,
                        committee_upgrade=[105_720, 50])
    c.tortoise = TortoiseConfig(hdist=10, zdist=2, window_size=4032)
    c.min_active_set_weight = [(0, 1_000_000)]  # mainnet.go:139-141
    c.poet_cycle_gap = 43200.0             # 12 h, mainnet.go:172
    return c


@preset("testnet")
def _testnet() -> Config:
    """Public testnet shape (reference config/presets/testnet.go):
    mainnet timing with short epochs (one day), small space units, and
    a low min-weight floor."""
    c = Config(preset="testnet")
    c.genesis.extra_data = "tpu-testnet"
    c.layer_duration = 300.0               # testnet.go:79
    c.layers_per_epoch = 288               # testnet.go:81
    c.post = PostConfig(min_num_units=2, labels_per_unit=1024,
                        scrypt_n=8192, k1=26, k2=37, k3=1)
    c.tortoise = TortoiseConfig(hdist=10, zdist=2, window_size=576)
    c.min_active_set_weight = [(0, 10_000)]  # testnet.go:104
    c.poet_cycle_gap = 7200.0              # 2 h, testnet.go:126
    return c


@preset("fastnet")
def _fastnet() -> Config:
    """Small/fast everything (reference config/presets/fastnet.go:19:
    15 s layers, 4 layers/epoch, scrypt N=2, small committees)."""
    c = Config(preset="fastnet")
    c.genesis.extra_data = "tpu-fastnet"
    c.layer_duration = 15.0
    c.layers_per_epoch = 4
    c.post = PostConfig(
        min_num_units=1, labels_per_unit=1024, scrypt_n=2, k1=12, k2=4, k3=4,
        pow_difficulty="08" + "ff" * 31)
    c.hare = HareConfig(committee_size=50, round_duration=0.7,
                        preround_delay=1.0, iteration_limit=2)
    c.beacon = BeaconConfig(kappa=40, rounds_number=4, grace_period=0.5,
                            proposal_duration=0.7,
                            first_voting_round_duration=1.4,
                            voting_round_duration=0.7,
                            weak_coin_round_duration=0.7)
    c.tortoise = TortoiseConfig(hdist=4, zdist=2, window_size=100,
                                delay_layers=4)
    c.poet_cycle_gap = 30.0
    c.activeset = ActiveSetConfig(network_delay=1.5)
    return c


@preset("standalone")
def _standalone() -> Config:
    """One in-proc node: own poet, own post worker, no external network
    (reference config/presets/standalone.go + node.go:1293
    launchStandalone)."""
    c = _fastnet()
    c.preset = "standalone"
    c.genesis.extra_data = "tpu-standalone"
    c.standalone = True
    c.smeshing.start = True
    c.smeshing.num_units = 1
    c.p2p.listen = ""
    # sub-second layers: the grading window must fit inside one epoch
    c.activeset = ActiveSetConfig(network_delay=0.05)
    return c


def load(preset_name: str = "", file: str | Path | None = None,
         overrides: dict | None = None) -> Config:
    """Preset -> JSON file -> explicit overrides (later wins)."""
    cfg = PRESETS[preset_name]() if preset_name else Config()
    if file is not None:
        _merge(cfg, json.loads(Path(file).read_text()))
    if overrides:
        _merge(cfg, overrides)
    if cfg.p2p.transport not in ("tcp", "quic"):
        # a typo'd transport must fail at startup, not silently run TCP
        raise ValueError(
            f"p2p.transport must be 'tcp' or 'quic', got "
            f"{cfg.p2p.transport!r}")
    return cfg
