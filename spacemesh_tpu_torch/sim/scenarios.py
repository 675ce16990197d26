"""Built-in scenario scripts (port of ``spacemesh_tpu/sim/scenarios.py``,
every script with its numbers unchanged).

Each builder returns a plain script dict (sim/scenario.py documents the
schema); ``builtin(name, **overrides)`` is the registry the CLI and CI
use. All numbers are DETERMINISTIC functions of the seed — nothing here
reads wall time. ``run(script, device=...)`` dispatches a script to its
engine on ``device`` (default ``"cuda"``).

* ``partition-heal`` — the bread-and-butter robustness drill (and the
  CI scenario-smoke workload): majority/minority islands, storm + tx
  traffic, malformed-ATX adversary, heal, SLI/SLO + convergence
  assertions. Replaces the wall-clock partition half of the old
  subprocess chaos suite with a seeded, replayable run.
* ``storm-256`` — the 256-node acceptance scenario: gossip storm at
  production fan-out, a 3-way partition (no island holds a certifying
  majority for part of it), link degradation, light-node churn, the
  full adversarial payload set, heal + Tortoise re-convergence with
  zero consensus divergence.
* ``timeskew-kill`` — ports the assertions of the randomly-seeded
  multi-process cluster chaos test (tests/test_cluster_chaos.py —
  systest timeskew.go + fail.go): one node's clock skews ahead and
  returns, another dies for good; the survivors keep applying layers
  and agree on applied blocks and state roots.
* ``smoke`` — tiny engine self-test (2 full, 8 light, one storm).
* ``verifyd-load`` — the verification SERVICE under seeded open-loop
  multi-client load (``"engine": "verifyd"`` dispatches to
  sim/verifyd_load.py): three light clients + one heavy client over
  capacity, typed rate sheds on the heavy client only, zero wrong
  verdicts, replay-stable outcome digest.
* ``crash-recovery`` — the POST storage plane under deterministic
  disk faults (``"engine": "crashrec"`` dispatches to
  sim/crash_recovery.py): power-cut and torn-write crashes swept over
  the write-path op sites of a tiny init, each reboot recovered to a
  bit-identical store, plus an ENOSPC hold that must degrade (not
  kill) the pipeline and release cleanly (docs/CRASH_SAFETY.md).
* ``verifyd-outage`` — the self-healing drill (``"engine":
  "failover"`` dispatches to sim/failover.py): verifyd killed
  mid-load, the node keeps verifying on the local farm with zero
  verdict divergence and a green BLOCK-lane SLO, the breaker stops
  re-paying the dead service, and traffic fails back to remote after
  recovery (docs/SELF_HEALING.md).
* ``runtime-degrade`` — the device-decay drill (same engine): a
  seeded device-dispatch fault plan; the runtime breaker opens after
  its failure budget (N device attempts for an M≫N-batch outage, not
  M), the host fallback carries the load bit-identically, and device
  recovery re-closes the breaker.
* ``storm-1024`` — the thousand-node acceptance drill on the event
  fabric (sim/net.py EventMeshHub): 1024 nodes, mostly light relays,
  through storm, a 3-way partition, churn, three concurrent
  adversaries, and heal — converged with a byte-identical replay
  digest inside the tier-1 wall budget (the storm-smoke CI job).
* ``storm-512-bench`` — the pure-fabric bench shape behind
  ``sim_fabric_events_per_sec`` (bench.py): smeshing and tracing off,
  sparse heartbeats, a long quiet tail, so the wall clock measures hub
  idle+relay cost — the axis the event fabric rebuilt — instead of
  the consensus/crypto floor both fabrics share. Digest-identical
  across fabrics (clean links draw nothing from the net RNG).
* ``crash-store`` — composed crash + netsplit: a full node is
  partitioned into its own island, SIGKILLed, and after heal restarts
  over its surviving on-disk stores (the ``restart`` fault), re-syncing
  into byte-identical consensus with the majority.
* ``storm-4096`` — storm-1024's geometry at 4x the relay population,
  only affordable on the SHARDED fabric (sim/shard.py): the light
  wheels spread over host cores with conservative virtual-time
  windows (``"shards": "auto"``).
* ``eclipse-campaign`` — eclipse a minority full across an epoch
  boundary while attacker lights feed it malformed ATXs; typed
  rejections only, victim re-syncs to zero divergence after heal.
* ``soak-epochs`` — 3.5 epochs of continuous storm + VM tx traffic on
  the sharded fabric with state-root equality asserted at EVERY epoch
  boundary (the slow-divergence drift detector).
* ``byzantine-verifyd`` — one fleet replica keeps a healthy transport
  but flips every verdict (``"engine": "fleet"``): the FleetVerifier's
  verdict audit must detect it, trip only that replica's breaker, and
  let zero wrong verdicts reach a caller.
"""

from __future__ import annotations


def smoke(seed: int = 1, light: int = 8) -> dict:
    return {
        "name": "smoke", "seed": seed,
        "nodes": {"full": 2, "light": light},
        "layer_sec": 2.0, "lpe": 3, "until_layer": 6,
        "digest_frontier": 5,
        "phases": [
            {"name": "run", "until_layer": 5,
             "traffic": {"storm": {"publishers": 3, "messages": 8,
                                   "interval": 0.2}}},
            {"name": "end",
             "converge": {"frontier": 5, "deadline": 180.0},
             "asserts": [
                 {"kind": "converged", "frontier": 5},
                 {"kind": "storm_coverage", "min_fraction": 0.9},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "slo_green"},
             ]},
        ],
    }


def partition_heal(seed: int = 7, light: int = 60) -> dict:
    """Majority island (4/6 identities) keeps deciding layers through
    the split; the minority islands coast and must re-converge after
    the merge. Healing has BOTH reference paths available: validated
    certificate adoption where the island's certifier hit threshold,
    and tortoise vote weight once the divergent layers leave the hdist
    window — which is why the run continues well past the merge
    (test_partition.healed3 uses the same geometry)."""
    return {
        "name": "partition-heal", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 20,
        "digest_frontier": 12,
        "phases": [
            {"name": "warmup", "until_layer": 10,
             "traffic": {"storm": {"publishers": 6, "messages": 16,
                                   "interval": 0.3},
                         "tx_spawn": {}},
             "asserts": [
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
            {"name": "partition", "until_layer": 13,
             "faults": [
                 {"kind": "partition", "islands": [[0, 1], [2], [3]]},
                 {"kind": "adversary", "what": "malformed_atx",
                  "count": 6, "via": 1},
             ],
             "traffic": {"storm": {"publishers": 6, "messages": 8,
                                   "interval": 0.4}}},
            {"name": "heal",
             "faults": [{"kind": "heal"}],
             "converge": {"frontier": 12, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 12},
                 {"kind": "progress", "min_layer": 12},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "sli_present", "name": "gossip_handler_p99"},
                 {"kind": "slo_green"},
                 {"kind": "span", "name": "mesh.process_layer",
                  "min": 8},
                 {"kind": "span", "name": "gossip.deliver", "min": 16},
             ]},
        ],
    }


def storm_256(seed: int = 11, light: int = 252) -> dict:
    """The acceptance scenario: 256 nodes, gossip storm, 3-way
    partition with link degradation and churn, adversarial payloads,
    heal, Tortoise re-convergence, zero consensus divergence."""
    churned = list(range(8, 32))
    return {
        "name": "storm-256", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 20,
        "digest_frontier": 12,
        "topology": {"degree": 6, "gossip_degree": 4},
        "phases": [
            {"name": "storm", "until_layer": 10,
             "traffic": {"storm": {"publishers": 12, "messages": 30,
                                   "interval": 0.15},
                         "tx_spawn": {}},
             "asserts": [
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
            {"name": "partition", "until_layer": 13,
             "faults": [
                 {"kind": "partition", "islands": [[0, 1], [2], [3]]},
                 {"kind": "link_policy", "loss": 0.05, "delay": 0.02,
                  "jitter": 0.05, "dup": 0.02, "reorder": 0.02},
                 {"kind": "churn", "light": churned},
                 {"kind": "adversary", "what": "malformed_atx",
                  "count": 6, "via": 40},
                 {"kind": "adversary", "what": "torsion_sig",
                  "count": 4, "via": 41},
                 {"kind": "adversary", "what": "dup_flood",
                  "count": 12, "via": 42, "interval": 0.1},
             ],
             "traffic": {"storm": {"publishers": 8, "messages": 10,
                                   "interval": 0.3}}},
            {"name": "heal",
             "faults": [
                 {"kind": "link_policy"},   # back to clean links
                 {"kind": "heal"},
                 {"kind": "resume", "light": churned},
             ],
             "converge": {"frontier": 12, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 12},
                 {"kind": "progress", "min_layer": 12},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "sli_present", "name": "gossip_handler_p99"},
                 {"kind": "slo_green"},
                 {"kind": "span", "name": "mesh.process_layer",
                  "min": 8},
                 {"kind": "span", "name": "gossip.deliver", "min": 32},
             ]},
        ],
    }


def storm_1024(seed: int = 17, light: int = 1020) -> dict:
    """The thousand-node acceptance scenario, only reachable on the
    event fabric: 1024 nodes (mostly light relays running NO gossipsub
    control plane), gossip storm, 3-way partition with link degradation
    and heavy light churn, the full adversarial payload set, heal,
    Tortoise re-convergence, zero consensus divergence. Same geometry
    as storm-256 so a fabric regression shows up as wall time, not as
    a different consensus question."""
    churned = list(range(16, 64))
    return {
        "name": "storm-1024", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 20,
        "digest_frontier": 12,
        # shard the light-relay wheel over host cores (sim/shard.py);
        # resolves to W=1 in-process on small hosts, and every W replays
        # the identical per-W digest
        "shards": "auto",
        # 4x the node count floods ~10x the gossip spans of storm-256;
        # the default 64Ki ring would evict every mesh.process_layer
        # span before the heal-phase span asserts read them
        "trace_capacity": 1 << 19,
        # when sharded, the merged capture must resolve at least one
        # fabric.publish -> shard.publish cross-process parent edge
        # (scenario.py appends merged_procs / cross_proc_links asserts)
        "require_cross_proc_links": 1,
        "topology": {"degree": 6, "gossip_degree": 4},
        "phases": [
            {"name": "storm", "until_layer": 10,
             "traffic": {"storm": {"publishers": 24, "messages": 40,
                                   "interval": 0.12},
                         "tx_spawn": {}},
             "asserts": [
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
            {"name": "partition", "until_layer": 13,
             "faults": [
                 {"kind": "partition", "islands": [[0, 1], [2], [3]]},
                 {"kind": "link_policy", "loss": 0.05, "delay": 0.02,
                  "jitter": 0.05, "dup": 0.02, "reorder": 0.02},
                 {"kind": "churn", "light": churned},
                 {"kind": "adversary", "what": "malformed_atx",
                  "count": 6, "via": 80},
                 {"kind": "adversary", "what": "torsion_sig",
                  "count": 4, "via": 81},
                 {"kind": "adversary", "what": "dup_flood",
                  "count": 12, "via": 82, "interval": 0.1},
             ],
             "traffic": {"storm": {"publishers": 12, "messages": 10,
                                   "interval": 0.3}}},
            {"name": "heal",
             "faults": [
                 {"kind": "link_policy"},   # back to clean links
                 {"kind": "heal"},
                 {"kind": "resume", "light": churned},
             ],
             "converge": {"frontier": 12, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 12},
                 {"kind": "progress", "min_layer": 12},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "sli_present", "name": "gossip_handler_p99"},
                 {"kind": "slo_green"},
                 {"kind": "span", "name": "mesh.process_layer",
                  "min": 8},
                 {"kind": "span", "name": "gossip.deliver", "min": 32},
             ]},
        ],
    }


def storm_512_bench(seed: int = 23, light: int = 510) -> dict:
    """The bench workload behind ``sim_fabric_events_per_sec``: a clean
    512-node gossip storm (no faults, no link policies — the data-plane
    RNG is never drawn, so BOTH fabrics replay the identical world and
    must land the identical digest; bench.py asserts that before
    reporting any rate). The scenario isolates the FABRIC: smeshing and
    tracing are off (no PoST init, no ATX/proposal crypto competing for
    the wall clock), and the storm burst is followed by a long quiet
    tail — the regime where per-node consumer tasks and an always-on
    control plane keep burning beats while the event wheel and the
    dirty-set heartbeat cost nothing."""
    return {
        "name": "storm-512-bench", "seed": seed,
        "nodes": {"full": 2, "light": light, "smeshing": False},
        "trace": False,
        # layer_sec 2.0 compresses time ~150x vs mainnet, so the default
        # 1.0-virtual-s beat is 150x SPARSER than gossipsub's real 1 s
        # heartbeat; 0.1 is still 15x sparser, and per-beat cost is the
        # O(nodes)-vs-O(dirty) axis the fabric rewrite targets
        "heartbeat": 0.1,
        "layer_sec": 2.0, "lpe": 8, "until_layer": 40,
        "digest_frontier": 6,
        "topology": {"degree": 6, "gossip_degree": 4},
        "phases": [
            {"name": "storm", "until_layer": 6,
             "traffic": {"storm": {"publishers": 24, "messages": 60,
                                   "interval": 0.1}}},
            {"name": "quiet-tail", "until_layer": 38},
            {"name": "end",
             "converge": {"frontier": 6, "deadline": 180.0},
             "asserts": [
                 {"kind": "converged", "frontier": 6},
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
        ],
    }


def storm_4096(seed: int = 29, light: int = 4092) -> dict:
    """The four-thousand-node tier-2 drill: storm-1024's geometry at 4x
    the relay population, only reachable with the sharded fabric
    (sim/shard.py) — ``"shards": "auto"`` spreads the light wheels over
    the host cores with conservative virtual-time windows. Same
    consensus question as storm-256/1024, so a fabric scaling
    regression shows up as wall time."""
    churned = list(range(64, 192))
    return {
        "name": "storm-4096", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 20,
        "digest_frontier": 12,
        "trace_capacity": 1 << 21,
        "shards": "auto",
        "topology": {"degree": 6, "gossip_degree": 4},
        "phases": [
            {"name": "storm", "until_layer": 10,
             "traffic": {"storm": {"publishers": 32, "messages": 48,
                                   "interval": 0.1},
                         "tx_spawn": {}},
             "asserts": [
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
            {"name": "partition", "until_layer": 13,
             "faults": [
                 {"kind": "partition", "islands": [[0, 1], [2], [3]]},
                 {"kind": "link_policy", "loss": 0.05, "delay": 0.02,
                  "jitter": 0.05, "dup": 0.02, "reorder": 0.02},
                 {"kind": "churn", "light": churned},
                 {"kind": "adversary", "what": "malformed_atx",
                  "count": 6, "via": 300},
                 {"kind": "adversary", "what": "torsion_sig",
                  "count": 4, "via": 301},
                 {"kind": "adversary", "what": "dup_flood",
                  "count": 12, "via": 302, "interval": 0.1},
             ],
             "traffic": {"storm": {"publishers": 16, "messages": 10,
                                   "interval": 0.3}}},
            {"name": "heal",
             "faults": [
                 {"kind": "link_policy"},   # back to clean links
                 {"kind": "heal"},
                 {"kind": "resume", "light": churned},
             ],
             "converge": {"frontier": 12, "deadline": 360.0},
             "asserts": [
                 {"kind": "converged", "frontier": 12},
                 {"kind": "progress", "min_layer": 12},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "slo_green"},
                 {"kind": "span", "name": "mesh.process_layer",
                  "min": 8},
                 {"kind": "span", "name": "gossip.deliver", "min": 32},
             ]},
        ],
    }


def eclipse_campaign(seed: int = 31, light: int = 48) -> dict:
    """Eclipse attack across an epoch boundary: minority full 3 may
    only talk to a clique of attacker lights, which feed it (and the
    honest side) malformed ATXs while the epoch turns. The honest
    majority keeps deciding; every hostile payload dies as a TYPED
    rejection (hub ``rejected``, never a crash); after the eclipse
    clears the victim re-syncs into byte-identical consensus — zero
    divergence. The in-proc analogue of an eclipse campaign against a
    bootstrapping node."""
    attackers = [("light", i) for i in (40, 41, 42, 43)]
    return {
        "name": "eclipse-campaign", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 20,
        "digest_frontier": 12,
        "shards": "auto",
        "phases": [
            {"name": "warmup", "until_layer": 6,
             "traffic": {"storm": {"publishers": 4, "messages": 12,
                                   "interval": 0.25},
                         "tx_spawn": {}},
             "asserts": [
                 {"kind": "storm_coverage", "min_fraction": 0.9},
             ]},
            # the eclipse holds from layer 6 through 11 — across the
            # epoch boundary at layer 8, the window where an isolated
            # node's ATX/beacon view is most poisonable
            {"name": "eclipse", "until_layer": 11,
             "faults": [
                 {"kind": "eclipse", "victim": ["full", 3],
                  "attackers": attackers},
                 {"kind": "adversary", "what": "malformed_atx",
                  "count": 8, "via": 40},
                 {"kind": "adversary", "what": "torsion_sig",
                  "count": 4, "via": 41},
             ],
             "traffic": {"storm": {"publishers": 4, "messages": 8,
                                   "interval": 0.4}}},
            {"name": "heal",
             "faults": [
                 {"kind": "clear_eclipse", "victim": ["full", 3]},
                 {"kind": "heal"},
             ],
             "converge": {"frontier": 12, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 12},
                 {"kind": "progress", "min_layer": 12},
                 {"kind": "hub_stat", "name": "rejected", "min": 1},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "slo_green"},
             ]},
        ],
    }


def soak_epochs(seed: int = 37, light: int = 252) -> dict:
    """The multi-epoch soak (tier-2): three and a half epochs of
    continuous storm + VM transaction traffic on the sharded fabric,
    with STATE-ROOT EQUALITY asserted at every epoch boundary — the
    drift detector for slow divergence that single-epoch drills can't
    see — plus green windowed SLOs over the whole run."""
    return {
        "name": "soak-epochs", "seed": seed,
        "nodes": {"full": 4, "light": light,
                  "identities": [3, 1, 1, 1]},
        "layer_sec": 2.0, "lpe": 8, "until_layer": 30,
        "digest_frontier": 26,
        "shards": "auto",
        "topology": {"degree": 6, "gossip_degree": 4},
        "phases": [
            {"name": "soak", "until_layer": 28,
             "traffic": {"storm": {"publishers": 8, "messages": 64,
                                   "interval": 0.5},
                         "tx_spawn": {}}},
            {"name": "end",
             "converge": {"frontier": 26, "deadline": 360.0},
             "asserts": [
                 {"kind": "converged", "frontier": 26},
                 {"kind": "progress", "min_layer": 26},
                 {"kind": "epoch_roots", "upto_layer": 26},
                 {"kind": "storm_coverage", "min_fraction": 0.9},
                 {"kind": "sli_present", "name": "layer_apply_p99"},
                 {"kind": "slo_green"},
             ]},
        ],
    }


def crash_store(seed: int = 13, light: int = 24) -> dict:
    """Composed crash-store-mid-partition drill: full node 2 is cut off
    in its own island and then SIGKILLed (storage left on disk), the
    majority island keeps certifying; after heal the node RESTARTS over
    its surviving stores (the recovery path through App.prepare)
    and must re-sync into byte-identical consensus with the majority —
    the fault every production operator actually fears, crash + netsplit
    at once."""
    return {
        "name": "crash-store", "seed": seed,
        "nodes": {"full": 3, "light": light, "identities": [2, 1, 1]},
        "layer_sec": 2.0, "lpe": 3, "until_layer": 16,
        "digest_frontier": 11,
        "phases": [
            {"name": "warmup", "until_layer": 6,
             "traffic": {"storm": {"publishers": 4, "messages": 10,
                                   "interval": 0.25}}},
            {"name": "partition-crash", "until_layer": 9,
             "faults": [
                 {"kind": "partition", "islands": [[0, 1], [2]]},
                 {"kind": "kill", "full": 2},
             ]},
            {"name": "heal-restart", "until_layer": 12,
             "faults": [
                 {"kind": "heal"},
                 {"kind": "restart", "full": 2},
             ]},
            {"name": "end",
             "converge": {"frontier": 11, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 11},
                 {"kind": "progress", "min_layer": 11},
                 {"kind": "slo_green"},
             ]},
        ],
    }


def byzantine_verifyd(seed: int = 9) -> dict:
    """One fleet replica turns byzantine mid-load: transport healthy,
    admission healthy, every verdict flipped. The FleetVerifier's
    verdict audit (``audit.items`` spot-checks per successful remote
    batch against the bit-identical local farm) must detect the
    divergence, trip THAT replica's breaker, and keep serving correct
    verdicts from the survivors; after the replica is restored the
    probe path re-closes the breaker. Zero wrong verdicts may reach a
    caller at any point."""
    return {
        "name": "byzantine-verifyd", "engine": "fleet", "seed": seed,
        "waves": 14, "wave_interval_s": 0.5,
        "replicas": [
            {"name": "r0", "router_max_clients": 64,
             "service": {"max_clients": 512, "max_pending_items": 4096,
                         "workers": 2}},
            {"name": "r1", "router_max_clients": 64,
             "service": {"max_clients": 512, "max_pending_items": 4096,
                         "workers": 2}},
            {"name": "r2", "router_max_clients": 64,
             "service": {"max_clients": 512, "max_pending_items": 4096,
                         "workers": 2}},
        ],
        "clients": {"active_per_wave": 10, "overflow": 0,
                    "pinned_hot": 0, "items": [2, 4],
                    "mix": {"sig": 6, "vrf": 1, "membership": 1,
                            "pow": 2}},
        "breaker": {"failure_budget": 2, "window_s": 60.0,
                    "cooldown_s": 1.0, "cooldown_cap_s": 2.0},
        "audit": {"items": 2},
        "faults": {"byzantine": {"replica": "r1", "wave": 3,
                                 "restore_wave": 9}},
        "workload": {"sigs": 48, "vrfs": 6, "posts": 2,
                     "memberships": 8, "pows": 10},
        "asserts": [
            {"kind": "no_wrong_verdicts"},
            {"kind": "typed_sheds_only", "reasons": []},
            {"kind": "byzantine_detected", "replica": "r1", "min": 1},
            {"kind": "breaker_sequence", "replica": "r1"},
            {"kind": "path_served", "path": "remote", "min": 60},
            {"kind": "failback"},
            {"kind": "sli_present", "name": "fleet_block_p99"},
            {"kind": "slo_green", "name": "fleet_block_p99",
             "target": 0.25},
        ],
    }


def timeskew_kill(seed: int = 5, light: int = 16) -> dict:
    """tests/test_cluster_chaos.py's assertions on the deterministic
    fabric: skew one node's clock layers ahead mid-run, reset it, then
    SIGKILL another node — the survivors (including the formerly
    skewed one) must keep applying layers and agree on state."""
    return {
        "name": "timeskew-kill", "seed": seed,
        "nodes": {"full": 3, "light": light, "identities": [2, 1, 1]},
        "layer_sec": 2.0, "lpe": 3, "until_layer": 14,
        "digest_frontier": 9,
        "phases": [
            {"name": "warmup", "until_layer": 4},
            {"name": "skew", "until_layer": 6,
             "faults": [{"kind": "timeskew", "full": 2, "offset": 4.0}]},
            {"name": "reset", "until_layer": 8,
             "faults": [{"kind": "timeskew", "full": 2, "offset": 0.0}]},
            {"name": "kill", "until_layer": 11,
             "faults": [{"kind": "kill", "full": 1}]},
            {"name": "end",
             "converge": {"frontier": 9, "deadline": 240.0},
             "asserts": [
                 {"kind": "converged", "frontier": 9},
                 {"kind": "progress", "min_layer": 9},
                 {"kind": "slo_green"},
             ]},
        ],
    }


def verifyd_load(seed: int = 7, light: int = 3) -> dict:
    """Open-loop mixed load from ``light`` in-budget clients plus one
    heavy client whose offered rate is far over its token budget: the
    heavy client sheds (typed ``rate``), the light clients never do,
    and every admitted verdict matches inline verification."""
    mix = {"sig": 6, "vrf": 1, "membership": 1, "pow": 2, "post": 1}
    clients = [
        {"id": f"light-{i}", "rate": 8000.0, "burst": 4000.0,
         "requests_per_wave": 2, "items": [3, 6], "mix": mix,
         "lane": "gossip"}
        for i in range(max(int(light), 1))]
    clients.append(
        {"id": "heavy", "rate": 40.0, "burst": 60.0,
         "requests_per_wave": 4, "items": [6, 10], "mix": mix,
         "lane": "sync"})
    return {
        "name": "verifyd-load", "engine": "verifyd", "seed": seed,
        "waves": 10, "wave_interval_s": 0.05,
        "service": {"max_clients": 8, "max_pending_items": 4096,
                    "workers": 3},
        "workload": {"sigs": 48, "vrfs": 6, "posts": 4,
                     "memberships": 8, "pows": 10},
        "clients": clients,
        "asserts": [
            {"kind": "no_wrong_verdicts"},
            {"kind": "shed", "client": "heavy", "reason": "rate",
             "min": 3},
            {"kind": "no_shed", "client": "light-0"},
            {"kind": "ok_requests", "client": "light-0", "min": 15},
            {"kind": "bounded_pending", "max": 4096},
            {"kind": "sli_present", "name": "verifyd_request_p99"},
        ],
    }


def crash_recovery(seed: int = 7) -> dict:
    """Crash-injection sweep over a tiny init's write-path op sites
    (every 3rd site, seed-offset; power-cut and torn-write variants
    alternating), each restart recovered and asserted bit-identical to
    the uninjected reference, then an ENOSPC hold window that must
    flip the ``post.store`` probe degraded and converge after the plan
    releases space. All fault points are exact op counts — no sleeps,
    byte-identical digest across ``--repeat`` runs."""
    return {
        "name": "crash-recovery", "engine": "crashrec", "seed": seed,
        "labels": 512, "batch": 128, "scrypt_n": 2,
        "max_file_size": 4096, "interval_labels": 128,
        "crash_every": 3, "variants": ["powercut", "torn"],
        "enospc": {"op": 2, "hold": 6},
        "asserts": [
            {"kind": "bit_identical"},
            {"kind": "recovered", "min": 3},
            {"kind": "enospc_degraded"},
            {"kind": "fault_metrics", "min": 3},
        ],
    }


def verifyd_outage(seed: int = 7) -> dict:
    """Kill verifyd mid-load; the node must serve every request from
    the local farm (bit-identical verdicts), keep the BLOCK-lane p99
    green, bound its attempts against the dead service to the breaker
    budget + probes, and fail back to remote after recovery."""
    return {
        "name": "verifyd-outage", "engine": "failover",
        "mode": "verifyd-outage", "seed": seed,
        "waves": 20, "wave_interval_s": 0.5, "requests_per_wave": 2,
        "items": [3, 6],
        "mix": {"sig": 6, "vrf": 1, "membership": 1, "pow": 2},
        "outage": {"kill_wave": 5, "restore_wave": 11},
        "breaker": {"failure_budget": 2, "window_s": 60.0,
                    "cooldown_s": 1.0, "cooldown_cap_s": 2.0},
        "service": {"max_clients": 4, "max_pending_items": 4096,
                    "workers": 2},
        "workload": {"sigs": 48, "vrfs": 6, "posts": 2,
                     "memberships": 8, "pows": 10},
        "asserts": [
            {"kind": "no_wrong_verdicts"},
            {"kind": "outage_local"},
            {"kind": "path_served", "path": "remote", "min": 10},
            {"kind": "path_served", "path": "local", "min": 8},
            {"kind": "remote_attempts_bounded", "max": 6},
            {"kind": "failback"},
            {"kind": "breaker_sequence"},
            {"kind": "sli_present", "name": "failover_block_p99"},
            {"kind": "slo_green", "name": "failover_block_p99",
             "target": 0.25},
        ],
    }


def fleet(seed: int = 7) -> dict:
    """Three sharded verifyd replicas behind one FleetVerifier: 2,400
    placed client identities fill the fleet-wide admission bound (the
    overflow client hears a typed ``registry_full``), a hot replica's
    registry pressure drives re-routes and work steals, a replica kill
    mid-load is absorbed by the survivors with zero verdict divergence,
    a full blackout lands every request on the local farm, and the
    fleet probes its way back to remote serving — BLOCK-lane p99 green
    throughout, byte-identical digest across ``--repeat`` runs."""
    return {
        "name": "fleet", "engine": "fleet", "seed": seed,
        "waves": 18, "wave_interval_s": 0.5,
        "replicas": [
            # r0's own registry is tiny: registry_full sheds re-route
            # its placed clients and heat it up into a steal source
            {"name": "r0", "router_max_clients": 800,
             "service": {"max_clients": 6, "max_pending_items": 4096,
                         "workers": 2}},
            {"name": "r1", "router_max_clients": 800,
             "service": {"max_clients": 512, "max_pending_items": 4096,
                         "workers": 2}},
            {"name": "r2", "router_max_clients": 800,
             "service": {"max_clients": 512, "max_pending_items": 4096,
                         "workers": 2}},
        ],
        "clients": {"active_per_wave": 14, "pinned_hot": 3,
                    "overflow": 2, "items": [2, 4], "hot_replica": "r0",
                    "mix": {"sig": 6, "vrf": 1, "membership": 1,
                            "pow": 2}},
        "breaker": {"failure_budget": 2, "window_s": 60.0,
                    "cooldown_s": 1.0, "cooldown_cap_s": 2.0},
        "faults": {"kill": {"replica": "r1", "wave": 3,
                            "restore_wave": 7},
                   "blackout": {"wave": 11, "restore_wave": 13}},
        "workload": {"sigs": 48, "vrfs": 6, "posts": 2,
                     "memberships": 8, "pows": 10},
        "asserts": [
            {"kind": "no_wrong_verdicts"},
            {"kind": "typed_sheds_only", "reasons": ["registry_full"]},
            {"kind": "fleet_bound", "clients": 2400},
            {"kind": "shed", "client": "over-", "reason":
             "registry_full", "min": 18},
            {"kind": "reroutes", "min": 3},
            {"kind": "steals", "min": 3},
            {"kind": "path_served", "path": "remote", "min": 100},
            {"kind": "path_served", "path": "local", "min": 10},
            {"kind": "path_served", "replica": "r2", "min": 20},
            {"kind": "blackout_local"},
            {"kind": "dead_replica_attempts_bounded", "replica": "r1",
             "max": 8},
            {"kind": "breaker_sequence", "replica": "r1"},
            {"kind": "failback"},
            {"kind": "autoscale", "min_desired": 3},
            {"kind": "sli_present", "name": "fleet_block_p99"},
            {"kind": "sli_present",
             "name": "fleet_replica_r0_shed_per_sec"},
            {"kind": "slo_green", "name": "fleet_block_p99",
             "target": 0.25},
            {"kind": "merged_capture", "min_spans": 1},
        ],
    }


def runtime_degrade(seed: int = 3) -> dict:
    """Seeded device-dispatch fault plan through the runtime engine's
    breaker: open after the failure budget, host fallback carries the
    fault span bit-identically, device recovery re-closes."""
    return {
        "name": "runtime-degrade", "engine": "failover",
        "mode": "runtime-degrade", "seed": seed,
        "batches": 80, "inflight": 3, "step_s": 0.5,
        "fault": {"start": 10, "end": 30},
        "breaker": {"failure_budget": 3, "window_s": 120.0,
                    "cooldown_s": 2.0, "cooldown_cap_s": 6.0,
                    "recover_slack": 14},
        "asserts": [
            {"kind": "bit_identical"},
            {"kind": "device_attempts_bounded", "max": 10},
            {"kind": "fallbacks", "min": 15},
            {"kind": "breaker_sequence"},
            {"kind": "breaker_recloses"},
        ],
    }


_BUILTINS = {
    "smoke": smoke,
    "verifyd-load": verifyd_load,
    "crash-recovery": crash_recovery,
    "partition-heal": partition_heal,
    "storm-256": storm_256,
    "storm-1024": storm_1024,
    "storm-4096": storm_4096,
    "storm-512-bench": storm_512_bench,
    "eclipse-campaign": eclipse_campaign,
    "soak-epochs": soak_epochs,
    "crash-store": crash_store,
    "byzantine-verifyd": byzantine_verifyd,
    "timeskew-kill": timeskew_kill,
    "verifyd-outage": verifyd_outage,
    "runtime-degrade": runtime_degrade,
    "fleet": fleet,
}


def builtin_names() -> list[str]:
    return sorted(_BUILTINS)


def builtin(name: str, **kwargs) -> dict:
    try:
        builder = _BUILTINS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {builtin_names()}") from None
    return builder(**kwargs)


def run(script: dict, device="cuda"):
    """Run a script on its engine (``"engine"``: verifyd, crashrec,
    failover or fleet; none is the network scenario engine) on
    ``device``; returns the engine's result."""
    engine = script.get("engine")
    if engine == "verifyd":
        from .verifyd_load import run_scenario
    elif engine == "crashrec":
        from .crash_recovery import run_scenario
    elif engine == "failover":
        from .failover import run_scenario
    elif engine == "fleet":
        from .fleet import run_scenario
    elif engine is None:
        from .scenario import run_scenario
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return run_scenario(script, device=device)
