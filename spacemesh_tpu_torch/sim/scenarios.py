"""Built-in scripts of the port's drills (the five of
``spacemesh_tpu/sim/scenarios.py`` the verifyd fleet and the runtime
engine's self-healing acceptance runs).

Each function below returns a plain script dict; ``builtin(name, **overrides)``
is the registry. All numbers are DETERMINISTIC functions of the seed —
nothing here reads wall time. ``run(script, device=...)`` dispatches a
script to its engine (``sim/verifyd_load.py``, ``sim/failover.py``,
``sim/fleet.py``).

* ``verifyd-load`` — the verification SERVICE under seeded open-loop
  multi-client load: three light clients + one heavy client over
  capacity, typed rate sheds on the heavy client only, zero wrong
  verdicts, replay-stable outcome digest.
* ``verifyd-outage`` — the self-healing drill: verifyd killed mid-load,
  the node keeps verifying on the local farm with zero verdict
  divergence and a green BLOCK-lane SLO, the breaker stops re-paying the
  dead service, and traffic fails back to remote after recovery.
* ``fleet`` — three sharded replicas behind one FleetVerifier: the
  fleet-wide admission bound, re-routes, work steals, a replica kill, a
  blackout served locally, failback.
* ``byzantine-verifyd`` — one replica flips every verdict; the verdict
  audit trips it and no wrong verdict reaches a caller.
* ``runtime-degrade`` — a seeded device-fault plan through the runtime
  engine's breaker: it opens after the failure budget, the host fallback
  carries the fault span bit-identically, and device recovery re-closes
  it.
"""

from __future__ import annotations


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
    "verifyd-load": verifyd_load,
    "verifyd-outage": verifyd_outage,
    "fleet": fleet,
    "byzantine-verifyd": byzantine_verifyd,
    "runtime-degrade": runtime_degrade,
}


def builtin_names() -> list[str]:
    return sorted(_BUILTINS)


def builtin(name: str, **kwargs) -> dict:
    try:
        make = _BUILTINS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {builtin_names()}") from None
    return make(**kwargs)


def run(script: dict, device="cuda"):
    """Run a script on its engine (``"engine"``: verifyd, failover or
    fleet) on ``device``; returns the engine's result."""
    engine = script.get("engine")
    if engine == "verifyd":
        from .verifyd_load import run_scenario
    elif engine == "failover":
        from .failover import run_scenario
    elif engine == "fleet":
        from .fleet import run_scenario
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return run_scenario(script, device=device)
