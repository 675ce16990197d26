"""CLI: run scripted scenarios, compare replay digests (port of
``spacemesh_tpu/sim/__main__.py``, plus ``--device``).

    python -m spacemesh_tpu_torch.sim --scenario partition-heal --seed 7
    python -m spacemesh_tpu_torch.sim --scenario smoke --device cpu \
        --repeat 2            # replay determinism: digests must match
    python -m spacemesh_tpu_torch.sim --script scenario.json --json out.json

``--repeat N`` runs the SAME script N times (fresh loop + fresh data
dirs each run) and exits non-zero unless every run's event digest is
byte-identical and every assertion held — the CI scenario-smoke
contract. A YAML script file works too when PyYAML is importable;
JSON always works. ``--device`` (default ``cuda``) is where the full
nodes, the crash sweep's inits and the verifyd drills run; without a card
and without ``--device cpu`` the CLI exits 2 with the device error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .scenarios import builtin, builtin_names, run


def _load_script(path: str) -> dict:
    text = Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore
        except ImportError as exc:
            raise SystemExit(
                f"{path} is not JSON and PyYAML is unavailable: {exc}")
        return yaml.safe_load(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spacemesh_tpu_torch.sim",
        description="deterministic scenario engine (docs/SCENARIOS.md)")
    ap.add_argument("--scenario", choices=builtin_names(),
                    help="built-in scenario name")
    ap.add_argument("--script", help="path to a JSON/YAML script")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--light", type=int, default=None,
                    help="light-node count override")
    ap.add_argument("--shards", default=None,
                    help="worker-process count for the sharded fabric: "
                         "an integer, or 'auto' for min(cores, light//64) "
                         "(SPACEMESH_SIM_SHARDS overrides)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run N times; digests must be byte-identical")
    ap.add_argument("--json", dest="json_out",
                    help="write the (last) full result JSON here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device for the full nodes' POST, the crash "
                         "sweep's inits and the verifyd drills: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)

    if bool(args.scenario) == bool(args.script):
        ap.error("exactly one of --scenario / --script is required")
    if args.scenario:
        kwargs = {}
        if args.seed is not None:
            kwargs["seed"] = args.seed
        if args.light is not None:
            kwargs["light"] = args.light
        script = builtin(args.scenario, **kwargs)
    else:
        script = _load_script(args.script)
        if args.seed is not None:
            script["seed"] = args.seed
    if args.shards is not None:
        script["shards"] = args.shards

    # script "engine" selects the runner (scenarios.run): the network
    # scenario engine (default), the verifyd service-load engine, the POST
    # crash-recovery engine, the self-healing failover engine, or the
    # verifyd fleet engine
    from ..device import resolve

    try:
        device = resolve(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    digests, ok = [], True
    result = None
    for i in range(max(args.repeat, 1)):
        result = run(script, device=device)
        digests.append(result.digest)
        ok = ok and result.ok
        failed = [a for a in result.asserts if not a["ok"]]
        print(f"run {i + 1}/{args.repeat}: digest={result.digest} "
              f"ok={result.ok}"
              + (f" failed={failed}" if failed else ""))
        if not args.quiet:
            for k, v in sorted(result.slis.items()):
                print(f"  sli {k}={v:.6f}")
            for k, v in sorted(result.stats.get("hub", {}).items()):
                print(f"  hub {k}={v}")
    if args.json_out and result is not None:
        Path(args.json_out).write_text(result.to_json())
    if len(set(digests)) != 1:
        print(f"DIGEST MISMATCH across {args.repeat} runs: {digests}",
              file=sys.stderr)
        return 2
    if not ok:
        print("scenario assertions failed", file=sys.stderr)
        return 1
    print(f"OK: {len(digests)} run(s), digest {digests[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
