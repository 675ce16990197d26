"""The control: a cell run with one stated guarantee broken, which the check
must call incorrect.

The configurations state no precision; they state scrypt's N. The
control runs the program itself at N/2 (its own path at a cheaper
setting, the cut a later change might be tempted by), while the
reference keeps the stated N, so every sampled label must read as wrong.
The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s>

prints one JSON line per seed: the numbers compared, each beside its
limit, and whether the run came out correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402


def control(workload: str, seed: int, seconds: float, device: str = "cuda",
            config_overrides=None, traffic_overrides=None,
            cache=None) -> dict:
    spec = harness.load_spec()
    n = dict(harness.config_of(spec, harness.workload(spec, workload)),
             **(config_overrides or {}))["scrypt_n"]
    return harness.run_cell(spec, workload, seed, seconds, False, device,
                            config_overrides=config_overrides,
                            traffic_overrides=traffic_overrides,
                            program_overrides={"scrypt_n": n // 2},
                            cache=cache)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the benchmark's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = control(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    harness.set_cache_env()
    sys.exit(main())
