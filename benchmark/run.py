"""Entry point of the benchmark: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. The last line of standard output is the result's JSON object.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, heads the import path
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_env()
    sys.exit(harness.main(t_start=T_START))
