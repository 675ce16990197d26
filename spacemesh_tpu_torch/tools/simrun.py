"""Operator alias for the scenario engine CLI.

The engine lives in ``spacemesh_tpu_torch/sim``; this alias keeps it
discoverable beside the other operator tools:

    python -m spacemesh_tpu_torch.tools.simrun --scenario partition-heal \
        --light 64 --seed 7 --repeat 2 --device cpu

is exactly ``python -m spacemesh_tpu_torch.sim ...``.
"""

from __future__ import annotations

import sys

from ..sim.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
