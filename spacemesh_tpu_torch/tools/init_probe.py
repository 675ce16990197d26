"""Where an init batch's host dispatch time goes on the card.

    python3 -m spacemesh_tpu_torch.tools.init_probe

Needs one CUDA card and ``nvcc``. Warms the three kernels on a few labels,
then runs ``initializer.initialize()`` over 8 init batches of 32768
lanes at N=8192, as ``chip_smoke.py``'s main path does, with host
timers around each call an init batch's dispatch makes: the index staging
(``u32.from_numpy``), the label kernels' wrappers (PBKDF2 expand, ROMix
with its ``lanes_that_fit``, PBKDF2 finish), the VRF min-scan and the two
``HostCopy`` enqueues. Prints, for each, the first batch's milliseconds
and the mean of the later batches', beside the whole dispatch's.
"""

from __future__ import annotations

import collections
import sys
import tempfile
import time

from .measure import smi

N = 8192
BATCH = 1 << 15
BATCHES = 8


def _timed(calls: list, name: str, fn):
    """``fn`` with its host time added to ``calls[-1][name]`` while a
    dispatch is open (``calls`` ends in None outside one)."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            if calls and calls[-1] is not None:
                calls[-1][name] += time.perf_counter() - t0
    return wrapper


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("init_probe: no CUDA card", file=sys.stderr)
        return 2
    from ..ops import pbkdf2_cuda, romix_cuda, scrypt, u32
    from ..post import initializer

    print(smi("name,power.limit"), flush=True)
    scrypt.scrypt_labels(bytes(32), range(4), n=N, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    calls: list = []
    patches = [(u32, "from_numpy"), (pbkdf2_cuda, "expand"),
               (romix_cuda, "romix"), (romix_cuda, "lanes_that_fit"),
               (pbkdf2_cuda, "finish"), (scrypt, "_minscan"),
               (initializer, "HostCopy")]
    for mod, name in patches:
        setattr(mod, name, _timed(calls, name, getattr(mod, name)))

    class Timed(initializer.engine.Pipeline):
        def run(self, items, dispatch, retire):
            def timed(item):
                calls.append(collections.defaultdict(float))
                t0 = time.perf_counter()
                try:
                    return dispatch(item)
                finally:
                    calls[-1]["dispatch"] = time.perf_counter() - t0
                    calls.append(None)
            return super().run(items, timed, retire)

    initializer.engine.Pipeline = Timed
    with tempfile.TemporaryDirectory(prefix="init-probe-") as d:
        _, res = initializer.initialize(
            d, node_id=bytes(32), commitment=bytes(32), num_units=1,
            labels_per_unit=BATCHES * BATCH, scrypt_n=N,
            batch_size=BATCH, device="cuda")
    batches = [c for c in calls if c is not None]
    print(f"[init] {BATCHES} batches of {BATCH} lanes, N={N}: "
          f"{res.labels_per_s:.0f} labels/s; dispatch_s "
          f"{res.stats.dispatch_s * 1e3:.2f} ms, fetch_s "
          f"{res.stats.fetch_s * 1e3:.2f} ms")
    for name in ["dispatch"] + [n for _, n in patches]:
        rest = [b[name] for b in batches[1:]]
        print(f"[dispatch] {name}: first batch {batches[0][name] * 1e3:.3f} "
              f"ms, later batches {sum(rest) / max(len(rest), 1) * 1e3:.3f} "
              f"ms on average", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
