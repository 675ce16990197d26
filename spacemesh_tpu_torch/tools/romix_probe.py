"""Time the ROMix kernel's two phases on the card and show the instructions
of the ROMix and PBKDF2 kernels.

    python3 -m spacemesh_tpu_torch.tools.romix_probe [--lanes 32768]

Needs one CUDA card and ``nvcc``. Prints, in order:

1. the card's name and power limit (``nvidia-smi``);
2. ptxas's registers and spills for ``csrc/romix.cu`` and ``csrc/pbkdf2.cu``;
3. the SASS opcode histogram of each of their kernels (``cuobjdump -sass``
   on the built library): the whole kernel, and each loop body found by its
   backward branch (ROMix's fill and mix loops each hold one BlockMix, the
   PBKDF2 expand loop one inner and one outer compression);
4. the CUDA-event time of the whole ROMix kernel and of the fill phase
   alone (``mix_phase=False``) at (32, lanes), N=8192, and the mix phase as
   their difference, with the operations bound and the V-traffic floor
   beside them;
5. the SM clock and power that nvidia-smi samples while the whole kernel
   runs back to back;
6. the rates the card's own library kernels reach on a tensor of V's size
   with the fill's and the mix's access patterns (``fill_``;
   ``embedding_bag`` over random rows), as practical floors beside the
   3.35 TB/s peak.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time
from pathlib import Path

from .measure import HBM_BYTES_PER_S, cuda_ms, int_ops_per_s, smi

N = 8192
REPS = 3
SOURCES = ("romix", "pbkdf2")

_INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, str]]]:
    """Kernel name -> [(address, opcode, operands)] from cuobjdump."""
    from ..ops import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INST.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def histogram(insts) -> str:
    groups = collections.Counter(op.split(".")[0] for _, op, _ in insts)
    return ", ".join(f"{k} {v}" for k, v in groups.most_common())


def loops(insts):
    """Loop bodies: (start, end) address ranges closed by a backward BRA."""
    out = []
    for addr, op, args in insts:
        if op.split(".")[0] == "BRA":
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < addr:
                out.append((int(m.group(1), 16), addr))
    return out


def show_sass(lib: Path) -> None:
    for name, insts in sass_functions(lib).items():
        print(f"[sass] {name}: {len(insts)} instructions: "
              f"{histogram(insts)}")
        for lo, hi in loops(insts):
            body = [i for i in insts if lo <= i[0] <= hi]
            if len(body) > 200:  # a hash body, not a copy loop
                print(f"[sass]   loop 0x{lo:x}-0x{hi:x}: {len(body)} "
                      f"instructions: {histogram(body)}")


def time_phases(lanes: int) -> None:
    import numpy as np
    import torch

    from ..ops import romix_cuda, u32

    dev = torch.device("cuda")
    x = u32.from_numpy(np.random.default_rng(5).integers(
        0, 2**32, (32, lanes), dtype=np.uint32), dev)
    ops_ms = romix_cuda.int_ops(lanes, N) / int_ops_per_s()[0] * 1e3
    v_ms = romix_cuda.scratch_bytes(lanes, N) / HBM_BYTES_PER_S * 1e3
    whole = cuda_ms(lambda: romix_cuda.romix(x, N), REPS)
    fill = cuda_ms(lambda: romix_cuda.romix(x, N, mix_phase=False), REPS)
    print(f"[time] (32, {lanes}) N={N}: whole {whole:.3f} ms, fill "
          f"{fill:.3f} ms, mix {whole - fill:.3f} ms "
          f"({lanes / whole * 1e3:.0f} labels/s); operations bound "
          f"{ops_ms:.2f} ms, V traffic floor {v_ms:.2f} ms (fill half "
          f"{v_ms / 2:.2f})", flush=True)
    clocks_under_load(lambda: romix_cuda.romix(x, N), 1.0)


def clocks_under_load(fn, seconds: float) -> None:
    """SM clock and power, sampled by nvidia-smi every 100 ms while ``fn``
    runs back to back for about ``seconds``."""
    import torch

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out = mon.communicate(timeout=10)[0]
    rows = [[float(v) for v in line.split(",")]
            for line in out.splitlines() if line.count(",") == 1]
    if not rows:
        print("[clock] no samples")
        return
    mhz = sorted(r[0] for r in rows)
    watts = sorted(r[1] for r in rows)
    print(f"[clock] under load, {len(rows)} samples: SM clock min "
          f"{mhz[0]:.0f} median {mhz[len(mhz) // 2]:.0f} MHz; power median "
          f"{watts[len(watts) // 2]:.0f} W, max {watts[-1]:.0f} W",
          flush=True)


def memory_floors(lanes: int) -> None:
    """What the card's own library kernels reach on a tensor of V's size:
    ``fill_`` (sequential stores, the fill's write volume without its
    arithmetic) and ``embedding_bag`` summing 2^24 rows picked at random
    (random 128-byte row reads, the mix's read pattern, into a small
    output)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rows = lanes * N
    v = torch.empty((rows, 32), dtype=torch.float32, device=dev)
    fill_ms = cuda_ms(lambda: v.fill_(1.0), REPS)
    nbytes = rows * 128
    print(f"[floor] fill_ of V's {nbytes / 2**30:.0f} GiB: {fill_ms:.3f} ms, "
          f"{nbytes / fill_ms / 1e9:.3f} TB/s", flush=True)
    picks = 1 << 24
    gen = torch.Generator(device=dev).manual_seed(9)
    idx = torch.randint(0, rows, (picks,), generator=gen, device=dev)
    offsets = torch.arange(0, picks, 256, device=dev)
    bag_ms = cuda_ms(lambda: F.embedding_bag(idx, v, offsets, mode="sum"),
                     REPS)
    print(f"[floor] embedding_bag of {picks} random 128-byte rows of V: "
          f"{bag_ms:.3f} ms, {picks * 128 / bag_ms / 1e9:.3f} TB/s of row "
          f"reads", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=32768)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("romix_probe: no CUDA card", file=sys.stderr)
        return 2
    from ..ops import _build

    print(smi("name,power.limit"), flush=True)
    logs = _build.build_all(SOURCES)
    for name in SOURCES:
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        show_sass(_build.library_path(name))
    time_phases(args.lanes)
    torch.cuda.empty_cache()
    memory_floors(args.lanes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
