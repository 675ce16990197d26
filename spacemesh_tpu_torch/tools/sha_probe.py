"""What bounds the SHA-256 kernels (``csrc/pbkdf2.cu``, ``csrc/k2pow.cu``)
on the card.

    python3 -m spacemesh_tpu_torch.tools.sha_probe [--baseline DIR]

Prints, for each kernel of the two sources, its SASS instruction count and
opcode classes (cuobjdump), then the kernel time (profiler) of each entry
at the shapes the paths launch it at, and for each the rate at which it
completes SHA-256 compressions and the integer instructions per SM per
clock that rate implies. The search kernel is one compression per thread
in straight-line code, so its SASS count per thread, less its set-up, is
the cost of one compression; the other kernels' rates are given in those
units. An SM issues 32-bit integer logic, shifts and adds at 64 lanes a
clock on compute capability 9.0, half the 128 lanes a clock that
``tools/measure.py`` takes as the integer bound. With ``--baseline DIR``
(another checkout, such as an unpacked ``git archive`` of the parent
commit) its ``csrc/pbkdf2.cu`` and ``csrc/proving_scan.cu`` are built too,
and each PBKDF2 entry and the proving scan (at the main path's 2^18 labels
x 16 nonces) of the two are held equal and timed in turns on the same
inputs (baseline, this, this, baseline). The last line is the JSON of
every measurement.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from .measure import int_ops_per_s, kernel_ms, smi
from .romix_probe import sass_functions

SOURCES = ("pbkdf2", "k2pow")
INT_PIPE_LANES = 64  # 32-bit integer lanes per SM per clock on sm_90
# SASS opcode classes: logic and shifts issue only on the integer pipe
CLASSES = {"logic/shift": ("LOP3", "SHF", "SHL", "SHR", "PRMT"),
           "add": ("IADD3", "IADD", "IMAD", "LEA"),
           "memory": ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST")}


def classes(insts) -> dict[str, int]:
    out: collections.Counter = collections.Counter()
    for _, op, _ in insts:
        head = op.split(".")[0]
        out[next((k for k, v in CLASSES.items() if head in v), "other")] += 1
    return dict(out)


def baseline_lib(checkout: Path, name: str, out_dir: Path) -> ctypes.CDLL:
    """``checkout``'s ``csrc/<name>.cu``, built into ``out_dir`` and
    loaded; its launch functions take the same arguments as this tree's
    (the callers copy the wrappers' ``argtypes``)."""
    from ..ops import _build

    lib_path = out_dir / f"lib{name}-baseline.so"
    subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(lib_path),
                    str(checkout / f"spacemesh_tpu_torch/csrc/{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def turns(old, new, kernel: str, reps: int) -> list[float]:
    """Kernel ms of ``old`` and ``new`` in turns: old, new, new, old."""
    return [kernel_ms(f, kernel, reps=reps) for f in (old, new, new, old)]


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose pbkdf2.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sha_probe: no CUDA card", file=sys.stderr)
        return 2
    from ..ops import _build, pbkdf2_cuda, pow_cuda, proving_cuda, u32

    print(smi("name,power.limit"), flush=True)
    _build.build_all(SOURCES)
    report: dict = {"sass": {}, "entries": []}
    for name in SOURCES:
        for fn, insts in sass_functions(_build.library_path(name)).items():
            report["sass"][fn] = dict(count=len(insts), **classes(insts))
            print(f"[sass] {fn}: {len(insts)} instructions "
                  f"{json.dumps(classes(insts))}", flush=True)
    search = next(v for k, v in report["sass"].items() if "search" in k)
    # one compression per thread; the rest (index, block, compare, store)
    # is set-up, about 40 instructions
    per_comp = search["count"] - 40
    ops_s, sms, mhz = int_ops_per_s()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), dev))

    def entry(name, fn, kernel, compressions):
        ms = kernel_ms(fn, kernel, reps=50)
        rate = compressions / (ms / 1e3)
        per_sm_clk = rate * per_comp / (sms * mhz * 1e6)
        row = dict(entry=name, kernel_ms=ms, compressions=compressions,
                   int_inst_per_sm_clk=per_sm_clk,
                   share_of_int_pipe=per_sm_clk / INT_PIPE_LANES)
        report["entries"].append(row)
        print(f"[time] {name}: {ms:.4f} ms, {rate / 1e9:.2f} G "
              f"compressions/s, about {per_sm_clk:.1f} integer instructions "
              f"per SM per clock ({per_sm_clk / INT_PIPE_LANES:.0%} of "
              f"{INT_PIPE_LANES})", flush=True)

    tmp = tempfile.TemporaryDirectory(prefix="sha-probe-")
    base = None
    if args.baseline:
        base = baseline_lib(args.baseline, "pbkdf2", Path(tmp.name))
        for name in ("expand", "finish"):
            fn = getattr(base, f"pbkdf2_{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = pbkdf2_cuda._lib(name).argtypes
    stream = (lambda: torch.cuda.current_stream().cuda_stream)

    def base_call(name, cw, *tensors):
        b = tensors[0].shape[-1]
        out = torch.empty((32 if name == "expand" else 4, b),
                          dtype=torch.int32, device=dev)
        strides = (1, 0) if cw.dim() == 1 else (b, 1)
        err = getattr(base, f"pbkdf2_{name}_launch")(
            cw.data_ptr(), *strides, *(t.data_ptr() for t in tensors),
            out.data_ptr(), b, stream())
        _build.check(err, f"baseline pbkdf2_{name}_launch")
        return out

    report["baseline"] = []
    for b, per_lane in ((32768, False), (32768, True), (9472, True),
                        (1037, True), (37, True)):
        cw = rand(8, b) if per_lane else rand(8)
        lo, hi, blk = rand(b), rand(b), rand(32, b)
        form = "per-lane" if per_lane else "shared"
        keys = b if per_lane else 1
        calls = {"expand": (lambda: pbkdf2_cuda.expand(cw, lo, hi),
                            (lo, hi), 8 * b + 2 * keys),
                 "finish": (lambda: pbkdf2_cuda.finish(cw, blk), (blk,),
                            4 * b + 2 * keys)}
        for name, (fn, tensors, comps) in calls.items():
            entry(f"{name} B={b} {form}", fn, f"{name}_kernel", comps)
            if base is None:
                continue
            old = (lambda: base_call(name, cw, *tensors))
            if not torch.equal(old(), fn()):
                raise RuntimeError(f"baseline {name} disagrees at B={b}")
            ms = turns(old, fn, f"{name}_kernel", reps=50)
            report["baseline"].append(dict(entry=f"{name} B={b} {form}",
                                           baseline_this_this_baseline=ms))
            print(f"[baseline] {name} B={b} {form}: kernel ms baseline, "
                  f"this, this, baseline {json.dumps(ms)}", flush=True)
    if args.baseline:
        # the scan at the main path's prove batch
        scan = baseline_lib(args.baseline, "proving_scan", Path(tmp.name))
        scan.proving_scan_launch.restype = ctypes.c_int
        scan.proving_scan_launch.argtypes = proving_cuda._lib().argtypes
        b, ng, thr = 1 << 18, 16, (26 << 32) // (1 << 20)
        lw, lo = rand(4, b), rand(b)
        hi = torch.zeros(b, dtype=torch.int32, device=dev)
        cw = np.arange(8, dtype=np.uint32)

        def old():
            mask = torch.empty((ng, b), dtype=torch.int8, device=dev)
            seg = torch.empty((ng, b // 64), dtype=torch.int32, device=dev)
            _build.check(scan.proving_scan_launch(
                (ctypes.c_uint32 * 8)(*(int(w) for w in cw)), 7, thr, b,
                lo.data_ptr(), hi.data_ptr(), lw.data_ptr(), mask.data_ptr(),
                seg.data_ptr(), b, ng, stream()), "baseline scan")
            return mask, seg

        def new():
            return proving_cuda.scan(cw, 7, lo, hi, lw, thr, b, n_nonces=ng)

        if not all(torch.equal(x, y) for x, y in zip(old(), new())):
            raise RuntimeError("baseline scan disagrees")
        ms = turns(old, new, "scan_kernel", reps=20)
        report["baseline"].append(dict(entry=f"scan B={b} nonces={ng}",
                                       baseline_this_this_baseline=ms))
        print(f"[baseline] scan B={b} nonces={ng}: kernel ms baseline, this, "
              f"this, baseline {json.dumps(ms)}", flush=True)
    tmp.cleanup()
    pre = np.arange(8, dtype=np.uint32)
    tgt = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
    for n in (1 << 16, 1 << 20):
        entry(f"k2pow search {n}",
              lambda: pow_cuda.search_batch(pre, tgt, 0, n, dev),
              "search_kernel", n)
    for b in (64, 4096):
        batch = (rand(16, b), rand(b), rand(b), rand(8, b))
        entry(f"k2pow verify {b}", lambda: pow_cuda.verify_batch(*batch),
              "verify_kernel", 2 * b)
    print(f"[clock] {smi('clocks.sm,clocks.max.sm')}; bound's integer rate "
          f"{ops_s / 1e12:.2f} T/s ({ops_s / (sms * mhz * 1e6):.0f} lanes "
          f"per SM per clock)")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
