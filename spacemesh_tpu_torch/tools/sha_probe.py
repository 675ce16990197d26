"""What bounds the SHA-256 kernels (``csrc/pbkdf2.cu``, ``csrc/k2pow.cu``)
on the card.

    python3 -m spacemesh_tpu_torch.tools.sha_probe [--baseline DIR]

Prints, for each kernel of the two sources, its SASS instruction count and
opcode classes (cuobjdump), the count of ``IMAD`` against ``IADD3``, and
for the k2pow search window the instructions of its loop body (one nonce:
one compression and the compare). Then the kernel time (profiler) of each
entry at the shapes the paths launch it at, and for each the rate at which
it completes SHA-256 compressions and the integer instructions per SM per
clock that rate implies (in loop-body instructions of the plain window,
one compression each). The window at 2^24 nonces with no winner is timed
in both forms of the rounds in turns (plain, IMAD, IMAD, plain), each with
its own loop body's instructions per SM per clock, split into those that
issue on the integer pipe and the ``IMAD``s, which issue on the FMA pipe,
and the SM clock and power sampled while the IMAD form runs.
An SM issues 32-bit integer logic, shifts and adds at 64 lanes a clock on
compute capability 9.0, half the 128 lanes a clock that
``tools/measure.py`` takes as the integer bound. Also the empty kernel's
time (``k2pow_empty_launch``): device time, back-to-back call rate, and
host launch to completion.

With ``--baseline DIR`` (another checkout, such as an unpacked ``git
archive`` of the parent commit) its ``csrc/pbkdf2.cu``, ``csrc/k2pow.cu``
and ``csrc/proving_scan.cu`` are built too; each kernel both trees have
has its SASS compared instruction for instruction; and they are held
equal to this tree's and timed in turns on the same inputs (baseline,
this, this, baseline):
each PBKDF2 entry; the proving scan at the main path's 2^18 labels x 16
nonces; the verifier's finish and proving hash (the baseline's two
launches against this tree's ``finish_hash``); and the baseline's k2pow
mask kernel over 2^24 nonces against this tree's window over the same
nonces. The last line is the JSON of every measurement.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .measure import cuda_ms, int_ops_per_s, kernel_ms, smi
from .romix_probe import clocks_under_load, loops, sass_functions

SOURCES = ("pbkdf2", "k2pow")
INT_PIPE_LANES = 64  # 32-bit integer lanes per SM per clock on sm_90
WINDOW = 1 << 24     # nonces of the timed search window
# SASS opcode classes: logic and shifts issue only on the integer pipe
CLASSES = {"logic/shift": ("LOP3", "SHF", "SHL", "SHR", "PRMT"),
           "add": ("IADD3", "IADD", "IMAD", "LEA"),
           "memory": ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST")}


def classes(insts) -> dict[str, int]:
    out: collections.Counter = collections.Counter()
    for _, op, _ in insts:
        head = op.split(".")[0]
        out[next((k for k, v in CLASSES.items() if head in v), "other")] += 1
        if head in ("IMAD", "IADD3"):
            out[head] += 1
    return dict(out)


def loop_body(insts) -> list:
    """The instructions of a kernel's longest loop body (by backward
    branch): the window's per-nonce work."""
    bodies = [[i for i in insts if lo <= i[0] <= hi]
              for lo, hi in loops(insts)]
    return max(bodies, key=len) if bodies else []


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


def same_sass(checkout: Path, out_dir: Path) -> dict:
    """Each kernel of ``checkout``'s SHA-256 and Salsa sources that this
    tree still has under the same name (finish_kernel<kShared> is now
    finish_kernel<kShared, false>, with HashArgs appended): whether its
    SASS, opcodes and operands, is instruction for instruction this
    tree's, and the two counts. Built by :func:`baseline_lib` first."""
    from ..ops import _build

    out = {}
    for name in ("pbkdf2", "k2pow", "proving_scan"):
        old = sass_functions(out_dir / f"lib{name}-baseline.so")
        new = {fn.replace("ELb0EEv", "EEv").replace("x8HashArgs", "x"): insts
               for fn, insts in sass_functions(
                   _build.library_path(name)).items()}
        for fn, insts in old.items():
            if fn in new:
                strip = (lambda xs: [(op, args) for _, op, args in xs])
                out[fn] = dict(identical=strip(insts) == strip(new[fn]),
                               baseline=len(insts), this=len(new[fn]))
    return out


def turns(old, new, kernel: str, reps: int, new_kernel: str | None = None
          ) -> list[float]:
    """Kernel ms per call of ``old`` and ``new`` in turns: old, new, new,
    old; the kernels whose names hold ``kernel`` (``new_kernel`` for
    ``new`` when given), summed over each call's launches."""
    names = [kernel, new_kernel or kernel, new_kernel or kernel, kernel]
    return [kernel_ms(f, k, reps=reps, per_call=True)
            for f, k in zip((old, new, new, old), names)]


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout whose kernels to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sha_probe: no CUDA card", file=sys.stderr)
        return 2
    from ..ops import _build, pbkdf2_cuda, pow_cuda, proving_cuda, u32

    print(smi("name,power.limit"), flush=True)
    _build.build_all(SOURCES)
    report: dict = {"sass": {}, "entries": [], "window": {}}
    bodies = {}
    for name in SOURCES:
        for fn, insts in sass_functions(_build.library_path(name)).items():
            report["sass"][fn] = dict(count=len(insts), **classes(insts))
            print(f"[sass] {fn}: {len(insts)} instructions "
                  f"{json.dumps(classes(insts))}", flush=True)
            if "window_kernel" in fn:
                form = "imad" if "ILb1E" in fn else "plain"
                body = loop_body(insts)
                bodies[form] = dict(count=len(body), **classes(body))
                print(f"[sass]   {form} loop body (one nonce): {len(body)} "
                      f"instructions {json.dumps(classes(body))}",
                      flush=True)
    report["window"]["loop_body"] = bodies
    # one compression and the compare per nonce of the plain window
    per_comp = bodies["plain"]["count"]
    ops_s, sms, mhz = int_ops_per_s()
    clk = sms * mhz * 1e6
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rand = (lambda *shape: u32.from_numpy(
        rng.integers(0, 2**32, shape, dtype=np.uint32), dev))

    def entry(name, fn, kernel, compressions):
        ms = kernel_ms(fn, kernel, reps=50)
        rate = compressions / (ms / 1e3)
        per_sm_clk = rate * per_comp / clk
        row = dict(entry=name, kernel_ms=ms, compressions=compressions,
                   int_inst_per_sm_clk=per_sm_clk,
                   share_of_int_pipe=per_sm_clk / INT_PIPE_LANES)
        report["entries"].append(row)
        print(f"[time] {name}: {ms:.4f} ms, {rate / 1e9:.2f} G "
              f"compressions/s, about {per_sm_clk:.1f} integer instructions "
              f"per SM per clock ({per_sm_clk / INT_PIPE_LANES:.0%} of "
              f"{INT_PIPE_LANES})", flush=True)

    # the search window at full width, no winner, both forms in turns
    block1 = np.arange(16, dtype=np.uint32)
    zero = np.zeros(8, dtype=np.uint32)

    def window(imad):
        return lambda: pow_cuda.search_window(
            block1, zero, 0, WINDOW, pow_cuda.new_cell(dev), dev, imad=imad)

    ms = turns(window(False), window(True), "window_kernel", reps=10)
    clocks_under_load(window(True), 1.0)
    bound_ms = pow_cuda.int_ops(WINDOW, "window") / ops_s * 1e3
    report["window"]["plain_imad_imad_plain_ms"] = ms
    report["window"]["bound_ms"] = bound_ms
    for form, t in (("plain", (ms[0] + ms[3]) / 2),
                    ("imad", (ms[1] + ms[2]) / 2)):
        b = bodies[form]
        per_clk = WINDOW / (t / 1e3) / clk
        total, imad_n = b["count"] * per_clk, b.get("IMAD", 0) * per_clk
        report["window"][form] = dict(
            kernel_ms=t, nonces_per_s=WINDOW / (t / 1e3),
            share_of_bound=bound_ms / t, inst_per_sm_clk=total,
            int_pipe_per_sm_clk=total - imad_n, imad_per_sm_clk=imad_n)
        print(f"[window] {form}: {t:.4f} ms per {WINDOW} nonces "
              f"({WINDOW / t / 1e6:.2f} G nonces/s), {bound_ms / t:.0%} of "
              f"the bound {bound_ms:.4f} ms; {total:.1f} instructions per "
              f"SM per clock, {total - imad_n:.1f} on the integer pipe and "
              f"{imad_n:.1f} IMAD", flush=True)
    print(f"[window] kernel ms plain, IMAD, IMAD, plain {json.dumps(ms)}",
          flush=True)

    # the empty kernel: the floor a launch costs
    empty = (lambda: pow_cuda.empty_launch(dev))
    host = []
    for _ in range(50):
        t0 = time.perf_counter()
        empty()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    report["empty"] = dict(kernel_ms=kernel_ms(empty, "empty_kernel",
                                               reps=50),
                           call_ms=cuda_ms(empty, reps=50),
                           launch_to_done_ms=sorted(host)[len(host) // 2])
    print(f"[empty] device {report['empty']['kernel_ms']:.4f} ms, back to "
          f"back {report['empty']['call_ms']:.4f} ms per call, launch to "
          f"completion (host clock, median of 50) "
          f"{report['empty']['launch_to_done_ms']:.4f} ms", flush=True)

    tmp = tempfile.TemporaryDirectory(prefix="sha-probe-")
    base = scan = None
    if args.baseline:
        base = baseline_lib(args.baseline, "pbkdf2", Path(tmp.name))
        for name in ("expand", "finish"):
            fn = getattr(base, f"pbkdf2_{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = pbkdf2_cuda._lib(name).argtypes
        scan = baseline_lib(args.baseline, "proving_scan", Path(tmp.name))
        scan.proving_scan_launch.restype = ctypes.c_int
        scan.proving_scan_launch.argtypes = proving_cuda._lib().argtypes
        scan.proving_hash_launch.restype = ctypes.c_int
        scan.proving_hash_launch.argtypes = proving_cuda._hash_lib().argtypes
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

    def held(entry_name, old, new, kernel, reps, new_kernel=None):
        ms = turns(old, new, kernel, reps=reps, new_kernel=new_kernel)
        report["baseline"].append(dict(entry=entry_name,
                                       baseline_this_this_baseline=ms))
        print(f"[baseline] {entry_name}: kernel ms baseline, this, this, "
              f"baseline {json.dumps(ms)}", flush=True)

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
            held(f"{name} B={b} {form}", old, fn, f"{name}_kernel", 50)
        # finish with the proving hash, against finish alone
        ch, nonce = (rand(8, b), rand(b)) if per_lane else (rand(8), 7)
        fh = (lambda: pbkdf2_cuda.finish_hash(cw, blk, ch, nonce, lo, hi))
        fin = (lambda: pbkdf2_cuda.finish(cw, blk))
        ms = turns(fin, fh, "finish_kernel", reps=50)
        report["entries"].append(dict(
            entry=f"finish_hash B={b} {form}",
            finish_hash_finish_hash_finish_ms=ms))
        print(f"[time] finish_hash B={b} {form}: kernel ms finish, "
              f"finish_hash, finish_hash, finish {json.dumps(ms)}; the hash "
              f"adds {(ms[1] + ms[2] - ms[0] - ms[3]) / 2:.5f} ms; its "
              f"standalone bound "
              f"{proving_cuda.hash_int_ops(b) / ops_s * 1e3:.5f} ms",
              flush=True)
        if base is None or not per_lane:
            continue

        def old_pair():
            words = base_call("finish", cw, blk)
            out = torch.empty(b, dtype=torch.int32, device=dev)
            _build.check(scan.proving_hash_launch(
                ch.data_ptr(), b, 1, nonce.data_ptr(), 1, 0, lo.data_ptr(),
                hi.data_ptr(), words.data_ptr(), 1, out.data_ptr(), b,
                stream()), "baseline proving_hash_launch")
            return out

        if not torch.equal(old_pair(), fh()[0]):
            raise RuntimeError(f"baseline finish + hash disagrees at B={b}")
        # the baseline's two kernels summed per call against the one
        held(f"finish + proving hash B={b} {form} (baseline: two launches)",
             old_pair, fh, "_kernel", 50, new_kernel="finish_kernel")
    if base is not None:
        _build.build_all(("proving_scan",))
        baseline_lib(args.baseline, "k2pow", Path(tmp.name))
        report["same_sass"] = same_sass(args.baseline, Path(tmp.name))
        for fn, row in report["same_sass"].items():
            print(f"[baseline] SASS of {fn}: "
                  f"{'identical' if row['identical'] else 'differs'} "
                  f"({row['baseline']} instructions, this tree "
                  f"{row['this']})", flush=True)
        # the scan at the main path's prove batch
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
        held(f"scan B={b} nonces={ng}", old, new, "scan_kernel", 20)
        # the baseline's mask search over the window's nonces, one launch
        k2 = ctypes.CDLL(str(Path(tmp.name) / "libk2pow-baseline.so"))
        k2.k2pow_search_launch.restype = ctypes.c_int
        k2.k2pow_search_launch.argtypes = pow_cuda._ARGTYPES["search"]
        pre = (ctypes.c_uint32 * 8)(*range(8))
        zw = (ctypes.c_uint32 * 8)()

        def old_search():
            out = torch.empty(WINDOW, dtype=torch.bool, device=dev)
            _build.check(k2.k2pow_search_launch(pre, zw, 0, out.data_ptr(),
                                                WINDOW, stream()),
                         "baseline k2pow_search_launch")
            return out

        for imad in (True, False, True, False):
            held(f"k2pow {WINDOW} nonces, no winner: baseline mask kernel, "
                 f"this window ({'IMAD' if imad else 'plain'})",
                 old_search, window(imad), "search_kernel", 10,
                 new_kernel="window_kernel")
        clocks_under_load(old_search, 1.0)
    tmp.cleanup()
    pre = np.arange(8, dtype=np.uint32)
    tgt = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
    for n in (1 << 16, 1 << 20):
        entry(f"k2pow mask search {n}",
              lambda: pow_cuda.search_batch(pre, tgt, 0, n, dev),
              "search_kernel", n)
    for b in (64, 4096):
        batch = (rand(16, b), rand(b), rand(b), rand(8, b))
        entry(f"k2pow verify {b}", lambda: pow_cuda.verify_batch(*batch),
              "verify_kernel", 2 * b)
    print(f"[clock] {smi('clocks.sm,clocks.max.sm')}; bound's integer rate "
          f"{ops_s / 1e12:.2f} T/s ({ops_s / clk:.0f} lanes per SM per "
          f"clock)")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
