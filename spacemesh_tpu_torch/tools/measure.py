"""Timing and bound helpers shared by ``chip_smoke.py`` and the probes.

A kernel's bound is the larger of two times: the bytes it must move over
the card's memory rate, and its integer operations over the card's
integer instruction rate (:func:`int_ops_per_s`).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
# integer instruction ceiling: 4 schedulers per SM, each starting one warp
# instruction (32 lanes) per clock. The 64 INT32 ALU lanes per SM are not
# the limit: integer adds also run on the FMA pipe (IMAD).
LANES_PER_SM_CLK = 128
# profiler sessions kernel_ms tries: on an H100 one session once recorded
# none of a short run's kernels, and a second session of the same run did
_PROFILE_ATTEMPTS = 3


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def int_ops_per_s() -> tuple[float, int, float]:
    """(integer operations per second, SMs, max SM clock in MHz) of card 0."""
    import torch

    max_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * LANES_PER_SM_CLK * max_mhz * 1e6, sms, max_mhz


def bound(ops: int, nbytes: int, ops_per_s: float) -> dict:
    """``bound_ms`` and what sets it (``bound_by``: bytes or operations)."""
    ops_ms = ops / ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_intervals(prof) -> list[tuple[float, float]]:
    """(start, end) microseconds of every device activity (kernels, copies)
    a ``torch.profiler.profile`` recorded."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def busy_us(intervals) -> float:
    """Length of the union of ``intervals``: the time the device was busy,
    counting overlapping activities on several streams once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def kernel_ms(fn, name: str, reps: int, per_call: bool = False
              ) -> float | None:
    """Mean device milliseconds per launch (``per_call``: per call of
    ``fn``, summing its launches) of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn`` after one warm-up, from the profiler's
    kernel times, without the host's call cost between them; None when the
    profiler recorded no such kernel in any of ``_PROFILE_ATTEMPTS``
    sessions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(_PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / (reps if per_call else len(us)) / 1e3
    return None
