"""scrypt ROMix (r=1): the CUDA kernel on the card, its plain twin on the CPU.

Replaces ``spacemesh_tpu/ops/romix_pallas.py::_romix_kernel`` (the
``pallas_call`` at :185), which ``ops/scrypt.py`` reached through
``_romix_dispatch``. The kernel is ``csrc/romix.cu``: four threads per
lane, each holding one Salsa column of both halves of the block in
registers, and a per-lane scratch ``V[lane][i]`` of 128-byte rows that
this wrapper allocates.

What bounds it on an H100: about 13.9 M integer instructions per lane at
N=8192 (16384 BlockMix of 832 add/rotate/xor each, plus the mix xors,
:func:`int_ops`) against 256 bytes of input and output per lane
(:func:`io_bytes`); at 132 SMs x 128 lanes per clock that is 13.6 ms per
32768 lanes. The V scratch traffic is tighter still: each 128-byte row is
written once and read back once, N*256 bytes per lane (2 MiB at N=8192,
:func:`scratch_bytes`), 68.7 GB or about 20.5 ms at 3.35 TB/s per 32768
lanes. Only a time-memory tradeoff (storing some rows and recomputing the
rest) goes below that floor. V is N*128 bytes per lane (1 MiB at N=8192),
which caps the lanes in flight and so the warps that can hide the latency
of the mix phase's dependent random reads. The lanes of one launch are
capped to what fits the card's free memory, and a larger batch runs as
several launches over lane chunks.

:func:`scratch` allocates V for one batch (the caller may take it ahead of
the launches, as ``ops/scrypt.py`` does inside its ``romix.scratch``
span); :func:`romix` takes the kernel for a CUDA tensor and
:func:`romix_r1`, the plain PyTorch version, only for a CPU tensor; a
kernel that fails to build or launch raises. ``launches`` counts kernel
launches; on the card each call's enqueue (the output's allocation, every
chunk's launch and its error check) runs inside a ``romix.launch`` span.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import _build
from .salsa import blockmix_r1
from .u32 import DTYPE

launches = 0

# free memory a launch leaves untouched (allocator slack, other tensors)
_HEADROOM = 0.9


def check_n(n: int) -> None:
    # RFC 7914: for r=1, N must be a power of two and < 2^(128*r/8) = 2^16
    if n < 2 or n >= 2**16 or (n & (n - 1)) != 0:
        raise ValueError(f"scrypt n must be a power of 2 in [2, 2^16), got {n}")


def int_ops(lanes: int, n: int) -> int:
    """Integer instructions ROMix needs: 2n BlockMix of 2 x (8 rounds of
    16 add/rotate/xor triples + 16 final adds) + 16 xors, plus 32 xors per
    mix step."""
    blockmix = 2 * (8 * 16 * 3 + 16) + 2 * 16
    return lanes * (2 * n * blockmix + n * 32)


def io_bytes(lanes: int) -> int:
    """Bytes ROMix must move: each lane's 32 input and 32 output words."""
    return lanes * 2 * 32 * 4


def scratch_bytes(lanes: int, n: int) -> int:
    """Bytes of V scratch traffic: each lane writes n rows of 128 bytes in
    the fill phase and reads n of them back in the mix phase."""
    return lanes * n * 2 * 32 * 4


def romix_r1(x: torch.Tensor, n: int, *, mix_phase: bool = True
             ) -> torch.Tensor:
    """Plain ROMix over a (32, B) int32 block batch, word-major V (n, 32, B)
    as ``spacemesh_tpu/ops/scrypt.py::romix_r1``. ``mix_phase=False``
    stops after the fill phase (the fill/mix time split)."""
    b = x.shape[1]
    v = torch.empty((n, 32, b), dtype=x.dtype, device=x.device)
    for i in range(n):
        v[i] = x
        x = blockmix_r1(x)
    if not mix_phase:
        return x
    for _ in range(n):
        j = (x[16] & (n - 1)).long()
        vj = torch.gather(v, 0, j.view(1, 1, b).expand(1, 32, b))[0]
        x = blockmix_r1(x ^ vj)
    return x


def lanes_that_fit(n: int, device: torch.device) -> int:
    """Lanes whose V fits the card's free memory now (the default cap)."""
    free, _ = torch.cuda.mem_get_info(device)
    # the allocator's cached bytes, from one read of its raw statistics:
    # memory_reserved() and memory_allocated() each flatten all of them,
    # about a millisecond of host time apiece on every init batch
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    free += (stats["reserved_bytes"]["all"]["current"]
             - stats["allocated_bytes"]["all"]["current"])
    return max(int(free * _HEADROOM) // (n * 128), 1)


def _lib():
    lib = _build.load("romix")
    fn = lib.romix_r1_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return fn


def scratch(n: int, lanes: int, device: torch.device,
            max_lanes: int | None = None) -> torch.Tensor | None:
    """V for a batch of ``lanes`` on the card: (per, n, 32) int32, ``per``
    the lanes of one launch, at most ``max_lanes`` (default: what fits the
    free memory). None on the CPU, whose plain twin makes its own, and for
    an empty batch."""
    if device.type != "cuda" or lanes == 0:
        return None
    per = min(lanes, max_lanes if max_lanes is not None
              else lanes_that_fit(n, device))
    if per < 1:
        raise ValueError("max_lanes must be positive")
    return torch.empty((per, n, 32), dtype=DTYPE, device=device)


def romix(x: torch.Tensor, n: int, *, max_lanes: int | None = None,
          mix_phase: bool = True, v: torch.Tensor | None = None
          ) -> torch.Tensor:
    """ROMix over a (32, B) int32 block batch; returns (32, B).

    On a CUDA tensor this launches ``csrc/romix.cu`` over chunks of at most
    ``max_lanes`` lanes (default: what fits the free memory), in the
    scratch ``v`` when given (from :func:`scratch`; its lanes are the
    chunk); on a CPU tensor it runs :func:`romix_r1`, over the same chunks
    when ``max_lanes`` is given. ``mix_phase=False`` stops after the
    fill phase."""
    global launches
    check_n(n)
    # each tensor attribute read once: on the card every read is a
    # host-side torch call per batch
    shape, dev = x.shape, x.device
    if len(shape) != 2 or shape[0] != 32 or x.dtype != DTYPE:
        raise ValueError(f"romix wants a (32, B) int32 tensor, got "
                         f"{tuple(shape)} {x.dtype}")
    if dev.type == "cpu":
        b = shape[1]
        if max_lanes is None or max_lanes >= b:
            return romix_r1(x, n, mix_phase=mix_phase)
        if max_lanes < 1:
            raise ValueError("max_lanes must be positive")
        return torch.cat([romix_r1(x[:, c0:c0 + max_lanes], n,
                                   mix_phase=mix_phase)
                          for c0 in range(0, b, max_lanes)], dim=1)
    if dev.type != "cuda":
        raise ValueError(f"romix: unsupported device {dev}")
    with tracing.span("romix.launch"):
        x = x.contiguous()
        b = shape[1]
        out = torch.empty_like(x)
        if b == 0:
            return out
        fn = _lib()
        if v is None:
            v = scratch(n, b, dev, max_lanes)
        per = v.shape[0]
        xp, op, vp = x.data_ptr(), out.data_ptr(), v.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for c0 in range(0, b, per):
                lanes = min(per, b - c0)
                err = fn(xp + 4 * c0, op + 4 * c0, vp, b, lanes, n,
                         int(mix_phase), stream)
                with _build.count_lock:
                    launches += 1
                _build.check(err, "romix_r1_launch")
        return out
