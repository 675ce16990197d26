"""Salsa20/8 core and scrypt BlockMix (r=1), plain PyTorch.

Copied from ``spacemesh_tpu/ops/scrypt.py`` (``salsa20_8``,
``blockmix_r1``) onto int32 bit patterns (``ops/u32.py``). The 4x4 state is
regrouped into four diagonal vectors of shape (4, B), so each of the 32
quarter-round steps of Salsa20/8 is one vector op over four quarters: the
fewest torch ops per call, which is what an eager framework pays for. This
is the plain version the CUDA kernels are held against
(``ops/romix_cuda.py``; ``ops/proving_cuda.py``, the scan and the proving
hash) and runs only on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .u32 import rotl

_DIAG = np.array([[0, 5, 10, 15],
                  [4, 9, 14, 3],
                  [8, 13, 2, 7],
                  [12, 1, 6, 11]])
_UNDIAG = np.argsort(_DIAG.ravel())


def salsa20_8(block: torch.Tensor) -> torch.Tensor:
    """Salsa20/8 core. ``block``: (16, B) int32 LE words (lanes trailing)."""
    a, b, c, d = (block[list(_DIAG[q])] for q in range(4))
    for _ in range(4):  # 4 double-rounds = 8 rounds
        b = b ^ rotl(a + d, 7)
        c = c ^ rotl(b + a, 9)
        d = d ^ rotl(c + b, 13)
        a = a ^ rotl(d + c, 18)
        b = torch.roll(b, 1, 0)
        c = torch.roll(c, 2, 0)
        d = torch.roll(d, 3, 0)
        d = d ^ rotl(a + b, 7)
        c = c ^ rotl(d + a, 9)
        b = b ^ rotl(c + d, 13)
        a = a ^ rotl(b + c, 18)
        b = torch.roll(b, -1, 0)
        c = torch.roll(c, -2, 0)
        d = torch.roll(d, -3, 0)
    return torch.cat([a, b, c, d])[list(_UNDIAG)] + block


def blockmix_r1(x: torch.Tensor) -> torch.Tensor:
    """scrypt BlockMix for r=1: ``x`` is (32, B) int32 LE, two halves."""
    y0 = salsa20_8(x[0:16] ^ x[16:32])
    y1 = salsa20_8(x[16:32] ^ y0)
    return torch.cat([y0, y1])
