"""The yardstick for roofline shares: the card's peaks and the work a label
needs.

Peaks, per card name as ``torch.cuda.get_device_name()`` gives it:

* ``hbm_bytes_per_s``: NVIDIA's published HBM3 rate of the H100 SXM5.
* ``int_ops_per_s``: an integer issue-rate ceiling, SMs x 128 lanes x the
  maximum SM clock: four schedulers per SM each start one 32-lane warp
  instruction a clock, and integer adds also issue on the FMA pipe
  (IMAD), so the 64 INT32 lanes per SM are not the limit. 132 SMs and
  1980 MHz are the H100 SXM5's published SM count and maximum boost clock
  (``nvidia-smi --query-gpu=clocks.max.sm`` reads 1980 on it). It assumes
  the card's full power limit; a card set lower runs slower under load.

A card not in the table gets no roofline share: the readers return
nothing rather than a share against a guessed peak.

Work per label, scrypt with r=1 and p=1, counted as the algorithm needs
it, not as a kernel happens to spend it:

* ROMix: 2N BlockMix, each two Salsa20/8 (8 rounds of 16 add, rotate and
  xor triples, then 16 feed-forward adds) and 16 xors feeding each; plus
  32 xors per step of the second loop.
* PBKDF2-HMAC-SHA256: 8 compressions to expand (4 blocks x inner, outer)
  and 4 to finish (3 inner blocks, outer), 1310 integer instructions
  each (1384 counted by hand with LOP3 and IADD3, fewer where message
  words are constant padding). The HMAC key's two midstates are once per
  identity and left out.
* Bytes: the 32-byte commitment and the 8-byte index in, the 16-byte
  label out. V, the ROMix scratch, is neither input nor output and is not
  counted: a time-memory trade-off on V would otherwise read above 100%.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"sms": 132, "max_sm_mhz": 1980.0,
                              "hbm_bytes_per_s": 3.35e12},
}
LANES_PER_SM_CLK = 128
SHA256_COMPRESS_OPS = 1310
PBKDF2_COMPRESSIONS = 8 + 4
LABEL_IO_BYTES = 32 + 8 + 16


def int_ops_per_s(kind: str) -> float | None:
    p = PEAKS.get(kind)
    if p is None:
        return None
    return p["sms"] * LANES_PER_SM_CLK * p["max_sm_mhz"] * 1e6


def romix_ops(n: int) -> int:
    blockmix = 2 * (8 * 16 * 3 + 16) + 2 * 16
    return 2 * n * blockmix + n * 32


def label_ops(n: int) -> int:
    return romix_ops(n) + PBKDF2_COMPRESSIONS * SHA256_COMPRESS_OPS


def label_least_s(labels: int, n: int, kind: str) -> float | None:
    """The least time ``labels`` labels could take on a ``kind`` card: the
    larger of the operations' and the bytes' bound; None off the table."""
    ops = int_ops_per_s(kind)
    if ops is None:
        return None
    return max(labels * label_ops(n) / ops,
               labels * LABEL_IO_BYTES / PEAKS[kind]["hbm_bytes_per_s"])
