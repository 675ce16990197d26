"""Labels: scrypt over the commitment with the little-endian index as salt.

``hashlib.scrypt`` releases the interpreter lock while it hashes, so a few
threads check a sample in parallel.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

LABEL_BYTES = 16


def label(commitment: bytes, index: int, n: int) -> bytes:
    """The 16-byte label at ``index`` for scrypt parameter ``n`` (r=1, p=1)."""
    return hashlib.scrypt(commitment, salt=int(index).to_bytes(8, "little"),
                          n=n, r=1, p=1, dklen=LABEL_BYTES)


def labels(commitment: bytes, indices, n: int,
           threads: int | None = None) -> list[bytes]:
    """:func:`label` at each of ``indices``, in order."""
    threads = threads or min(os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda i: label(commitment, i, n), indices))
