"""The VRF nonce that init leaves in the metadata: the index of the
numerically smallest label, its 16 bytes read as a little-endian integer,
the lowest index on a tie."""

from __future__ import annotations

import numpy as np


def smallest(labels: np.ndarray) -> tuple[int, bytes] | None:
    """(index, label bytes) of the smallest of ``labels``, a (count, 16)
    uint8 array from index 0; None when it is empty."""
    if labels.shape[0] == 0:
        return None
    words = np.ascontiguousarray(labels).view("<u8")  # (count, 2): lo, hi
    hi = words[:, 1]
    cand = np.flatnonzero(hi == hi.min())
    best = int(cand[np.argmin(words[cand, 0])])  # argmin: the first on a tie
    return best, labels[best].tobytes()
