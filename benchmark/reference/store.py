"""Reads labels back from a PoST data directory.

The layout is the PoST data format: ``postdata_<k>.bin`` files of
``max_file_size`` bytes each, holding consecutive 16-byte labels from
index 0. A label past the end of what was written reads as missing.
Beside them, ``postdata_metadata.json`` holds the durable count of labels
and the VRF nonce.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .labels import LABEL_BYTES


def read_labels(data_dir, indices, max_file_size: int) -> list[bytes | None]:
    """The stored label at each of ``indices`` (None where absent)."""
    per_file = max_file_size // LABEL_BYTES
    out: list[bytes | None] = []
    handles: dict[int, object] = {}
    try:
        for i in indices:
            k, off = divmod(int(i), per_file)
            if k not in handles:
                path = Path(data_dir) / f"postdata_{k}.bin"
                handles[k] = open(path, "rb") if path.exists() else None
            f = handles[k]
            if f is None:
                out.append(None)
                continue
            f.seek(off * LABEL_BYTES)
            data = f.read(LABEL_BYTES)
            out.append(data if len(data) == LABEL_BYTES else None)
    finally:
        for f in handles.values():
            if f is not None:
                f.close()
    return out


def read_range(data_dir, count: int, max_file_size: int) -> np.ndarray:
    """Labels ``[0, count)`` as a (count, 16) uint8 array; raises when the
    store holds fewer."""
    per_file = max_file_size // LABEL_BYTES
    parts = []
    for k in range(-(-count // per_file)):
        want = min(per_file, count - k * per_file)
        data = (Path(data_dir) / f"postdata_{k}.bin").read_bytes()
        if len(data) < want * LABEL_BYTES:
            raise ValueError(f"{data_dir}: file {k} holds "
                             f"{len(data) // LABEL_BYTES} labels, "
                             f"{want} wanted")
        parts.append(np.frombuffer(data[:want * LABEL_BYTES], np.uint8))
    return np.concatenate(parts).reshape(count, LABEL_BYTES)


def read_metadata(data_dir) -> dict | None:
    """The store's metadata as its JSON file holds it, or None."""
    path = Path(data_dir) / "postdata_metadata.json"
    if not path.exists():
        return None
    return json.loads(path.read_text(encoding="utf-8"))
