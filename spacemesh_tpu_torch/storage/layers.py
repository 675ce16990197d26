"""Per-layer bookkeeping (port of ``spacemesh_tpu/storage/layers.py``;
reference sql/layers)."""

from __future__ import annotations

from .db import Database


def set_processed(db: Database, layer: int) -> None:
    db.exec("INSERT INTO layers (id, processed) VALUES (?,1)"
            " ON CONFLICT(id) DO UPDATE SET processed=1", (layer,))


def processed(db: Database) -> int:
    row = db.one("SELECT MAX(id) m FROM layers WHERE processed=1")
    return row["m"] if row and row["m"] is not None else -1


def set_applied(db: Database, layer: int, block_id: bytes,
                state_hash: bytes) -> None:
    db.exec(
        "INSERT INTO layers (id, applied_block, state_hash) VALUES (?,?,?)"
        " ON CONFLICT(id) DO UPDATE SET applied_block=excluded.applied_block,"
        " state_hash=excluded.state_hash", (layer, block_id, state_hash))


def applied_block(db: Database, layer: int) -> bytes | None:
    row = db.one("SELECT applied_block FROM layers WHERE id=?", (layer,))
    return row["applied_block"] if row else None


def state_hash(db: Database, layer: int) -> bytes | None:
    row = db.one("SELECT state_hash FROM layers WHERE id=?", (layer,))
    return row["state_hash"] if row else None


def last_applied(db: Database) -> int:
    row = db.one("SELECT MAX(id) m FROM layers WHERE applied_block IS NOT NULL")
    return row["m"] if row and row["m"] is not None else -1


def set_aggregated_hash(db: Database, layer: int, h: bytes) -> None:
    db.exec(
        "INSERT INTO layers (id, aggregated_hash) VALUES (?,?)"
        " ON CONFLICT(id) DO UPDATE SET aggregated_hash=excluded.aggregated_hash",
        (layer, h))


def aggregated_hash(db: Database, layer: int) -> bytes | None:
    row = db.one("SELECT aggregated_hash FROM layers WHERE id=?", (layer,))
    return row["aggregated_hash"] if row else None
