"""Block queries (port of ``spacemesh_tpu/storage/blocks.py``; reference
sql/blocks)."""

from __future__ import annotations

from ..core.types import Block
from .db import Database

UNDECIDED, VALID, INVALID = 0, 1, -1


def add(db: Database, block: Block) -> None:
    db.exec("INSERT OR IGNORE INTO blocks (id, layer, data) VALUES (?,?,?)",
            (block.id, block.layer, block.to_bytes()))


def get(db: Database, block_id: bytes) -> Block | None:
    row = db.one("SELECT data FROM blocks WHERE id=?", (block_id,))
    return Block.from_bytes(row["data"]) if row else None


def has(db: Database, block_id: bytes) -> bool:
    return db.one("SELECT 1 FROM blocks WHERE id=?", (block_id,)) is not None


def in_layer(db: Database, layer: int) -> list[Block]:
    return [Block.from_bytes(r["data"]) for r in
            db.all("SELECT data FROM blocks WHERE layer=?", (layer,))]


def ids_in_layer(db: Database, layer: int) -> list[bytes]:
    return [r["id"] for r in
            db.all("SELECT id FROM blocks WHERE layer=? ORDER BY id", (layer,))]


def set_valid(db: Database, block_id: bytes) -> None:
    db.exec("UPDATE blocks SET validity=? WHERE id=?", (VALID, block_id))


def set_invalid(db: Database, block_id: bytes) -> None:
    db.exec("UPDATE blocks SET validity=? WHERE id=?", (INVALID, block_id))


def validity(db: Database, block_id: bytes) -> int | None:
    row = db.one("SELECT validity FROM blocks WHERE id=?", (block_id,))
    return row["validity"] if row else None


def contextually_valid(db: Database, layer: int) -> list[bytes]:
    return [r["id"] for r in
            db.all("SELECT id FROM blocks WHERE layer=? AND validity=?"
                   " ORDER BY id", (layer, VALID))]
