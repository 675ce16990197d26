"""ATX queries (port of ``spacemesh_tpu/storage/atxs.py``; reference
sql/atxs). V2 (merged) ATXs store the shared
envelope blob once per covered identity under per-identity synthetic ids;
readers return a uniform per-identity `AtxView`."""

from __future__ import annotations

import dataclasses

from ..core.types import EMPTY32, ActivationTx, ActivationTxV2
from .db import Database


@dataclasses.dataclass
class AtxView:
    """Per-identity view over a v1 or v2 ATX row — the fields every
    consumer (cache warmup, builder chaining, double-publish checks)
    needs, version-independent."""

    id: bytes
    node_id: bytes
    publish_epoch: int
    prev_atx: bytes
    num_units: int
    vrf_nonce: int
    vrf_public_key: bytes
    version: int

    def target_epoch(self) -> int:
        return self.publish_epoch + 1


def _view(row) -> AtxView | None:
    version = row["version"] if "version" in row.keys() else 1
    if version == 1:
        atx = ActivationTx.from_bytes(row["data"])
        return AtxView(id=atx.id, node_id=atx.node_id,
                       publish_epoch=atx.publish_epoch,
                       prev_atx=atx.prev_atx, num_units=atx.num_units,
                       vrf_nonce=atx.vrf_nonce,
                       vrf_public_key=atx.vrf_public_key, version=1)
    atx2 = ActivationTxV2.from_bytes(row["data"])
    for sp in atx2.subposts:
        if sp.node_id == row["node_id"]:
            return AtxView(id=atx2.identity_atx_id(sp.node_id),
                           node_id=sp.node_id,
                           publish_epoch=atx2.publish_epoch,
                           prev_atx=sp.prev_atx, num_units=sp.num_units,
                           vrf_nonce=sp.vrf_nonce,
                           vrf_public_key=sp.node_id, version=2)
    return None


def add(db: Database, atx: ActivationTx, *, tick_height: int = 0,
        received: int = 0) -> None:
    db.exec(
        "INSERT OR IGNORE INTO atxs (id, node_id, publish_epoch, num_units,"
        " tick_height, vrf_nonce, coinbase, received, data, version)"
        " VALUES (?,?,?,?,?,?,?,?,?,1)",
        (atx.id, atx.node_id, atx.publish_epoch, atx.num_units, tick_height,
         atx.vrf_nonce, atx.coinbase, received, atx.to_bytes()))


def add_v2(db: Database, atx2: ActivationTxV2, *, tick_heights: dict,
           received: int = 0) -> None:
    """One row per covered identity, all sharing the envelope blob."""
    blob = atx2.to_bytes()
    for sp in atx2.subposts:
        db.exec(
            "INSERT OR IGNORE INTO atxs (id, node_id, publish_epoch,"
            " num_units, tick_height, vrf_nonce, coinbase, received, data,"
            " version) VALUES (?,?,?,?,?,?,?,?,?,2)",
            (atx2.identity_atx_id(sp.node_id), sp.node_id,
             atx2.publish_epoch, sp.num_units,
             tick_heights.get(sp.node_id, 0), sp.vrf_nonce, atx2.coinbase,
             received, blob))


def get(db: Database, atx_id: bytes) -> ActivationTx | None:
    row = db.one("SELECT data FROM atxs WHERE id=? AND version=1",
                 (atx_id,))
    return ActivationTx.from_bytes(row["data"]) if row else None


def get_blob(db: Database, atx_id: bytes) -> bytes | None:
    """Raw wire blob under the id (v1 ATX bytes or v2 envelope)."""
    row = db.one("SELECT data FROM atxs WHERE id=?", (atx_id,))
    return row["data"] if row else None


def view(db: Database, atx_id: bytes) -> AtxView | None:
    row = db.one("SELECT node_id, data, version FROM atxs WHERE id=?",
                 (atx_id,))
    return _view(row) if row else None


def has(db: Database, atx_id: bytes) -> bool:
    return db.one("SELECT 1 FROM atxs WHERE id=?", (atx_id,)) is not None


def list_rows(db: Database, *, limit: int, offset: int = 0,
              epoch: int | None = None, smesher: bytes | None = None,
              coinbase: bytes | None = None) -> list:
    """Paginated ATX listing (reference v2alpha1 ActivationService.List:
    sql builder ops over epoch/smesher/coinbase, LIMIT capped by the
    service)."""
    where, args = [], []
    if epoch is not None:
        where.append("publish_epoch=?")
        args.append(epoch)
    if smesher is not None:
        where.append("node_id=?")
        args.append(smesher)
    if coinbase is not None:
        where.append("coinbase=?")
        args.append(coinbase)
    clause = (" WHERE " + " AND ".join(where)) if where else ""
    return db.all(
        f"SELECT * FROM atxs{clause} ORDER BY publish_epoch, id"
        " LIMIT ? OFFSET ?", (*args, limit, offset))


def count(db: Database, *, epoch: int | None = None) -> int:
    if epoch is None:
        row = db.one("SELECT COUNT(*) AS n FROM atxs", ())
    else:
        row = db.one("SELECT COUNT(*) AS n FROM atxs WHERE publish_epoch=?",
                     (epoch,))
    return row["n"] if row else 0


def tick_height(db: Database, atx_id: bytes) -> int | None:
    row = db.one("SELECT tick_height FROM atxs WHERE id=?", (atx_id,))
    return row["tick_height"] if row else None


def by_node_in_epoch(db: Database, node_id: bytes, epoch: int
                     ) -> AtxView | None:
    row = db.one(
        "SELECT node_id, data, version FROM atxs WHERE node_id=?"
        " AND publish_epoch=?", (node_id, epoch))
    return _view(row) if row else None


def latest_by_node(db: Database, node_id: bytes) -> AtxView | None:
    row = db.one(
        "SELECT node_id, data, version FROM atxs WHERE node_id=?"
        " ORDER BY publish_epoch DESC LIMIT 1", (node_id,))
    return _view(row) if row else None


def ids_in_epoch(db: Database, epoch: int) -> list[bytes]:
    return [r["id"] for r in
            db.all("SELECT id FROM atxs WHERE publish_epoch=?", (epoch,))]


def all_in_epoch(db: Database, epoch: int) -> list[AtxView]:
    return [v for r in
            db.all("SELECT node_id, data, version FROM atxs"
                   " WHERE publish_epoch=?", (epoch,))
            if (v := _view(r)) is not None]


def all_rows(db: Database):
    """(id, tick_height, prev tick lookup support) for cache warmup."""
    return db.all("SELECT id, node_id, publish_epoch, num_units,"
                  " tick_height, data, version FROM atxs"
                  " ORDER BY publish_epoch")


def count_in_epoch(db: Database, epoch: int) -> int:
    return db.one("SELECT COUNT(*) c FROM atxs WHERE publish_epoch=?",
                  (epoch,))["c"]


def coinbase_of(db: Database, atx_id: bytes) -> bytes | None:
    """Reward coinbase for any ATX version (the column is populated for
    both v1 rows and v2 per-identity rows)."""
    row = db.one("SELECT coinbase FROM atxs WHERE id=?", (atx_id,))
    return row["coinbase"] if row else None


def rows_for_grading(db: Database, publish_epoch: int):
    """(id, received, proof_received) for ATXs published in the epoch,
    joined with any malfeasance-proof receipt time (reference sql/atxs
    IterateForGrading)."""
    return db.all(
        "SELECT a.id id, a.received received,"
        " (SELECT i.received FROM identities i"
        "   WHERE i.node_id=a.node_id AND i.proof IS NOT NULL)"
        " proof_received"
        " FROM atxs a WHERE a.publish_epoch=?", (publish_epoch,))
