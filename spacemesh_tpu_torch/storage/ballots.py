"""Ballot queries (port of ``spacemesh_tpu/storage/ballots.py``;
reference sql/ballots)."""

from __future__ import annotations

from ..core.types import Ballot
from .db import Database


def add(db: Database, ballot: Ballot) -> None:
    db.exec(
        "INSERT OR IGNORE INTO ballots (id, layer, atx_id, node_id, data)"
        " VALUES (?,?,?,?,?)",
        (ballot.id, ballot.layer, ballot.atx_id, ballot.node_id,
         ballot.to_bytes()))


def get(db: Database, ballot_id: bytes) -> Ballot | None:
    row = db.one("SELECT data FROM ballots WHERE id=?", (ballot_id,))
    return Ballot.from_bytes(row["data"]) if row else None


def resolve_epoch_data(db: Database, ballot: Ballot,
                       layers_per_epoch: int | None = None):
    """The ballot's own EpochData, else its ref ballot's — accepted only
    from the same owner AND the same ATX (reference
    eligibility_validator.go validateSecondary: a ballot must share its
    atx with its reference ballot; it must not inherit another
    identity's epoch declaration either), and — when the caller passes
    ``layers_per_epoch`` — only from a ref ballot in the SAME epoch.
    The reference rejects a cross-epoch ref explicitly; relying on an
    ATX id resolving for a single target epoch covers this only
    incidentally. ONE definition shared by live ingest
    (miner.ingest_ballot) and restart recovery (Tortoise.recover): the
    two paths must derive identical beacons and eligibility counts, or
    a restart changes ballot weights and bad-beacon flags."""
    if ballot.epoch_data is not None:
        return ballot.epoch_data
    ref = get(db, ballot.ref_ballot)
    if ref is not None and ref.epoch_data is not None \
            and ref.node_id == ballot.node_id \
            and ref.atx_id == ballot.atx_id \
            and (layers_per_epoch is None
                 or ref.layer // layers_per_epoch
                 == ballot.layer // layers_per_epoch):
        return ref.epoch_data
    return None


def has(db: Database, ballot_id: bytes) -> bool:
    return db.one("SELECT 1 FROM ballots WHERE id=?", (ballot_id,)) is not None


def in_layer(db: Database, layer: int) -> list[Ballot]:
    return [Ballot.from_bytes(r["data"]) for r in
            db.all("SELECT data FROM ballots WHERE layer=?", (layer,))]


def ids_in_layer(db: Database, layer: int) -> list[bytes]:
    return [r["id"] for r in
            db.all("SELECT id FROM ballots WHERE layer=?", (layer,))]


def by_node_in_layer(db: Database, node_id: bytes, layer: int) -> list[Ballot]:
    return [Ballot.from_bytes(r["data"]) for r in
            db.all("SELECT data FROM ballots WHERE node_id=? AND layer=?",
                   (node_id, layer))]


def refballot(db: Database, node_id: bytes, epoch_start: int, epoch_end: int
              ) -> Ballot | None:
    """First ballot of the node within [epoch_start, epoch_end) that carries
    epoch data (the epoch's reference ballot)."""
    for r in db.all(
            "SELECT data FROM ballots WHERE node_id=? AND layer>=? AND layer<?"
            " ORDER BY layer", (node_id, epoch_start, epoch_end)):
        b = Ballot.from_bytes(r["data"])
        if b.epoch_data is not None:
            return b
    return None


def refballot_by_atx(db: Database, atx_id: bytes, epoch_start: int,
                     epoch_end: int) -> Ballot | None:
    """First epoch-data ballot built on ``atx_id`` in the epoch (reference
    sql/ballots FirstInEpoch, keyed by ATX for active-set recovery)."""
    for r in db.all(
            "SELECT data FROM ballots WHERE atx_id=? AND layer>=? AND layer<?"
            " ORDER BY layer", (atx_id, epoch_start, epoch_end)):
        b = Ballot.from_bytes(r["data"])
        if b.epoch_data is not None:
            return b
    return None
