"""Small per-entity query modules bundled (port of
``spacemesh_tpu/storage/misc.py``): beacons, certificates,
identities (malfeasance), rewards, poet proofs, active sets
(reference sql/beacons, sql/certificates, sql/identities, sql/rewards,
sql/poets, sql/activesets)."""

from __future__ import annotations

from ..core.types import Certificate, MalfeasanceProof, PoetProof
from .db import Database


# --- beacons ---------------------------------------------------------------


BEACON_PROTOCOL = 0  # decided by running the beacon protocol (final)
BEACON_FALLBACK = 1  # adopted from sync/bootstrap/checkpoint (supersedable)
BEACON_GUESS = 2     # OUR OWN timeout-guess (an early get() fell back to
                     # the local bootstrap derivation before the protocol
                     # ran) — supersedable by anything, and the ONLY
                     # source run_epoch may overwrite by running the
                     # protocol: a network-adopted FALLBACK value can be
                     # bit-identical to the local derivation, so
                     # provenance must be recorded, not inferred


def set_beacon(db: Database, epoch: int, beacon: bytes,
               source: int = BEACON_PROTOCOL) -> None:
    db.exec(
        "INSERT OR REPLACE INTO beacons (epoch, beacon, source) VALUES (?,?,?)",
        (epoch, beacon, source))


def get_beacon(db: Database, epoch: int) -> bytes | None:
    row = db.one("SELECT beacon FROM beacons WHERE epoch=?", (epoch,))
    return row["beacon"] if row else None


def beacon_source(db: Database, epoch: int) -> int | None:
    row = db.one("SELECT source FROM beacons WHERE epoch=?", (epoch,))
    return row["source"] if row else None


# --- migration marks -------------------------------------------------------


def migration_boundary(db: Database) -> int:
    """Highest layer whose signed artifacts (ballot vote lists, hare
    certificates) predate the 0004 block-id rewrite; -1 when the database
    never held legacy-format blocks. Tortoise.recover replays ballots only
    strictly after this layer (their support votes name pre-rewrite ids
    that no longer resolve; persisted per-block validity covers the rest).
    """
    import sqlite3
    try:
        row = db.one("SELECT value FROM migration_marks"
                     " WHERE key='block_id_rewrite_boundary'")
    except sqlite3.OperationalError:
        return -1  # db migrated before the mark table existed
    return row["value"] if row else -1


# --- certificates ----------------------------------------------------------


def add_certificate(db: Database, layer: int, cert: Certificate) -> None:
    db.exec(
        "INSERT OR REPLACE INTO certificates (layer, block_id, cert, valid)"
        " VALUES (?,?,?,1)", (layer, cert.block_id, cert.to_bytes()))


def certificate(db: Database, layer: int) -> Certificate | None:
    row = db.one(
        "SELECT cert FROM certificates WHERE layer=? AND valid=1", (layer,))
    return Certificate.from_bytes(row["cert"]) if row and row["cert"] else None


def certified_block(db: Database, layer: int) -> bytes | None:
    row = db.one(
        "SELECT block_id FROM certificates WHERE layer=? AND valid=1", (layer,))
    return row["block_id"] if row else None


# --- identities (malfeasance) ---------------------------------------------


def set_malicious(db: Database, node_id: bytes, proof: MalfeasanceProof,
                  received: int = 0) -> None:
    # identities rows also carry marriages: upsert, first proof wins
    db.exec(
        "INSERT INTO identities (node_id, proof, received) VALUES (?,?,?)"
        " ON CONFLICT(node_id) DO UPDATE SET"
        " proof=COALESCE(identities.proof, excluded.proof)",
        (node_id, proof.to_bytes(), received))


def is_malicious(db: Database, node_id: bytes) -> bool:
    row = db.one("SELECT proof FROM identities WHERE node_id=?", (node_id,))
    return row is not None and row["proof"] is not None


def malfeasance_proof(db: Database, node_id: bytes) -> MalfeasanceProof | None:
    row = db.one("SELECT proof FROM identities WHERE node_id=?", (node_id,))
    return MalfeasanceProof.from_bytes(row["proof"]) if row and row["proof"] else None


def all_malicious(db: Database) -> list[bytes]:
    return [r["node_id"] for r in
            db.all("SELECT node_id FROM identities WHERE proof IS NOT NULL")]


# --- marriages (equivocation sets; reference sql/marriage) -----------------


def set_marriage(db: Database, node_id: bytes, marriage_atx: bytes) -> None:
    db.exec(
        "INSERT INTO identities (node_id, marriage_atx) VALUES (?,?)"
        " ON CONFLICT(node_id) DO UPDATE SET"
        " marriage_atx=COALESCE(identities.marriage_atx,"
        " excluded.marriage_atx)", (node_id, marriage_atx))


def marriage_of(db: Database, node_id: bytes) -> bytes | None:
    row = db.one("SELECT marriage_atx FROM identities WHERE node_id=?",
                 (node_id,))
    return row["marriage_atx"] if row else None


def married_set(db: Database, marriage_atx: bytes) -> list[bytes]:
    return [r["node_id"] for r in
            db.all("SELECT node_id FROM identities WHERE marriage_atx=?",
                   (marriage_atx,))]


# --- rewards ---------------------------------------------------------------


def add_reward(db: Database, coinbase: bytes, layer: int, total: int,
               layer_reward: int) -> None:
    db.exec(
        "INSERT OR REPLACE INTO rewards (coinbase, layer, total_reward,"
        " layer_reward) VALUES (?,?,?,?)", (coinbase, layer, total, layer_reward))


def rewards_for(db: Database, coinbase: bytes) -> list[tuple[int, int]]:
    return [(r["layer"], r["total_reward"]) for r in
            db.all("SELECT layer, total_reward FROM rewards WHERE coinbase=?"
                   " ORDER BY layer", (coinbase,))]


def list_rewards(db: Database, *, limit: int, offset: int = 0,
                 coinbase: bytes | None = None,
                 start_layer: int = 0) -> list:
    """Paginated reward listing (reference v2alpha1 RewardService.List)."""
    where, args = ["layer >= ?"], [start_layer]
    if coinbase is not None:
        where.append("coinbase=?")
        args.append(coinbase)
    return db.all(
        "SELECT coinbase, layer, total_reward, layer_reward FROM rewards"
        f" WHERE {' AND '.join(where)} ORDER BY layer, coinbase"
        " LIMIT ? OFFSET ?", (*args, limit, offset))


# --- poet proofs -----------------------------------------------------------


def add_poet_proof(db: Database, proof: PoetProof) -> None:
    db.exec(
        "INSERT OR IGNORE INTO poet_proofs (ref, poet_id, round_id, ticks,"
        " data) VALUES (?,?,?,?,?)",
        (proof.id, proof.poet_id, proof.round_id, proof.ticks,
         proof.to_bytes()))


def poet_proof(db: Database, ref: bytes) -> PoetProof | None:
    row = db.one("SELECT data FROM poet_proofs WHERE ref=?", (ref,))
    return PoetProof.from_bytes(row["data"]) if row else None


def poet_proof_for_round(db: Database, poet_id: bytes, round_id: str
                         ) -> PoetProof | None:
    row = db.one(
        "SELECT data FROM poet_proofs WHERE poet_id=? AND round_id=?",
        (poet_id, round_id))
    return PoetProof.from_bytes(row["data"]) if row else None


# --- active sets -----------------------------------------------------------


def add_active_set(db: Database, set_id: bytes, epoch: int,
                   atx_ids: list[bytes]) -> None:
    db.exec("INSERT OR IGNORE INTO active_sets (id, epoch, data) VALUES (?,?,?)",
            (set_id, epoch, b"".join(atx_ids)))


def active_set(db: Database, set_id: bytes) -> list[bytes] | None:
    row = db.one("SELECT data FROM active_sets WHERE id=?", (set_id,))
    if row is None:
        return None
    data = row["data"]
    return [data[i:i + 32] for i in range(0, len(data), 32)]
