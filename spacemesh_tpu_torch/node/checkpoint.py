"""Checkpoint: state snapshot + restore ("quicksync") (port of
``spacemesh_tpu/node/checkpoint.py``).

Mirrors the reference checkpoint package (reference checkpoint/runner.go:31
Generate writes a JSON snapshot of accounts + essential ATX chain data at a
layer; recovery.go:111 Recover wipes the database and bootstraps from the
snapshot, preserving the node's own ATX lineage :401; triggered by the
admin API or config at startup).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from ..core.types import ActivationTx
from ..storage import atxs as atxstore
from ..storage import layers as layerstore
from ..storage import misc as miscstore
from ..storage import transactions as txstore
from ..storage.db import Database
from ..utils import fsio

VERSION = 1


def generate(db: Database, layer: int | None = None) -> dict:
    """Snapshot accounts (latest state) + all ATXs + beacons at ``layer``
    (default: last applied)."""
    if layer is None:
        layer = layerstore.last_applied(db)
    accounts = []
    for row in txstore.all_current_accounts(db):
        accounts.append({
            "address": row["address"].hex(),
            "balance": row["balance"],
            "next_nonce": row["next_nonce"],
            "template": row["template"].hex() if row["template"] else None,
            "state": row["state"].hex() if row["state"] else None,
        })
    atx_rows = db.all(
        "SELECT id, tick_height, data FROM atxs"
        " ORDER BY publish_epoch, id")
    # v2 (merged) envelopes appear once per covered identity — snapshot
    # each blob once; ticks stay per-row (synthetic per-identity ids)
    seen_blobs: set[bytes] = set()
    atxs = []
    for r in atx_rows:
        if r["data"] not in seen_blobs:
            seen_blobs.add(r["data"])
            atxs.append(r["data"].hex())
    ticks = {r["id"].hex(): r["tick_height"] for r in atx_rows}
    beacons = {str(r["epoch"]): r["beacon"].hex() for r in
               db.all("SELECT epoch, beacon FROM beacons")}
    return {
        "version": VERSION,
        # spacecheck: ok=SC001 checkpoint files record REAL wall time for operators (reference parity)
        "timestamp": int(time.time()),
        "layer": layer,
        "state_hash": (layerstore.state_hash(db, layer) or b"").hex(),
        "accounts": accounts,
        "atxs": atxs,
        "atx_ticks": ticks,
        "beacons": beacons,
    }


def write(db: Database, path: str | Path, layer: int | None = None) -> dict:
    snapshot = generate(db, layer)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    # durable write (utils/fsio): a checkpoint exists precisely for the
    # crash case — a rename that beats its payload to the platter would
    # leave a truncated snapshot for the recovery it was meant to serve
    fsio.atomic_write_text(p, json.dumps(snapshot))
    return snapshot


def recover(db: Database, snapshot: dict, *,
            preserve_node_id: bytes | None = None) -> None:
    """Wipe consensus tables and restore from the snapshot. ATXs belonging
    to ``preserve_node_id`` that are NOT in the snapshot survive (the
    reference preserves the node's own ATX lineage so it can keep smeshing
    across a checkpoint recovery)."""
    if snapshot.get("version") != VERSION:
        raise ValueError(f"unsupported checkpoint version "
                         f"{snapshot.get('version')}")
    own: list[tuple] = []
    if preserve_node_id is not None:
        own = [tuple(r) for r in db.all(
            "SELECT id, node_id, publish_epoch, num_units, tick_height,"
            " vrf_nonce, coinbase, received, data, version FROM atxs"
            " WHERE node_id=?", (preserve_node_id,))]
    with db.tx():
        for table in ("atxs", "ballots", "blocks", "layers", "certificates",
                      "beacons", "transactions", "accounts", "rewards",
                      "poet_proofs", "active_sets"):
            db.exec(f"DELETE FROM {table}")
        layer = snapshot["layer"]
        for acct in snapshot["accounts"]:
            txstore.update_account(
                db, bytes.fromhex(acct["address"]), layer, acct["balance"],
                acct["next_nonce"],
                bytes.fromhex(acct["template"]) if acct["template"] else None,
                bytes.fromhex(acct["state"]) if acct["state"] else None)
        ticks = snapshot.get("atx_ticks", {})
        for blob_hex in snapshot["atxs"]:
            blob = bytes.fromhex(blob_hex)
            atx = None
            try:  # ONLY the parse probe — storage errors must surface
                atx = ActivationTx.from_bytes(blob)
            except Exception:  # noqa: BLE001 — not a v1 blob
                pass
            if atx is not None:
                atxstore.add(db, atx,
                             tick_height=ticks.get(atx.id.hex(), 0))
                continue
            from ..core.types import ActivationTxV2

            atx2 = ActivationTxV2.from_bytes(blob)
            atxstore.add_v2(db, atx2, tick_heights={
                sp.node_id: ticks.get(
                    atx2.identity_atx_id(sp.node_id).hex(), 0)
                for sp in atx2.subposts})
        for epoch, beacon in snapshot.get("beacons", {}).items():
            # checkpoint-derived: supersedable, like the 0002 migration's
            # default for pre-existing rows
            miscstore.set_beacon(db, int(epoch), bytes.fromhex(beacon),
                                 source=miscstore.BEACON_FALLBACK)
        for row in own:
            db.exec(
                "INSERT OR IGNORE INTO atxs (id, node_id, publish_epoch,"
                " num_units, tick_height, vrf_nonce, coinbase, received,"
                " data, version) VALUES (?,?,?,?,?,?,?,?,?,?)", row)
        state_hash = bytes.fromhex(snapshot["state_hash"]) or bytes(32)
        layerstore.set_applied(db, layer, bytes(32), state_hash)
        layerstore.set_processed(db, layer)


def recover_file(db: Database, path: str | Path,
                 preserve_node_id: bytes | None = None) -> dict:
    snapshot = json.loads(Path(path).read_text())
    recover(db, snapshot, preserve_node_id=preserve_node_id)
    return snapshot
