"""Transaction + account queries (port of
``spacemesh_tpu/storage/transactions.py``; reference sql/transactions,
sql/accounts)."""

from __future__ import annotations

from ..core.types import Transaction, TransactionResult
from .db import Database


def add_tx(db: Database, tx: Transaction, principal: bytes | None = None,
           nonce: int | None = None) -> None:
    db.exec(
        "INSERT OR IGNORE INTO transactions (id, raw, principal, nonce)"
        " VALUES (?,?,?,?)", (tx.id, tx.raw, principal, nonce))


def get_tx(db: Database, tx_id: bytes) -> Transaction | None:
    row = db.one("SELECT raw FROM transactions WHERE id=?", (tx_id,))
    return Transaction(raw=row["raw"]) if row else None


def has_tx(db: Database, tx_id: bytes) -> bool:
    return db.one("SELECT 1 FROM transactions WHERE id=?", (tx_id,)) is not None


def set_result(db: Database, tx_id: bytes, layer: int, block: bytes,
               result: TransactionResult) -> None:
    db.exec(
        "UPDATE transactions SET layer=?, block=?, result=? WHERE id=?",
        (layer, block, result.to_bytes(), tx_id))


def result(db: Database, tx_id: bytes) -> TransactionResult | None:
    row = db.one("SELECT result FROM transactions WHERE id=?", (tx_id,))
    return (TransactionResult.from_bytes(row["result"])
            if row and row["result"] else None)


def pending_by_principal(db: Database, principal: bytes) -> list[Transaction]:
    return [Transaction(raw=r["raw"]) for r in
            db.all("SELECT raw FROM transactions WHERE principal=? AND layer"
                   " IS NULL ORDER BY nonce", (principal,))]


# --- accounts (layered snapshots; latest row wins) ------------------------


def update_account(db: Database, address: bytes, layer: int, balance: int,
                   next_nonce: int, template: bytes | None = None,
                   state: bytes | None = None) -> None:
    db.exec(
        "INSERT OR REPLACE INTO accounts (address, layer, balance, next_nonce,"
        " template, state) VALUES (?,?,?,?,?,?)",
        (address, layer, balance, next_nonce, template, state))


def account(db: Database, address: bytes, at_layer: int | None = None):
    q = ("SELECT * FROM accounts WHERE address=?"
         + ("" if at_layer is None else " AND layer<=?")
         + " ORDER BY layer DESC LIMIT 1")
    params = (address,) if at_layer is None else (address, at_layer)
    return db.one(q, params)


def revert_accounts_above(db: Database, layer: int) -> None:
    db.exec("DELETE FROM accounts WHERE layer>?", (layer,))


def all_current_accounts(db: Database):
    return db.all(
        "SELECT a.* FROM accounts a JOIN (SELECT address, MAX(layer) m FROM"
        " accounts GROUP BY address) b ON a.address=b.address AND a.layer=b.m")
