"""Mempool with per-account nonce/balance projection (port of
``spacemesh_tpu/txs/conservative_state.py``, whole).

Mirrors the reference's conservative state (reference
txs/conservative_state.go:53: a tx cache projecting each account's
nonce/balance as if pending txs applied in order; txs/mempool_iterator.go
orders candidates by fee; SelectProposalTXs picks for a proposal). A tx is
admitted only if its nonce continues the account's projected chain and the
projected balance covers fee + amount (conservative: never propose a tx
that cannot apply).
"""

from __future__ import annotations

import dataclasses
import threading

from ..core.types import Transaction
from ..storage import transactions as txstore
from ..storage.db import Database
from ..vm.vm import Method, SpendPayload, TxBody, TxValidity, VM


@dataclasses.dataclass
class _Pending:
    tx: Transaction
    body: TxBody
    fee: int
    spend: int


class ConservativeState:
    def __init__(self, db: Database, vm: VM):
        self.db = db
        self.vm = vm
        self._lock = threading.RLock()
        # principal -> list of pending txs ordered by nonce
        self._pool: dict[bytes, list[_Pending]] = {}

    # --- admission ----------------------------------------------------

    def add(self, tx: Transaction) -> TxValidity:
        """Validate + admit a gossip/API transaction into the pool."""
        body = self.vm.parse(tx)
        if body is None:
            return TxValidity.MALFORMED
        with self._lock:
            validity = self._admissible(body)
            if validity != TxValidity.VALID:
                return validity
            fee = self.vm.gas(body) * body.gas_price
            spend = 0
            if body.method == Method.SPEND:
                spend = SpendPayload.from_bytes(body.payload).amount
            self._pool.setdefault(body.principal, []).append(
                _Pending(tx=tx, body=body, fee=fee, spend=spend))
            txstore.add_tx(self.db, tx, principal=body.principal,
                           nonce=body.nonce)
            return TxValidity.VALID

    def _admissible(self, body: TxBody) -> TxValidity:
        # signature/structure against current state
        validity = self.vm.validate(body, check_sig=True)
        if validity == TxValidity.INVALID_NONCE:
            pass  # maybe continues the projected chain; checked below
        elif validity == TxValidity.NOT_SPAWNED:
            # allowed if a pending spawn for this principal exists
            if not any(p.body.method == Method.SPAWN
                       for p in self._pool.get(body.principal, ())):
                return TxValidity.NOT_SPAWNED
        elif validity != TxValidity.VALID:
            return validity

        nonce, balance = self._projection(body.principal)
        if body.nonce != nonce:
            return TxValidity.INVALID_NONCE
        fee = self.vm.gas(body) * body.gas_price
        spend = 0
        if body.method == Method.SPEND:
            try:
                spend = SpendPayload.from_bytes(body.payload).amount
            except Exception:
                return TxValidity.MALFORMED
        if balance < fee + spend:
            return TxValidity.INSUFFICIENT_FUNDS
        return TxValidity.VALID

    def _projection(self, principal: bytes) -> tuple[int, int]:
        row = txstore.account(self.db, principal)
        nonce = row["next_nonce"] if row else 0
        balance = row["balance"] if row else 0
        for p in self._pool.get(principal, ()):
            nonce = max(nonce, p.body.nonce + 1)
            balance -= p.fee + p.spend
        return nonce, balance

    def projected(self, principal: bytes) -> tuple[int, int]:
        with self._lock:
            return self._projection(principal)

    # --- selection ----------------------------------------------------

    def select_proposal_txs(self, max_txs: int) -> list[bytes]:
        """Pick tx ids for a proposal: per-account nonce order, accounts
        interleaved by fee (reference SelectProposalTXs + mempool
        iterator)."""
        with self._lock:
            heads = {p: list(txs) for p, txs in self._pool.items() if txs}
            out: list[bytes] = []
            while heads and len(out) < max_txs:
                best = max(heads, key=lambda p: heads[p][0].fee)
                out.append(heads[best][0].tx.id)
                heads[best].pop(0)
                if not heads[best]:
                    del heads[best]
            return out

    def get(self, tx_id: bytes) -> Transaction | None:
        with self._lock:
            for txs in self._pool.values():
                for p in txs:
                    if p.tx.id == tx_id:
                        return p.tx
        return txstore.get_tx(self.db, tx_id)

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pool.values())

    # --- post-application maintenance ---------------------------------

    def on_applied(self) -> None:
        """Drop pool entries the chain has caught up with (nonce below the
        account's persisted next_nonce) or that became unpayable under the
        account's NEW balance — otherwise a drained account's spends would
        be re-proposed and fail layer after layer."""
        with self._lock:
            for principal in list(self._pool):
                row = txstore.account(self.db, principal)
                next_nonce = row["next_nonce"] if row else 0
                balance = row["balance"] if row else 0
                kept = []
                for p in self._pool[principal]:
                    if p.body.nonce < next_nonce:
                        continue
                    if balance < p.fee + p.spend:
                        break  # nonce chain broken from here on
                    balance -= p.fee + p.spend
                    kept.append(p)
                if kept:
                    self._pool[principal] = kept
                else:
                    del self._pool[principal]
