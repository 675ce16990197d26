"""The VM: parse -> verify -> execute -> rewards, one sql tx per layer
(port of ``spacemesh_tpu/vm/vm.py``, whole).

Mirrors the reference's genvm (reference genvm/vm.go:192-291 Apply:
executes a block's transactions against layered account state, writes
accounts + receipts in one transaction, maintains a sequential blake3
state root; :124 Revert). Methods: SPAWN (instantiate a template into a
principal account), SPEND (transfer), DRAIN_VAULT (owner-authorized vault
withdrawal). Gas = base template cost + per-byte cost; fee = gas *
gas_price, burned from the principal.

Transaction wire format (this framework's own; the reference uses
scale-encoded athena txs):

  TxBody{principal, method u8, template(spawn only), nonce u64,
         gas_price u64, payload bytes, sigs vec<sig64>}
  signed message = genesis_prefix || domain(TX) || body-without-sigs
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from ..core import codec
from ..core.codec import fixed, option, u8, u64, var_bytes, vec
from ..core.hashing import sum256
from ..core.signing import Domain, EdVerifier
from ..core.types import ADDRESS_SIZE, Address, Reward, Transaction, TransactionResult
from ..storage import transactions as txstore
from ..storage.db import Database
from . import templates as T

GAS_PER_BYTE = 1
BASE_REWARD = 50_000_000_000  # per-layer issuance before fees (smidge)


class Method(enum.IntEnum):
    SPAWN = 0
    SPEND = 1
    DRAIN_VAULT = 2


class TxValidity(enum.IntEnum):
    VALID = 0
    INVALID_NONCE = 1
    INSUFFICIENT_FUNDS = 2
    BAD_SIGNATURE = 3
    MALFORMED = 4
    NOT_SPAWNED = 5


@codec.register
class SpendPayload:
    destination: bytes
    amount: int
    FIELDS = [("destination", fixed(ADDRESS_SIZE)), ("amount", u64)]


@codec.register
class DrainPayload:
    vault: bytes
    destination: bytes
    amount: int
    FIELDS = [("vault", fixed(ADDRESS_SIZE)),
              ("destination", fixed(ADDRESS_SIZE)), ("amount", u64)]


@codec.register
class TxBody:
    principal: bytes
    method: int
    template: Optional[bytes]
    nonce: int
    gas_price: int
    payload: bytes
    sigs: list[bytes]

    FIELDS = [("principal", fixed(ADDRESS_SIZE)), ("method", u8),
              ("template", option(fixed(ADDRESS_SIZE))), ("nonce", u64),
              ("gas_price", u64), ("payload", var_bytes),
              ("sigs", vec(fixed(64), 10))]

    def unsigned_bytes(self) -> bytes:
        return dataclasses.replace(self, sigs=[]).to_bytes()


@dataclasses.dataclass
class Account:
    address: bytes
    balance: int = 0
    next_nonce: int = 0
    template: bytes | None = None
    state: bytes | None = None


class Staged:
    """Layered read-through cache over the accounts table
    (reference genvm/core/staged_cache.go)."""

    def __init__(self, db: Database):
        self.db = db
        self.cache: dict[bytes, Account] = {}
        self.touched: set[bytes] = set()

    def get(self, address: bytes) -> Account:
        if address not in self.cache:
            row = txstore.account(self.db, address)
            if row is None:
                self.cache[address] = Account(address=address)
            else:
                self.cache[address] = Account(
                    address=address, balance=row["balance"],
                    next_nonce=row["next_nonce"], template=row["template"],
                    state=row["state"])
        return self.cache[address]

    def touch(self, address: bytes) -> Account:
        self.touched.add(address)
        return self.get(address)


class VM:
    """One instance per node; Apply is called by the mesh executor."""

    def __init__(self, db: Database, verifier: EdVerifier):
        self.db = db
        self.verifier = verifier

    # --- parsing / syntactic validation (used by mempool too) ---------

    def parse(self, tx: Transaction) -> TxBody | None:
        try:
            return TxBody.from_bytes(tx.raw)
        except (codec.DecodeError, ValueError):
            return None

    def validate(self, body: TxBody, *, check_sig: bool = True
                 ) -> TxValidity:
        """Syntactic + signature validation against CURRENT state."""
        staged = Staged(self.db)
        return self._check(staged, body, check_sig=check_sig)

    def _check(self, staged: Staged, body: TxBody, *, check_sig: bool,
               layer: int | None = None) -> TxValidity:
        acct = staged.get(body.principal)
        if body.method == Method.SPAWN:
            if body.template not in T.REGISTRY:
                return TxValidity.MALFORMED
            tmpl = T.REGISTRY[body.template]
            try:
                tmpl.parse_spawn(body.payload)
            except (ValueError, codec.DecodeError):
                return TxValidity.MALFORMED
            if tmpl.principal(body.payload).raw != body.principal:
                return TxValidity.MALFORMED
            if acct.template is not None:
                return TxValidity.MALFORMED  # already spawned
            if check_sig and body.template != T.VAULT:
                if not tmpl.authorize(body.payload, self.verifier, Domain.TX,
                                      self._msg(body), body.sigs):
                    return TxValidity.BAD_SIGNATURE
        else:
            if acct.template is None:
                return TxValidity.NOT_SPAWNED
            tmpl = T.REGISTRY.get(acct.template)
            if tmpl is None:
                return TxValidity.MALFORMED
            try:
                if body.method == Method.SPEND:
                    SpendPayload.from_bytes(body.payload)
                elif body.method == Method.DRAIN_VAULT:
                    DrainPayload.from_bytes(body.payload)
                else:
                    return TxValidity.MALFORMED
            except (codec.DecodeError, ValueError):
                return TxValidity.MALFORMED
            if check_sig and not tmpl.authorize(
                    acct.state, self.verifier, Domain.TX,
                    self._msg(body), body.sigs):
                return TxValidity.BAD_SIGNATURE
        if body.nonce != acct.next_nonce:
            return TxValidity.INVALID_NONCE
        return TxValidity.VALID

    def _msg(self, body: TxBody) -> bytes:
        return body.unsigned_bytes()

    def gas(self, body: TxBody) -> int:
        base = 100
        if body.method == Method.SPAWN and body.template in T.REGISTRY:
            base = T.REGISTRY[body.template].base_gas()
        return base + GAS_PER_BYTE * len(body.payload)

    def apply_genesis(self, allocations: dict[bytes, int]) -> bytes:
        """Fund genesis accounts (reference config/mainnet.go:91-190 bakes
        genesis accounts; vaults are funded with their total_amount)."""
        with self.db.tx():
            staged = Staged(self.db)
            for addr, amount in allocations.items():
                staged.touch(addr).balance = amount
            from ..storage import layers as layerstore
            root = self._persist(staged, 0)
            layerstore.set_applied(self.db, 0, bytes(32), root)
            return root

    # --- execution ----------------------------------------------------

    def apply(self, layer: int, block_id: bytes, txs: list[Transaction],
              rewards: list[Reward]) -> tuple[list[TransactionResult], bytes]:
        """Execute a block. Returns per-tx results + new state root.
        Everything commits in one sql transaction."""
        with self.db.tx():
            staged = Staged(self.db)
            results: list[TransactionResult] = []
            fees = 0
            for tx in txs:
                res = self._exec_one(staged, layer, block_id, tx)
                fees += res.fee
                results.append(res)
                txstore.add_tx(self.db, tx)  # ensure presence
                txstore.set_result(self.db, tx.id, layer, block_id, res)

            total_weight = sum(r.weight for r in rewards) or 1
            pot = BASE_REWARD + fees
            # rewards are keyed per ATX on the wire (AnyReward); a multi-
            # identity smesher repeats one coinbase, and the ledger row is
            # per (coinbase, layer) — aggregate BEFORE writing or the
            # upsert clobbers earlier shares
            per_coinbase: dict[bytes, tuple[int, int]] = {}
            for r in rewards:
                share = pot * r.weight // total_weight
                base = BASE_REWARD * r.weight // total_weight
                acct = staged.touch(bytes(r.coinbase))
                acct.balance += share
                tot, lay = per_coinbase.get(bytes(r.coinbase), (0, 0))
                per_coinbase[bytes(r.coinbase)] = (tot + share, lay + base)
            from ..storage.misc import add_reward
            for coinbase, (share, base) in per_coinbase.items():
                add_reward(self.db, coinbase, layer, share, base)

            state_root = self._persist(staged, layer)
            return results, state_root

    def _exec_one(self, staged: Staged, layer: int, block_id: bytes,
                  tx: Transaction) -> TransactionResult:
        def fail(status: TxValidity, msg: str, gas=0, fee=0):
            return TransactionResult(status=int(status), message=msg,
                                     gas_consumed=gas, fee=fee, layer=layer,
                                     block=block_id)

        body = self.parse(tx)
        if body is None:
            return fail(TxValidity.MALFORMED, "undecodable")
        validity = self._check(staged, body, check_sig=True, layer=layer)
        if validity != TxValidity.VALID:
            return fail(validity, validity.name.lower())

        gas = self.gas(body)
        fee = gas * body.gas_price
        principal = staged.touch(body.principal)
        if principal.balance < fee:
            return fail(TxValidity.INSUFFICIENT_FUNDS, "cannot cover fee")
        principal.balance -= fee
        principal.next_nonce = body.nonce + 1

        if body.method == Method.SPAWN:
            principal.template = body.template
            principal.state = body.payload
        elif body.method == Method.SPEND:
            p = SpendPayload.from_bytes(body.payload)
            if principal.balance < p.amount:
                return fail(TxValidity.INSUFFICIENT_FUNDS,
                            "balance below amount", gas, fee)
            principal.balance -= p.amount
            staged.touch(p.destination).balance += p.amount
        elif body.method == Method.DRAIN_VAULT:
            p = DrainPayload.from_bytes(body.payload)
            vault = staged.touch(p.vault)
            if vault.template != T.VAULT:
                return fail(TxValidity.MALFORMED, "not a vault", gas, fee)
            args = T.VaultSpawnArgs.from_bytes(vault.state)
            if args.owner != body.principal:
                return fail(TxValidity.BAD_SIGNATURE, "not vault owner",
                            gas, fee)
            vested = T.VaultTemplate.vested(args, layer)
            drained = args.total_amount - vault.balance
            available = min(vault.balance, max(vested - drained, 0))
            if p.amount > available:
                return fail(TxValidity.INSUFFICIENT_FUNDS,
                            "exceeds vested amount", gas, fee)
            vault.balance -= p.amount
            staged.touch(p.destination).balance += p.amount

        return TransactionResult(status=int(TxValidity.VALID), message="",
                                 gas_consumed=gas, fee=fee, layer=layer,
                                 block=block_id)

    def _persist(self, staged: Staged, layer: int) -> bytes:
        """Write touched accounts; state root = blake3 chain over the
        previous root and sorted account updates (reference genvm/vm.go
        updateStateHash)."""
        from ..storage import layers as layerstore
        prev = layerstore.state_hash(self.db, layer - 1) or bytes(32)
        root = prev
        for addr in sorted(staged.touched):
            acct = staged.cache[addr]
            txstore.update_account(
                self.db, addr, layer, acct.balance, acct.next_nonce,
                acct.template, acct.state)
            # template + state must be committed too: two states differing
            # only in spawned template or template args (e.g. vault owner)
            # must not share a root
            # variable-length fields are length-prefixed: template/state
            # boundary shifts must change the root
            template = acct.template or b""
            state = acct.state or b""
            root = sum256(root, addr,
                          acct.balance.to_bytes(8, "little"),
                          acct.next_nonce.to_bytes(8, "little"),
                          len(template).to_bytes(4, "little"), template,
                          len(state).to_bytes(4, "little"), state)
        return root

    def revert(self, to_layer: int) -> None:
        """Drop account state above ``to_layer`` (reference genvm/vm.go:124)."""
        with self.db.tx():
            txstore.revert_accounts_above(self.db, to_layer)

    def state_root(self, layer: int) -> bytes | None:
        from ..storage import layers as layerstore
        return layerstore.state_hash(self.db, layer)
