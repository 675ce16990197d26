"""Transaction-building SDK (port of ``spacemesh_tpu/vm/sdk.py``;
reference genvm/sdk: used by tests, the
genesis generator, and wallets to assemble signed txs)."""

from __future__ import annotations

from ..core import codec
from ..core.signing import Domain, EdSigner
from ..core.types import Address, Transaction
from . import templates as T
from .vm import DrainPayload, Method, SpendPayload, TxBody


def wallet_address(public_key: bytes) -> Address:
    args = codec.encode(T.WalletSpawnArgs(public_key=public_key))
    return T.REGISTRY[T.WALLET].principal(args)


def multisig_address(required: int, public_keys: list[bytes]) -> Address:
    args = codec.encode(T.MultisigSpawnArgs(required=required,
                                            public_keys=public_keys))
    return T.REGISTRY[T.MULTISIG].principal(args)


def vault_address(args: T.VaultSpawnArgs) -> Address:
    return T.REGISTRY[T.VAULT].principal(args.to_bytes())


def _finish(body: TxBody, signers: list[EdSigner]) -> Transaction:
    msg = body.unsigned_bytes()
    body.sigs = [s.sign(Domain.TX, msg) for s in signers]
    return Transaction(raw=body.to_bytes())


def spawn_wallet(signer: EdSigner, nonce: int = 0, gas_price: int = 1
                 ) -> Transaction:
    args = codec.encode(T.WalletSpawnArgs(public_key=signer.public_key))
    body = TxBody(principal=wallet_address(signer.public_key).raw,
                  method=int(Method.SPAWN), template=T.WALLET, nonce=nonce,
                  gas_price=gas_price, payload=args, sigs=[])
    return _finish(body, [signer])


def spawn_multisig(required: int, signers: list[EdSigner], nonce: int = 0,
                   gas_price: int = 1) -> Transaction:
    keys = [s.public_key for s in signers]
    args = codec.encode(T.MultisigSpawnArgs(required=required,
                                            public_keys=keys))
    body = TxBody(principal=multisig_address(required, keys).raw,
                  method=int(Method.SPAWN), template=T.MULTISIG, nonce=nonce,
                  gas_price=gas_price, payload=args, sigs=[])
    return _finish(body, signers[:required])


def spawn_vault(args: T.VaultSpawnArgs, nonce: int = 0) -> Transaction:
    body = TxBody(principal=vault_address(args).raw, method=int(Method.SPAWN),
                  template=T.VAULT, nonce=nonce, gas_price=0,
                  payload=args.to_bytes(), sigs=[])
    return Transaction(raw=body.to_bytes())


def spend(principal: Address, signers: list[EdSigner], destination: Address,
          amount: int, nonce: int, gas_price: int = 1) -> Transaction:
    payload = codec.encode(SpendPayload(destination=destination.raw,
                                        amount=amount))
    body = TxBody(principal=principal.raw, method=int(Method.SPEND),
                  template=None, nonce=nonce, gas_price=gas_price,
                  payload=payload, sigs=[])
    return _finish(body, signers)


def drain_vault(owner: Address, signers: list[EdSigner], vault: Address,
                destination: Address, amount: int, nonce: int,
                gas_price: int = 1) -> Transaction:
    payload = codec.encode(DrainPayload(vault=vault.raw,
                                        destination=destination.raw,
                                        amount=amount))
    body = TxBody(principal=owner.raw, method=int(Method.DRAIN_VAULT),
                  template=None, nonce=nonce, gas_price=gas_price,
                  payload=payload, sigs=[])
    return _finish(body, signers)
