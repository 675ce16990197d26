"""Account templates: wallet, multisig, vesting, vault (port of
``spacemesh_tpu/vm/templates.py``, whole).

Mirrors the reference's template registry (reference genvm/vm.go:68-74
registers wallet/multisig/vesting/vault from genvm/templates/). A template
defines: spawn-argument parsing, the principal address derivation, spend
authorization (signature scheme), and any template-specific spend rules
(vesting schedule, vault drip).

Template addresses are well-known 24-byte constants (index in the last
byte), as in the reference's core.Address template handles.
"""

from __future__ import annotations

import dataclasses

from ..core import codec
from ..core.codec import fixed, u8, u32, u64, vec
from ..core.signing import EdVerifier
from ..core.types import ADDRESS_SIZE, Address

WALLET = bytes(23) + b"\x01"
MULTISIG = bytes(23) + b"\x02"
VESTING = bytes(23) + b"\x03"
VAULT = bytes(23) + b"\x04"


@codec.register
class WalletSpawnArgs:
    public_key: bytes
    FIELDS = [("public_key", fixed(32))]


@codec.register
class MultisigSpawnArgs:
    required: int
    public_keys: list[bytes]
    FIELDS = [("required", u8), ("public_keys", vec(fixed(32), 10))]


@codec.register
class VaultSpawnArgs:
    owner: bytes                  # controlling (vesting) account address
    total_amount: int
    initial_unlock: int
    vesting_start: int            # layer
    vesting_end: int              # layer
    FIELDS = [("owner", fixed(ADDRESS_SIZE)), ("total_amount", u64),
              ("initial_unlock", u64), ("vesting_start", u32),
              ("vesting_end", u32)]


class TemplateError(ValueError):
    pass


class BaseTemplate:
    address: bytes
    name: str

    def principal(self, spawn_args: bytes) -> Address:
        return Address.from_public_key(self.address, spawn_args)

    def parse_spawn(self, args: bytes):
        raise NotImplementedError

    def authorize(self, state: bytes, verifier: EdVerifier, domain,
                  msg: bytes, sigs: list[bytes]) -> bool:
        raise NotImplementedError

    def base_gas(self) -> int:
        return 100


class WalletTemplate(BaseTemplate):
    """Single-signature account (reference genvm/templates/wallet)."""

    address = WALLET
    name = "wallet"

    def parse_spawn(self, args: bytes) -> bytes:
        WalletSpawnArgs.from_bytes(args)  # validates
        return args

    def authorize(self, state, verifier, domain, msg, sigs) -> bool:
        if len(sigs) != 1:
            return False
        pk = WalletSpawnArgs.from_bytes(state).public_key
        return verifier.verify(domain, pk, msg, sigs[0])


class MultisigTemplate(BaseTemplate):
    """k-of-n ed25519 (reference genvm/templates/multisig)."""

    address = MULTISIG
    name = "multisig"

    def parse_spawn(self, args: bytes) -> bytes:
        a = MultisigSpawnArgs.from_bytes(args)
        if not (1 <= a.required <= len(a.public_keys) <= 10):
            raise TemplateError("invalid multisig spawn: k-of-n out of range")
        if len(set(a.public_keys)) != len(a.public_keys):
            raise TemplateError("duplicate multisig keys")
        return args

    def authorize(self, state, verifier, domain, msg, sigs) -> bool:
        a = MultisigSpawnArgs.from_bytes(state)
        if len(sigs) < a.required:
            return False
        used = set()
        good = 0
        for sig in sigs:
            for i, pk in enumerate(a.public_keys):
                if i in used:
                    continue
                if verifier.verify(domain, pk, msg, sig):
                    used.add(i)
                    good += 1
                    break
        return good >= a.required

    def base_gas(self) -> int:
        return 300


class VestingTemplate(MultisigTemplate):
    """Multisig that can additionally drain a vault on schedule
    (reference genvm/templates/vesting — multisig + DrainVault method)."""

    address = VESTING
    name = "vesting"


class VaultTemplate(BaseTemplate):
    """Time-locked funds, spendable only by the owner account up to the
    vested amount (reference genvm/templates/vault)."""

    address = VAULT
    name = "vault"

    def parse_spawn(self, args: bytes) -> bytes:
        a = VaultSpawnArgs.from_bytes(args)
        if a.vesting_end < a.vesting_start:
            raise TemplateError("vault vesting_end before vesting_start")
        if a.initial_unlock > a.total_amount:
            raise TemplateError("vault initial unlock exceeds total")
        return args

    def authorize(self, state, verifier, domain, msg, sigs) -> bool:
        # a vault has no keys: spends happen only via the owner's
        # DrainVault, authorized against the OWNER account (vm.py)
        return False

    @staticmethod
    def vested(args: VaultSpawnArgs, layer: int) -> int:
        if layer < args.vesting_start:
            return 0
        if layer >= args.vesting_end:
            return args.total_amount
        span = args.vesting_end - args.vesting_start
        linear = (args.total_amount - args.initial_unlock) * (
            layer - args.vesting_start) // span
        return args.initial_unlock + linear


REGISTRY: dict[bytes, BaseTemplate] = {
    t.address: t for t in (WalletTemplate(), MultisigTemplate(),
                           VestingTemplate(), VaultTemplate())
}
