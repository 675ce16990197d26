"""Deterministic account-template VM (port of ``spacemesh_tpu/vm/``;
reference genvm/: no user bytecode,
a fixed registry of account templates — wallet, multisig, vesting, vault —
with spawn/spend transaction lifecycle, nonces, gas, and a running state
root over account updates)."""

from .vm import VM, TxValidity  # noqa: F401
