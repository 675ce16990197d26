"""Conservative state / mempool (port of ``spacemesh_tpu/txs/``;
reference txs/)."""

from .conservative_state import ConservativeState  # noqa: F401
