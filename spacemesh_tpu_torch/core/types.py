"""Wire types of ``spacemesh_tpu/core/types.py`` that the port uses.

Only :class:`MerkleProof` so far: the shape of a poet membership proof,
which the verification farm's membership kind checks. The JAX package
registers it with its codec; the port carries the same two fields as a
plain dataclass (the codec goes with the rest of ``core/*``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MerkleProof:
    leaf_index: int
    nodes: list[bytes]
