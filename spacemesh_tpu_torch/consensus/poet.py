"""Poet merkle membership (port of the membership half of
``spacemesh_tpu/consensus/poet.py``).

Merkle: leaves = blake3(member), internal = blake3(left || right), odd
nodes promoted. Verification walks ``MerkleProof.nodes`` with the leaf
index. The poet service itself (rounds, sequential work, certificates)
goes with the rest of ``consensus/*``.
"""

from __future__ import annotations

from ..core.hashing import sum256
from ..core.types import MerkleProof


def merkle_root(leaves: list[bytes]) -> bytes:
    if not leaves:
        return bytes(32)
    level = [sum256(m) for m in leaves]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(sum256(level[i], level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def merkle_path(leaves: list[bytes], index: int) -> MerkleProof:
    nodes = []
    level = [sum256(m) for m in leaves]
    i = index
    while len(level) > 1:
        sib = i ^ 1
        if sib < len(level):
            nodes.append(level[sib])
        nxt = []
        for k in range(0, len(level) - 1, 2):
            nxt.append(sum256(level[k], level[k + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        i //= 2
    return MerkleProof(leaf_index=index, nodes=nodes)


def verify_membership(member: bytes, proof: MerkleProof, root: bytes,
                      leaf_count: int) -> bool:
    if not 0 <= proof.leaf_index < leaf_count:
        return False
    h = sum256(member)
    i = proof.leaf_index
    width = leaf_count
    nodes = list(proof.nodes)
    while width > 1:
        sib = i ^ 1
        if sib < width:
            if not nodes:
                return False
            s = nodes.pop(0)
            h = sum256(h, s) if i % 2 == 0 else sum256(s, h)
        i //= 2
        width = (width + 1) // 2
    return not nodes and h == root
