"""The pieces of ``spacemesh_tpu/core/`` the verification farm needs:
blake3 (``hashing.py``), ed25519 and ECVRF (``signing.py``) and the
``MerkleProof`` shape (``types.py``)."""
