"""The port of ``spacemesh_tpu/core/``: the canonical codec
(``codec.py``) and wire types (``types.py``), blake3 (``hashing.py``),
ed25519 and ECVRF (``signing.py``)."""
