"""The pieces of ``spacemesh_tpu/consensus/`` the verification farm needs
(``poet.py``: merkle membership)."""
