"""The port of ``spacemesh_tpu/consensus/``: ATX building and validation
(``activation.py``, ``activation_v2.py``), malfeasance, the poet and its
certifier, and hare's wire messages (``hare.py``)."""
