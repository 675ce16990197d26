"""The port of ``spacemesh_tpu/consensus/``: ATX building and validation
(``activation.py``, ``activation_v2.py``), malfeasance, the poet, its
certifier and the external poet (``poet_remote.py``), the eligibility
oracle (``eligibility.py``, with ``activeset.py``'s min-weight gating),
hare (``hare3.py``'s graded protocol, ``hare.py``'s sessions) and the
beacon (``beacon.py``)."""
