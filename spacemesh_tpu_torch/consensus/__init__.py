"""The port of ``spacemesh_tpu/consensus/``: ATX building and validation
(``activation.py``, ``activation_v2.py``), malfeasance, the poet, its
certifier and the external poet (``poet_remote.py``), the eligibility
oracle (``eligibility.py``), hare (``hare3.py``'s graded protocol,
``hare.py``'s sessions), the beacon (``beacon.py``), and the mesh they
drive: the tortoise (``tortoise.py``), ``mesh.py`` (proposals, execution,
apply/revert), ``blocks.py`` (the block generator and certifier),
``activeset.py`` (grading, the active-set generator, min-weight gating)
and ``miner.py`` (proposal building and validation)."""
