"""The port's standalone node (``spacemesh_tpu_torch/node/app.py``) on
``device="cpu"``: the cases of ``tests/test_standalone.py`` (a node lives
through epochs on the real clock) and ``tests/test_recovery.py`` (a
restart recovers the ATX cache and the tortoise and keeps running), run
on the port through ``torch_twin``.
"""

from torch_twin import export

export("test_standalone", globals())
export("test_recovery", globals())
