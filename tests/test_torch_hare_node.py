"""The port's hare inside nodes (``spacemesh_tpu_torch/node/app.py`` over
``consensus/hare.py``): the cases of ``tests/test_hare_compact.py``,
``tests/test_hare_upgrade.py`` and ``tests/test_partition.py`` run on the
port through ``torch_twin``, on the port's virtual clock loop where the
JAX cases run on the JAX package's.
"""

from torch_twin import export

export("test_hare_compact", globals())
export("test_hare_upgrade", globals())
export("test_partition", globals())
