"""The port's QUIC-lite transport (``spacemesh_tpu_torch/p2p/quic.py``)
against the JAX package's: the cases of ``tests/test_quic.py`` on the port
through ``torch_twin``, ``test_transport.py``'s matrix over ``QuicHost``
included (its autouse fixture swaps the twin's host class for each test of
this file only). The three-process cluster case is ``slow``, as in the JAX
file.
"""

from torch_twin import export

export("test_quic", globals())
