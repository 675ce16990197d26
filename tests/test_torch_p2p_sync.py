"""The port's request/response seam, fetch, range sync and syncer
(``spacemesh_tpu_torch/p2p/{server,fetch,rangesync,sync}.py``,
``node/peersync.py``) and a node over an out-of-process POST worker: the
cases of ``tests/test_peersync.py``, ``tests/test_rangesync.py``,
``tests/test_fetch_backoff.py``, ``tests/test_sync_hardening.py`` and
``tests/test_multi_identity.py`` run on the port through ``torch_twin``.
"""

from torch_twin import export

export("test_peersync", globals())
export("test_rangesync", globals())
export("test_fetch_backoff", globals())
export("test_sync_hardening", globals())
export("test_multi_identity", globals())
