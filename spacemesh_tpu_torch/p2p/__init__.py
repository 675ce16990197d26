"""The port of ``spacemesh_tpu/p2p/``: the publish/subscribe seam and the
in-process loopback hub (``pubsub.py``), the request/response server and
its loopback network (``server.py``), fetch (``fetch.py``), range sync
(``rangesync.py``) and the syncer (``sync.py``)."""
