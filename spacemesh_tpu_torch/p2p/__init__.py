"""The port of ``spacemesh_tpu/p2p/``: the publish/subscribe seam and the
in-process loopback hub (``pubsub.py``), the request/response server and
its loopback network (``server.py``), fetch (``fetch.py``), range sync
(``rangesync.py``), the syncer (``sync.py``), and the real network: the
Noise-style channel (``noise.py``), the TCP ``Host`` (``transport.py``)
with its gossipsub-lite meshes (``gossipmesh.py``), and QUIC-lite
(``quic.py``) under the same ``Host``. The transport is wire-identical to
the JAX package's: a port node and a JAX node peer with each other."""
