"""The port of ``spacemesh_tpu/p2p/``: the publish/subscribe seam and the
in-process loopback hub (``pubsub.py``)."""
