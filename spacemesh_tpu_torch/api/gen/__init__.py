"""Generated protobuf modules.

``post_pb2.py``, ``core_pb2.py`` and ``v2alpha1_pb2.py`` are copies of the
modules of ``spacemesh_tpu/api/gen/`` whose serialized descriptors are
byte-identical to those ones' (protoc --python_out of ``post.proto``,
``core.proto`` and ``v2alpha1.proto``), so both packages load side by side
in one process and share their message classes. Keep them so: a copy with
another descriptor clashes with the JAX package's in the default
descriptor pool.
"""
