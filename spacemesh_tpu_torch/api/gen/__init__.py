"""Generated protobuf modules.

``post_pb2.py`` is a copy of ``spacemesh_tpu/api/gen/post_pb2.py`` whose
serialized descriptor is byte-identical to that one's (protoc --python_out
of ``post.proto``), so both load side by side in one process and share
their message classes. Keep it so: a copy with another descriptor clashes
with the JAX package's in the default descriptor pool.
"""
