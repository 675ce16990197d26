"""The node-facing wire surface the PoST worker speaks: the generated
``spacemesh.v1`` PostService messages (``gen/post_pb2.py``) and the
helpers of ``rpc.py``. Importing this package imports neither grpc nor
protobuf."""
