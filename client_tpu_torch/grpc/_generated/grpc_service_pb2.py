"""``grpc_service.proto``'s messages (``ModelInferRequest`` ...), as
protoc's module names them."""

from client_tpu_torch.grpc import _proto

globals().update(_proto.namespace("grpc_service"))
