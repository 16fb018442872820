"""``model_config.proto``'s messages and enums (``ModelConfig``,
``DataType``, ``TYPE_FP32`` ...), as protoc's module names them."""

from client_tpu_torch.grpc import _proto

globals().update(_proto.namespace("model_config"))
