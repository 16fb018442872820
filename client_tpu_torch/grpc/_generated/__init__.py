"""The KServe v2 message modules under the names protoc gives them.

Built by the port's own proto3 runtime (``client_tpu_torch.grpc._proto``)
from ``client_tpu_torch/protos/``; no protobuf library is needed.
"""

from client_tpu_torch.grpc._generated import model_config_pb2  # noqa: F401
from client_tpu_torch.grpc._generated import grpc_service_pb2  # noqa: F401

# the reference wheel's module name
service_pb2 = grpc_service_pb2
