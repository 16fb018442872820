"""InferRequestedOutput for the gRPC protocol.

An own copy of ``client_tpu/grpc/_requested_output.py``.
"""

from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb


class InferRequestedOutput:
    """Describes a requested output tensor for a gRPC inference request."""

    def __init__(self, name: str, class_count: int = 0):
        self._output = pb.ModelInferRequest.InferRequestedOutputTensor(name=name)
        if class_count != 0:
            self._output.parameters["classification"].int64_param = int(
                class_count
            )

    def name(self) -> str:
        return self._output.name

    def set_shared_memory(
        self, region_name: str, byte_size: int, offset: int = 0
    ) -> "InferRequestedOutput":
        """Direct the server to write this output into a registered region."""
        self._output.parameters["shared_memory_region"].string_param = region_name
        self._output.parameters["shared_memory_byte_size"].int64_param = int(
            byte_size
        )
        if offset != 0:
            self._output.parameters["shared_memory_offset"].int64_param = int(
                offset
            )
        return self

    def unset_shared_memory(self) -> "InferRequestedOutput":
        self._output.parameters.pop("shared_memory_region", None)
        self._output.parameters.pop("shared_memory_byte_size", None)
        self._output.parameters.pop("shared_memory_offset", None)
        return self

    def _get_tensor(self) -> pb.ModelInferRequest.InferRequestedOutputTensor:
        return self._output
