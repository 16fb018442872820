"""InferInput for the gRPC protocol (message-backed).

An own copy of ``client_tpu/grpc/_infer_input.py``, with
``set_data_from_torch`` in place of ``set_data_from_jax``.
"""

from typing import List, Optional, Sequence

import numpy as np

from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.utils import (
    InferenceServerException,
    np_to_triton_dtype,
    serialize_byte_tensor,
    tensors_to_numpy,
)


class InferInput:
    """An input tensor for a gRPC inference request."""

    def __init__(self, name: str, shape: Sequence[int], datatype: str):
        self._input = pb.ModelInferRequest.InferInputTensor(
            name=name, datatype=datatype
        )
        self._input.shape.extend(int(s) for s in shape)
        self._raw_content: Optional[bytes] = None

    def name(self) -> str:
        return self._input.name

    def datatype(self) -> str:
        return self._input.datatype

    def shape(self) -> List[int]:
        return list(self._input.shape)

    def set_shape(self, shape: Sequence[int]) -> "InferInput":
        self._input.ClearField("shape")
        self._input.shape.extend(int(s) for s in shape)
        return self

    def set_data_from_numpy(self, input_tensor: np.ndarray) -> "InferInput":
        """Attach data from a numpy array (always raw bytes on gRPC)."""
        if not isinstance(input_tensor, np.ndarray):
            raise InferenceServerException("input tensor must be a numpy array")
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if dtype is None:
            raise InferenceServerException(
                f"unsupported numpy dtype {input_tensor.dtype}"
            )
        if dtype != self._input.datatype:
            raise InferenceServerException(
                f"got unexpected datatype {dtype} from numpy array; expected "
                f"{self._input.datatype}"
            )
        if list(input_tensor.shape) != list(self._input.shape):
            raise InferenceServerException(
                f"got unexpected numpy array shape {list(input_tensor.shape)}; "
                f"expected {list(self._input.shape)}"
            )
        self._input.parameters.pop("shared_memory_region", None)
        self._input.parameters.pop("shared_memory_byte_size", None)
        self._input.parameters.pop("shared_memory_offset", None)
        if self._input.datatype == "BYTES":
            self._raw_content = serialize_byte_tensor(input_tensor).tobytes()
        else:
            self._raw_content = np.ascontiguousarray(input_tensor).tobytes()
        return self

    def set_data_from_torch(self, tensor) -> "InferInput":
        """Attach data from a torch tensor (one device-to-host read);
        bfloat16 stays bfloat16 on the wire (datatype BF16)."""
        (host,) = tensors_to_numpy([tensor])
        return self.set_data_from_numpy(host)

    def set_shared_memory(
        self, region_name: str, byte_size: int, offset: int = 0
    ) -> "InferInput":
        """Source this input from a pre-registered shared-memory region."""
        self._raw_content = None
        self._input.ClearField("contents")
        self._input.parameters["shared_memory_region"].string_param = region_name
        self._input.parameters["shared_memory_byte_size"].int64_param = int(
            byte_size
        )
        if offset != 0:
            self._input.parameters["shared_memory_offset"].int64_param = int(
                offset
            )
        return self

    def _get_tensor(self) -> pb.ModelInferRequest.InferInputTensor:
        return self._input

    def _get_raw_content(self) -> Optional[bytes]:
        return self._raw_content
