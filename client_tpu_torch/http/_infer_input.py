"""InferInput for the HTTP protocol.

An own copy of ``client_tpu/http/_infer_input.py`` (capability parity with
reference src/python/library/tritonclient/http/_infer_input.py), whose
``set_data_from_jax`` becomes :meth:`InferInput.set_data_from_torch`: a
torch tensor on any device (bfloat16 included) is read to the host
exactly once.
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from client_tpu_torch.utils import (
    InferenceServerException,
    np_to_triton_dtype,
    serialize_byte_tensor,
    tensors_to_numpy,
)


class InferInput:
    """An input tensor for an inference request."""

    def __init__(self, name: str, shape: Sequence[int], datatype: str):
        self._name = name
        self._shape = [int(s) for s in shape]
        self._datatype = datatype
        self._parameters: Dict[str, Any] = {}
        self._raw_data: Optional[bytes] = None
        self._json_data: Optional[list] = None

    def name(self) -> str:
        return self._name

    def datatype(self) -> str:
        return self._datatype

    def shape(self) -> List[int]:
        return self._shape

    def set_shape(self, shape: Sequence[int]) -> None:
        self._shape = [int(s) for s in shape]

    def set_data_from_numpy(
        self, input_tensor: np.ndarray, binary_data: bool = True
    ) -> "InferInput":
        """Attach tensor data from a numpy array.

        ``binary_data=False`` sends the tensor inside the JSON header (not
        supported for BF16, which has no JSON representation).
        """
        if not isinstance(input_tensor, np.ndarray):
            raise InferenceServerException(
                "input tensor must be a numpy array"
            )
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if dtype is None:
            raise InferenceServerException(
                f"unsupported numpy dtype {input_tensor.dtype}"
            )
        if dtype != self._datatype:
            raise InferenceServerException(
                f"got unexpected datatype {dtype} from numpy array; "
                f"expected {self._datatype}"
            )
        valid_shape = list(input_tensor.shape) == self._shape
        if not valid_shape:
            raise InferenceServerException(
                f"got unexpected numpy array shape {list(input_tensor.shape)}; "
                f"expected {self._shape}"
            )

        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)

        if not binary_data:
            if self._datatype == "BF16":
                raise InferenceServerException(
                    "BF16 tensors must use binary_data=True (no JSON form)"
                )
            self._parameters.pop("binary_data_size", None)
            self._raw_data = None
            if self._datatype == "BYTES":
                flat = []
                for obj in input_tensor.flatten():
                    if isinstance(obj, (bytes, np.bytes_)):
                        flat.append(bytes(obj).decode("utf-8"))
                    else:
                        flat.append(str(obj))
            else:
                flat = input_tensor.flatten().tolist()
            self._json_data = flat
            return self

        self._json_data = None
        if self._datatype == "BYTES":
            serialized = serialize_byte_tensor(input_tensor)
            self._raw_data = serialized.tobytes()
        else:
            self._raw_data = np.ascontiguousarray(input_tensor).tobytes()
        self._parameters["binary_data_size"] = len(self._raw_data)
        return self

    def set_data_from_torch(self, tensor) -> "InferInput":
        """Attach tensor data from a torch tensor (one device-to-host read).

        The torch twin of ``set_data_from_numpy``: bfloat16 tensors stay
        bfloat16 on the wire (datatype BF16), no float32 upcast.
        """
        (host,) = tensors_to_numpy([tensor])
        return self.set_data_from_numpy(host, binary_data=True)

    def set_shared_memory(
        self, region_name: str, byte_size: int, offset: int = 0
    ) -> "InferInput":
        """Source this input's data from a pre-registered shm region."""
        self._raw_data = None
        self._json_data = None
        self._parameters.pop("binary_data_size", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = int(byte_size)
        if offset != 0:
            self._parameters["shared_memory_offset"] = int(offset)
        return self

    # -- wire building -----------------------------------------------------

    def _get_binary_data(self) -> Optional[bytes]:
        return self._raw_data

    def _get_tensor_json(self, binary_chunks: Optional[list] = None) -> Dict:
        tensor: Dict[str, Any] = {
            "name": self._name,
            "shape": self._shape,
            "datatype": self._datatype,
        }
        if self._parameters:
            tensor["parameters"] = dict(self._parameters)
        if self._raw_data is not None:
            if binary_chunks is not None:
                binary_chunks.append(self._raw_data)
        elif self._json_data is not None:
            tensor["data"] = self._json_data
        return tensor
