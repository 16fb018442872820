"""InferResult for the gRPC protocol.

An own copy of ``client_tpu/grpc/_infer_result.py``: wraps a
ModelInferResponse and decodes raw_output_contents (or typed contents)
into numpy arrays or torch tensors (``as_torch`` in place of ``as_jax``).
"""

from typing import Dict, Optional

import numpy as np

from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._proto import message_to_dict
from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    numpy_to_tensor,
    resolve_device,
    triton_to_np_dtype,
)

_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}


class InferResult:
    """The result of a gRPC inference request."""

    def __init__(self, response: pb.ModelInferResponse):
        self._response = response
        self._index: Dict[str, int] = {
            out.name: i for i, out in enumerate(response.outputs)
        }

    def get_response(self, as_json: bool = False):
        """The underlying ModelInferResponse (or a JSON-ish dict)."""
        if as_json:
            return message_to_dict(self._response)
        return self._response

    def get_output(self, name: str, as_json: bool = False):
        """Metadata for output ``name`` (None if absent)."""
        i = self._index.get(name)
        if i is None:
            return None
        out = self._response.outputs[i]
        if as_json:
            return message_to_dict(out)
        return out

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """Output ``name`` as a numpy array (None if absent or in shm)."""
        i = self._index.get(name)
        if i is None:
            return None
        out = self._response.outputs[i]
        shape = list(out.shape)
        datatype = out.datatype
        if "shared_memory_region" in out.parameters:
            return None  # caller reads the registered region directly
        if i < len(self._response.raw_output_contents):
            raw = self._response.raw_output_contents[i]
            if datatype == "BYTES":
                return deserialize_bytes_tensor(raw).reshape(shape)
            np_dtype = triton_to_np_dtype(datatype)
            if np_dtype is None:
                raise InferenceServerException(
                    f"unknown datatype '{datatype}' for output '{name}'"
                )
            return np.frombuffer(raw, dtype=np_dtype).reshape(shape)
        field = _CONTENTS_FIELD.get(datatype)
        if field is not None and out.HasField("contents"):
            values = getattr(out.contents, field)
            if datatype == "BYTES":
                return np.array(list(values), dtype=np.object_).reshape(shape)
            return np.array(
                list(values), dtype=triton_to_np_dtype(datatype)
            ).reshape(shape)
        return None

    def as_torch(self, name: str, device="cuda"):
        """Output ``name`` as a torch tensor on ``device`` (None if absent):
        one host-to-device copy. Raises when there is no card unless the
        caller asks for ``device="cpu"``."""
        host = self.as_numpy(name)
        if host is None:
            return None
        if host.dtype == np.dtype(object):
            raise InferenceServerException(
                f"BYTES output '{name}' cannot convert to a torch tensor"
            )
        return numpy_to_tensor(host, resolve_device(device))
