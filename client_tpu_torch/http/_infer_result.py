"""InferResult for the HTTP protocol: an own copy of
``client_tpu/http/_infer_result.py`` whose ``as_jax`` becomes
:meth:`InferResult.as_torch`.

Parses the KServe v2 binary response: JSON header (size given by
``Inference-Header-Content-Length``) followed by concatenated binary output
buffers in header order. Capability parity with reference
src/python/library/tritonclient/http/_infer_result.py, with BF16 decoded to
native ``ml_dtypes.bfloat16`` arrays.
"""

import json
from typing import Any, Dict, Optional

import numpy as np

from client_tpu_torch.http._utils import HEADER_CONTENT_LENGTH, decompress_body
from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    numpy_to_tensor,
    resolve_device,
    triton_to_np_dtype,
)


class InferResult:
    """The result of an inference request."""

    def __init__(self, response_body: bytes, header_length: Optional[int]):
        if header_length is None:
            try:
                self._result: Dict[str, Any] = json.loads(
                    response_body.decode("utf-8")
                )
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise InferenceServerException(
                    f"malformed inference response: {e}"
                ) from None
            binary = b""
        else:
            header_length = int(header_length)
            try:
                self._result = json.loads(
                    response_body[:header_length].decode("utf-8")
                )
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise InferenceServerException(
                    f"malformed inference response header: {e}"
                ) from None
            binary = response_body[header_length:]

        # Map output name -> raw buffer, walking outputs in order.
        self._output_name_to_buffer: Dict[str, bytes] = {}
        offset = 0
        for output in self._result.get("outputs", []):
            params = output.get("parameters", {})
            size = params.get("binary_data_size")
            if size is not None:
                size = int(size)
                if offset + size > len(binary):
                    raise InferenceServerException(
                        f"binary section truncated for output "
                        f"'{output.get('name')}': need {size} bytes at offset "
                        f"{offset}, have {len(binary) - offset}"
                    )
                self._output_name_to_buffer[output["name"]] = binary[
                    offset : offset + size
                ]
                offset += size

    @classmethod
    def from_response(
        cls, response_body: bytes, headers: Dict[str, str]
    ) -> "InferResult":
        """Build a result from a raw HTTP response body + headers."""
        lowered = {k.lower(): v for k, v in headers.items()}
        body = decompress_body(response_body, lowered.get("content-encoding"))
        header_length = lowered.get(HEADER_CONTENT_LENGTH.lower())
        return cls(body, header_length)

    def get_response(self) -> Dict[str, Any]:
        """The deserialized JSON response header."""
        return self._result

    def get_output(self, name: str) -> Optional[Dict[str, Any]]:
        """The JSON metadata of output ``name`` (None if absent)."""
        for output in self._result.get("outputs", []):
            if output.get("name") == name:
                return output
        return None

    def as_numpy(self, name: str) -> Optional[np.ndarray]:
        """Output ``name`` as a numpy array (None if absent)."""
        output = self.get_output(name)
        if output is None:
            return None
        datatype = output["datatype"]
        shape = [int(s) for s in output.get("shape", [])]
        if name in self._output_name_to_buffer:
            buf = self._output_name_to_buffer[name]
            if datatype == "BYTES":
                return deserialize_bytes_tensor(buf).reshape(shape)
            np_dtype = triton_to_np_dtype(datatype)
            if np_dtype is None:
                raise InferenceServerException(
                    f"unknown datatype '{datatype}' for output '{name}'"
                )
            return np.frombuffer(buf, dtype=np_dtype).reshape(shape)
        if "data" in output:
            np_dtype = triton_to_np_dtype(datatype)
            if datatype == "BYTES":
                arr = np.array(
                    [
                        d.encode("utf-8") if isinstance(d, str) else d
                        for d in output["data"]
                    ],
                    dtype=np.object_,
                )
            else:
                arr = np.array(output["data"], dtype=np_dtype)
            return arr.reshape(shape)
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
