"""InferRequestedOutput for the HTTP protocol.

An own copy of ``client_tpu/http/_requested_output.py``.

Capability parity with reference
src/python/library/tritonclient/http/_requested_output.py.
"""

from typing import Any, Dict


class InferRequestedOutput:
    """Describes a requested output tensor.

    Parameters
    ----------
    name:
        Output tensor name.
    binary_data:
        Ask the server to return this output in the binary section of the
        response (default True; BF16 outputs require it).
    class_count:
        If > 0, request classification results with this many classes
        instead of the raw tensor.
    """

    def __init__(self, name: str, binary_data: bool = True, class_count: int = 0):
        self._name = name
        self._parameters: Dict[str, Any] = {}
        if class_count != 0:
            self._parameters["classification"] = int(class_count)
        self._binary = bool(binary_data)
        if self._binary:
            self._parameters["binary_data"] = True

    def name(self) -> str:
        return self._name

    def set_shared_memory(
        self, region_name: str, byte_size: int, offset: int = 0
    ) -> "InferRequestedOutput":
        """Direct the server to write this output into a registered region."""
        self._parameters.pop("binary_data", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = int(byte_size)
        if offset != 0:
            self._parameters["shared_memory_offset"] = int(offset)
        return self

    def unset_shared_memory(self) -> "InferRequestedOutput":
        """Clear a previous set_shared_memory so data returns inline."""
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        if self._binary:
            self._parameters["binary_data"] = True
        return self

    def _get_tensor_json(self) -> Dict[str, Any]:
        tensor: Dict[str, Any] = {"name": self._name}
        if self._parameters:
            tensor["parameters"] = dict(self._parameters)
        return tensor
