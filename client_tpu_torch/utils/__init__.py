"""The server's exception, the port's device helper, and the KServe v2
wire dtype tables and tensor serialization.

The wire helpers are own copies of ``client_tpu/utils``. BF16 host arrays
are ``ml_dtypes.bfloat16`` (the same numbers the JAX package hands out); a
BF16 tensor crosses to and from torch through a 16-bit view
(:func:`numpy_to_tensor`, :func:`tensors_to_numpy`).
"""

import struct
from typing import List, Optional, Sequence, Union

import ml_dtypes
import numpy as np
import torch

bfloat16 = np.dtype(ml_dtypes.bfloat16)

__all__ = [
    "KSERVE_TO_TF_DTYPE",
    "TF_TO_KSERVE_DTYPE",
    "InferenceServerException",
    "bfloat16",
    "deserialize_bf16_tensor",
    "deserialize_bytes_tensor",
    "np_to_torch_dtype",
    "np_to_triton_dtype",
    "num_elements",
    "numpy_to_tensor",
    "resolve_device",
    "serialize_bf16_tensor",
    "serialize_byte_tensor",
    "tensors_to_numpy",
    "triton_dtype_byte_size",
    "triton_to_np_dtype",
]


class InferenceServerException(Exception):
    """Exception raised for server- or client-side inference errors:
    ``message()``, ``status()`` (e.g. a gRPC status name) and
    ``debug_details()`` accessors."""

    def __init__(
        self,
        msg: str,
        status: Optional[str] = None,
        debug_details: Optional[str] = None,
    ):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        super().__init__(msg)

    def __str__(self) -> str:
        msg = super().__str__() if self._msg is None else self._msg
        if self._status is not None:
            msg = f"[{self._status}] {msg}"
        return msg

    def message(self) -> str:
        """The error message."""
        return self._msg

    def status(self) -> Optional[str]:
        """The error status code (e.g. gRPC status name), if any."""
        return self._status

    def debug_details(self) -> Optional[str]:
        """Low-level debug details (e.g. traceback), if any."""
        return self._debug_details


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Raises when CUDA is asked for (or implied by
    ``None``) and there is no card — the port never falls back to the
    CPU on its own."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return resolved


# ---------------------------------------------------------------------------
# dtype tables: KServe v2 wire dtype string <-> numpy dtype <-> torch dtype
# ---------------------------------------------------------------------------

_NP_TO_TRITON = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
    bfloat16: "BF16",
}

_TRITON_TO_NP = {v: k for k, v in _NP_TO_TRITON.items()}
_TRITON_TO_NP["BYTES"] = np.dtype(object)

_FIXED_BYTE_SIZES = {
    "BOOL": 1,
    "INT8": 1,
    "UINT8": 1,
    "INT16": 2,
    "UINT16": 2,
    "FP16": 2,
    "BF16": 2,
    "INT32": 4,
    "UINT32": 4,
    "FP32": 4,
    "INT64": 8,
    "UINT64": 8,
    "FP64": 8,
}

# host dtype of each torch dtype a model may return (bf16 via its bits)
_TORCH_TO_NP = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.uint8: np.dtype(np.uint8),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.bfloat16: bfloat16,
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}


def np_to_triton_dtype(np_dtype) -> Optional[str]:
    """Map a numpy dtype (or type) to a KServe v2 dtype string.

    Object/str/bytes dtypes map to ``"BYTES"``; unsupported dtypes give
    ``None``.
    """
    dt = np.dtype(np_dtype)
    if dt in _NP_TO_TRITON:
        return _NP_TO_TRITON[dt]
    if dt == np.dtype(object) or dt.kind in ("S", "U"):
        return "BYTES"
    return None


def np_to_torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a fixed-size numpy dtype (BF16 included)."""
    try:
        return _NP_TO_TORCH[np.dtype(np_dtype)]
    except KeyError:
        raise InferenceServerException(f"no torch dtype for {np_dtype}") from None


# TensorFlow wire dtype names <-> KServe: one map for the TFS compat
# front-end (server side) and the tfserving perf backend (client side)
KSERVE_TO_TF_DTYPE = {
    "FP32": "DT_FLOAT",
    "FP64": "DT_DOUBLE",
    "INT32": "DT_INT32",
    "INT64": "DT_INT64",
    "INT16": "DT_INT16",
    "INT8": "DT_INT8",
    "UINT8": "DT_UINT8",
    "UINT16": "DT_UINT16",
    "BOOL": "DT_BOOL",
    "BYTES": "DT_STRING",
}
TF_TO_KSERVE_DTYPE = {v: k for k, v in KSERVE_TO_TF_DTYPE.items()}


def triton_to_np_dtype(dtype: str):
    """Map a KServe v2 dtype string to a numpy dtype.

    ``"BYTES"`` maps to ``np.object_``; unknown strings return ``None``.
    """
    return _TRITON_TO_NP.get(dtype)


def triton_dtype_byte_size(dtype: str) -> int:
    """Per-element byte size of a fixed-size dtype; -1 for BYTES."""
    if dtype == "BYTES":
        return -1
    try:
        return _FIXED_BYTE_SIZES[dtype]
    except KeyError:
        raise InferenceServerException(f"unknown dtype '{dtype}'") from None


def num_elements(shape: Sequence[int]) -> int:
    """Total element count of ``shape`` (1 for rank-0)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# BYTES tensors: each element is a 4-byte little-endian length followed by
# the element's raw bytes, elements concatenated in row-major order.
# ---------------------------------------------------------------------------


def _element_to_bytes(obj) -> bytes:
    if isinstance(obj, bytes):
        return obj
    if isinstance(obj, bytearray):
        return bytes(obj)
    if isinstance(obj, str):
        return obj.encode("utf-8")
    return str(obj).encode("utf-8")


def serialize_byte_tensor(input_tensor: np.ndarray) -> np.ndarray:
    """Serialize a BYTES tensor into its flat binary representation.

    Accepts numpy arrays of dtype object (bytes/str elements), ``S`` or
    ``U``. Returns a 1-D ``np.uint8`` array (empty for zero elements).
    """
    arr = np.asarray(input_tensor)
    if arr.size == 0:
        return np.empty([0], dtype=np.uint8)
    if not (arr.dtype == np.dtype(object) or arr.dtype.kind in ("S", "U")):
        raise InferenceServerException(
            "cannot serialize bytes tensor: invalid dtype "
            f"{arr.dtype} (expected object/bytes/str)"
        )
    chunks: List[bytes] = []
    for obj in arr.flat:
        b = _element_to_bytes(obj)
        chunks.append(struct.pack("<I", len(b)))
        chunks.append(b)
    return np.frombuffer(b"".join(chunks), dtype=np.uint8)


def deserialize_bytes_tensor(encoded_tensor: Union[bytes, np.ndarray]) -> np.ndarray:
    """Inverse of :func:`serialize_byte_tensor`: a 1-D ``np.object_``
    array of ``bytes`` elements (the caller reshapes it)."""
    if isinstance(encoded_tensor, np.ndarray):
        buf = encoded_tensor.tobytes()
    else:
        buf = bytes(encoded_tensor)
    elems: List[bytes] = []
    offset = 0
    n = len(buf)
    while offset + 4 <= n:
        (length,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        if offset + length > n:
            raise InferenceServerException(
                "malformed BYTES tensor: element length "
                f"{length} overruns buffer of {n} bytes at offset {offset}"
            )
        elems.append(buf[offset : offset + length])
        offset += length
    if offset != n:
        raise InferenceServerException(
            f"malformed BYTES tensor: {n - offset} trailing bytes"
        )
    return np.array(elems, dtype=np.object_)


# ---------------------------------------------------------------------------
# BF16 tensors: 2 bytes an element on the wire. A float input is rounded
# to nearest even (ml_dtypes' conversion).
# ---------------------------------------------------------------------------


def serialize_bf16_tensor(input_tensor: np.ndarray) -> np.ndarray:
    """Serialize a BF16 tensor to its 2-byte-per-element wire form.

    Accepts :data:`bfloat16` arrays (a raw view) or float arrays
    (converted). Returns a 1-D ``np.uint8`` array.
    """
    arr = np.asarray(input_tensor)
    if arr.dtype != bfloat16:
        if arr.dtype.kind != "f":
            raise InferenceServerException(
                f"cannot serialize bf16 tensor from dtype {arr.dtype}"
            )
        arr = arr.astype(bfloat16)
    return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)


def deserialize_bf16_tensor(encoded_tensor: Union[bytes, np.ndarray]) -> np.ndarray:
    """Inverse of :func:`serialize_bf16_tensor`: a 1-D :data:`bfloat16`
    array."""
    try:
        if isinstance(encoded_tensor, np.ndarray):
            buf = np.ascontiguousarray(encoded_tensor).view(np.uint8)
            return buf.view(bfloat16).reshape(-1)
        return np.frombuffer(encoded_tensor, dtype=bfloat16)
    except ValueError as e:
        raise InferenceServerException(f"malformed BF16 tensor: {e}") from None


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def numpy_to_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (BF16 through its bits)."""
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:  # e.g. a view of a request body
        array = array.copy()
    if array.dtype == bfloat16:
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(array).to(device)


def tensors_to_numpy(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors`` through ONE device-to-host read: their
    bytes are packed into one buffer on the device, copied, and cut apart
    on the host. The read is the caller's one synchronisation with the
    device."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
    out, offset = [], 0
    for tensor, chunk in zip(tensors, flat):
        dtype = _TORCH_TO_NP.get(tensor.dtype)
        if dtype is None:
            raise InferenceServerException(f"unsupported tensor dtype {tensor.dtype}")
        size = chunk.numel()
        out.append(host[offset:offset + size].view(dtype).reshape(tuple(tensor.shape)))
        offset += size
    return out
