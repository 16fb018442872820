"""TPU shared-memory regions: the data plane that takes the place of
Triton's CUDA IPC, as the JAX package defines it.

An own copy of ``client_tpu/utils/tpu_shared_memory`` (without its slot
ring). A region is a POSIX shared-memory buffer that client and server
both map; its raw handle (:func:`get_raw_handle`) is the same JSON
document, ``{"kind": "tpu-host-pinned", "shm_key", "byte_size",
"device_id"}``, so a region either package creates registers with
either server. It is host memory: crossing to the card costs one copy
each way.

- :func:`set_shared_memory_region_from_torch` stages torch tensors: all
  the CUDA ones come back in ONE device-to-host read
  (:func:`client_tpu_torch.utils.tensors_to_numpy`), then one copy a
  tensor goes into the mapping; host tensors copy straight in.
- :func:`as_shared_memory_tensor` and :func:`get_contents_as_numpy` are
  zero-copy views of the mapping; :func:`as_torch_tensor` adds the one
  host-to-device copy.
"""

import json
import threading
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from client_tpu_torch.utils import (
    InferenceServerException,
    np_to_torch_dtype,
    num_elements,
    resolve_device,
    tensors_to_numpy,
    triton_to_np_dtype,
)
from client_tpu_torch.utils import shared_memory as _system_shm

_allocated_lock = threading.Lock()
_allocated_regions: Dict[str, "TpuSharedMemoryRegion"] = {}

HANDLE_KIND = "tpu-host-pinned"


class TpuSharedMemoryException(InferenceServerException):
    """Raised for TPU shared-memory errors."""


class TpuSharedMemoryRegion:
    """Handle to an allocated TPU shared-memory region."""

    def __init__(self, triton_shm_name: str, byte_size: int, device_id: int):
        self._name = triton_shm_name
        self._byte_size = byte_size
        self._device_id = device_id
        self._shm_key = f"client_tpu_shm_{uuid.uuid4().hex}"
        self._base = _system_shm.create_shared_memory_region(
            triton_shm_name, self._shm_key, byte_size, create_only=True
        )

    def name(self) -> str:
        return self._name

    def key(self) -> str:
        return self._shm_key

    def byte_size(self) -> int:
        return self._byte_size

    def device_id(self) -> int:
        return self._device_id

    def buf(self, offset: int = 0, length: Optional[int] = None) -> memoryview:
        return self._base.buf(offset, length)


def create_shared_memory_region(triton_shm_name: str, byte_size: int,
                                device_id: int = 0) -> TpuSharedMemoryRegion:
    """Allocate a region of ``byte_size`` bytes for card ``device_id``."""
    region = TpuSharedMemoryRegion(triton_shm_name, byte_size, device_id)
    with _allocated_lock:
        _allocated_regions[triton_shm_name] = region
    return region


def get_raw_handle(shm_handle: TpuSharedMemoryRegion) -> bytes:
    """The serialized handle to pass to ``register_tpu_shared_memory``."""
    return json.dumps({
        "kind": HANDLE_KIND,
        "shm_key": shm_handle.key(),
        "byte_size": shm_handle.byte_size(),
        "device_id": shm_handle.device_id(),
    }).encode("utf-8")


def _np_dtype(datatype) -> np.dtype:
    """A numpy dtype from a numpy dtype or a KServe dtype string."""
    if isinstance(datatype, str):
        np_dtype = triton_to_np_dtype(datatype)
        if np_dtype is None:
            raise TpuSharedMemoryException(f"unknown datatype '{datatype}'")
        return np_dtype
    return np.dtype(datatype)


def set_shared_memory_region(shm_handle: TpuSharedMemoryRegion, input_values,
                             offset: int = 0) -> None:
    """Copy numpy arrays into the region back to back from ``offset``."""
    if not isinstance(input_values, (list, tuple)):
        raise TpuSharedMemoryException("input_values must be a list/tuple of arrays")
    _system_shm.set_shared_memory_region(shm_handle, input_values, offset)


def set_shared_memory_region_from_torch(shm_handle: TpuSharedMemoryRegion, tensors,
                                        offset: int = 0) -> None:
    """Stage torch tensors into the region back to back from ``offset``.

    Every CUDA tensor comes back in ONE device-to-host read (one
    synchronisation, however many tensors), then each is copied once into
    the mapping; host tensors are copied straight in.
    """
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    tensors = list(tensors)
    on_card = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    hosts = {i: a for i, a in zip(on_card, tensors_to_numpy([tensors[i] for i in on_card]))}
    cursor = offset
    for i, tensor in enumerate(tensors):
        nbytes = tensor.numel() * tensor.element_size()
        view = shm_handle.buf(cursor, nbytes)  # bounds-checked even when empty
        if nbytes:
            target = torch.frombuffer(view, dtype=torch.uint8)
            if i in hosts:
                target.copy_(torch.from_numpy(hosts[i].reshape(-1).view(np.uint8)))
            else:
                target.copy_(tensor.detach().contiguous().reshape(-1).view(torch.uint8))
        cursor += nbytes


def set_shared_memory_region_from_dlpack(shm_handle: TpuSharedMemoryRegion, input_values,
                                         offset: int = 0) -> None:
    """Copy DLPack-exporting tensors (torch, numpy, ...) into the region:
    each is imported with ``torch.from_dlpack`` and staged as
    :func:`set_shared_memory_region_from_torch` does."""
    if not isinstance(input_values, (list, tuple)):
        input_values = [input_values]
    set_shared_memory_region_from_torch(
        shm_handle, [torch.from_dlpack(t) for t in input_values], offset)


def get_contents_as_numpy(shm_handle: TpuSharedMemoryRegion, datatype, shape: List[int],
                          offset: int = 0) -> np.ndarray:
    """The region's contents as numpy (zero-copy for fixed-size dtypes).
    ``datatype`` is a numpy dtype or a KServe dtype string ("BF16"...)."""
    return _system_shm.get_contents_as_numpy(shm_handle, _np_dtype(datatype), shape, offset)


def as_shared_memory_tensor(shm_handle: TpuSharedMemoryRegion, datatype, shape: List[int],
                            offset: int = 0) -> torch.Tensor:
    """A host torch tensor viewing the region (zero-copy; it exports
    DLPack, so ``np.from_dlpack`` and other frameworks import it without a
    copy too)."""
    np_dtype = _np_dtype(datatype)
    if np_dtype == np.dtype(object):
        raise TpuSharedMemoryException(
            f"datatype '{datatype}' cannot be viewed as a DLPack tensor"
        )
    dtype = np_to_torch_dtype(np_dtype)
    count = num_elements(shape)
    view = shm_handle.buf(offset, count * np_dtype.itemsize)
    if count == 0:  # torch.frombuffer refuses an empty buffer
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(view, dtype=dtype).reshape(shape)


def as_torch_tensor(shm_handle: TpuSharedMemoryRegion, datatype, shape: List[int],
                    offset: int = 0, device=None) -> torch.Tensor:
    """The region's contents as a tensor on ``device`` (``cuda`` unless the
    caller asks for another): one host-to-device copy from the mapping."""
    device = resolve_device(device)
    host = as_shared_memory_tensor(shm_handle, datatype, shape, offset)
    return host.to(device, copy=True)


def allocated_shared_memory_regions() -> List[str]:
    """Names of TPU regions currently allocated by this process."""
    with _allocated_lock:
        return list(_allocated_regions.keys())


def destroy_shared_memory_region(shm_handle: TpuSharedMemoryRegion) -> None:
    """Free the region (unmap and unlink its shared-memory file)."""
    with _allocated_lock:
        _allocated_regions.pop(shm_handle.name(), None)
    _system_shm.destroy_shared_memory_region(shm_handle._base)
