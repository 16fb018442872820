"""System (POSIX) shared-memory regions: the client side of the system
shared-memory extension.

An own copy of ``client_tpu/utils/shared_memory``: a region is a file
under ``/dev/shm`` mapped with ``mmap``, named by its key, so a region one
package creates the other maps. Writes are one copy into the mapping;
fixed-size reads are zero-copy views of it.
"""

import mmap
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from client_tpu_torch.utils import (
    deserialize_bytes_tensor,
    num_elements,
    serialize_byte_tensor,
)

SHM_DIR = "/dev/shm"

_mapped_lock = threading.Lock()
_mapped_regions: Dict[str, "SharedMemoryRegion"] = {}


class SharedMemoryException(Exception):
    """Exception raised for shared-memory errors (errno-style messages)."""

    def __init__(self, err: str):
        self.err = err
        super().__init__(err)

    def __str__(self) -> str:
        return self.err


class SharedMemoryRegion:
    """Handle to a created or attached system shared-memory region."""

    def __init__(self, triton_shm_name: str, shm_key: str, fd: int,
                 mapping: mmap.mmap, byte_size: int):
        self._triton_shm_name = triton_shm_name
        self._shm_key = shm_key
        self._fd = fd
        self._map = mapping
        self._byte_size = byte_size
        self._closed = False

    def name(self) -> str:
        return self._triton_shm_name

    def key(self) -> str:
        return self._shm_key

    def byte_size(self) -> int:
        return self._byte_size

    def offset(self) -> int:
        return 0

    def buf(self, offset: int = 0, length: Optional[int] = None) -> memoryview:
        """A writable memoryview over [offset, offset+length) of the region."""
        if self._closed:
            raise SharedMemoryException("unable to access destroyed shared memory region")
        end = self._byte_size if length is None else offset + length
        if offset < 0 or end > self._byte_size:
            raise SharedMemoryException(
                "unable to access shared memory region beyond its size"
            )
        return memoryview(self._map)[offset:end]

    def _close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._map.close()
        except BufferError:
            # zero-copy views still reference the mapping: it unmaps when
            # the last of them goes; the fd and the name are released now
            pass
        finally:
            os.close(self._fd)
        try:
            os.unlink(_shm_path(self._shm_key))
        except FileNotFoundError:
            pass


def _shm_path(shm_key: str) -> str:
    return os.path.join(SHM_DIR, shm_key.lstrip("/"))


def create_shared_memory_region(triton_shm_name: str, shm_key: str, byte_size: int,
                                create_only: bool = False) -> SharedMemoryRegion:
    """Create (or attach to) the region named ``shm_key``.

    ``create_only=True`` fails if the key already exists; otherwise an
    existing region is attached and grown to ``byte_size`` if needed.
    """
    if byte_size < 0:
        raise SharedMemoryException(
            "unable to create shared memory region: negative byte_size"
        )
    flags = os.O_RDWR | os.O_CREAT
    if create_only:
        flags |= os.O_EXCL
    try:
        fd = os.open(_shm_path(shm_key), flags, 0o600)
    except FileExistsError:
        raise SharedMemoryException(
            f"unable to create the shared memory region, already exists: '{shm_key}'"
        ) from None
    except OSError as e:
        raise SharedMemoryException(
            f"unable to create the shared memory region: {e}"
        ) from None
    try:
        existing = os.fstat(fd).st_size
        if existing < byte_size:
            os.ftruncate(fd, byte_size)
        mapping = mmap.mmap(fd, max(byte_size, existing) or 1)
    except OSError as e:
        os.close(fd)
        raise SharedMemoryException(f"unable to map the shared memory region: {e}") from None
    region = SharedMemoryRegion(triton_shm_name, shm_key, fd, mapping, byte_size)
    with _mapped_lock:
        _mapped_regions[triton_shm_name] = region
    return region


def set_shared_memory_region(shm_handle: SharedMemoryRegion, input_values,
                             offset: int = 0) -> None:
    """Copy a list of numpy arrays into the region back to back from
    ``offset``, one copy each; BYTES (object, ``S`` or ``U``) arrays in
    their serialized wire form."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException("input_values must be a list/tuple of numpy arrays")
    cursor = offset
    for arr in input_values:
        arr = np.asarray(arr)
        if arr.dtype == np.dtype(object) or arr.dtype.kind in ("S", "U"):
            arr = serialize_byte_tensor(arr)
        arr = np.ascontiguousarray(arr)
        view = shm_handle.buf(cursor, arr.nbytes)
        np.frombuffer(view, dtype=np.uint8)[...] = arr.reshape(-1).view(np.uint8)
        cursor += arr.nbytes


def get_contents_as_numpy(shm_handle: SharedMemoryRegion, datatype, shape: List[int],
                          offset: int = 0) -> np.ndarray:
    """The region's contents as a numpy array of ``datatype``/``shape``:
    a zero-copy view for fixed-size dtypes; BYTES deserializes."""
    np_dtype = np.dtype(datatype)
    if np_dtype == np.dtype(object):
        return deserialize_bytes_tensor(bytes(shm_handle.buf(offset))).reshape(shape)
    view = shm_handle.buf(offset, num_elements(shape) * np_dtype.itemsize)
    return np.frombuffer(view, dtype=np_dtype).reshape(shape)


def mapped_shared_memory_regions() -> List[str]:
    """Names of regions currently mapped by this process."""
    with _mapped_lock:
        return list(_mapped_regions.keys())


def destroy_shared_memory_region(shm_handle: SharedMemoryRegion) -> None:
    """Unmap and unlink the region."""
    with _mapped_lock:
        _mapped_regions.pop(shm_handle.name(), None)
    shm_handle._close()
