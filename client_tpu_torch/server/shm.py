"""Server-side shared-memory region manager.

An own copy of ``client_tpu/server/shm.py``. It tracks the regions that
clients register over the system and TPU shared-memory extensions and maps
them into the server process. The server reads request inputs from, and
writes requested outputs into, these mappings.

A TPU region is a POSIX shared-memory buffer too: its raw handle (from
``client_tpu_torch.utils.tpu_shared_memory.get_raw_handle`` or the JAX
package's twin) is a JSON document naming the key behind it. Both kinds
map alike and are tracked apart, so the per-kind status and unregister
routes see only their own.
"""

import json
import mmap
import os
import threading
from typing import Any, Dict, Optional

from client_tpu_torch.utils import InferenceServerException

SHM_DIR = "/dev/shm"


class _Region:
    def __init__(self, name: str, kind: str, key: str, offset: int, byte_size: int,
                 device_id: int = 0):
        self.name = name
        self.kind = kind  # "system" | "tpu"
        self.key = key
        self.offset = offset
        self.byte_size = byte_size
        self.device_id = device_id
        try:
            self._fd = os.open(os.path.join(SHM_DIR, key.lstrip("/")), os.O_RDWR)
        except OSError as e:
            raise InferenceServerException(
                f"failed to open shared memory region '{name}' (key '{key}'): {e}"
            ) from None
        try:
            total = os.fstat(self._fd).st_size
            if offset < 0 or byte_size < 0 or offset + byte_size > total:
                raise InferenceServerException(
                    f"shared memory region '{name}' (key '{key}') is {total} bytes; "
                    f"cannot map offset {offset} + byte_size {byte_size}"
                )
            self._map = mmap.mmap(self._fd, total)
        except BaseException:
            os.close(self._fd)
            raise

    def same_as(self, other: "_Region") -> bool:
        return (self.kind, self.key, self.offset, self.byte_size) == (
            other.kind, other.key, other.offset, other.byte_size)

    def view(self, offset: int, byte_size: int) -> memoryview:
        start = self.offset + offset
        end = start + byte_size
        if offset < 0 or byte_size < 0 or end > self.offset + self.byte_size:
            raise InferenceServerException(
                f"invalid offset/byte_size for shared memory region '{self.name}': "
                f"{offset}+{byte_size} exceeds region size {self.byte_size}"
            )
        return memoryview(self._map)[start:end]

    def close(self) -> None:
        try:
            self._map.close()
        except BufferError:
            # zero-copy views of the mapping are still alive (decode_input
            # hands them to in-flight requests): the mapping unmaps when
            # the last of them goes; the fd is released now
            pass
        finally:
            os.close(self._fd)


class SharedMemoryManager:
    """name -> mapped region registry (thread-safe)."""

    def __init__(self):
        self._regions: Dict[str, _Region] = {}
        self._lock = threading.Lock()

    def register_system(self, name: str, key: str, offset: int, byte_size: int) -> None:
        self._register(_Region(name, "system", key, offset, byte_size))

    def register_tpu(self, name: str, raw_handle: bytes, device_id: int,
                     byte_size: int) -> None:
        try:
            handle = json.loads(bytes(raw_handle).decode("utf-8"))
            key = handle["shm_key"]
            handle_size = int(handle.get("byte_size", byte_size))
        except (UnicodeDecodeError, json.JSONDecodeError, KeyError, TypeError,
                AttributeError, ValueError) as e:
            raise InferenceServerException(
                f"malformed TPU shared-memory raw handle for region '{name}': {e}"
            ) from None
        if handle_size < byte_size:
            raise InferenceServerException(
                f"TPU shared-memory region '{name}': registered byte_size {byte_size} "
                f"exceeds handle's buffer size {handle_size}"
            )
        self._register(_Region(name, "tpu", key, 0, byte_size, device_id=device_id))

    def _register(self, region: _Region) -> None:
        with self._lock:
            existing = self._regions.get(region.name)
            if existing is None:
                self._regions[region.name] = region
                return
        region.close()
        # re-registration with identical parameters is idempotent
        if not existing.same_as(region):
            raise InferenceServerException(
                f"shared memory region '{region.name}' already registered with "
                "different parameters"
            )

    def unregister(self, name: str, kind: Optional[str] = None) -> None:
        """Drop ``name``; an unknown name is a no-op (Triton's semantics),
        a region of another kind than ``kind`` an error."""
        with self._lock:
            region = self._regions.get(name)
            if region is None:
                return
            if kind is not None and region.kind != kind:
                raise InferenceServerException(
                    f"shared memory region '{name}' is of kind '{region.kind}', "
                    f"not '{kind}'"
                )
            del self._regions[name]
        region.close()

    def unregister_all(self, kind: Optional[str] = None) -> None:
        with self._lock:
            names = [n for n, r in self._regions.items() if kind is None or r.kind == kind]
            regions = [self._regions.pop(n) for n in names]
        for region in regions:
            region.close()

    def status(self, kind: str, name: str = "") -> Dict[str, Dict[str, Any]]:
        """The regions of ``kind`` (or the one called ``name``), keyed by
        name, in the JAX server's keys."""
        with self._lock:
            result = {}
            for n, r in self._regions.items():
                if r.kind != kind or (name and n != name):
                    continue
                if kind == "system":
                    result[n] = {"name": n, "key": r.key, "offset": r.offset,
                                 "byte_size": r.byte_size}
                else:
                    result[n] = {"name": n, "device_id": r.device_id,
                                 "byte_size": r.byte_size, "key": r.key}
            return result

    def region(self, name: str) -> Optional[_Region]:
        """The registered region ``name``, or None."""
        with self._lock:
            return self._regions.get(name)

    def read(self, name: str, offset: int, byte_size: int) -> memoryview:
        """A writable view of ``byte_size`` bytes at ``offset`` of region
        ``name``, bounds-checked against its registered size."""
        region = self.region(name)
        if region is None:
            raise InferenceServerException(f"Unable to find shared memory region: '{name}'")
        return region.view(offset, byte_size)

    def write(self, name: str, offset: int, data) -> None:
        """Copy ``data`` (any bytes-like object) into region ``name`` at
        ``offset``."""
        data = memoryview(data).cast("B")
        self.read(name, offset, len(data))[:] = data
