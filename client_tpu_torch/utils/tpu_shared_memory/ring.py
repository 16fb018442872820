"""Fixed-layout shared-memory ring: the zero-round-trip small-tensor plane.

An own copy of ``client_tpu/utils/tpu_shared_memory/ring.py``, byte for
byte the same layout, so a ring either package creates serves with
either server. Where the JAX package stages a ``jax.Array``, this one
stages a torch tensor (on any device, bfloat16 included): one
device-to-host read a tensor.

The named-region shm path (``create_shared_memory_region`` +
``register_tpu_shared_memory`` + per-input ``shared_memory_region``
parameters) amortizes *registration* but still pays per-request costs
that swamp the copy savings at small tensor sizes: per-tensor parameter
maps on the wire, per-request region lookups, and a response that must
round-trip output staging through the same machinery. The ring closes
that gap with ONE pre-registered region laid out as fixed-size slots:

* the client packs a whole request's tensors into a free slot (name/
  dtype/shape/data framing, one memcpy per tensor) and sends a request
  whose only payload is three integers of parameters
  (``shm_ring_region``/``shm_ring_slot``/``shm_ring_seq``);
* the server reads the slot zero-copy, runs the model, writes the
  response tensors back into the *same* slot, and answers with a slim
  acknowledgement — no tensor bytes cross the wire in either direction;
* a per-slot sequence number + state word make torn writes, stale
  retries, and double-completions detectable instead of corrupting.

Region layout (all little-endian)::

    header (64 B): magic "TPURING1" | version u32 | slot_size u32 |
                   n_slots u32 | reserved
    slot[i] at 64 + i*slot_size:
        state u32 (0 free, 1 request, 2 busy, 3 response, 4 error)
        seq u32   (client-incremented per use; echoed in the request)
        payload_len u32 | reserved u32
        payload (slot_size - 16 bytes):
            n_tensors u32, then per tensor:
                name_len u16 | name | dtype_len u8 | dtype |
                ndim u8 | ndim * i64 shape | data_len u32 | data

The framing is shared verbatim by the server side
(:mod:`client_tpu_torch.server.shm_ring`), so client and server can never
drift on the byte layout.
"""

import struct
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    np_to_triton_dtype,
    serialize_byte_tensor,
    tensors_to_numpy,
    triton_to_np_dtype,
)
from client_tpu_torch.utils import tpu_shared_memory as tpushm

MAGIC = b"TPURING1"
VERSION = 1
HEADER_SIZE = 64
SLOT_HEADER_SIZE = 16

STATE_FREE = 0
STATE_REQUEST = 1
STATE_BUSY = 2
STATE_RESPONSE = 3
STATE_ERROR = 4

PARAM_REGION = "shm_ring_region"
PARAM_SLOT = "shm_ring_slot"
PARAM_SEQ = "shm_ring_seq"
PARAM_BYTES = "shm_ring_bytes"

_HEADER = struct.Struct("<8sIII")
_SLOT_HEADER = struct.Struct("<IIII")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")


class ShmRingError(InferenceServerException):
    """Client-side ring protocol violation."""


def write_region_header(buf, slot_size: int, n_slots: int) -> None:
    """Stamp the ring header into a freshly allocated region."""
    buf[:HEADER_SIZE] = b"\x00" * HEADER_SIZE
    _HEADER.pack_into(buf, 0, MAGIC, VERSION, slot_size, n_slots)


def read_region_header(buf) -> Tuple[int, int]:
    """Validate the header; returns (slot_size, n_slots)."""
    if len(buf) < HEADER_SIZE:
        raise ShmRingError(
            f"shm ring region is {len(buf)} bytes; too small for the "
            f"{HEADER_SIZE}-byte ring header"
        )
    magic, version, slot_size, n_slots = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ShmRingError(
            "shm ring region has no TPURING1 header (not a ring, or a "
            "torn header write)"
        )
    if version != VERSION:
        raise ShmRingError(
            f"shm ring version {version} is not supported (want {VERSION})"
        )
    if slot_size <= SLOT_HEADER_SIZE or n_slots <= 0:
        raise ShmRingError(
            f"shm ring header is malformed: slot_size {slot_size}, "
            f"n_slots {n_slots}"
        )
    if HEADER_SIZE + slot_size * n_slots > len(buf):
        raise ShmRingError(
            f"shm ring header declares {n_slots} x {slot_size} B slots "
            f"but the region holds only {len(buf)} bytes"
        )
    return slot_size, n_slots


def slot_offset(slot: int, slot_size: int) -> int:
    return HEADER_SIZE + slot * slot_size


def pack_tensors(
    payload: "memoryview", tensors: Sequence[Tuple[str, Any]]
) -> int:
    """Write the tensor framing into a slot payload view; returns the
    payload length in bytes. Raises when the slot is too small. A tensor
    is an array or a torch tensor (read to the host once)."""
    capacity = len(payload)
    pos = 4
    count = 0
    for name, arr in tensors:
        if isinstance(arr, torch.Tensor):
            (arr,) = tensors_to_numpy([arr])
        arr = np.asarray(arr)
        if arr.dtype == np.dtype(object) or arr.dtype.kind in ("S", "U"):
            datatype = "BYTES"
            data = serialize_byte_tensor(arr).tobytes()
        else:
            datatype = np_to_triton_dtype(arr.dtype)
            if datatype is None:
                raise ShmRingError(
                    f"unsupported dtype {arr.dtype} for ring tensor '{name}'"
                )
            data = np.ascontiguousarray(arr)
        name_b = name.encode("utf-8")
        dtype_b = datatype.encode("utf-8")
        shape = arr.shape
        nbytes = data.nbytes if isinstance(data, np.ndarray) else len(data)
        need = 2 + len(name_b) + 1 + len(dtype_b) + 1 + 8 * len(shape) + 4 + nbytes
        if pos + need > capacity:
            raise ShmRingError(
                f"ring slot too small: request needs {pos + need} bytes, "
                f"slot payload holds {capacity}"
            )
        _U16.pack_into(payload, pos, len(name_b))
        pos += 2
        payload[pos : pos + len(name_b)] = name_b
        pos += len(name_b)
        payload[pos] = len(dtype_b)
        pos += 1
        payload[pos : pos + len(dtype_b)] = dtype_b
        pos += len(dtype_b)
        payload[pos] = len(shape)
        pos += 1
        for dim in shape:
            _I64.pack_into(payload, pos, dim)
            pos += 8
        _U32.pack_into(payload, pos, nbytes)
        pos += 4
        if isinstance(data, np.ndarray):
            payload[pos : pos + nbytes] = data.reshape(-1).view(np.uint8)
        else:
            payload[pos : pos + nbytes] = data
        pos += nbytes
        count += 1
    _U32.pack_into(payload, 0, count)
    return pos


def unpack_tensors(
    payload: "memoryview", payload_len: int
) -> List[Tuple[str, str, List[int], "memoryview"]]:
    """Read the tensor framing from a slot payload view; returns
    (name, datatype, shape, data view) per tensor — data stays a
    zero-copy view into the mapping."""
    if payload_len < 4 or payload_len > len(payload):
        raise ShmRingError(
            f"ring payload length {payload_len} is out of bounds "
            f"(payload capacity {len(payload)})"
        )
    (count,) = _U32.unpack_from(payload, 0)
    pos = 4
    tensors = []
    try:
        for _ in range(count):
            (name_len,) = _U16.unpack_from(payload, pos)
            pos += 2
            name = bytes(payload[pos : pos + name_len]).decode("utf-8")
            pos += name_len
            dtype_len = payload[pos]
            pos += 1
            datatype = bytes(payload[pos : pos + dtype_len]).decode("utf-8")
            pos += dtype_len
            ndim = payload[pos]
            pos += 1
            shape = []
            for _ in range(ndim):
                shape.append(_I64.unpack_from(payload, pos)[0])
                pos += 8
            (nbytes,) = _U32.unpack_from(payload, pos)
            pos += 4
            if pos + nbytes > payload_len:
                raise ShmRingError(
                    f"ring tensor '{name}' data ({nbytes} B at {pos}) "
                    f"exceeds the declared payload ({payload_len} B): "
                    "torn or stale slot write"
                )
            tensors.append((name, datatype, shape, payload[pos : pos + nbytes]))
            pos += nbytes
    except (struct.error, IndexError, UnicodeDecodeError):
        raise ShmRingError(
            "ring slot framing is truncated: torn or stale slot write"
        ) from None
    return tensors


def view_as_numpy(datatype: str, shape: List[int], data: "memoryview") -> np.ndarray:
    """Tensor view helper shared by both ends (zero-copy except BYTES)."""
    if datatype == "BYTES":
        return deserialize_bytes_tensor(bytes(data)).reshape(shape)
    np_dtype = triton_to_np_dtype(datatype)
    if np_dtype is None:
        raise ShmRingError(f"unknown ring tensor datatype '{datatype}'")
    return np.frombuffer(data, dtype=np_dtype).reshape(shape)


class RingTicket:
    """One staged request: a claimed slot + its sequence number."""

    __slots__ = ("slot", "seq", "parameters")

    def __init__(self, slot: int, seq: int, region_name: str):
        self.slot = slot
        self.seq = seq
        self.parameters = {
            PARAM_REGION: region_name,
            PARAM_SLOT: slot,
            PARAM_SEQ: seq,
        }


class ShmRing:
    """Client side of the slot ring over one TPU shared-memory region.

    Create once, register once (``register(client)`` /
    ``await aregister(client)``), then per request::

        ticket = ring.stage([("INPUT0", arr0), ("INPUT1", arr1)])
        result = client.infer("simple", [], parameters=ticket.parameters)
        outputs = ring.take_response(ticket)   # {name: ndarray}
        ring.release(ticket)

    ``stage`` blocks (up to ``acquire_timeout_s``) when every slot is in
    flight. Thread-safe; one asyncio loop or N threads can share a ring
    as long as each ticket is released exactly once.
    """

    def __init__(
        self,
        n_slots: int = 32,
        slot_size: int = 8192,
        name: Optional[str] = None,
        device_id: int = 0,
        acquire_timeout_s: float = 30.0,
    ):
        if n_slots <= 0 or slot_size <= SLOT_HEADER_SIZE:
            raise ShmRingError(
                f"bad ring geometry: {n_slots} slots x {slot_size} B"
            )
        self.n_slots = n_slots
        self.slot_size = slot_size
        # uuid, not id(): forked workers constructing a ring at the same
        # code point can land on identical heap addresses, and a name
        # collision fails the second worker's registration outright
        self.region_name = name or f"ctpu_ring_{uuid.uuid4().hex[:16]}"
        self._acquire_timeout_s = acquire_timeout_s
        total = HEADER_SIZE + n_slots * slot_size
        self._handle = tpushm.create_shared_memory_region(
            self.region_name, total, device_id
        )
        self._buf = self._handle.buf(0, total)
        write_region_header(self._buf, slot_size, n_slots)
        self._lock = threading.Lock()
        self._free_cv = threading.Condition(self._lock)
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self._seqs = [0] * n_slots
        self._staged = 0  # lifetime staged-request counter (wraparound test)

    # -- registration --------------------------------------------------------

    def raw_handle(self) -> bytes:
        return tpushm.get_raw_handle(self._handle)

    def byte_size(self) -> int:
        return self._handle.byte_size()

    def register(self, client) -> None:
        """Register the backing region with a sync protocol client."""
        client.register_tpu_shared_memory(
            self.region_name,
            self.raw_handle(),
            self._handle.device_id(),
            self.byte_size(),
        )

    async def aregister(self, client) -> None:
        """Register the backing region with an asyncio protocol client."""
        await client.register_tpu_shared_memory(
            self.region_name,
            self.raw_handle(),
            self._handle.device_id(),
            self.byte_size(),
        )

    # -- slot lifecycle ------------------------------------------------------

    def _slot_view(self, slot: int) -> "memoryview":
        off = slot_offset(slot, self.slot_size)
        return self._buf[off : off + self.slot_size]

    def stage(self, inputs: Sequence[Tuple[str, Any]]) -> RingTicket:
        """Claim a free slot and pack ``inputs`` into it."""
        with self._free_cv:
            if not self._free and not self._free_cv.wait_for(
                lambda: bool(self._free), timeout=self._acquire_timeout_s
            ):
                raise ShmRingError(
                    f"no free ring slot after {self._acquire_timeout_s}s "
                    f"({self.n_slots} slots, all in flight)"
                )
            slot = self._free.pop()
            self._seqs[slot] = seq = (self._seqs[slot] + 1) & 0xFFFFFFFF
            self._staged += 1
        view = self._slot_view(slot)
        payload = view[SLOT_HEADER_SIZE:]
        try:
            payload_len = pack_tensors(payload, inputs)
        except Exception:
            self.release(RingTicket(slot, seq, self.region_name))
            raise
        _SLOT_HEADER.pack_into(view, 0, STATE_REQUEST, seq, payload_len, 0)
        return RingTicket(slot, seq, self.region_name)

    def take_response(
        self, ticket: RingTicket, copy: bool = True
    ) -> Dict[str, np.ndarray]:
        """Read the server's response tensors out of the ticket's slot.

        With ``copy=False`` the arrays are views into the mapping and
        are valid only until :meth:`release`."""
        view = self._slot_view(ticket.slot)
        state, seq, payload_len, _ = _SLOT_HEADER.unpack_from(view, 0)
        if state != STATE_RESPONSE or seq != ticket.seq:
            raise ShmRingError(
                f"ring slot {ticket.slot} has no response for seq "
                f"{ticket.seq} (state {state}, slot seq {seq})"
            )
        outputs: Dict[str, np.ndarray] = {}
        for name, datatype, shape, data in unpack_tensors(
            view[SLOT_HEADER_SIZE:], payload_len
        ):
            arr = view_as_numpy(datatype, shape, data)
            outputs[name] = arr.copy() if copy else arr
        return outputs

    def release(self, ticket: RingTicket) -> None:
        """Return the ticket's slot to the free pool."""
        view = self._slot_view(ticket.slot)
        _SLOT_HEADER.pack_into(view, 0, STATE_FREE, ticket.seq, 0, 0)
        with self._free_cv:
            if ticket.slot not in self._free:
                self._free.append(ticket.slot)
                self._free_cv.notify()

    @property
    def staged_total(self) -> int:
        return self._staged

    # -- convenience ---------------------------------------------------------

    def infer(
        self,
        client,
        model_name: str,
        inputs: Sequence[Tuple[str, np.ndarray]],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, np.ndarray]:
        """One ring inference through a sync protocol client.

        Outputs are COPIES (the slot is released before returning). For
        zero-copy reads use the staged API — ``stage`` / send /
        ``take_response(..., copy=False)`` / ``release`` — and release
        only after you are done with the views."""
        ticket = self.stage(inputs)
        try:
            params = dict(parameters or {})
            params.update(ticket.parameters)
            client.infer(
                model_name,
                [],
                model_version=model_version,
                request_id=request_id,
                parameters=params,
            )
            return self.take_response(ticket, copy=True)
        finally:
            self.release(ticket)

    async def ainfer(
        self,
        client,
        model_name: str,
        inputs: Sequence[Tuple[str, np.ndarray]],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, np.ndarray]:
        """One ring inference through an asyncio protocol client.
        Outputs are COPIES — see :meth:`infer` for the zero-copy path."""
        ticket = self.stage(inputs)
        try:
            params = dict(parameters or {})
            params.update(ticket.parameters)
            await client.infer(
                model_name,
                [],
                model_version=model_version,
                request_id=request_id,
                parameters=params,
            )
            return self.take_response(ticket, copy=True)
        finally:
            self.release(ticket)

    def close(self) -> None:
        """Free the backing region (unregister with the server first)."""
        self._buf = None
        tpushm.destroy_shared_memory_region(self._handle)
