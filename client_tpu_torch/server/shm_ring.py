"""Server side of the fixed-layout shared-memory ring.

An own copy of ``client_tpu/server/shm_ring.py`` over the port's
:class:`~client_tpu_torch.server.shm.SharedMemoryManager`; the slots in
use export as ``tpu_shm_ring_slots_in_use{region}``.

Framing and layout live in :mod:`client_tpu_torch.utils.tpu_shared_memory.ring`
(one source of truth for both ends); this module adds what only the
server knows: resolving ``shm_ring_region`` parameters against the
registered-region table, validating slot state/sequence before trusting
client-written bytes (a torn or stale write is a clean INVALID_ARGUMENT,
never a crash or a wrong answer), and writing response tensors back into
the slot so the wire acknowledgement stays tens of bytes.

Front-end contract (all front-ends share it):

* after building the CoreRequest, call :func:`attach` — it pops the ring
  parameters (they must never reach the batch signature: the slot number
  differs per request and would fragment batches), reads the slot's
  tensors into ``request.inputs`` zero-copy, and leaves a
  :class:`RingTicket` on ``request.shm_ring``;
* after the core produces a CoreResponse, call ``ticket.complete(resp)``
  — it packs the outputs into the same slot and returns the slim
  acknowledgement response to serialize instead.

A ring request against a server that no longer has the region (restart
with a live client ring) fails with an *unavailable* message so both
protocols surface it as the JAX server does (HTTP: 400 with that
message; the reference's gRPC front-end maps it to UNAVAILABLE) — the
client re-registers and carries on; the bytes in its mapping are
untouched.
"""

import struct
import threading
from typing import Any, Dict, List, Optional

from client_tpu_torch.utils import InferenceServerException
from client_tpu_torch.utils.tpu_shared_memory import ring as ringfmt

_SLOT_HEADER = struct.Struct("<IIII")


class RingTicket:
    """One in-flight ring request on the server side.

    The ticket is the ONCE-ONLY completion surface: ``complete``/
    ``fail`` close the read_request accounting exactly once no matter
    how many error paths also call ``fail()`` afterwards (the in-use
    count books per ticket, not per slot peek)."""

    __slots__ = ("_ring", "slot", "seq", "_open")

    def __init__(self, ring: "ServerShmRing", slot: int, seq: int):
        self._ring = ring
        self.slot = slot
        self.seq = seq
        self._open = True

    def complete(self, response) -> Any:
        """Pack ``response`` outputs into the slot; returns the slim
        acknowledgement CoreResponse to put on the wire. Raises (with
        the slot marked errored and the accounting closed) when the
        response does not fit or the slot was re-staged underneath us —
        a stale completion must never scribble over a newer request."""
        if not self._open:
            raise InferenceServerException(
                f"shm ring '{self._ring.name}' slot {self.slot} ticket "
                "already completed"
            )
        self._open = False
        return self._ring.write_response(self.slot, self.seq, response)

    def fail(self) -> None:
        """Mark the slot errored (the RPC error carries the details).
        Idempotent: later calls (or a call after ``complete``) no-op."""
        if self._open:
            self._open = False
            self._ring.fail(self.slot, self.seq)


class ServerShmRing:
    """A validated ring over one registered region's mapping."""

    def __init__(self, name: str, region, metrics=None):
        import numpy as np

        self.name = name
        self._region = region
        buf = region.view(0, region.byte_size)
        self.slot_size, self.n_slots = ringfmt.read_region_header(buf)
        self._buf = buf
        # byte view of the whole mapping, for output-aliasing detection
        # (np.may_share_memory is a cheap bounds check)
        self._np_view = np.frombuffer(buf, dtype=np.uint8)
        self._metrics = metrics
        self._lock = threading.Lock()
        self._in_use = 0

    @property
    def region(self):
        return self._region

    def _slot_view(self, slot: int):
        if not 0 <= slot < self.n_slots:
            raise InferenceServerException(
                f"shm ring '{self.name}' has {self.n_slots} slots; "
                f"slot {slot} is out of range"
            )
        off = ringfmt.slot_offset(slot, self.slot_size)
        return self._buf[off : off + self.slot_size]

    def _book(self, delta: int) -> None:
        with self._lock:
            self._in_use += delta
            value = self._in_use
        if self._metrics is not None:
            self._metrics.set_ring_slots(self.name, value)

    def read_request(self, slot: int, seq: int) -> List[Any]:
        """Validate + read the request tensors from ``slot`` (zero-copy
        views into the mapping). Transitions the slot to BUSY."""
        from client_tpu_torch.server.core import CoreTensor

        view = self._slot_view(slot)
        state, slot_seq, payload_len, _ = _SLOT_HEADER.unpack_from(view, 0)
        if state != ringfmt.STATE_REQUEST:
            raise InferenceServerException(
                f"shm ring '{self.name}' slot {slot} is not in the "
                f"request-ready state (state {state}): torn write or "
                "double submission"
            )
        if slot_seq != seq:
            raise InferenceServerException(
                f"shm ring '{self.name}' slot {slot} carries seq "
                f"{slot_seq} but the request names seq {seq}: stale or "
                "torn slot write"
            )
        tensors = []
        try:
            for name, datatype, shape, data in ringfmt.unpack_tensors(
                view[ringfmt.SLOT_HEADER_SIZE :], payload_len
            ):
                if datatype != "BYTES":
                    # read-only view, same contract as decode_input's shm
                    # path: a model mutating its input raises instead of
                    # corrupting the client's slot
                    data = data.toreadonly()
                arr = ringfmt.view_as_numpy(datatype, shape, data)
                tensors.append(CoreTensor(name, datatype, list(shape), arr))
        except InferenceServerException:
            raise
        except (ValueError, TypeError) as e:
            # inconsistent framing that passed the bounds checks (e.g.
            # data_len not matching shape x dtype): the client's fault,
            # surfaced cleanly — never a bare 500
            raise InferenceServerException(
                f"shm ring '{self.name}' slot {slot} framing is "
                f"inconsistent: {e}"
            ) from None
        _SLOT_HEADER.pack_into(view, 0, ringfmt.STATE_BUSY, seq, payload_len, 0)
        self._book(+1)
        return tensors

    def write_response(self, slot: int, seq: int, response) -> Any:
        """Pack the response outputs into the slot and return the slim
        wire response (no tensor payloads).

        Called exactly once per read ticket (RingTicket gates this), so
        it always closes the read's in-use accounting. The slot must
        still be (BUSY, seq): if the client abandoned the request and
        re-staged the slot, this stale completion is DROPPED with an
        error instead of corrupting the newer request's bytes."""
        from client_tpu_torch.server.core import CoreResponse

        import numpy as np

        view = self._slot_view(slot)
        self._book(-1)
        state, slot_seq, _, _ = _SLOT_HEADER.unpack_from(view, 0)
        if state != ringfmt.STATE_BUSY or slot_seq != seq:
            raise InferenceServerException(
                f"shm ring '{self.name}' slot {slot} was re-staged while "
                f"its request executed (state {state}, seq {slot_seq} vs "
                f"{seq}): stale completion dropped"
            )
        payload = view[ringfmt.SLOT_HEADER_SIZE :]
        # A model may return (a view of) its zero-copy ring input — e.g.
        # identity passthrough. Packing that back into the same slot
        # would be a self-overlapping copy (the response framing shifts
        # the data bytes), so snapshot any output aliasing the mapping.
        tensors = []
        for t in response.outputs:
            data = t.data
            if (
                isinstance(data, np.ndarray)
                and data.dtype.kind != "O"
                and np.may_share_memory(data, self._np_view)
            ):
                data = data.copy()
            tensors.append((t.name, data))
        try:
            payload_len = ringfmt.pack_tensors(payload, tensors)
        except Exception:
            # accounting already closed above; just mark our generation
            _SLOT_HEADER.pack_into(view, 0, ringfmt.STATE_ERROR, seq, 0, 0)
            raise
        _SLOT_HEADER.pack_into(
            view, 0, ringfmt.STATE_RESPONSE, seq, payload_len, 0
        )
        return CoreResponse(
            model_name=response.model_name,
            model_version=response.model_version,
            id=response.id,
            outputs=[],
            parameters={
                **response.parameters,
                ringfmt.PARAM_SLOT: slot,
                ringfmt.PARAM_SEQ: seq,
                ringfmt.PARAM_BYTES: payload_len,
            },
        )

    def fail(self, slot: int, seq: int) -> None:
        """Close an abandoned read ticket: books the in-use accounting
        (once — RingTicket gates callers) and marks the slot errored
        only while it is still OUR (BUSY, seq) generation, so a
        re-staged slot or an already-written response is never
        clobbered."""
        self._book(-1)
        try:
            view = self._slot_view(slot)
        except InferenceServerException:
            return
        state, slot_seq, _, _ = _SLOT_HEADER.unpack_from(view, 0)
        if state != ringfmt.STATE_BUSY or slot_seq != seq:
            return
        _SLOT_HEADER.pack_into(view, 0, ringfmt.STATE_ERROR, seq, 0, 0)


class RingRegistry:
    """name -> ServerShmRing cache over the shared-memory manager.

    Rings are validated once per registration: the cache entry is keyed
    on the *region object*, so an unregister/re-register cycle (or a
    server restart, which empties the manager) can never serve a stale
    mapping."""

    def __init__(self, shm_manager, metrics=None):
        self._shm = shm_manager
        self._metrics = metrics
        self._rings: Dict[str, ServerShmRing] = {}
        self._lock = threading.Lock()

    def prune(self) -> None:
        """Evict cached rings whose region is gone or replaced — without
        this, each ring pins its full mapping for the server's lifetime:
        ring names rotate per client run, so the cache would only ever
        grow. Cheap (the live ring set is small); runs on every lookup."""
        with self._lock:
            stale = [
                name
                for name, ring in self._rings.items()
                if self._shm.region(name) is not ring.region
            ]
            for name in stale:
                del self._rings[name]
        if self._metrics is not None:
            for name in stale:
                self._metrics.remove_ring_region(name)

    def get(self, name: str) -> ServerShmRing:
        self.prune()
        region = self._shm.region(name)
        if region is None:
            raise InferenceServerException(
                f"shm ring region '{name}' is unavailable: not registered "
                "with this server (was the server restarted?); re-register "
                "the ring region and retry"
            )
        with self._lock:
            ring = self._rings.get(name)
            if ring is not None and ring.region is region:
                return ring
        ring = ServerShmRing(name, region, metrics=self._metrics)
        with self._lock:
            current = self._rings.get(name)
            if current is not None and current.region is region:
                return current
            self._rings[name] = ring
        return ring


def attach(core, request) -> Optional[RingTicket]:
    """Resolve ring parameters on a decoded CoreRequest (if any).

    Pops the ``shm_ring_*`` parameters, reads the slot's tensors into
    ``request.inputs``, and stores the ticket on ``request.shm_ring``.
    Returns the ticket (None for non-ring requests). Raises
    InferenceServerException on any protocol violation.
    """
    params = request.parameters
    if not params or ringfmt.PARAM_REGION not in params:
        return None
    region_name = params.pop(ringfmt.PARAM_REGION)
    slot = params.pop(ringfmt.PARAM_SLOT, None)
    seq = params.pop(ringfmt.PARAM_SEQ, 0)
    if not isinstance(region_name, str) or not isinstance(slot, int):
        raise InferenceServerException(
            "shm ring requests need string 'shm_ring_region' and integer "
            "'shm_ring_slot' parameters"
        )
    if request.inputs:
        raise InferenceServerException(
            "shm ring requests must not also carry inline inputs"
        )
    ring = core.shm_rings.get(region_name)
    request.inputs = ring.read_request(int(slot), int(seq))
    ticket = RingTicket(ring, int(slot), int(seq))
    request.shm_ring = ticket
    return ticket
