"""Hand-rolled protobuf wire codec for the ModelInfer hot path.

An own copy of ``client_tpu/grpc/_wire.py``.

It decodes and encodes ``ModelInferRequest`` / ``ModelInferResponse``
bytes without building message objects, for the common shape (raw tensor
contents, no per-tensor parameters, no typed ``contents``):

* :class:`RequestScanner` splits serialized ``ModelInferRequest`` bytes
  into a metadata *prefix* and the ``raw_input_contents`` tail with one
  top-level tag walk, then memoizes the parsed prefix by its exact bytes
  (the top-level ``id`` excised from the key), so requests of one
  workload share it and the raw tensors stay zero-copy views.
* :func:`encode_infer_response` / :func:`encode_infer_request` build
  serialized messages into a caller-owned ``bytearray``, byte-identical
  to ``SerializeToString(deterministic=True)`` for the shapes they accept
  (fields in number order, packed shapes, map entries sorted by key);
  ``tests/test_torch_grpc.py`` holds them to the reference's bytes.

Anything outside the fast shape returns ``None`` and the caller falls back
to the message codec (``client_tpu_torch.grpc._proto``): the fast path is
an optimization, never a fork of the protocol.

Wire schema (client_tpu_torch/protos/grpc_service.proto):

    ModelInferRequest:  1 model_name, 2 model_version, 3 id,
                        4 parameters map, 5 inputs, 6 outputs,
                        7 raw_input_contents
    InferInputTensor:   1 name, 2 datatype, 3 shape (packed int64),
                        4 parameters map, 5 contents
    InferRequestedOutputTensor: 1 name, 2 parameters map
    ModelInferResponse: 1 model_name, 2 model_version, 3 id,
                        4 parameters map, 5 outputs,
                        6 raw_output_contents
    InferOutputTensor:  1 name, 2 datatype, 3 shape (packed int64),
                        4 parameters map, 5 contents
    InferParameter oneof: 1 bool, 2 int64, 3 string, 4 double, 5 uint64
    ModelStreamInferResponse: 1 error_message, 2 infer_response
"""

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

_U64_MASK = (1 << 64) - 1
_PACK_DOUBLE = struct.Struct("<d")

# top-level ModelInferRequest tags (all length-delimited, single-byte)
_TAG_MODEL_NAME = 0x0A
_TAG_MODEL_VERSION = 0x12
_TAG_ID = 0x1A
_TAG_PARAMS = 0x22
_TAG_INPUTS = 0x2A
_TAG_OUTPUTS = 0x32
_TAG_RAW = 0x3A
_KNOWN_TAGS = frozenset(
    (0x0A, 0x12, 0x1A, 0x22, 0x2A, 0x32, 0x3A)
)


class WireError(ValueError):
    """Structurally invalid bytes (not merely an unsupported shape)."""


# -- varint primitives --------------------------------------------------------


def read_varint(buf, pos: int) -> Tuple[int, int]:
    """Decode one base-128 varint at ``pos``; returns (value, new pos)."""
    result = 0
    shift = 0
    while True:
        try:
            b = buf[pos]
        except IndexError:
            raise WireError("truncated varint") from None
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def write_varint(out: bytearray, value: int) -> None:
    """Append one base-128 varint (value must be in [0, 2**64))."""
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _signed64(value: int) -> int:
    """Unsigned varint value -> int64 (two's complement)."""
    return value - (1 << 64) if value >= (1 << 63) else value


# -- InferParameter -----------------------------------------------------------


def _decode_parameter(buf: bytes, pos: int, end: int) -> Any:
    """Decode an InferParameter submessage body; oneof = last field wins
    (protobuf merge semantics)."""
    value: Any = None
    while pos < end:
        tag, pos = read_varint(buf, pos)
        if tag == 0x08:  # bool_param
            raw, pos = read_varint(buf, pos)
            value = bool(raw)
        elif tag == 0x10:  # int64_param
            raw, pos = read_varint(buf, pos)
            value = _signed64(raw)
        elif tag == 0x1A:  # string_param
            n, pos = read_varint(buf, pos)
            value = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif tag == 0x21:  # double_param (fixed64)
            value = _PACK_DOUBLE.unpack_from(buf, pos)[0]
            pos += 8
        elif tag == 0x28:  # uint64_param
            value, pos = read_varint(buf, pos)
        else:
            raise WireError(f"unknown InferParameter tag {tag:#x}")
    return value


def _encode_parameter(out: bytearray, value: Any) -> None:
    """InferParameter body for one python value — same type mapping as
    the proto codec's ``dict_to_params``/``set_parameter`` (bool before
    int: bool is an int subclass)."""
    if isinstance(value, bool):
        out.append(0x08)
        out.append(1 if value else 0)
    elif isinstance(value, int):
        out.append(0x10)
        write_varint(out, value & _U64_MASK)
    elif isinstance(value, float):
        out.append(0x21)
        out += _PACK_DOUBLE.pack(value)
    else:
        data = str(value).encode("utf-8")
        out.append(0x1A)
        write_varint(out, len(data))
        out += data


def _encode_params_map(
    out: bytearray, field_tag: int, params: Dict[str, Any]
) -> None:
    """Map<string, InferParameter> entries, sorted by key (matching
    ``SerializeToString(deterministic=True)``)."""
    for key in sorted(params):
        entry = bytearray()
        key_bytes = key.encode("utf-8")
        if key_bytes:
            entry.append(0x0A)
            write_varint(entry, len(key_bytes))
            entry += key_bytes
        value = bytearray()
        _encode_parameter(value, params[key])
        entry.append(0x12)
        write_varint(entry, len(value))
        entry += value
        out.append(field_tag)
        write_varint(out, len(entry))
        out += entry


def _decode_map_entry(buf: bytes, pos: int, end: int) -> Tuple[str, Any]:
    key = ""
    value: Any = None
    while pos < end:
        tag, pos = read_varint(buf, pos)
        if tag == 0x0A:  # key
            n, pos = read_varint(buf, pos)
            key = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif tag == 0x12:  # value (InferParameter)
            n, pos = read_varint(buf, pos)
            value = _decode_parameter(buf, pos, pos + n)
            pos += n
        else:
            raise WireError(f"unknown map-entry tag {tag:#x}")
    return key, value


# -- request decode -----------------------------------------------------------


class DecodedInfer:
    """Flat view of a fast-shape ModelInferRequest (no proto objects).

    Instances coming out of :class:`RequestScanner` are cached templates
    shared across requests — treat every field as READ-ONLY (copy
    ``parameters`` before mutating).
    """

    __slots__ = (
        "model_name",
        "model_version",
        "id",
        "parameters",
        "inputs",
        "output_names",
        "prepared",
    )

    def __init__(self):
        self.model_name = ""
        self.model_version = ""
        self.id = ""
        self.parameters: Dict[str, Any] = {}
        # (name, datatype, shape) per input, aligned order with the wire
        self.inputs: List[Tuple[str, str, List[int]]] = []
        self.output_names: List[str] = []
        # server-codec slot: per-template precomputed decode plan (the
        # template is cached, so the plan amortizes to zero per request)
        self.prepared: Any = None


def _decode_input_tensor(buf: bytes, pos: int, end: int):
    """InferInputTensor body -> (name, datatype, shape) or None when the
    tensor carries parameters/contents (fall back to proto)."""
    name = ""
    datatype = ""
    shape: List[int] = []
    while pos < end:
        tag, pos = read_varint(buf, pos)
        if tag == 0x0A:  # name
            n, pos = read_varint(buf, pos)
            name = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif tag == 0x12:  # datatype
            n, pos = read_varint(buf, pos)
            datatype = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif tag == 0x1A:  # shape, packed
            n, pos = read_varint(buf, pos)
            stop = pos + n
            while pos < stop:
                dim, pos = read_varint(buf, pos)
                shape.append(_signed64(dim))
        elif tag == 0x18:  # shape, unpacked element
            dim, pos = read_varint(buf, pos)
            shape.append(_signed64(dim))
        else:
            # per-tensor parameters (shared-memory refs), typed contents,
            # or an unknown field: not the fast shape
            return None
    return name, datatype, shape


def _decode_output_tensor(buf: bytes, pos: int, end: int) -> Optional[str]:
    """InferRequestedOutputTensor body -> name, or None when it carries
    parameters (classification / shared-memory refs)."""
    name = ""
    while pos < end:
        tag, pos = read_varint(buf, pos)
        if tag == 0x0A:
            n, pos = read_varint(buf, pos)
            name = buf[pos : pos + n].decode("utf-8")
            pos += n
        else:
            return None
    return name


def decode_request_prefix(buf: bytes) -> Optional[DecodedInfer]:
    """Parse the metadata fields of a serialized ModelInferRequest
    (everything except ``raw_input_contents``, which the scanner strips
    first). Returns ``None`` for shapes the fast path does not cover."""
    out = DecodedInfer()
    pos = 0
    end = len(buf)
    try:
        while pos < end:
            tag, pos = read_varint(buf, pos)
            if tag == _TAG_INPUTS:
                n, pos = read_varint(buf, pos)
                tensor = _decode_input_tensor(buf, pos, pos + n)
                if tensor is None:
                    return None
                out.inputs.append(tensor)
                pos += n
            elif tag == _TAG_MODEL_NAME:
                n, pos = read_varint(buf, pos)
                out.model_name = buf[pos : pos + n].decode("utf-8")
                pos += n
            elif tag == _TAG_MODEL_VERSION:
                n, pos = read_varint(buf, pos)
                out.model_version = buf[pos : pos + n].decode("utf-8")
                pos += n
            elif tag == _TAG_ID:
                n, pos = read_varint(buf, pos)
                out.id = buf[pos : pos + n].decode("utf-8")
                pos += n
            elif tag == _TAG_PARAMS:
                n, pos = read_varint(buf, pos)
                key, value = _decode_map_entry(buf, pos, pos + n)
                out.parameters[key] = value
                pos += n
            elif tag == _TAG_OUTPUTS:
                n, pos = read_varint(buf, pos)
                name = _decode_output_tensor(buf, pos, pos + n)
                if name is None:
                    return None
                out.output_names.append(name)
                pos += n
            else:
                return None  # unknown field: not the fast shape
    except UnicodeDecodeError:
        raise WireError("non-UTF-8 string field") from None
    return out


# per-request parameters excised from the scanner's cache key (their
# values change every request — keyed raw, they would make ring traffic
# a 100% cache miss AND wholesale-clear hot templates at cache_max)
_EXCISED_PARAM_KEYS = frozenset((b"shm_ring_slot", b"shm_ring_seq"))


class RequestScanner:
    """Memoizing ModelInferRequest scanner.

    ``scan(data)`` walks only the TOP-LEVEL tags (a dozen varints),
    collects ``raw_input_contents`` as zero-copy memoryviews, and looks
    the metadata prefix up in a bounded cache keyed by its exact bytes —
    steady-state cost is the walk plus one dict hit. Per-request fields
    are excised from the cache key and returned separately: the
    top-level ``id`` (unique correlation ids in the multiplexed stream
    mode) and the ``shm_ring_slot``/``shm_ring_seq`` parameters (they
    advance every ring request). A prefix outside the fast shape caches
    as a negative entry so repeated exotic requests don't re-parse
    either.

    The cache is bounded (``cache_max`` distinct prefixes, cleared
    wholesale on overflow) so a hostile client cycling distinct
    metadata cannot grow server memory without bound.
    """

    __slots__ = ("cache_max", "_cache")

    _MISS = object()  # negative cache entry: prefix is not fast-shape

    def __init__(self, cache_max: int = 512):
        self.cache_max = cache_max
        self._cache: Dict[bytes, Any] = {}

    def scan(
        self, data: bytes
    ) -> Optional[
        Tuple[DecodedInfer, str, Optional[Dict[str, Any]], List[memoryview]]
    ]:
        """Returns (metadata template, request id, excised per-request
        parameters or None, raw views) — or None (fall back to the proto
        codec).

        The template is SHARED across requests with the same prefix —
        callers must not mutate it (``template.id`` is always ""; the
        per-request id and the excised parameters ride alongside).
        Raises :class:`WireError` on structurally broken bytes.
        """
        pos = 0
        end = len(data)
        raw_start = -1
        request_id = ""
        excised: List[Tuple[int, int]] = []  # spans cut from the key
        extra_params: Optional[Dict[str, Any]] = None
        raws: List[memoryview] = []
        mv = None
        while pos < end:
            tag = data[pos]
            pos += 1
            if tag >= 0x80:  # multi-byte tag: field > 15, unknown schema
                return None
            if tag == _TAG_RAW:
                if raw_start < 0:
                    raw_start = pos - 1
                n, pos = read_varint(data, pos)
                if mv is None:
                    mv = memoryview(data)
                raws.append(mv[pos : pos + n])
                pos += n
            elif tag in _KNOWN_TAGS:
                if raw_start >= 0:
                    # metadata after raw contents: legal protobuf but not
                    # the serializer order the prefix split assumes
                    return None
                start = pos - 1
                n, pos = read_varint(data, pos)
                content = pos
                pos += n
                if tag == _TAG_ID:
                    try:
                        request_id = data[content:pos].decode("utf-8")
                    except UnicodeDecodeError:
                        raise WireError("non-UTF-8 id field") from None
                    excised.append((start, pos))
                elif (
                    tag == _TAG_PARAMS
                    and n > 2
                    and data[content] == 0x0A
                    and data[content + 1] < 0x80
                    and data[content + 2 : content + 2 + data[content + 1]]
                    in _EXCISED_PARAM_KEYS
                ):
                    try:
                        key, value = _decode_map_entry(data, content, pos)
                    except WireError:
                        return None
                    if extra_params is None:
                        extra_params = {}
                    extra_params[key] = value
                    excised.append((start, pos))
            else:
                return None
        if pos != end:
            raise WireError("truncated message")
        meta_end = raw_start if raw_start >= 0 else end
        if not excised:
            prefix = data[:meta_end]
        else:
            parts = []
            cursor = 0
            for span_start, span_stop in excised:  # in scan order
                parts.append(data[cursor:span_start])
                cursor = span_stop
            parts.append(data[cursor:meta_end])
            prefix = b"".join(parts)
        template = self._cache.get(prefix)
        if template is None:
            template = decode_request_prefix(prefix)
            if len(self._cache) >= self.cache_max:
                self._cache.clear()
            self._cache[prefix] = (
                template if template is not None else self._MISS
            )
        if template is self._MISS or template is None:
            return None
        return template, request_id, extra_params, raws


# -- message builders ---------------------------------------------------------


def _encode_string_field(out: bytearray, tag: int, value: str) -> None:
    """Length-delimited string field; default ("") omitted like proto3."""
    if not value:
        return
    data = value.encode("utf-8")
    out.append(tag)
    write_varint(out, len(data))
    out += data


def _encode_shape(out: bytearray, shape: Sequence[int]) -> None:
    """Packed repeated int64 ``shape`` (field 3); empty omitted."""
    if not shape:
        return
    packed = bytearray()
    for dim in shape:
        write_varint(packed, int(dim) & _U64_MASK)
    out.append(0x1A)
    write_varint(out, len(packed))
    out += packed


def _encode_tensor_meta(
    name: str,
    datatype: str,
    shape: Sequence[int],
    params: Optional[Dict[str, Any]],
) -> bytearray:
    sub = bytearray()
    _encode_string_field(sub, 0x0A, name)
    _encode_string_field(sub, 0x12, datatype)
    _encode_shape(sub, shape)
    if params:
        _encode_params_map(sub, 0x22, params)
    return sub


def encode_infer_response(
    out: bytearray,
    model_name: str,
    model_version: str,
    request_id: str,
    parameters: Optional[Dict[str, Any]],
    outputs: Sequence[Tuple[str, str, Sequence[int], Optional[Dict[str, Any]]]],
    raw_contents: Sequence[Any],
) -> None:
    """Append a serialized ModelInferResponse to ``out``.

    ``outputs`` holds (name, datatype, shape, parameters-or-None) per
    tensor; ``raw_contents`` the aligned raw_output_contents entries
    (bytes-like; every output contributes one, empty for shm outputs).
    """
    _encode_string_field(out, 0x0A, model_name)
    _encode_string_field(out, 0x12, model_version)
    _encode_string_field(out, 0x1A, request_id)
    if parameters:
        _encode_params_map(out, 0x22, parameters)
    for name, datatype, shape, params in outputs:
        sub = _encode_tensor_meta(name, datatype, shape, params)
        out.append(0x2A)
        write_varint(out, len(sub))
        out += sub
    for raw in raw_contents:
        out.append(0x32)
        write_varint(out, len(raw))
        out += raw


def encode_output_meta_block(
    outputs: Sequence[Tuple[str, str, Sequence[int]]]
) -> bytes:
    """The concatenated field-5 (outputs) submessages for a parameterless
    output set — the cacheable middle of a ModelInferResponse."""
    out = bytearray()
    for name, datatype, shape in outputs:
        sub = _encode_tensor_meta(name, datatype, shape, None)
        out.append(0x2A)
        write_varint(out, len(sub))
        out += sub
    return bytes(out)


def encode_head(model_name: str, model_version: str) -> bytes:
    """Fields 1-2 of a ModelInfer message (cacheable per model)."""
    out = bytearray()
    _encode_string_field(out, 0x0A, model_name)
    _encode_string_field(out, 0x12, model_version)
    return bytes(out)


def encode_infer_request(
    out: bytearray,
    model_name: str,
    model_version: str,
    request_id: str,
    parameters: Optional[Dict[str, Any]],
    inputs: Sequence[Tuple[str, str, Sequence[int]]],
    raw_contents: Sequence[Any],
    output_names: Sequence[str] = (),
) -> None:
    """Append a serialized ModelInferRequest to ``out`` (client mirror of
    :func:`encode_infer_response`; inputs are (name, datatype, shape))."""
    _encode_string_field(out, 0x0A, model_name)
    _encode_string_field(out, 0x12, model_version)
    _encode_string_field(out, 0x1A, request_id)
    if parameters:
        _encode_params_map(out, 0x22, parameters)
    for name, datatype, shape in inputs:
        sub = _encode_tensor_meta(name, datatype, shape, None)
        out.append(_TAG_INPUTS)
        write_varint(out, len(sub))
        out += sub
    for name in output_names:
        sub = bytearray()
        _encode_string_field(sub, 0x0A, name)
        out.append(_TAG_OUTPUTS)
        write_varint(out, len(sub))
        out += sub
    for raw in raw_contents:
        out.append(_TAG_RAW)
        write_varint(out, len(raw))
        out += raw


def encode_input_meta_block(
    inputs: Sequence[Tuple[str, str, Sequence[int]]],
    output_names: Sequence[str] = (),
) -> bytes:
    """The concatenated field-5/6 submessages of a ModelInferRequest —
    the cacheable middle for clients resending one tensor signature."""
    out = bytearray()
    for name, datatype, shape in inputs:
        sub = _encode_tensor_meta(name, datatype, shape, None)
        out.append(_TAG_INPUTS)
        write_varint(out, len(sub))
        out += sub
    for name in output_names:
        sub = bytearray()
        _encode_string_field(sub, 0x0A, name)
        out.append(_TAG_OUTPUTS)
        write_varint(out, len(sub))
        out += sub
    return bytes(out)


def encode_stream_response(
    out: bytearray, infer_response: Any = b"", error_message: str = ""
) -> None:
    """Append a serialized ModelStreamInferResponse wrapping an
    already-serialized ModelInferResponse (``infer_response`` bytes-like)
    and/or an in-band ``error_message``. The ``infer_response`` field is
    always emitted (possibly empty) — matching the servicer, which always
    sets the submessage, so presence-sensitive clients see no change."""
    _encode_string_field(out, 0x0A, error_message)
    out.append(0x12)
    write_varint(out, len(infer_response))
    out += infer_response


def decode_infer_request(data):
    """One-shot request decode (tests and one-off callers): a thin
    wrapper over :class:`RequestScanner` — there is exactly one parser.
    Returns (template, request_id, extra_params, raw views) or None."""
    return RequestScanner(cache_max=1).scan(bytes(data))


# -- router splice helpers ----------------------------------------------------
#
# The router tier forwards serialized ModelInfer bytes without ever
# materializing a proto: it rewrites exactly ONE field — the top-level
# ``id`` (field 3 on BOTH ModelInferRequest and ModelInferResponse, the
# correlation key of the multiplexed backend streams) — with a tag walk
# plus bytes slices. Field order is irrelevant to protobuf decoding and
# the server-side RequestScanner excises ``id`` from its cache key, so a
# spliced request still rides the backend's fast path.


def _skip_wire_value(buf, pos: int, wiretype: int) -> int:
    """Advance past one field's value (generic walk: the response side
    may carry fields this module doesn't model)."""
    if wiretype == 0:  # varint
        _, pos = read_varint(buf, pos)
        return pos
    if wiretype == 1:  # fixed64
        return pos + 8
    if wiretype == 2:  # length-delimited
        n, pos = read_varint(buf, pos)
        return pos + n
    if wiretype == 5:  # fixed32
        return pos + 4
    raise WireError(f"unsupported wire type {wiretype}")


def _id_spans(data) -> Tuple[str, List[Tuple[int, int]]]:
    """(decoded id, [(start, stop) of every top-level field-3 entry])
    via one generic top-level walk; last entry wins (protobuf merge)."""
    pos = 0
    end = len(data)
    message_id = ""
    spans: List[Tuple[int, int]] = []
    while pos < end:
        start = pos
        tag, pos = read_varint(data, pos)
        field, wiretype = tag >> 3, tag & 0x7
        if field == 3 and wiretype == 2:
            n, pos = read_varint(data, pos)
            try:
                message_id = bytes(data[pos : pos + n]).decode("utf-8")
            except UnicodeDecodeError:
                raise WireError("non-UTF-8 id field") from None
            pos += n
            spans.append((start, pos))
        else:
            pos = _skip_wire_value(data, pos, wiretype)
    if pos != end:
        raise WireError("truncated message")
    return message_id, spans


def read_message_id(data) -> str:
    """The top-level ``id`` of serialized ModelInferRequest/Response
    bytes (same schema slot both directions — one reader serves the
    router's correlation on requests and responses alike)."""
    message_id, _spans = _id_spans(data)
    return message_id


def splice_message_id(data, new_id: str) -> Tuple[bytes, str]:
    """Serialized ModelInfer{Request,Response} bytes with the top-level
    ``id`` replaced by ``new_id``; returns (spliced bytes, original id).
    No other byte is touched — the rewrite is a prepended id field plus
    the excision of the old spans (prepending keeps metadata ahead of
    the raw contents, so the backend scanner's prefix split still
    applies)."""
    original, spans = _id_spans(data)
    out = bytearray()
    _encode_string_field(out, _TAG_ID, new_id)
    cursor = 0
    for start, stop in spans:
        out += data[cursor:start]
        cursor = stop
    out += data[cursor:]
    return bytes(out), original


def splice_forward_request(data, new_id: str) -> Tuple[bytes, str]:
    """The router's request rewrite in one pass: correlation ``id`` :=
    ``new_id`` and a ``multiplex`` parameter prepended (so the backend
    executes it as its own task on the shared persistent stream instead
    of serializing the stream). Returns (forwarded bytes, original id).
    A client-sent ``multiplex`` entry, if any, appears later in the map
    and wins under protobuf merge — the router never overrides it."""
    original, spans = _id_spans(data)
    out = bytearray()
    _encode_string_field(out, _TAG_ID, new_id)
    _encode_params_map(out, _TAG_PARAMS, {"multiplex": True})
    cursor = 0
    for start, stop in spans:
        out += data[cursor:start]
        cursor = stop
    out += data[cursor:]
    return bytes(out), original


def split_stream_frame(data) -> Tuple[str, Any]:
    """Split serialized ModelStreamInferResponse bytes into
    (error_message, infer_response bytes view) without a proto parse —
    the router's per-frame cost on the response path. The server emits
    exactly one ``infer_response`` per frame; were several present the
    last complete submessage wins (protobuf merge approximation that
    cannot occur with our own server)."""
    pos = 0
    end = len(data)
    error_message = ""
    response: Any = b""
    mv = None
    while pos < end:
        tag, pos = read_varint(data, pos)
        field, wiretype = tag >> 3, tag & 0x7
        if field == 1 and wiretype == 2:  # error_message
            n, pos = read_varint(data, pos)
            try:
                error_message = bytes(data[pos : pos + n]).decode("utf-8")
            except UnicodeDecodeError:
                raise WireError("non-UTF-8 error_message") from None
            pos += n
        elif field == 2 and wiretype == 2:  # infer_response
            n, pos = read_varint(data, pos)
            if mv is None:
                mv = memoryview(data)
            response = mv[pos : pos + n]
            pos += n
        else:
            pos = _skip_wire_value(data, pos, wiretype)
    if pos != end:
        raise WireError("truncated stream frame")
    return error_message, response


def response_is_final(data) -> bool:
    """Whether serialized ModelInferResponse bytes carry the
    ``triton_final_response`` parameter set (a decoupled stream's last
    frame): one top-level walk over the parameters map (field 4)."""
    pos = 0
    end = len(data)
    final = False
    while pos < end:
        tag, pos = read_varint(data, pos)
        field, wiretype = tag >> 3, tag & 0x7
        if field == 4 and wiretype == 2:
            n, pos = read_varint(data, pos)
            key, value = _decode_map_entry(data, pos, pos + n)
            if key == "triton_final_response":
                final = bool(value)
            pos += n
        else:
            pos = _skip_wire_value(data, pos, wiretype)
    if pos != end:
        raise WireError("truncated message")
    return final
