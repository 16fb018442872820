"""A small proto3 runtime for the KServe v2 messages, without protobuf.

The port imports neither ``grpcio`` nor ``google.protobuf`` (it stands on
torch and the standard library alone, and the machines it runs on need not
have them), so it reads its own copies of the two ``.proto`` files
(``client_tpu_torch/protos/``) at import and builds message classes from
them. It covers what those files use: scalars, ``bytes`` and ``string``,
enums, nested messages, ``repeated`` (numeric scalars packed), ``map<,>``
and ``oneof``.

* ``SerializeToString()`` gives the bytes the real library gives with
  ``deterministic=True``: fields in number order, maps sorted by key
  (bytewise, a longer key before its own prefix, as that library sorts
  them), map entries with both key and value written, proto3 defaults omitted
  except where a field has presence (submessages, ``oneof`` members).
* ``ParseFromString()`` reads packed and unpacked repeated scalars and
  skips unknown fields.
* :func:`message_to_dict` is ``json_format.MessageToDict(message,
  preserving_proto_field_name=True)``: 64-bit integers as strings, enums
  by name, ``bytes`` in base64, defaults left out.

The message API is the part of the generated classes that the clients and
the server's codec use: keyword construction, attribute access, ``add``,
``append``, ``extend`` on repeated fields, ``m[key]`` on maps (a message
value is made on first access), ``HasField``, ``WhichOneof``,
``SetInParent``, ``CopyFrom``, ``MergeFrom``, ``ClearField``,
``ListFields``, ``FromString`` and ``ByteSize``.
"""

import base64
import math
import re
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

PROTO_DIR = Path(__file__).resolve().parent.parent / "protos"


class DecodeError(ValueError):
    """Malformed wire bytes."""


# -- wire primitives ------------------------------------------------------------

# the scalar types the two files use (no sint*, fixed* or sfixed*)
_VARINT_KINDS = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_FIXED32 = {"float": "<f"}
_FIXED64 = {"double": "<d"}
_SCALARS = _VARINT_KINDS | set(_FIXED32) | set(_FIXED64) | {"string", "bytes"}
_INT_RANGES = {
    "int32": (-(1 << 31), (1 << 31) - 1),
    "int64": (-(1 << 63), (1 << 63) - 1),
    "uint32": (0, (1 << 32) - 1),
    "uint64": (0, (1 << 64) - 1),
}


def _write_varint(out: bytearray, value: int) -> None:
    value &= (1 << 64) - 1
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _wire_type(kind: str) -> int:
    if kind in _FIXED64:
        return 1
    if kind in _FIXED32:
        return 5
    if kind in ("string", "bytes") or kind not in _SCALARS:
        return 2
    return 0


def _encode_scalar(out: bytearray, kind: str, value) -> None:
    """The value of one scalar field (no tag)."""
    if kind in ("string", "bytes"):
        data = value.encode("utf-8") if kind == "string" else bytes(value)
        _write_varint(out, len(data))
        out += data
    elif kind in _FIXED32:
        out += struct.pack(_FIXED32[kind], value)
    elif kind in _FIXED64:
        out += struct.pack(_FIXED64[kind], value)
    else:
        _write_varint(out, int(value))


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _decode_varint_value(kind: str, raw: int):
    if kind == "bool":
        return raw != 0
    if kind in ("int32", "enum"):
        return _signed(raw, 32)
    if kind == "int64":
        return _signed(raw, 64)
    if kind == "uint32":
        return raw & 0xFFFFFFFF
    return raw


def _skip(buf, pos: int, wire: int, end: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise DecodeError(f"unsupported wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


# -- .proto reader ----------------------------------------------------------------


class FieldSpec:
    """One declared field. ``kind`` is a scalar name, or ``message`` /
    ``enum`` with ``type_name`` naming the full type; a map field has
    ``map_entry`` (its key and value specs)."""

    __slots__ = ("name", "number", "kind", "type_name", "repeated", "oneof",
                 "map_key", "map_value", "message_type", "enum_type")

    def __init__(self, name, number, kind, type_name=None, repeated=False,
                 oneof=None):
        self.name = name
        self.number = number
        self.kind = kind
        self.type_name = type_name
        self.repeated = repeated
        self.oneof = oneof
        self.map_key: Optional[FieldSpec] = None
        self.map_value: Optional[FieldSpec] = None
        self.message_type = None
        self.enum_type = None

    @property
    def is_map(self) -> bool:
        return self.map_key is not None

    @property
    def packable(self) -> bool:
        return self.repeated and not self.is_map and self.kind not in (
            "string", "bytes", "message")

    @property
    def has_presence(self) -> bool:
        return not self.repeated and (self.kind == "message" or self.oneof is not None)

    def default(self):
        if self.kind == "string":
            return ""
        if self.kind == "bytes":
            return b""
        if self.kind == "bool":
            return False
        if self.kind in ("float", "double"):
            return 0.0
        return 0


_TOKEN = re.compile(r'"[^"]*"|[A-Za-z_][\w.]*|-?\d+|[{}()<>;=,\[\]]')


def _tokens(text: str) -> List[str]:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return _TOKEN.findall(text)


class _Parser:
    """Reads the subset of proto3 the two files use into plain specs:
    ``messages[full_name] = (fields, oneof names, nested enum names)``,
    ``enums[full_name] = [(name, number)]``, ``methods = [(name,
    request, response, client streaming, server streaming)]``."""

    def __init__(self):
        self.package = ""
        self.messages: Dict[str, List[FieldSpec]] = {}
        self.oneofs: Dict[str, List[str]] = {}
        self.enums: Dict[str, List[Tuple[str, int]]] = {}
        self.methods: List[Tuple[str, str, str, bool, bool]] = []
        self.order: List[str] = []

    def parse(self, text: str) -> None:
        toks = _tokens(text)
        i = 0
        while i < len(toks):
            t = toks[i]
            if t in ("syntax", "import", "option"):
                while toks[i] != ";":
                    i += 1
                i += 1
            elif t == "package":
                self.package = toks[i + 1]
                i += 3
            elif t == "message":
                i = self._message(toks, i, self.package)
            elif t == "enum":
                i = self._enum(toks, i, self.package)
            elif t == "service":
                i = self._service(toks, i)
            else:
                raise ValueError(f"unexpected token {t!r} in .proto")

    def _enum(self, toks, i, scope) -> int:
        name = f"{scope}.{toks[i + 1]}"
        i += 3  # enum Name {
        values = []
        while toks[i] != "}":
            values.append((toks[i], int(toks[i + 2])))
            i += 4  # NAME = N ;
        self.enums[name] = values
        return i + 1

    def _message(self, toks, i, scope) -> int:
        name = f"{scope}.{toks[i + 1]}"
        self.order.append(name)
        fields: List[FieldSpec] = []
        oneofs: List[str] = []
        self.messages[name] = fields
        self.oneofs[name] = oneofs
        i += 3  # message Name {
        oneof = None
        while True:
            t = toks[i]
            if t == "}":
                if oneof is not None:
                    oneof = None
                    i += 1
                    continue
                return i + 1
            if t == "message":
                i = self._message(toks, i, name)
            elif t == "enum":
                i = self._enum(toks, i, name)
            elif t == "oneof":
                oneof = toks[i + 1]
                oneofs.append(oneof)
                i += 3
            elif t == "map":
                # map < K , V > name = N ;
                key, value = toks[i + 2], toks[i + 4]
                spec = FieldSpec(toks[i + 6], int(toks[i + 8]), "message",
                                 repeated=True)
                spec.map_key = FieldSpec("key", 1, key)
                spec.map_value = self._typed(FieldSpec("value", 2, value), name)
                fields.append(spec)
                i += 10
            else:
                repeated = t == "repeated"
                if repeated:
                    i += 1
                spec = self._typed(
                    FieldSpec(toks[i + 1], int(toks[i + 3]), toks[i],
                              repeated=repeated, oneof=oneof), name)
                fields.append(spec)
                i += 5

    @staticmethod
    def _typed(spec: FieldSpec, scope: str) -> FieldSpec:
        if spec.kind not in _SCALARS:
            spec.type_name = spec.kind
            spec.kind = "message"  # or enum: resolved once every file is read
            spec.message_type = scope  # the scope the name resolves from
        return spec

    def _service(self, toks, i) -> int:
        i += 3  # service Name {
        while toks[i] != "}":
            # rpc Name ( [stream] Req ) returns ( [stream] Resp ) { }
            name = toks[i + 1]
            i += 3
            client_stream = toks[i] == "stream"
            if client_stream:
                i += 1
            request = toks[i]
            i += 4  # Req ) returns (
            server_stream = toks[i] == "stream"
            if server_stream:
                i += 1
            response = toks[i]
            i += 2  # Resp )
            while toks[i] != "}":
                i += 1
            i += 1
            if toks[i] == ";":
                i += 1
            self.methods.append((name, request, response, client_stream, server_stream))
        return i + 1

    def resolve(self, spec: FieldSpec) -> None:
        """Find a field's message or enum type from the scope it was
        declared in, innermost first, as protoc does."""
        scope = spec.message_type
        parts = scope.split(".")
        while parts:
            candidate = ".".join(parts + [spec.type_name])
            if candidate in self.messages:
                spec.kind, spec.type_name = "message", candidate
                return
            if candidate in self.enums:
                spec.kind, spec.type_name = "enum", candidate
                return
            parts.pop()
        raise ValueError(f"unknown type {spec.type_name!r} in {scope}")


# -- enums ------------------------------------------------------------------------


class EnumType:
    """``Name.Value("X")``, ``Name.Name(n)``, ``Name.X``, ``keys()``,
    ``values()``, ``items()``: the generated enum wrapper's surface."""

    def __init__(self, full_name: str, values: List[Tuple[str, int]]):
        self.full_name = full_name
        self._by_name = dict(values)
        self._by_number: Dict[int, str] = {}
        for key, number in values:
            self._by_number.setdefault(number, key)
        for key, number in values:
            setattr(self, key, number)

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"enum {self.full_name} has no value named {name}") from None

    def Name(self, number: int) -> str:
        try:
            return self._by_number[number]
        except KeyError:
            raise ValueError(f"enum {self.full_name} has no name for {number}") from None

    def keys(self):
        return list(self._by_name)

    def values(self):
        return list(self._by_name.values())

    def items(self):
        return list(self._by_name.items())


# -- containers -----------------------------------------------------------------


def _check_scalar(spec: FieldSpec, value):
    kind = spec.kind
    if kind == "string":
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{spec.name}: expected str, got {type(value).__name__}")
        return value
    if kind == "bytes":
        if isinstance(value, str):
            value = value.encode("utf-8")
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"{spec.name}: expected bytes, got {type(value).__name__}")
        return bytes(value)
    if kind == "bool":
        return bool(value)
    if kind in ("float", "double"):
        if isinstance(value, (str, bytes)):
            raise TypeError(f"{spec.name}: expected a number")
        value = float(value)
        if kind == "float":
            value = struct.unpack("<f", struct.pack("<f", value))[0] if math.isfinite(
                value) and abs(value) <= 3.4028234663852886e38 else value
        return value
    if kind == "enum":
        if isinstance(value, str):
            return spec.enum_type.Value(value)
        return int(value)
    if isinstance(value, (str, bytes, float)) and not (
            isinstance(value, float) and value.is_integer()):
        raise TypeError(f"{spec.name}: expected an int, got {type(value).__name__}")
    value = int(value)
    lo, hi = _INT_RANGES[kind]
    if not lo <= value <= hi:
        raise ValueError(f"{spec.name}: value {value} out of range for {kind}")
    return value


class RepeatedScalar(list):
    """A repeated scalar field; checks each value as it goes in."""

    def __init__(self, owner, spec: FieldSpec):
        super().__init__()
        self._owner = owner
        self._spec = spec

    def append(self, value) -> None:
        super().append(_check_scalar(self._spec, value))
        self._owner._modified()

    def extend(self, values) -> None:
        super().extend(_check_scalar(self._spec, v) for v in values)
        self._owner._modified()

    def __setitem__(self, index, value) -> None:
        if isinstance(index, slice):
            super().__setitem__(index, [_check_scalar(self._spec, v) for v in value])
        else:
            super().__setitem__(index, _check_scalar(self._spec, value))
        self._owner._modified()

    def __eq__(self, other) -> bool:
        return list(self) == list(other)

    __hash__ = None


class RepeatedMessage(list):
    """A repeated message field: ``add(**fields)`` makes an element."""

    def __init__(self, owner, spec: FieldSpec):
        super().__init__()
        self._owner = owner
        self._spec = spec

    def add(self, **kwargs):
        message = self._spec.message_type(**kwargs)
        super().append(message)
        self._owner._modified()
        return message

    def append(self, message) -> None:
        copy = self._spec.message_type()
        copy.CopyFrom(message)
        super().append(copy)
        self._owner._modified()

    def extend(self, messages) -> None:
        for message in messages:
            self.append(message)

    def __eq__(self, other) -> bool:
        return list(self) == list(other)

    __hash__ = None


class MessageMap(dict):
    """A ``map<K, V>`` field. For a message value, ``m[key]`` makes the
    entry on first access, as the generated class does."""

    def __init__(self, owner, spec: FieldSpec):
        super().__init__()
        self._owner = owner
        self._spec = spec

    def _is_message(self) -> bool:
        return self._spec.map_value.kind == "message"

    def __getitem__(self, key):
        key = _check_scalar(self._spec.map_key, key)
        if self._is_message():
            value = dict.get(self, key)
            if value is None:
                value = self._spec.map_value.message_type()
                dict.__setitem__(self, key, value)
                self._owner._modified()
            return value
        return dict.__getitem__(self, key)

    def __setitem__(self, key, value) -> None:
        if self._is_message():
            raise ValueError("direct assignment of a message map value is not allowed")
        dict.__setitem__(self, _check_scalar(self._spec.map_key, key),
                         _check_scalar(self._spec.map_value, value))
        self._owner._modified()

    def __contains__(self, key) -> bool:
        return dict.__contains__(self, key)

    def get(self, key, default=None):
        return dict.get(self, key, default)

    def update(self, *args, **kwargs) -> None:
        for key, value in dict(*args, **kwargs).items():
            if self._is_message():
                self[key].CopyFrom(value)
            else:
                self[key] = value

    def __delitem__(self, key) -> None:
        dict.__delitem__(self, key)
        self._owner._modified()


# -- messages ---------------------------------------------------------------------


class Message:
    """Base of every generated message class. Each class has
    ``DESCRIPTOR`` (its :class:`MessageDescriptor`)."""

    DESCRIPTOR: "MessageDescriptor"
    __slots__ = ("_values", "_present", "_parent", "_parent_field", "_oneof_set")

    def __init__(self, **kwargs):
        self._values: Dict[str, Any] = {}
        self._present = set()
        self._parent = None
        self._parent_field = None
        self._oneof_set: Dict[str, str] = {}
        for key, value in kwargs.items():
            spec = self.DESCRIPTOR.fields_by_name.get(key)
            if spec is None:
                raise ValueError(
                    f'Protocol message {self.DESCRIPTOR.name} has no "{key}" field.')
            if value is None:
                continue
            if spec.is_map:
                getattr(self, key).update(value)
            elif spec.repeated:
                getattr(self, key).extend(value)
            elif spec.kind == "message":
                sub = getattr(self, key)
                sub.CopyFrom(value)
                sub._modified()
            else:
                setattr(self, key, value)

    # presence ---------------------------------------------------------------------

    def _modified(self) -> None:
        parent = self._parent
        if parent is not None:
            parent._set_present(self._parent_field)
            parent._modified()

    def _set_present(self, spec: FieldSpec) -> None:
        if spec.oneof is not None:
            previous = self._oneof_set.get(spec.oneof)
            if previous is not None and previous != spec.name:
                self._values.pop(previous, None)
                self._present.discard(previous)
            self._oneof_set[spec.oneof] = spec.name
        self._present.add(spec.name)

    # attribute access ---------------------------------------------------------------

    def __getattr__(self, name):
        spec = type(self).DESCRIPTOR.fields_by_name.get(name)
        if spec is None:
            raise AttributeError(name)
        values = self._values
        if name in values:
            return values[name]
        if spec.is_map:
            value = MessageMap(self, spec)
        elif spec.repeated:
            value = (RepeatedMessage(self, spec) if spec.kind == "message"
                     else RepeatedScalar(self, spec))
        elif spec.kind == "message":
            value = spec.message_type()
            value._parent = self
            value._parent_field = spec
        else:
            return spec.default()
        values[name] = value
        return value

    def __setattr__(self, name, value):
        if name in Message.__slots__:
            object.__setattr__(self, name, value)
            return
        spec = type(self).DESCRIPTOR.fields_by_name.get(name)
        if spec is None:
            raise AttributeError(
                f'Protocol message {self.DESCRIPTOR.name} has no "{name}" field.')
        if spec.repeated or spec.kind == "message":
            raise AttributeError(
                f"Assignment not allowed to field \"{name}\" in protocol message object.")
        self._values[name] = _check_scalar(spec, value)
        if spec.oneof is not None:
            self._set_present(spec)
        self._modified()

    # the generated-class API -----------------------------------------------------------

    def HasField(self, name: str) -> bool:
        desc = self.DESCRIPTOR
        if name in desc.oneof_names:
            return name in self._oneof_set
        spec = desc.fields_by_name.get(name)
        if spec is None or not spec.has_presence:
            raise ValueError(f'Protocol message has no singular "{name}" field.')
        return name in self._present

    def WhichOneof(self, oneof: str) -> Optional[str]:
        if oneof not in self.DESCRIPTOR.oneof_names:
            raise ValueError(f'Protocol message has no oneof "{oneof}" field.')
        return self._oneof_set.get(oneof)

    def SetInParent(self) -> None:
        self._modified()

    def ClearField(self, name: str) -> None:
        desc = self.DESCRIPTOR
        if name in desc.oneof_names:
            member = self._oneof_set.pop(name, None)
            if member is not None:
                self._values.pop(member, None)
                self._present.discard(member)
            return
        spec = desc.fields_by_name[name]
        self._values.pop(name, None)
        self._present.discard(name)
        if spec.oneof is not None and self._oneof_set.get(spec.oneof) == name:
            del self._oneof_set[spec.oneof]

    def Clear(self) -> None:
        self._values.clear()
        self._present.clear()
        self._oneof_set.clear()

    def _is_set(self, spec: FieldSpec) -> bool:
        """Whether serialization writes the field."""
        value = self._values.get(spec.name)
        if spec.has_presence:
            return spec.name in self._present
        if value is None:
            return False
        if spec.repeated:
            return len(value) > 0
        if spec.kind in ("float", "double"):
            return value != 0.0 or math.copysign(1.0, value) < 0
        return bool(value)

    def ListFields(self) -> List[Tuple[FieldSpec, Any]]:
        return [(spec, self._values[spec.name]) for spec in self.DESCRIPTOR.fields
                if self._is_set(spec)]

    def CopyFrom(self, other: "Message") -> None:
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    def MergeFrom(self, other: "Message") -> None:
        if type(other).DESCRIPTOR is not self.DESCRIPTOR:
            raise TypeError(f"MergeFrom: expected {self.DESCRIPTOR.name}")
        for spec, value in other.ListFields():
            if spec.is_map:
                target = getattr(self, spec.name)
                if spec.map_value.kind == "message":
                    for key, sub in value.items():
                        target[key].MergeFrom(sub)
                else:
                    target.update(value)
            elif spec.repeated:
                getattr(self, spec.name).extend(value)
            elif spec.kind == "message":
                sub = getattr(self, spec.name)
                sub.MergeFrom(value)
                sub._modified()
            else:
                setattr(self, spec.name, value)
        self._modified()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Message) or type(other).DESCRIPTOR is not self.DESCRIPTOR:
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    __hash__ = None

    def __repr__(self) -> str:
        return _text(self, "")

    __str__ = __repr__

    # wire -------------------------------------------------------------------------

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        out = bytearray()
        _encode_message(out, self)
        return bytes(out)

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    def ParseFromString(self, data) -> int:
        self.Clear()
        self.MergeFromString(data)
        return len(data)

    def MergeFromString(self, data) -> int:
        view = memoryview(data).cast("B") if not isinstance(data, bytes) else data
        _decode_into(self, view, 0, len(view))
        return len(data)

    @classmethod
    def FromString(cls, data) -> "Message":
        message = cls()
        message.MergeFromString(data)
        return message


class MessageDescriptor:
    """What a message class knows of its declaration."""

    def __init__(self, full_name: str, fields: List[FieldSpec], oneofs: List[str]):
        self.full_name = full_name
        self.name = full_name.rsplit(".", 1)[-1]
        self.fields = sorted(fields, key=lambda f: f.number)
        self.fields_by_name = {f.name: f for f in fields}
        self.fields_by_number = {f.number: f for f in fields}
        self.oneof_names = set(oneofs)


def _map_order(key):
    """The order ``deterministic=True`` gives map keys: by their bytes,
    and where one key is a prefix of another, the longer first."""
    if isinstance(key, str):
        return (*key.encode("utf-8"), 256)
    return (key,)


def _encode_field_value(out: bytearray, spec: FieldSpec, value) -> None:
    """One non-repeated field with its tag."""
    if spec.kind == "message":
        _write_varint(out, spec.number << 3 | 2)
        body = bytearray()
        _encode_message(body, value)
        _write_varint(out, len(body))
        out += body
    else:
        _write_varint(out, spec.number << 3 | _wire_type(spec.kind))
        _encode_scalar(out, spec.kind, value)


def _encode_message(out: bytearray, message: Message) -> None:
    values = message._values
    for spec in message.DESCRIPTOR.fields:
        if not message._is_set(spec):
            continue
        value = values[spec.name]
        if spec.is_map:
            key_spec, value_spec = spec.map_key, spec.map_value
            for key in sorted(value, key=_map_order):
                entry = bytearray()
                _encode_field_value(entry, key_spec, key)
                _encode_field_value(entry, value_spec, dict.__getitem__(value, key))
                _write_varint(out, spec.number << 3 | 2)
                _write_varint(out, len(entry))
                out += entry
        elif spec.packable:
            body = bytearray()
            for item in value:
                _encode_scalar(body, spec.kind, item)
            _write_varint(out, spec.number << 3 | 2)
            _write_varint(out, len(body))
            out += body
        elif spec.repeated:
            for item in value:
                _encode_field_value(out, spec, item)
        else:
            _encode_field_value(out, spec, value)


def _read_scalar(kind: str, wire: int, buf, pos: int, end: int):
    if wire == 0:
        raw, pos = _read_varint(buf, pos)
        return _decode_varint_value(kind, raw), pos
    if wire == 5:
        if pos + 4 > end:
            raise DecodeError("truncated float")
        return struct.unpack_from(_FIXED32[kind], buf, pos)[0], pos + 4
    if wire == 1:
        if pos + 8 > end:
            raise DecodeError("truncated double")
        return struct.unpack_from(_FIXED64[kind], buf, pos)[0], pos + 8
    raise DecodeError(f"wire type {wire} for a {kind}")


def _decode_into(message: Message, buf, pos: int, end: int) -> None:
    by_number = message.DESCRIPTOR.fields_by_number
    while pos < end:
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        spec = by_number.get(number)
        expected = None if spec is None else _wire_type(spec.kind)
        if spec is None or (wire != expected and not (spec.packable and wire == 2)):
            pos = _skip(buf, pos, wire, end)
            continue
        if wire == 2:
            n, pos = _read_varint(buf, pos)
            stop = pos + n
            if stop > end:
                raise DecodeError("truncated length-delimited field")
            if spec.is_map:
                _decode_map_entry(message, spec, buf, pos, stop)
            elif spec.kind == "message":
                if spec.repeated:
                    sub = getattr(message, spec.name).add()
                else:
                    sub = getattr(message, spec.name)
                    sub._modified()
                _decode_into(sub, buf, pos, stop)
            elif spec.kind in ("string", "bytes"):
                raw = bytes(buf[pos:stop])
                if spec.kind == "string":
                    try:
                        value = raw.decode("utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"{spec.name}: invalid UTF-8") from e
                else:
                    value = raw
                if spec.repeated:
                    list.append(getattr(message, spec.name), value)
                else:
                    message._values[spec.name] = value
                    if spec.oneof is not None:
                        message._set_present(spec)
            else:  # packed scalars
                target = getattr(message, spec.name)
                item_wire = _wire_type(spec.kind)
                p = pos
                while p < stop:
                    value, p = _read_scalar(spec.kind, item_wire, buf, p, stop)
                    list.append(target, value)
                if p != stop:
                    raise DecodeError("packed field overruns its length")
            pos = stop
        else:
            value, pos = _read_scalar(spec.kind, wire, buf, pos, end)
            if spec.repeated:
                list.append(getattr(message, spec.name), value)
            else:
                message._values[spec.name] = value
                if spec.oneof is not None:
                    message._set_present(spec)
    if pos != end:
        raise DecodeError("field overruns its message")


def _decode_map_entry(message: Message, spec: FieldSpec, buf, pos: int, end: int) -> None:
    key_spec, value_spec = spec.map_key, spec.map_value
    key = key_spec.default()
    value = None
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if number == 1 and wire == _wire_type(key_spec.kind):
            if wire == 2:
                n, pos = _read_varint(buf, pos)
                raw = bytes(buf[pos:pos + n])
                key = raw.decode("utf-8") if key_spec.kind == "string" else raw
                pos += n
            else:
                key, pos = _read_scalar(key_spec.kind, wire, buf, pos, end)
        elif number == 2 and value_spec.kind == "message" and wire == 2:
            n, pos = _read_varint(buf, pos)
            value = value_spec.message_type()
            _decode_into(value, buf, pos, pos + n)
            pos += n
        elif number == 2 and value_spec.kind in ("string", "bytes") and wire == 2:
            n, pos = _read_varint(buf, pos)
            raw = bytes(buf[pos:pos + n])
            value = raw.decode("utf-8") if value_spec.kind == "string" else raw
            pos += n
        elif number == 2 and value_spec.kind not in ("message", "string", "bytes") and \
                wire == _wire_type(value_spec.kind):
            value, pos = _read_scalar(value_spec.kind, wire, buf, pos, end)
        else:
            pos = _skip(buf, pos, wire, end)
    target = getattr(message, spec.name)
    if value_spec.kind == "message":
        entry = target[key]
        entry.Clear()
        if value is not None:
            entry.MergeFrom(value)
    else:
        dict.__setitem__(target, key, value_spec.default() if value is None else value)
        message._modified()


# -- MessageToDict -----------------------------------------------------------------


def _shortest_float(value: float) -> float:
    """The shortest decimal that reads back as the same float32, as
    json_format writes a ``float`` field."""
    precision = 6
    rounded = float(f"{value:.{precision}g}")
    while struct.unpack("<f", struct.pack("<f", rounded))[0] != value:
        precision += 1
        rounded = float(f"{value:.{precision}g}")
    return rounded


def _json_scalar(spec: FieldSpec, value):
    kind = spec.kind
    if kind == "enum":
        try:
            return spec.enum_type.Name(value)
        except ValueError:
            return value
    if kind in ("int64", "uint64"):
        return str(value)
    if kind == "bytes":
        return base64.b64encode(value).decode("ascii")
    if kind in ("float", "double"):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        if kind == "float":
            return _shortest_float(value)
        return value
    return value


def message_to_dict(message: Message) -> Dict[str, Any]:
    """``json_format.MessageToDict(message,
    preserving_proto_field_name=True)``."""
    out: Dict[str, Any] = {}
    for spec, value in message.ListFields():
        if spec.is_map:
            out[spec.name] = {
                str(k): (message_to_dict(v) if spec.map_value.kind == "message"
                         else _json_scalar(spec.map_value, v))
                for k, v in dict.items(value)
            }
        elif spec.repeated:
            out[spec.name] = [message_to_dict(v) if spec.kind == "message"
                              else _json_scalar(spec, v) for v in value]
        elif spec.kind == "message":
            out[spec.name] = message_to_dict(value)
        else:
            out[spec.name] = _json_scalar(spec, value)
    return out


def _text(message: Message, indent: str) -> str:
    """A text rendering close to the text format (for logs and ``print``)."""
    lines = []
    for spec, value in message.ListFields():
        items = (list(dict.items(value)) if spec.is_map else
                 list(value) if spec.repeated else [value])
        for item in items:
            if spec.is_map:
                k, v = item
                inner = (_text(v, indent + "    ") if isinstance(v, Message)
                         else f"{indent}    value: {v!r}\n")
                lines.append(f"{indent}{spec.name} {{\n{indent}  key: {k!r}\n{inner}{indent}}}\n")
            elif isinstance(item, Message):
                lines.append(f"{indent}{spec.name} {{\n{_text(item, indent + '  ')}{indent}}}\n")
            else:
                shown = spec.enum_type.Name(item) if spec.kind == "enum" else repr(item)
                lines.append(f"{indent}{spec.name}: {shown}\n")
    return "".join(lines)


# -- building the classes -------------------------------------------------------------


class ProtoModule:
    """The classes and enums of the two files, by full and short name."""

    def __init__(self, parser: _Parser):
        self.enums: Dict[str, EnumType] = {
            name: EnumType(name, values) for name, values in parser.enums.items()}
        self.classes: Dict[str, type] = {}
        for full_name in parser.order:
            desc = MessageDescriptor(full_name, parser.messages[full_name],
                                     parser.oneofs[full_name])
            self.classes[full_name] = type(desc.name, (Message,),
                                           {"DESCRIPTOR": desc, "__slots__": ()})
        for full_name, fields in parser.messages.items():
            for spec in fields:
                for s in ([spec.map_key, spec.map_value] if spec.is_map else [spec]):
                    if s.kind == "message" and s.type_name and s.message_type is not None \
                            and isinstance(s.message_type, str):
                        parser.resolve(s)
                    if s.kind == "message" and s.type_name:
                        s.message_type = self.classes[s.type_name]
                    elif s.kind == "enum":
                        s.enum_type = self.enums[s.type_name]
                        s.message_type = None
        # nested classes and enums as attributes of their parents
        for full_name, cls in self.classes.items():
            parent = full_name.rsplit(".", 1)[0]
            if parent in self.classes:
                setattr(self.classes[parent], cls.DESCRIPTOR.name, cls)
        for full_name, enum in self.enums.items():
            parent = full_name.rsplit(".", 1)[0]
            if parent in self.classes:
                setattr(self.classes[parent], full_name.rsplit(".", 1)[1], enum)
                for key, number in enum.items():
                    setattr(self.classes[parent], key, number)
        self.methods = parser.methods

    def top_level(self, package: str, names: List[str]) -> Dict[str, Any]:
        """The module namespace of one file: its top-level messages,
        enums and enum values."""
        namespace: Dict[str, Any] = {}
        for name in names:
            full = f"{package}.{name}"
            if full in self.classes:
                namespace[name] = self.classes[full]
            elif full in self.enums:
                namespace[name] = self.enums[full]
                namespace.update(self.enums[full].items())
        return namespace


def _top_names(text: str) -> List[str]:
    """Names of the top-level messages and enums of one file."""
    names, depth = [], 0
    toks = _tokens(text)
    for i, tok in enumerate(toks):
        if tok == "{":
            depth += 1
        elif tok == "}":
            depth -= 1
        elif depth == 0 and tok in ("message", "enum"):
            names.append(toks[i + 1])
    return names


def _load() -> Tuple[ProtoModule, Dict[str, List[str]]]:
    parser = _Parser()
    top: Dict[str, List[str]] = {}
    for stem in ("model_config", "grpc_service"):
        text = (PROTO_DIR / f"{stem}.proto").read_text()
        parser.parse(text)
        top[stem] = _top_names(text)
    return ProtoModule(parser), top


MODULE, _TOP = _load()
PACKAGE = "inference"


def namespace(stem: str) -> Dict[str, Any]:
    """What ``client_tpu_torch.grpc._generated.<stem>_pb2`` exports."""
    return MODULE.top_level(PACKAGE, _TOP[stem])
