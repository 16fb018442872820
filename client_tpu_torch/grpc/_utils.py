"""gRPC client helpers: status codes, request building and error mapping.

An own copy of ``client_tpu/grpc/_utils.py``. The port imports no
grpcio, so :class:`StatusCode` and :class:`RpcError` are its own,
with grpcio's names and values: ``str(StatusCode.UNAVAILABLE)`` is
``"StatusCode.UNAVAILABLE"``, the token the resilience layer and the
reference's ``InferenceServerException.status()`` carry.
"""

import dataclasses
import enum
import ssl as _ssl
from typing import Any, Dict, Optional

from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._proto import message_to_dict
from client_tpu_torch.utils import InferenceServerException

# INT32_MAX: the reference's cap, both directions
MAX_GRPC_MESSAGE_SIZE = 2**31 - 1


@dataclasses.dataclass
class KeepAliveOptions:
    """gRPC keepalive tuning (the reference's fields): a PING every
    ``keepalive_time_ms`` (the default, INT32_MAX, sends none), the
    connection closed when one goes unanswered for
    ``keepalive_timeout_ms``."""

    keepalive_time_ms: int = 2**31 - 1
    keepalive_timeout_ms: int = 20000
    keepalive_permit_without_calls: bool = False
    http2_max_pings_without_data: int = 2


def _grpc_compression(algorithm: Optional[str]) -> Optional[str]:
    """A client's ``compression_algorithm`` as the transport takes it."""
    if algorithm is None or algorithm == "none":
        return None
    if algorithm not in ("deflate", "gzip"):
        raise InferenceServerException(
            f"unsupported compression algorithm '{algorithm}' "
            "(expected 'deflate', 'gzip', or 'none')"
        )
    return algorithm


def _to_json(message) -> Dict[str, Any]:
    """``as_json=True``: the dict ``json_format.MessageToDict(message,
    preserving_proto_field_name=True)`` gives."""
    return message_to_dict(message)


def client_ssl_context(ssl=False, creds=None, root_certificates=None, private_key=None,
                       certificate_chain=None) -> Optional[_ssl.SSLContext]:
    """The clients' TLS arguments as the transport takes them: None for
    h2c, else a stdlib ``SSLContext`` built as grpcio's
    ``ssl_channel_credentials`` builds its credentials from the same PEM
    files (the reference's clients read them so): the server verified
    against ``root_certificates`` (the system's roots when None), a client
    certificate for mutual TLS when ``certificate_chain`` and its
    ``private_key`` are given, and ALPN ``h2`` offered. As in the
    reference, the PEM paths count only with ``ssl=True``. ``creds`` (a
    ``grpc.ChannelCredentials`` object) is refused: it is grpcio's own
    type, and the port does not use grpcio."""
    if creds is not None:
        raise InferenceServerException(
            "creds: a grpc.ChannelCredentials object belongs to grpcio, which the "
            "port does not use; pass ssl=True with root_certificates, private_key "
            "and certificate_chain (PEM file paths) instead")
    if not ssl:
        return None
    try:
        context = _ssl.create_default_context(cafile=root_certificates)
        if certificate_chain:
            context.load_cert_chain(certificate_chain, private_key)
    except (OSError, ValueError) as e:
        raise InferenceServerException(f"gRPC TLS: cannot load the PEM files: {e}") from None
    context.set_alpn_protocols(["h2"])
    return context


class StatusCode(enum.Enum):
    """gRPC status codes, valued as ``grpc.StatusCode`` is: (number, name)."""

    OK = (0, "ok")
    CANCELLED = (1, "cancelled")
    UNKNOWN = (2, "unknown")
    INVALID_ARGUMENT = (3, "invalid argument")
    DEADLINE_EXCEEDED = (4, "deadline exceeded")
    NOT_FOUND = (5, "not found")
    ALREADY_EXISTS = (6, "already exists")
    PERMISSION_DENIED = (7, "permission denied")
    RESOURCE_EXHAUSTED = (8, "resource exhausted")
    FAILED_PRECONDITION = (9, "failed precondition")
    ABORTED = (10, "aborted")
    OUT_OF_RANGE = (11, "out of range")
    UNIMPLEMENTED = (12, "unimplemented")
    INTERNAL = (13, "internal")
    UNAVAILABLE = (14, "unavailable")
    DATA_LOSS = (15, "data loss")
    UNAUTHENTICATED = (16, "unauthenticated")

    @classmethod
    def from_int(cls, code: int) -> "StatusCode":
        for member in cls:
            if member.value[0] == code:
                return member
        return cls.UNKNOWN


class RpcError(Exception):
    """A failed call: ``code()``, ``details()`` and
    ``trailing_metadata()``, as grpcio's call errors have them."""

    def __init__(self, code: StatusCode, details: str = "", trailing_metadata=()):
        super().__init__(f"{code}: {details}")
        self._code = code
        self._details = details
        self._trailing = tuple(trailing_metadata or ())

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self):
        return self._trailing


def raise_error(msg: str) -> None:
    raise InferenceServerException(msg)


def rpc_error_to_exception(rpc_error: RpcError) -> InferenceServerException:
    """Map an :class:`RpcError` to the client exception type.

    A ``retry-after`` entry in the trailing metadata (seconds — what a
    shedding router or draining server attaches, the gRPC face of the
    HTTP ``Retry-After`` header) rides along as ``retry_after_s`` so the
    retry loop's server-hint backoff floor engages."""
    retry_after_s = None
    try:
        code = rpc_error.code()
        status = str(code) if code is not None else None
        details = rpc_error.details()
        trailing = rpc_error.trailing_metadata()
        if trailing:
            for key, value in trailing:
                if key == "retry-after":
                    try:
                        retry_after_s = max(0.0, float(value))
                    except (TypeError, ValueError):
                        pass
                    break
    except Exception:
        status = None
        details = str(rpc_error)
    error = InferenceServerException(
        details or "gRPC request failed", status=status
    )
    if retry_after_s is not None:
        error.retry_after_s = retry_after_s
    return error


def request_routing_key(request, key_parameter: Optional[str]):
    """The consistent-hash routing key of a built ModelInferRequest,
    read from the policy's key parameter (both gRPC clients; zero work
    when no keyed policy is installed — pass key_parameter=None)."""
    if key_parameter is None:
        return None
    if key_parameter in request.parameters:
        value = request.parameters[key_parameter]
        return value.string_param or value.int64_param
    return None


def request_is_hedgeable(request) -> bool:
    """False when a ModelInferRequest references a single-writer buffer
    — an shm-ring ticket or a shared-memory region on any input/output:
    two servers racing to fill one client-owned buffer would corrupt
    whichever response loses, so such requests never hedge. One helper
    so both gRPC clients classify identically (call only while hedging
    is armed)."""
    if "shm_ring_region" in request.parameters:
        return False
    for output in request.outputs:
        if "shared_memory_region" in output.parameters:
            return False
    for tensor in request.inputs:
        if "shared_memory_region" in tensor.parameters:
            return False
    return True


def is_sequence_request(request) -> bool:
    """True when a prepared ModelInferRequest carries sequence state
    (such requests are non-idempotent and must never be auto-retried)."""
    if "sequence_id" not in request.parameters:
        return False
    param = request.parameters["sequence_id"]
    return bool(param.int64_param or param.string_param)


def set_parameter(proto_params, key: str, value: Any) -> None:
    if isinstance(value, bool):
        proto_params[key].bool_param = value
    elif isinstance(value, int):
        proto_params[key].int64_param = value
    elif isinstance(value, float):
        proto_params[key].double_param = value
    elif isinstance(value, str):
        proto_params[key].string_param = value
    else:
        raise InferenceServerException(
            f"unsupported parameter type {type(value).__name__} for '{key}'"
        )


_RESERVED_PARAMS = frozenset(
    (
        "sequence_id",
        "sequence_start",
        "sequence_end",
        "priority",
        "timeout",
        "shared_memory_region",
        "shared_memory_byte_size",
        "shared_memory_offset",
        "classification",
        "binary_data",
        "binary_data_size",
        "binary_data_output",
    )
)


def get_inference_request(
    model_name: str,
    inputs,
    model_version: str = "",
    request_id: str = "",
    outputs=None,
    sequence_id: int = 0,
    sequence_start: bool = False,
    sequence_end: bool = False,
    priority: int = 0,
    timeout: Optional[int] = None,
    parameters: Optional[Dict[str, Any]] = None,
) -> pb.ModelInferRequest:
    """Build a ModelInferRequest proto from client-side tensor objects."""
    request = pb.ModelInferRequest(
        model_name=model_name, model_version=model_version
    )
    if request_id:
        request.id = request_id
    if sequence_id != 0 and sequence_id != "":
        if isinstance(sequence_id, str):
            request.parameters["sequence_id"].string_param = sequence_id
        else:
            request.parameters["sequence_id"].int64_param = sequence_id
        request.parameters["sequence_start"].bool_param = bool(sequence_start)
        request.parameters["sequence_end"].bool_param = bool(sequence_end)
    if priority != 0:
        request.parameters["priority"].uint64_param = priority
    if timeout is not None:
        request.parameters["timeout"].int64_param = timeout
    if parameters:
        for key, value in parameters.items():
            if key in _RESERVED_PARAMS:
                raise InferenceServerException(
                    f"parameter '{key}' is reserved; use the dedicated "
                    "keyword argument"
                )
            set_parameter(request.parameters, key, value)
    for infer_input in inputs:
        tensor = request.inputs.add()
        tensor.CopyFrom(infer_input._get_tensor())
        raw = infer_input._get_raw_content()
        if raw is not None:
            request.raw_input_contents.append(raw)
    if outputs:
        for infer_output in outputs:
            request.outputs.add().CopyFrom(infer_output._get_tensor())
    return request
