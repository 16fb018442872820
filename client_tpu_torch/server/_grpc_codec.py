"""Shared gRPC method codec: proto bytes <-> ServerCore calls.

An own copy of ``client_tpu/server/_grpc_codec.py``, on the port's proto3
runtime (``client_tpu_torch.grpc._proto``) instead of protobuf.

Every non-inference RPC of inference.GRPCInferenceService is a synchronous
request->response exchange over :class:`ServerCore`, implemented here on
serialized messages for the native front-end (``native_frontend.py``),
which hands undecoded method payloads to Python. The ModelInfer codec
lives here too: :class:`FastInferCodec` (the protobuf-free fast path of
``client_tpu_torch.grpc._wire``) with the message codec
(:func:`build_core_request`, :func:`build_proto_response`, the reference's
``grpc_server.py`` helpers) behind it for every shape it declines. The
``CudaSharedMemory*`` RPCs answer empty, as the HTTP routes do.
"""

from typing import Any, Callable, Dict, Tuple

import numpy as np

from client_tpu_torch.grpc import _wire
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._generated import model_config_pb2 as mc
from client_tpu_torch.observability.profiling import stage_scope
from client_tpu_torch.server import shm_ring
from client_tpu_torch.server.core import (
    SERVER_EXTENSIONS,
    SERVER_NAME,
    SERVER_VERSION,
    CoreRequest,
    CoreRequestedOutput,
    CoreResponse,
    CoreTensor,
    ServerCore,
)
from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    num_elements,
    serialize_byte_tensor,
    triton_to_np_dtype,
)

# gRPC status codes (subset used here; numeric so the native front-end can
# put them straight into the grpc-status trailer).
GRPC_OK = 0
GRPC_DEADLINE_EXCEEDED = 4
GRPC_INVALID_ARGUMENT = 3
GRPC_NOT_FOUND = 5
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_UNIMPLEMENTED = 12
GRPC_INTERNAL = 13
GRPC_UNAVAILABLE = 14

# grpc.StatusCode names (as carried by SchedulingError.grpc_code) ->
# numeric codes, for exception-aware callers.
_CODE_BY_NAME = {
    "DEADLINE_EXCEEDED": GRPC_DEADLINE_EXCEEDED,
    "INVALID_ARGUMENT": GRPC_INVALID_ARGUMENT,
    "NOT_FOUND": GRPC_NOT_FOUND,
    "RESOURCE_EXHAUSTED": GRPC_RESOURCE_EXHAUSTED,
    "UNIMPLEMENTED": GRPC_UNIMPLEMENTED,
    "INTERNAL": GRPC_INTERNAL,
    "UNAVAILABLE": GRPC_UNAVAILABLE,
}


def status_code_for(message: str, exc=None) -> int:
    """Map an InferenceServerException (or its message) to a gRPC status
    code. Exceptions that declare ``grpc_code`` (the scheduling layer's
    admission rejections) win; message patterns cover callers that only
    have the text (the native front-end's completion path)."""
    if exc is not None:
        code = _CODE_BY_NAME.get(getattr(exc, "grpc_code", None))
        if code is not None:
            return code
    lowered = message.lower()
    if "queue" in lowered and "full" in lowered:
        return GRPC_RESOURCE_EXHAUSTED
    if "timed out in queue" in lowered:
        return GRPC_DEADLINE_EXCEEDED
    if "not found" in lowered or "unknown model" in lowered:
        return GRPC_NOT_FOUND
    if (
        "not ready" in lowered
        or "unavailable" in lowered
        or "draining" in lowered
        or "not accepting new inference" in lowered
    ):
        return GRPC_UNAVAILABLE
    if "not implemented" in lowered or "no cuda" in lowered:
        return GRPC_UNIMPLEMENTED
    return GRPC_INVALID_ARGUMENT


class RpcError(Exception):
    """A method failure carrying its gRPC status code."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def params_to_dict(proto_params) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, p in proto_params.items():
        which = p.WhichOneof("parameter_choice")
        if which is not None:
            out[key] = getattr(p, which)
    return out


def dict_to_params(values: Dict[str, Any], proto_params) -> None:
    for key, value in values.items():
        if isinstance(value, bool):
            proto_params[key].bool_param = value
        elif isinstance(value, int):
            proto_params[key].int64_param = value
        elif isinstance(value, float):
            proto_params[key].double_param = value
        else:
            proto_params[key].string_param = str(value)


# -- per-method handlers (request proto -> response proto) -------------------


def _server_live(core: ServerCore, request):
    return pb.ServerLiveResponse(live=core.live)


def _server_ready(core: ServerCore, request):
    # Real readiness (was a copy of _server_live): live AND accepting
    # (drain-aware) AND repository ready set non-degraded. Shared by the
    # grpc.aio servicer and the native C++ front-end.
    return pb.ServerReadyResponse(ready=core.ready)


def _model_ready(core: ServerCore, request):
    return pb.ModelReadyResponse(
        ready=core.repository.is_ready(request.name, request.version)
    )


def _server_metadata(core: ServerCore, request):
    return pb.ServerMetadataResponse(
        name=SERVER_NAME, version=SERVER_VERSION, extensions=SERVER_EXTENSIONS
    )


def _model_metadata(core: ServerCore, request):
    model = core.repository.get(request.name, request.version)
    meta = model.metadata()
    response = pb.ModelMetadataResponse(
        name=meta["name"],
        versions=meta["versions"],
        platform=meta["platform"],
    )
    for io_key, target in (
        ("inputs", response.inputs),
        ("outputs", response.outputs),
    ):
        for tensor in meta[io_key]:
            target.add(
                name=tensor["name"],
                datatype=tensor["datatype"],
                shape=tensor["shape"],
            )
    return response


def _model_config(core: ServerCore, request):
    model = core.repository.get(request.name, request.version)
    cfg = model.config()
    proto = mc.ModelConfig(
        name=cfg["name"],
        platform=cfg["platform"],
        backend=cfg["backend"],
        max_batch_size=cfg["max_batch_size"],
    )
    for tensor in cfg["input"]:
        proto.input.add(
            name=tensor["name"],
            data_type=mc.DataType.Value(tensor["data_type"]),
            dims=tensor["dims"],
        )
    for tensor in cfg["output"]:
        proto.output.add(
            name=tensor["name"],
            data_type=mc.DataType.Value(tensor["data_type"]),
            dims=tensor["dims"],
        )
    proto.model_transaction_policy.decoupled = cfg["model_transaction_policy"][
        "decoupled"
    ]
    # Scheduler declarations (reference model_parser.cc detection inputs).
    if "dynamic_batching" in cfg:
        proto.dynamic_batching.SetInParent()
    if "sequence_batching" in cfg:
        proto.sequence_batching.SetInParent()
    # Free-form config parameters (the "mesh" topology document for
    # sharded models — the gRPC face of the HTTP metadata devices block).
    for key, value in cfg.get("parameters", {}).items():
        proto.parameters[key].string_value = value.get("string_value", "")
    if "ensemble_scheduling" in cfg:
        for step in cfg["ensemble_scheduling"].get("step", []):
            entry = proto.ensemble_scheduling.step.add(
                model_name=step["model_name"],
                model_version=int(step.get("model_version", -1)),
            )
            entry.input_map.update(step.get("input_map", {}))
            entry.output_map.update(step.get("output_map", {}))
    return pb.ModelConfigResponse(config=proto)


def _model_statistics(core: ServerCore, request):
    stats = core.statistics(request.name, request.version)
    response = pb.ModelStatisticsResponse()
    for snap in stats["model_stats"]:
        entry = response.model_stats.add(
            name=snap["name"],
            version=snap["version"],
            last_inference=snap["last_inference"],
            inference_count=snap["inference_count"],
            execution_count=snap["execution_count"],
        )
        for field, duration in snap["inference_stats"].items():
            target = getattr(entry.inference_stats, field)
            target.count = duration["count"]
            target.ns = duration["ns"]
        for key, fields in snap.get("response_stats", {}).items():
            rs = entry.response_stats[key]
            for field, duration in fields.items():
                target = getattr(rs, field)
                target.count = duration["count"]
                target.ns = duration["ns"]
    return response


def _repository_index(core: ServerCore, request):
    response = pb.RepositoryIndexResponse()
    for entry in core.repository.index():
        if request.ready and entry["state"] != "READY":
            continue
        response.models.add(**entry)
    return response


def _repository_model_load(core: ServerCore, request):
    params = params_to_dict(request.parameters)
    config = params.get("config")
    core.load_model(
        request.model_name,
        config_override=config if isinstance(config, str) else None,
    )
    return pb.RepositoryModelLoadResponse()


def _repository_model_unload(core: ServerCore, request):
    # Drain-aware unload through the core (see ServerCore.unload_model);
    # the RPC returns once the model stops admitting — the drain itself
    # runs in the background, Triton-style.
    core.unload_model(request.model_name)
    return pb.RepositoryModelUnloadResponse()


def _system_shm_status(core: ServerCore, request):
    response = pb.SystemSharedMemoryStatusResponse()
    for name, region in core.shm.status("system", request.name).items():
        response.regions[name].name = region["name"]
        response.regions[name].key = region["key"]
        response.regions[name].offset = region["offset"]
        response.regions[name].byte_size = region["byte_size"]
    return response


def _system_shm_register(core: ServerCore, request):
    core.shm.register_system(
        request.name, request.key, request.offset, request.byte_size
    )
    return pb.SystemSharedMemoryRegisterResponse()


def _system_shm_unregister(core: ServerCore, request):
    if request.name:
        core.shm.unregister(request.name, kind="system")
    else:
        core.shm.unregister_all(kind="system")
    return pb.SystemSharedMemoryUnregisterResponse()


def _cuda_shm_status(core: ServerCore, request):
    return pb.CudaSharedMemoryStatusResponse()


def _cuda_shm_register(core: ServerCore, request):
    raise RpcError(
        GRPC_UNIMPLEMENTED,
        "this server has no CUDA devices; use TPU or system shared memory",
    )


def _cuda_shm_unregister(core: ServerCore, request):
    return pb.CudaSharedMemoryUnregisterResponse()


def _tpu_shm_status(core: ServerCore, request):
    response = pb.TpuSharedMemoryStatusResponse()
    for name, region in core.shm.status("tpu", request.name).items():
        response.regions[name].name = region["name"]
        response.regions[name].device_id = region["device_id"]
        response.regions[name].byte_size = region["byte_size"]
        response.regions[name].key = region["key"]
    return response


def _tpu_shm_register(core: ServerCore, request):
    core.shm.register_tpu(
        request.name, request.raw_handle, request.device_id, request.byte_size
    )
    return pb.TpuSharedMemoryRegisterResponse()


def _tpu_shm_unregister(core: ServerCore, request):
    if request.name:
        core.shm.unregister(request.name, kind="tpu")
    else:
        core.shm.unregister_all(kind="tpu")
    return pb.TpuSharedMemoryUnregisterResponse()


def _trace_setting(core: ServerCore, request):
    """The trace-settings RPC, backed by the real TraceManager: validated
    updates (unknown keys / wrong types -> INVALID_ARGUMENT), per-model
    overrides via ``model_name``, and an empty value clearing a setting
    (Triton semantics)."""
    updates = {}
    for key, value in request.settings.items():
        updates[key] = list(value.value) if value.value else None
    if updates:
        settings = core.trace_manager.update(updates, request.model_name)
    else:
        settings = core.trace_manager.settings(request.model_name)
    response = pb.TraceSettingResponse()
    for key, value in settings.items():
        values = value if isinstance(value, list) else [str(value)]
        response.settings[key].value.extend([str(v) for v in values])
    return response


def _log_settings(core: ServerCore, request):
    """The logging-settings RPC, backed by the real structured logger:
    updates change what the server emits immediately. The proto carries
    no model field, so a per-model override rides in as a reserved
    "model" settings key (the HTTP face accepts the same key alongside
    its /v2/models/{model}/logging route)."""
    updates = {}
    for key, value in request.settings.items():
        which = value.WhichOneof("parameter_choice")
        if which is not None:
            updates[key] = getattr(value, which)
    model = updates.pop("model", "")
    if not isinstance(model, str):
        raise InferenceServerException(
            f"log setting 'model' expects a string, got {model!r}"
        )
    settings = core.logger.update(updates, model)
    response = pb.LogSettingsResponse()
    for key, value in settings.items():
        if isinstance(value, bool):
            response.settings[key].bool_param = value
        elif isinstance(value, int):
            response.settings[key].uint32_param = value
        else:
            response.settings[key].string_param = str(value)
    return response


# method name (last :path segment) -> (request class, handler)
METHODS: Dict[str, Tuple[Any, Callable]] = {
    "ServerLive": (pb.ServerLiveRequest, _server_live),
    "ServerReady": (pb.ServerReadyRequest, _server_ready),
    "ModelReady": (pb.ModelReadyRequest, _model_ready),
    "ServerMetadata": (pb.ServerMetadataRequest, _server_metadata),
    "ModelMetadata": (pb.ModelMetadataRequest, _model_metadata),
    "ModelConfig": (pb.ModelConfigRequest, _model_config),
    "ModelStatistics": (pb.ModelStatisticsRequest, _model_statistics),
    "RepositoryIndex": (pb.RepositoryIndexRequest, _repository_index),
    "RepositoryModelLoad": (pb.RepositoryModelLoadRequest, _repository_model_load),
    "RepositoryModelUnload": (
        pb.RepositoryModelUnloadRequest,
        _repository_model_unload,
    ),
    "SystemSharedMemoryStatus": (
        pb.SystemSharedMemoryStatusRequest,
        _system_shm_status,
    ),
    "SystemSharedMemoryRegister": (
        pb.SystemSharedMemoryRegisterRequest,
        _system_shm_register,
    ),
    "SystemSharedMemoryUnregister": (
        pb.SystemSharedMemoryUnregisterRequest,
        _system_shm_unregister,
    ),
    "CudaSharedMemoryStatus": (
        pb.CudaSharedMemoryStatusRequest,
        _cuda_shm_status,
    ),
    "CudaSharedMemoryRegister": (
        pb.CudaSharedMemoryRegisterRequest,
        _cuda_shm_register,
    ),
    "CudaSharedMemoryUnregister": (
        pb.CudaSharedMemoryUnregisterRequest,
        _cuda_shm_unregister,
    ),
    "TpuSharedMemoryStatus": (pb.TpuSharedMemoryStatusRequest, _tpu_shm_status),
    "TpuSharedMemoryRegister": (
        pb.TpuSharedMemoryRegisterRequest,
        _tpu_shm_register,
    ),
    "TpuSharedMemoryUnregister": (
        pb.TpuSharedMemoryUnregisterRequest,
        _tpu_shm_unregister,
    ),
    "TraceSetting": (pb.TraceSettingRequest, _trace_setting),
    "LogSettings": (pb.LogSettingsRequest, _log_settings),
}


def handle_method(core: ServerCore, method: str, request_proto):
    """Run one non-inference method on a decoded request proto.

    Returns the response proto; raises :class:`RpcError` on failure.
    Thread-CPU books under the "rpc" profiling stage when stage-CPU
    accounting is enabled: statistics/metadata scrapes share the serving
    threads, so their cycles are part of the wire path's CPU bill and
    must show up in the attribution, not hide in the unaccounted rest.
    The native front-end routes here through :func:`handle_method_bytes`.
    """
    entry = METHODS.get(method)
    if entry is None:
        raise RpcError(GRPC_UNIMPLEMENTED, f"unknown method '{method}'")
    with stage_scope(core.profiling, "rpc"):
        try:
            return entry[1](core, request_proto)
        except RpcError:
            raise
        except InferenceServerException as e:
            raise RpcError(status_code_for(e.message()), e.message()) from e


def handle_method_bytes(core: ServerCore, method: str, payload: bytes) -> bytes:
    """Wire-level entry for the native front-end: parse, run, serialize."""
    entry = METHODS.get(method)
    if entry is None:
        raise RpcError(GRPC_UNIMPLEMENTED, f"unknown method '{method}'")
    request = entry[0]()
    try:
        request.ParseFromString(payload)
    except Exception as e:  # noqa: BLE001 - malformed wire bytes
        raise RpcError(GRPC_INTERNAL, f"failed to parse {method} request: {e}")
    return handle_method(core, method, request).SerializeToString()


# -- the ModelInfer message codec ---------------------------------------------

_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}


def build_core_request(core: ServerCore, request) -> CoreRequest:
    """A decoded ModelInferRequest -> CoreRequest (the reference's
    ``grpc_server.build_core_request``)."""
    core_request = CoreRequest(
        model_name=request.model_name,
        model_version=request.model_version,
        id=request.id,
        parameters=params_to_dict(request.parameters),
    )
    # raw_input_contents entries are consumed in order by the inputs that
    # are NOT sourced from shared memory (Triton semantics: shm inputs
    # contribute no raw entry).
    n_raw = len(request.raw_input_contents)
    raw_index = 0
    for tensor in request.inputs:
        params = params_to_dict(tensor.parameters)
        shm_region = params.get("shared_memory_region")
        raw = None
        json_data = None
        if shm_region is not None:
            pass
        elif raw_index < n_raw:
            raw = request.raw_input_contents[raw_index]
            raw_index += 1
        elif tensor.HasField("contents"):
            field = _CONTENTS_FIELD.get(tensor.datatype)
            if field is None:
                raise InferenceServerException(
                    f"datatype '{tensor.datatype}' has no proto contents "
                    "representation; use raw_input_contents"
                )
            json_data = list(getattr(tensor.contents, field))
        core_request.inputs.append(
            core.decode_input(
                tensor.name,
                tensor.datatype,
                list(tensor.shape),
                raw=raw,
                json_data=json_data,
                shm_region=shm_region,
                shm_byte_size=int(params.get("shared_memory_byte_size", 0)),
                shm_offset=int(params.get("shared_memory_offset", 0)),
            )
        )
    if raw_index != n_raw:
        raise InferenceServerException(
            f"raw_input_contents has {n_raw} entries but only "
            f"{raw_index} non-shared-memory inputs consumed them"
        )
    for out in request.outputs:
        params = params_to_dict(out.parameters)
        core_request.outputs.append(
            CoreRequestedOutput(
                name=out.name,
                classification=int(params.get("classification", 0)),
                shm_region=params.get("shared_memory_region"),
                shm_byte_size=int(params.get("shared_memory_byte_size", 0)),
                shm_offset=int(params.get("shared_memory_offset", 0)),
            )
        )
    return core_request


def build_proto_response(core_response: CoreResponse):
    """CoreResponse -> ModelInferResponse message (the reference's
    ``grpc_server.build_proto_response``)."""
    response = pb.ModelInferResponse(
        model_name=core_response.model_name,
        model_version=core_response.model_version,
        id=core_response.id,
    )
    dict_to_params(core_response.parameters, response.parameters)
    for tensor in core_response.outputs:
        out = response.outputs.add(
            name=tensor.name,
            datatype=tensor.datatype,
            shape=tensor.shape,
        )
        if tensor.name in core_response.shm_outputs:
            region, size, offset = core_response.shm_outputs[tensor.name]
            out.parameters["shared_memory_region"].string_param = region
            out.parameters["shared_memory_byte_size"].int64_param = size
            if offset:
                out.parameters["shared_memory_offset"].int64_param = offset
            response.raw_output_contents.append(b"")
        elif tensor.datatype == "BYTES":
            response.raw_output_contents.append(
                serialize_byte_tensor(tensor.data).tobytes()
            )
        else:
            response.raw_output_contents.append(
                np.ascontiguousarray(tensor.data).tobytes()
            )
    return response


# -- protobuf-free ModelInfer fast path ---------------------------------------
#
# The common small-request shape (raw tensor contents, no per-tensor
# parameters, no typed contents) decodes and encodes through the
# hand-rolled wire scanner in client_tpu_torch.grpc._wire, with no message
# objects on the hot path. Anything else falls back to the message codec
# above, so the wire contract never forks; tests/test_torch_grpc.py holds
# both to the reference's bytes.


class ScratchBuffer:
    """A reusable, *bounded* bytearray for wire encoding.

    One oversized response must not pin its peak for the connection's
    lifetime: after an encode that grew the buffer past ``cap_bytes``
    the buffer is released and a fresh default-sized one allocated on
    next use (satellite: bounded per-connection scratch)."""

    DEFAULT_BYTES = 1 << 16

    __slots__ = ("cap_bytes", "_buf", "high_water")

    def __init__(self, cap_bytes: int = 4 << 20):
        self.cap_bytes = cap_bytes
        self._buf = bytearray()
        self.high_water = 0

    def take(self) -> bytearray:
        """The cleared scratch (hold only across one synchronous encode)."""
        buf = self._buf
        del buf[:]
        return buf

    def seal(self, buf: bytearray) -> bytes:
        """Snapshot the encoded bytes and apply the shrink policy."""
        data = bytes(buf)
        if len(buf) > self.high_water:
            self.high_water = len(buf)
        if len(buf) > self.cap_bytes:
            self._buf = bytearray()
        return data

    @property
    def capacity(self) -> int:
        """Currently retained backing capacity (for the bound test)."""
        return len(self._buf) if self._buf is not None else 0


class FastInferCodec:
    """Per-front-end ModelInfer codec: fast path + proto fallback.

    One instance per servicer/pump (its scratch is reused across
    requests and must not be shared across threads). Books
    ``tpu_codec_fastpath_total{outcome}`` per decode and falls back to
    the proto codec for any shape the scanner declines.
    """

    _CACHE_MAX = 512  # bounded like the scanner's prefix cache

    def __init__(self, core: ServerCore, scratch_cap_bytes: int = 4 << 20):
        self._wire = _wire
        self._np = np
        self._CoreRequest = CoreRequest
        self._CoreTensor = CoreTensor
        self._CoreRequestedOutput = CoreRequestedOutput
        self._deserialize_bytes = deserialize_bytes_tensor
        self._serialize_bytes = serialize_byte_tensor
        self._num_elements = num_elements
        self._triton_to_np = triton_to_np_dtype
        self.core = core
        self.scratch = ScratchBuffer(scratch_cap_bytes)
        self._scanner = _wire.RequestScanner()
        self._metrics = core.metrics
        # encode-side templates: serialized fields 1-2 per (model,
        # version) and the concatenated outputs-meta block per tensor
        # signature — responses under load share both
        self._head_cache: Dict[Tuple[str, str], bytes] = {}
        self._meta_cache: Dict[Any, bytes] = {}

    # -- decode --------------------------------------------------------------

    def _prepare(self, template):
        """Per-template decode plan, computed once per cached prefix:
        (name, datatype, shape, np dtype or None-for-BYTES or
        False-for-unknown, expected bytes) per input, plus the shared
        CoreRequestedOutput objects (read-only downstream)."""
        plan = []
        for name, datatype, shape in template.inputs:
            if datatype == "BYTES":
                plan.append((name, datatype, shape, None, -1))
                continue
            np_dtype = self._triton_to_np(datatype)
            if np_dtype is None:
                plan.append((name, datatype, shape, False, 0))
            else:
                expected = self._num_elements(shape) * np_dtype.itemsize
                plan.append((name, datatype, shape, np_dtype, expected))
        outputs = [
            self._CoreRequestedOutput(name=n) for n in template.output_names
        ]
        template.prepared = (plan, outputs)
        return template.prepared

    def decode_request(self, data):
        """Serialized ModelInferRequest bytes -> CoreRequest, or None
        when the request is outside the fast shape (caller parses with
        the proto codec). Raises InferenceServerException on invalid
        tensor framing (same messages as ``ServerCore.decode_input``)."""
        wire = self._wire
        try:
            scanned = self._scanner.scan(data)
        except wire.WireError:
            scanned = None
        if scanned is None:
            self._metrics.observe_codec("fallback")
            return None
        template, request_id, extra_params, raws = scanned
        self._metrics.observe_codec("hit")
        prepared = template.prepared
        if prepared is None:
            prepared = self._prepare(template)
        plan, req_outputs = prepared
        n_raw = len(raws)
        if n_raw != len(plan):
            if n_raw < len(plan):
                raise InferenceServerException(
                    f"input '{plan[n_raw][0]}' has no data (inline, JSON, "
                    "or shared memory)"
                )
            raise InferenceServerException(
                f"raw_input_contents has {n_raw} entries but only "
                f"{len(plan)} non-shared-memory inputs consumed them"
            )
        np = self._np
        CoreTensor = self._CoreTensor
        inputs = []
        for i, (name, datatype, shape, np_dtype, expected) in enumerate(plan):
            raw = raws[i]
            if np_dtype is None:
                arr = self._deserialize_bytes(bytes(raw)).reshape(shape)
            elif np_dtype is False:
                raise InferenceServerException(
                    f"unsupported datatype '{datatype}' for input '{name}'"
                )
            else:
                if len(raw) != expected:
                    raise InferenceServerException(
                        f"input '{name}' expected {expected} bytes for "
                        f"shape {shape} and datatype {datatype}, got "
                        f"{len(raw)}"
                    )
                arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
            inputs.append(CoreTensor(name, datatype, shape, arr))
        # the template is shared across requests: copy before the
        # ring/scheduling layers pop entries out of it; excised
        # per-request params (ring slot/seq) merge back in
        if template.parameters:
            parameters = dict(template.parameters)
            if extra_params:
                parameters.update(extra_params)
        else:
            parameters = dict(extra_params) if extra_params else {}
        return self._CoreRequest(
            model_name=template.model_name,
            model_version=template.model_version,
            id=request_id,
            inputs=inputs,
            outputs=list(req_outputs) if req_outputs else [],
            parameters=parameters,
        )

    # -- encode --------------------------------------------------------------

    def _response_parts(self, core_response):
        """CoreResponse -> (outputs meta, raw contents) for the wire
        builder; mirrors build_proto_response field for field."""
        outputs = []
        raws = []
        shm_outputs = core_response.shm_outputs
        for t in core_response.outputs:
            shm = shm_outputs.get(t.name)
            if shm is not None:
                region, size, offset = shm
                params = {
                    "shared_memory_region": region,
                    "shared_memory_byte_size": int(size),
                }
                if offset:
                    params["shared_memory_offset"] = int(offset)
                outputs.append((t.name, t.datatype, t.shape, params))
                raws.append(b"")
            elif t.datatype == "BYTES":
                outputs.append((t.name, t.datatype, t.shape, None))
                raws.append(serialize_byte_tensor(t.data).tobytes())
            else:
                data = t.data
                if type(data) is not np.ndarray or not data.flags.c_contiguous:
                    data = np.ascontiguousarray(data)
                outputs.append((t.name, t.datatype, t.shape, None))
                raws.append(data.data.cast("B") if data.ndim else data.tobytes())
        return outputs, raws

    def encode_response(self, core_response) -> bytes:
        """CoreResponse -> serialized ModelInferResponse bytes (never
        fails over the wire: shapes the hand encoder declines fall back
        to the proto builder)."""
        np = self._np
        serialize_byte_tensor = self._serialize_bytes
        wire = self._wire
        try:
            if core_response.shm_outputs:
                # per-output parameter maps: rare path, build in full
                buf = self.scratch.take()
                outputs, raws = self._response_parts(core_response)
                wire.encode_infer_response(
                    buf,
                    core_response.model_name,
                    core_response.model_version,
                    core_response.id,
                    core_response.parameters,
                    outputs,
                    raws,
                )
                return self.scratch.seal(buf)
            buf = self.scratch.take()
            head_key = (core_response.model_name, core_response.model_version)
            head = self._head_cache.get(head_key)
            if head is None:
                if len(self._head_cache) >= self._CACHE_MAX:
                    self._head_cache.clear()
                head = self._head_cache[head_key] = wire.encode_head(
                    *head_key
                )
            buf += head
            if core_response.id:
                rid = core_response.id.encode("utf-8")
                buf.append(0x1A)
                wire.write_varint(buf, len(rid))
                buf += rid
            if core_response.parameters:
                wire._encode_params_map(buf, 0x22, core_response.parameters)
            tensors = core_response.outputs
            meta_key = tuple(
                (t.name, t.datatype, tuple(t.shape)) for t in tensors
            )
            meta = self._meta_cache.get(meta_key)
            if meta is None:
                if len(self._meta_cache) >= self._CACHE_MAX:
                    self._meta_cache.clear()
                meta = self._meta_cache[meta_key] = (
                    wire.encode_output_meta_block(meta_key)
                )
            buf += meta
            for t in tensors:
                if t.datatype == "BYTES":
                    raw = serialize_byte_tensor(t.data).tobytes()
                else:
                    data = t.data
                    if (
                        type(data) is not np.ndarray
                        or not data.flags.c_contiguous
                    ):
                        data = np.ascontiguousarray(data)
                    raw = (
                        data.data.cast("B") if data.ndim else data.tobytes()
                    )
                buf.append(0x32)
                wire.write_varint(buf, len(raw))
                buf += raw
            return self.scratch.seal(buf)
        except Exception:  # noqa: BLE001 - parity net: proto must agree
            self._metrics.observe_codec("encode_fallback")
            return build_proto_response(core_response).SerializeToString()

    def encode_stream_response(self, core_response) -> bytes:
        """CoreResponse -> serialized ModelStreamInferResponse bytes."""
        body = self.encode_response(core_response)
        buf = self.scratch.take()
        self._wire.encode_stream_response(buf, body)
        return self.scratch.seal(buf)

    def encode_stream_error(self, message: str, request_id: str = "") -> bytes:
        """In-band stream error frame (error_message + id-only response)."""
        inner = bytearray()
        self._wire.encode_infer_response(
            inner, "", "", request_id, None, (), ()
        )
        buf = self.scratch.take()
        self._wire.encode_stream_response(
            buf, bytes(inner), error_message=message
        )
        return self.scratch.seal(buf)

    def decode_infer(self, data) -> CoreRequest:
        """Serialized ModelInferRequest -> CoreRequest: the fast path
        first, the message codec for anything it declines. Resolves
        shm-ring parameters (inputs then view the ring slot)."""
        core_request = self.decode_request(data)
        if core_request is None:
            try:
                request = pb.ModelInferRequest.FromString(data)
            except Exception as e:  # noqa: BLE001 - malformed wire bytes
                raise InferenceServerException(
                    f"failed to parse ModelInferRequest: {e}"
                ) from None
            core_request = build_core_request(self.core, request)
        shm_ring.attach(self.core, core_request)
        return core_request
