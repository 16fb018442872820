"""Persistent multiplexed inference streams (client side).

An own copy of ``client_tpu/grpc/_mux.py``, on the port's own h2c/TLS
transport (:mod:`client_tpu_torch.grpc._h2`) instead of grpcio.

Unary ``infer()`` over gRPC pays per-RPC machinery — a header block, a
fresh HTTP/2 stream, its trailers — per request. Stream mode
(``InferenceServerClient(stream_mode=True)``) amortizes all of it: every
unary infer rides ONE long-lived ``ModelStreamInfer`` bidi stream as a
message pair, correlated by request id. The server executes each stream
request as its own task (the ``multiplex`` request parameter marks them)
and the responses resolve per-request futures as they arrive, in any
order.

* :class:`AioStreamMultiplexer` — requests are serialized by the
  protobuf-free builder in :mod:`client_tpu_torch.grpc._wire` (head +
  tensor-metadata blocks are memoized per signature, so the steady state
  appends raw tensor bytes to cached templates); shapes the fast builder
  declines fall back to the message builder. A stream torn down with
  UNAVAILABLE fails its in-flight requests with a retryable error (never
  silently replayed) and the next request reopens it under the client's
  retry policy. The blocking client runs this same multiplexer on its
  event loop (the reference has a second, ``SyncStreamMultiplexer``, for
  grpcio's blocking API, which the port does not stand on).

Request ids: callers may pass their own ``request_id``; it must be unique
among in-flight requests, and one that is not is refused (the reference
lets the later waiter take the earlier one's response). Otherwise the mux
stamps ``mx<N>``.
"""

import asyncio
from typing import Any, Dict, Optional

from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._utils import (
    RpcError,
    get_inference_request,
    rpc_error_to_exception,
)
from client_tpu_torch.utils import InferenceServerException

# bounded like the server codec's template caches
_CACHE_MAX = 256


def _derive_status(message: str) -> Optional[str]:
    """Status for an in-band stream error. The wire frame carries only
    the message text — without a derived status, a drain rejection or
    queue-full that is RETRYABLE on the unary path (gRPC UNAVAILABLE /
    RESOURCE_EXHAUSTED) would be terminal under stream mode and never
    trigger pool failover. Mirrors the server's message patterns
    (server._grpc_codec.status_code_for) for the retry-relevant codes."""
    lowered = message.lower()
    if "queue" in lowered and "full" in lowered:
        return "StatusCode.RESOURCE_EXHAUSTED"
    if "timed out in queue" in lowered:
        return "StatusCode.DEADLINE_EXCEEDED"
    if (
        "not ready" in lowered
        or "unavailable" in lowered
        or "draining" in lowered
        or "not accepting new inference" in lowered
    ):
        return "StatusCode.UNAVAILABLE"
    return None


def _inband_error(message: str) -> InferenceServerException:
    return InferenceServerException(message, status=_derive_status(message))


def _duplicate_id(rid: str) -> InferenceServerException:
    return InferenceServerException(
        f"request id '{rid}' is already in flight on the multiplexed stream; "
        "ids must be unique among in-flight requests",
        status="StatusCode.INVALID_ARGUMENT",
    )


class _FastRequestBuilder:
    """Protobuf-free ModelInferRequest serializer with memoized
    head/metadata blocks (the client mirror of the server's encode
    templates). ``build`` returns None for shapes it does not cover —
    the caller falls back to the message builder."""

    __slots__ = ("_wire", "_head_cache", "_meta_cache")

    def __init__(self):
        from client_tpu_torch.grpc import _wire

        self._wire = _wire
        self._head_cache: Dict[Any, bytes] = {}
        self._meta_cache: Dict[Any, bytes] = {}

    def build(
        self,
        model_name: str,
        inputs,
        model_version: str,
        request_id: str,
        outputs,
        parameters: Optional[Dict[str, Any]],
    ) -> Optional[bytes]:
        wire = self._wire
        raws = []
        sig = []
        for inp in inputs:
            raw = inp._get_raw_content()
            if raw is None:
                return None  # shared-memory/typed-contents input
            raws.append(raw)
            sig.append((inp.name(), inp.datatype(), tuple(inp.shape())))
        out_names = ()
        if outputs:
            for out in outputs:
                tensor = out._get_tensor()
                if tensor.parameters:
                    return None  # classification / shm-ref outputs
            out_names = tuple(out._get_tensor().name for out in outputs)
        head_key = (model_name, model_version)
        head = self._head_cache.get(head_key)
        if head is None:
            if len(self._head_cache) >= _CACHE_MAX:
                self._head_cache.clear()
            head = self._head_cache[head_key] = wire.encode_head(*head_key)
        meta_key = (tuple(sig), out_names)
        meta = self._meta_cache.get(meta_key)
        if meta is None:
            if len(self._meta_cache) >= _CACHE_MAX:
                self._meta_cache.clear()
            meta = self._meta_cache[meta_key] = wire.encode_input_meta_block(
                sig, out_names
            )
        buf = bytearray(head)
        if request_id:
            rid = request_id.encode("utf-8")
            buf.append(0x1A)
            wire.write_varint(buf, len(rid))
            buf += rid
        if parameters:
            wire._encode_params_map(buf, 0x22, parameters)
        buf += meta
        for raw in raws:
            buf.append(0x3A)
            wire.write_varint(buf, len(raw))
            buf += raw
        return bytes(buf)


def _proto_request_bytes(
    model_name,
    inputs,
    model_version,
    request_id,
    outputs,
    parameters,
    priority,
    timeout,
    sequence_id,
    sequence_start,
    sequence_end,
) -> bytes:
    """Fallback: the message builder + the mux correlation fields."""
    request = get_inference_request(
        model_name,
        inputs,
        model_version=model_version,
        request_id=request_id,
        outputs=outputs,
        sequence_id=sequence_id,
        sequence_start=sequence_start,
        sequence_end=sequence_end,
        priority=priority,
        timeout=timeout,
        parameters=parameters,
    )
    request.parameters["multiplex"].bool_param = True
    return request.SerializeToString()


class AioStreamMultiplexer:
    """One long-lived bidi stream multiplexing unary infers (asyncio).

    Opened lazily on first ``infer``; a dead stream (UNAVAILABLE, server
    restart) fails its in-flight futures with a retryable error and the
    next ``infer`` opens a fresh stream — combined with the client's
    retry policy this is reconnect-on-UNAVAILABLE at the request level.
    """

    def __init__(self, client):
        self._client = client
        self._builder = _FastRequestBuilder()
        self._call = None
        self._reader: Optional[asyncio.Task] = None
        self._pending: Dict[str, asyncio.Future] = {}
        self._counter = 0
        self._write_lock = asyncio.Lock()
        self.endpoint = None  # pool endpoint pinned at open

    # -- stream lifecycle ----------------------------------------------------

    def _ensure_open(self) -> None:
        if self._call is not None:
            return
        endpoint = self._client._pool.pick()
        self.endpoint = endpoint
        # the transport call alone: its write() takes serialized requests,
        # its read() gives serialized responses (None at the end)
        call = self._client._stub_for(endpoint.url).ModelStreamInfer.open(
            self._client._metadata(None)
        )
        self._call = call
        self._reader = asyncio.ensure_future(self._read_loop(call))

    async def _read_loop(self, call) -> None:
        try:
            while True:
                raw = await call.read()
                if raw is None:
                    self._fail_pending(
                        InferenceServerException(
                            "multiplexed stream closed by the server",
                            status="StatusCode.UNAVAILABLE",
                        )
                    )
                    return
                response = pb.ModelStreamInferResponse.FromString(raw)
                inner = response.infer_response
                if response.error_message and not inner.id:
                    # an error the server could not correlate (the bytes
                    # never decoded): no single waiter owns it — fail
                    # everything retryably rather than hang one forever
                    self._fail_pending(_inband_error(response.error_message))
                    continue
                future = self._pending.pop(inner.id, None)
                if future is None or future.done():
                    continue
                if response.error_message:
                    future.set_exception(
                        _inband_error(response.error_message)
                    )
                else:
                    future.set_result(inner)
        except asyncio.CancelledError:
            self._fail_pending(
                InferenceServerException(
                    "multiplexed stream closed",
                    status="StatusCode.CANCELLED",
                )
            )
            raise
        except RpcError as e:
            self._fail_pending(rpc_error_to_exception(e))
        except Exception as e:  # noqa: BLE001 - surface to waiters
            self._fail_pending(InferenceServerException(str(e)))
        finally:
            if self._call is call:
                self._call = None
                self._reader = None

    def _fail_pending(self, error: InferenceServerException) -> None:
        pending, self._pending = self._pending, {}
        for future in pending.values():
            if not future.done():
                future.set_exception(error)

    # -- request path --------------------------------------------------------

    def next_id(self) -> str:
        self._counter += 1
        return f"mx{self._counter}"

    async def infer(
        self,
        model_name: str = "",
        inputs=(),
        model_version: str = "",
        request_id: str = "",
        outputs=None,
        parameters: Optional[Dict[str, Any]] = None,
        priority: int = 0,
        timeout: Optional[int] = None,
        sequence_id=0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        client_timeout: Optional[float] = None,
        prepared_request=None,
    ) -> pb.ModelInferResponse:
        if prepared_request is not None:
            # prepared requests are shared/reused: serialize a clone so
            # the correlation id never races concurrent senders
            clone = pb.ModelInferRequest()
            clone.CopyFrom(prepared_request)
            rid = clone.id or self.next_id()
            clone.id = rid
            clone.parameters["multiplex"].bool_param = True
            return await self._send(
                rid, clone.SerializeToString(), client_timeout
            )
        rid = request_id or self.next_id()
        data = None
        if not sequence_id and priority == 0 and timeout is None:
            params = {"multiplex": True}
            if parameters:
                params.update(parameters)
                params["multiplex"] = True
            data = self._builder.build(
                model_name, inputs, model_version, rid, outputs, params
            )
        if data is None:
            data = _proto_request_bytes(
                model_name,
                inputs,
                model_version,
                rid,
                outputs,
                parameters,
                priority,
                timeout,
                sequence_id,
                sequence_start,
                sequence_end,
            )
        return await self._send(rid, data, client_timeout)

    async def _send(
        self, rid: str, data: bytes, client_timeout: Optional[float]
    ) -> pb.ModelInferResponse:
        if rid in self._pending:
            raise _duplicate_id(rid)
        self._ensure_open()
        call = self._call
        future = asyncio.get_running_loop().create_future()
        self._pending[rid] = future
        try:
            async with self._write_lock:
                await call.write(data)
        except BaseException as e:
            if self._pending.get(rid) is future:
                del self._pending[rid]
            if isinstance(e, RpcError):
                raise rpc_error_to_exception(e) from None
            raise
        try:
            if client_timeout is not None:
                return await asyncio.wait_for(future, client_timeout)
            return await future
        except asyncio.TimeoutError:
            if self._pending.get(rid) is future:
                del self._pending[rid]
            raise InferenceServerException(
                f"timeout waiting for multiplexed response to '{rid}'"
            ) from None

    async def close(self) -> None:
        call, self._call = self._call, None
        reader, self._reader = self._reader, None
        if call is not None:
            call.cancel()
        if reader is not None:
            reader.cancel()
            try:
                await reader
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._fail_pending(
            InferenceServerException(
                "multiplexed stream closed",
                status="StatusCode.CANCELLED",
            )
        )
