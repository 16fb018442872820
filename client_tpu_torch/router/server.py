"""Router front-ends: gRPC + HTTP over one :class:`RouterCore`.

An own copy of ``client_tpu/router/server.py``. The reference's fronts
stand on grpcio (a ``grpc.aio`` server whose servicer takes raw request
bytes) and aiohttp (a reverse proxy); the port imports neither:

* the gRPC face, :class:`_RouterBridge`, is the port's native h2c
  front-end (``csrc/frontend/grpc_frontend.cc``, the C ABI the server's
  bridge uses), which hands up every request message as bytes. Each
  ``ModelStreamInfer`` event carries its stream's key, so a whole client
  stream pins to one backend, and a stream-end event says when the
  client can send no more on it;
* the HTTP face, :class:`_HttpFront`, is stdlib asyncio: the port
  server's request reader and keep-alive connections to each backend's
  HTTP address (the port's HTTP client transport).

Both fronts are THIN: inference requests arrive and leave as serialized
bytes (the router never builds a message on the hot path), and the HTTP
front is a byte-level reverse proxy. Health endpoints are answered
locally (the router's readiness is "≥1 healthy backend", so a client
pool of routers benches a router whose whole fleet is gone);
control-plane metadata RPCs proxy to a healthy backend with the same
UNAVAILABLE failover the data path gets.

A stream request forwarded to a backend completes at its final frame:
an error frame, the frame of a model that is not decoupled (it answers
once), or a decoupled model's frame marked ``triton_final_response``.
The client's call ends once it has half-closed and every request it
sent has completed, so frames that arrive after the half-close are
delivered (the reference's servicer stops reading at the half-close and
drops them).

:class:`RouterServer` runs both fronts on a background event loop in a
daemon thread, the same harness shape as
:class:`client_tpu_torch.testing.InProcessServer`, so tests and the
``python -m client_tpu_torch.router`` CLI share one lifecycle.
"""

import asyncio
import ctypes
import threading
from collections import deque
from typing import Dict, Optional

from client_tpu_torch import frontend_build
from client_tpu_torch.grpc import _wire as wire
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._service_stubs import METHODS, SERVICE
from client_tpu_torch.grpc._utils import RpcError, StatusCode, rpc_error_to_exception
from client_tpu_torch.http.aio import _Connections, _request_head
from client_tpu_torch.lifecycle.pool import status_is_unavailable
from client_tpu_torch.router.backends import ReadinessProber
from client_tpu_torch.router.core import RouterCore, RouterOverloadError
from client_tpu_torch.server.http_server import (
    MAX_HEADER_BYTES,
    Response,
    json_response,
    serve_connection,
)
from client_tpu_torch.server.native_frontend import (
    EVENT_CANCEL,
    EVENT_INFER,
    EVENT_STREAM_END,
    EVENT_STREAM_INFER,
    inflate,
    pump_events,
)
from client_tpu_torch.utils import InferenceServerException

GRPC_CANCELLED = StatusCode.CANCELLED.value[0]
GRPC_RESOURCE_EXHAUSTED = StatusCode.RESOURCE_EXHAUSTED.value[0]
GRPC_UNAVAILABLE = StatusCode.UNAVAILABLE.value[0]
GRPC_INTERNAL = StatusCode.INTERNAL.value[0]

# hop-by-hop headers never cross a proxy (RFC 9110 §7.6.1)
_HOP_HEADERS = frozenset(
    (
        "connection",
        "keep-alive",
        "proxy-authenticate",
        "proxy-authorization",
        "te",
        "trailers",
        "transfer-encoding",
        "upgrade",
        "host",
        "content-length",
    )
)

# control-plane RPCs forwarded verbatim to a healthy backend
_PROXIED_METHODS = (
    "ServerMetadata",
    "ModelMetadata",
    "ModelConfig",
    "ModelStatistics",
    "RepositoryIndex",
)


def _grpc_code_for(token: Optional[str]) -> int:
    name = token[len("StatusCode."):] if token and token.startswith("StatusCode.") else ""
    if name in StatusCode.__members__:
        return StatusCode[name].value[0]
    if status_is_unavailable(token):
        return GRPC_UNAVAILABLE
    return GRPC_INTERNAL


def _stream_error_frame(message: str, request_id: str) -> bytes:
    """An in-band ModelStreamInferResponse error whose inner response
    carries the CLIENT's request id: error frames stay correlatable on
    multiplexed client streams (server parity)."""
    inner, _ = wire.splice_message_id(b"", request_id)
    out = bytearray()
    wire.encode_stream_response(out, inner, message)
    return bytes(out)


class _Forward:
    """One request of a client stream: queued, then forwarded until its
    final frame completes its handle."""

    __slots__ = ("handle", "stream", "data", "rid", "original", "decoupled",
                 "admitted", "done")

    def __init__(self, handle: int, stream: "_ClientStream", data: bytes):
        self.handle = handle
        self.stream = stream
        self.data = data
        self.rid = ""
        self.original = ""
        self.decoupled = False
        self.admitted = False
        self.done = False


class _ClientStream:
    """A client's ModelStreamInfer call (its front-end stream key): the
    backend it is pinned to, its requests in order, and whether the client
    can still send."""

    __slots__ = ("key", "ep", "link", "inbox", "open", "feeding", "closed")

    def __init__(self, key: int):
        self.key = key
        self.ep = None
        self.link = None
        self.inbox: deque = deque()  # _Forwards not yet written, in order
        self.open: Dict[int, _Forward] = {}  # written, not yet final
        self.feeding = False
        self.closed = False


class _RouterBridge:
    """The gRPC face: the native front-end's events on the router's loop.

    One pump thread drains the front-end's event queue and posts each
    batch to the loop; everything else runs there. Unary ``ModelInfer``
    goes through :meth:`RouterCore.forward_unary`; each client stream's
    requests are forwarded in order onto the backend it pinned at its
    first request, admission bracketed from forward to first frame, and
    a backend stream's death answers each open request in-band with a
    retryable UNAVAILABLE; health is local and the metadata RPCs proxy.
    """

    def __init__(self, router: RouterCore, loop: asyncio.AbstractEventLoop,
                 proxy_timeout_s: float = 5.0):
        self._lib = frontend_build.load()
        self.router = router
        self._loop = loop
        self.proxy_timeout_s = proxy_timeout_s
        self.draining = False
        self.port: Optional[int] = None
        self._id: Optional[int] = None
        self._pump: Optional[threading.Thread] = None
        self._calls: Dict[int, asyncio.Task] = {}  # handle -> unary/RPC task
        self._streams: Dict[int, _ClientStream] = {}  # stream key -> stream
        self._forwards: Dict[int, _Forward] = {}  # handle -> stream request
        self._feeders: set = set()

    # -- lifecycle -------------------------------------------------------------

    def start(self, host: str, port: int) -> None:
        err = ctypes.create_string_buffer(1024)
        fid = self._lib.ctpu_grpc_start(host.encode(), int(port), None, None, err,
                                        len(err))
        if not fid:
            raise OSError("router gRPC front-end failed to start: "
                          f"{err.value.decode('utf-8', 'replace')}")
        self._id = fid
        self.port = self._lib.ctpu_grpc_port(fid)
        self._pump = threading.Thread(
            target=pump_events, args=(self._lib, fid, 128, self._post),
            name="router-grpc-pump", daemon=True)
        self._pump.start()

    @property
    def busy(self) -> bool:
        return bool(self._calls or self._forwards)

    def stop(self) -> None:
        if self._id is None:
            return
        fid, self._id = self._id, None
        self._lib.ctpu_grpc_stop(fid)
        self._pump.join(timeout=10)

    def _post(self, events) -> None:
        """Pump thread: hand a batch to the loop."""
        try:
            self._loop.call_soon_threadsafe(self._dispatch, events)
        except RuntimeError:
            pass  # the loop closed: the router is stopping

    # -- completions -----------------------------------------------------------

    def _finish(self, handle: int, body: Optional[bytes] = None, status: int = 0,
                message: str = "", rpc: bool = False, metadata=()) -> None:
        """Complete a unary or RPC handle (a body, or an error status)."""
        lib = self._lib
        encoded = message.encode("utf-8", "replace") if message else None
        size = len(body) if body else 0
        if metadata:
            packed = b"".join(f"{k}\0{v}\0".encode() for k, v in metadata)
            lib.ctpu_grpc_complete_with_metadata(handle, body, size, status, encoded,
                                                 packed, len(packed))
        elif rpc:
            lib.ctpu_grpc_complete_rpc(handle, body, size, status, encoded)
        else:
            lib.ctpu_grpc_complete(handle, body, size, status, encoded, 1)

    def _free(self, handle: int, message: str) -> None:
        """Complete a handle of any method with CANCELLED: a cancelled
        handle stays registered until its final completion."""
        encoded = message.encode()
        if self._lib.ctpu_grpc_complete(handle, None, 0, GRPC_CANCELLED, encoded, 1) < 0:
            self._lib.ctpu_grpc_complete_rpc(handle, None, 0, GRPC_CANCELLED, encoded)

    def _frame(self, forward: _Forward, frame: bytes, final: bool) -> None:
        self._lib.ctpu_grpc_complete(forward.handle, frame, len(frame), 0, None,
                                     1 if final else 0)

    # -- events (the loop) -------------------------------------------------------

    def _dispatch(self, events) -> None:
        for kind, handle, key, method, _trace, message, compression in events:
            if kind == EVENT_CANCEL:
                self._cancel(handle)
                continue
            if kind == EVENT_STREAM_END:
                stream = self._streams.get(key)
                if stream is not None:
                    stream.closed = True
                    self._maybe_end(stream)
                continue
            try:
                data = inflate(message, compression)
            except InferenceServerException as e:
                self._finish(handle, status=GRPC_INTERNAL, message=e.message(),
                             rpc=kind not in (EVENT_INFER, EVENT_STREAM_INFER))
                continue
            if kind == EVENT_STREAM_INFER:
                self._stream_request(handle, key, data)
            elif kind == EVENT_INFER:
                self._spawn(handle, self._model_infer(handle, data))
            else:
                self._spawn(handle, self._rpc(handle, method, data))

    def _spawn(self, handle: int, coro) -> None:
        task = self._loop.create_task(coro)
        self._calls[handle] = task
        task.add_done_callback(lambda _t, h=handle: self._calls.pop(h, None))

    def _cancel(self, handle: int) -> None:
        """The client reset the call, dropped the connection, or its
        deadline passed: stop forwarding, free the handle."""
        task = self._calls.get(handle)
        if task is not None:
            task.cancel()  # the task frees its handle
            return
        forward = self._forwards.get(handle)
        if forward is not None:
            self._settle(forward)
        self._free(handle, "request cancelled")
        if forward is not None:
            self._maybe_end(forward.stream)

    # -- unary ModelInfer ----------------------------------------------------------

    async def _model_infer(self, handle: int, data: bytes) -> None:
        try:
            body = await self.router.forward_unary(data, protocol="grpc")
        except RouterOverloadError as e:
            self._finish(handle, status=GRPC_RESOURCE_EXHAUSTED, message=e.message(),
                         metadata=(("retry-after", f"{e.retry_after_s:g}"),))
        except InferenceServerException as e:
            self._finish(handle, status=_grpc_code_for(e.status()), message=e.message())
        except asyncio.CancelledError:
            self._free(handle, "request cancelled")
            raise
        except Exception as e:  # noqa: BLE001 - answer, keep serving
            self._finish(handle, status=GRPC_INTERNAL, message=str(e))
        else:
            self._finish(handle, body)

    # -- the stream front -----------------------------------------------------------

    def _stream_request(self, handle: int, key: int, data: bytes) -> None:
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = _ClientStream(key)
        forward = _Forward(handle, stream, data)
        self._forwards[handle] = forward
        stream.inbox.append(forward)
        if not stream.feeding:
            stream.feeding = True
            task = self._loop.create_task(self._feed(stream))
            self._feeders.add(task)
            task.add_done_callback(self._feeders.discard)

    async def _feed(self, stream: _ClientStream) -> None:
        """Forward a stream's requests one at a time, in arrival order."""
        try:
            while stream.inbox:
                forward = stream.inbox.popleft()
                if forward.done:
                    continue  # a cancelled request is already freed
                try:
                    await self._forward(forward)
                except Exception as e:  # noqa: BLE001 - answer it, keep the stream
                    if not forward.done:
                        self._done(forward, _stream_error_frame(
                            f"router failed to forward the request: {e}", forward.original))
        finally:
            stream.feeding = False
            self._maybe_end(stream)

    async def _forward(self, forward: _Forward) -> None:
        router = self.router
        stream = forward.stream
        data, forward.data = forward.data, None
        try:
            forward.original = wire.read_message_id(data)
        except wire.WireError as e:
            self._done(forward, _stream_error_frame(str(e), ""))
            return
        model_name, key, priority, _sequence = router.classify(data)
        try:
            router.admit(priority)
        except RouterOverloadError as e:
            router.m_requests.labels("grpc_stream", "shed").inc()
            self._done(forward, _stream_error_frame(e.message(), forward.original))
            return
        forward.admitted = True
        if stream.ep is None:
            ep = router.pool.pick(key=key, allow=router.table.urls_for(model_name))
            router.pool.pin_stream(ep)
            stream.ep = ep
            stream.link = router.link_for(ep.url)
        link = stream.link
        try:
            forward.decoupled = await router.model_decoupled(model_name, link)
        except InferenceServerException as e:
            router.m_requests.labels("grpc_stream", "error").inc()
            if not forward.done:
                self._done(forward, _stream_error_frame(e.message(), forward.original))
            return
        if forward.done:
            return  # cancelled meanwhile
        forward.rid = router.next_rid()
        payload, _original = wire.splice_forward_request(data, forward.rid)
        stream.open[forward.handle] = forward
        link.register(forward.rid, lambda error_message, response, failure:
                      self._on_frame(forward, error_message, response, failure),
                      long_lived=True)
        try:
            await link.write(payload)
        except InferenceServerException as e:
            router.m_requests.labels("grpc_stream", "error").inc()
            if not forward.done:
                self._done(forward, _stream_error_frame(e.message(), forward.original))
            return
        router.m_requests.labels("grpc_stream", "ok").inc()

    def _on_frame(self, forward: _Forward, error_message, response, failure) -> None:
        """A backend frame (or the backend stream's death) for one
        forwarded request: restore the client's id and pass it on; its
        final frame completes the request."""
        if forward.done:
            return
        if failure is not None:
            self._done(forward, _stream_error_frame(failure.message(), forward.original))
            return
        if forward.admitted:
            forward.admitted = False
            self.router.release()
        spliced, _rid = wire.splice_message_id(response, forward.original)
        out = bytearray()
        wire.encode_stream_response(out, spliced, error_message)
        try:
            final = bool(error_message) or not forward.decoupled or \
                wire.response_is_final(response)
        except wire.WireError:
            final = True  # unreadable: nothing more can be correlated
        if final:
            self._done(forward, bytes(out))
        else:
            self._frame(forward, bytes(out), False)

    def _settle(self, forward: _Forward) -> None:
        """Drop a stream request's router state: its admission slot, its
        backend sink, its place among the stream's open requests."""
        forward.done = True
        if forward.admitted:
            forward.admitted = False
            self.router.release()
        stream = forward.stream
        if forward.rid and stream.link is not None:
            stream.link.unregister(forward.rid)
        stream.open.pop(forward.handle, None)
        self._forwards.pop(forward.handle, None)

    def _done(self, forward: _Forward, frame: bytes) -> None:
        self._settle(forward)
        self._frame(forward, frame, True)
        self._maybe_end(forward.stream)

    def _maybe_end(self, stream: _ClientStream) -> None:
        """Forget a stream once the client can send no more on it and
        every request it sent has completed."""
        if stream.closed and not (stream.open or stream.inbox or stream.feeding):
            if self._streams.pop(stream.key, None) is not None and stream.ep is not None:
                self.router.pool.unpin_stream(stream.ep)

    # -- health and the control plane ---------------------------------------------------

    def _fleet_ready(self) -> bool:
        if self.draining:
            return False
        router = self.router
        now = router.now()
        return any(ep.state(now) == "up" for ep in router.pool.endpoints)

    async def _rpc(self, handle: int, method: str, data: bytes) -> None:
        try:
            body = await self._rpc_body(method, data)
        except RpcError as e:
            self._finish(handle, status=e.code().value[0], message=e.details(), rpc=True)
        except asyncio.CancelledError:
            self._free(handle, "request cancelled")
            raise
        except Exception as e:  # noqa: BLE001 - answer, keep serving
            self._finish(handle, status=GRPC_INTERNAL, message=str(e), rpc=True)
        else:
            self._finish(handle, body, rpc=True)

    async def _rpc_body(self, method: str, data: bytes) -> bytes:
        if method == "ServerLive":
            return pb.ServerLiveResponse(live=True).SerializeToString()
        if method == "ServerReady":
            return pb.ServerReadyResponse(ready=self._fleet_ready()).SerializeToString()
        if method == "ModelReady":
            if self.router.table.urls_for(pb.ModelReadyRequest.FromString(data).name):
                return pb.ModelReadyResponse(ready=True).SerializeToString()
            # the table does not know the model (cold start): ask a backend
            return await self._proxy(method, data)
        if method in _PROXIED_METHODS:
            return await self._proxy(method, data)
        if method in METHODS:
            # shared-memory RPCs and the like: host-local concepts that
            # are meaningless across a proxy hop
            raise RpcError(StatusCode.UNIMPLEMENTED,
                           f"{method} is not supported by the router tier")
        raise RpcError(StatusCode.UNIMPLEMENTED, "Method not found!")

    async def _proxy(self, method: str, data: bytes) -> bytes:
        """One control-plane RPC to a healthy backend, verbatim, with
        UNAVAILABLE failover."""
        router = self.router
        exclude = None
        max_attempts = max(2, router.pool.size)
        for attempt in range(max_attempts):
            ep = router.pool.pick(exclude=exclude)
            link = router.link_for(ep.url)
            try:
                return await link.channel.unary_unary(
                    f"/{SERVICE}/{method}", data, timeout=self.proxy_timeout_s)
            except RpcError as e:
                token = rpc_error_to_exception(e).status()
                if status_is_unavailable(token):
                    router.pool.observe(ep, ok=False, token=token)
                    if attempt + 1 < max_attempts and router.pool.has_alternative(ep):
                        exclude = ep
                        continue
                raise
        raise RpcError(StatusCode.UNAVAILABLE, "no backend answered")  # pragma: no cover


# -- HTTP front ---------------------------------------------------------------


class _HttpFront:
    """Stdlib-asyncio reverse proxy: local health/metrics/status,
    everything else forwarded byte for byte to a healthy backend's HTTP
    address over kept-alive connections.

    The HTTP infer path cannot see the gRPC priority parameter without
    parsing the JSON body, so HTTP admission uses the DEFAULT priority
    class: latency-protected traffic belongs on gRPC. Each upstream
    response is read whole before it is passed on, as the reference's
    proxy does, so a streamed (SSE) response reaches the client in one
    piece at its end.
    """

    def __init__(self, bridge: _RouterBridge):
        self.bridge = bridge
        self.router = bridge.router
        self._connections = _Connections(limit=1024, connect_timeout=5.0)
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(
            self._serve_connection, host, port, limit=MAX_HEADER_BYTES)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        await self._connections.close()

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            await serve_connection(reader, writer, self._handle)
        finally:
            self._writers.discard(writer)

    async def _handle(self, method, path, query, headers, body) -> Response:
        if method == "GET":
            if path == "/v2/health/live":
                return Response(200)
            if path == "/v2/health/ready":
                if self.bridge._fleet_ready():
                    return Response(200)
                return Response(503, b"no healthy backend",
                                {"Retry-After": "1", "Content-Type": "text/plain; charset=utf-8"})
            if path == "/metrics":
                return Response(200, self.router.metrics.render().encode(),
                                {"Content-Type": "text/plain; charset=utf-8"})
            if path == "/v2/router/status":
                return json_response(self.router.snapshot())
        return await self._proxy(method, path, f"{path}?{query}" if query else path,
                                 headers, body)

    async def _proxy(self, method, path, target, headers, body) -> Response:
        router = self.router
        is_infer = method == "POST" and path.endswith("/infer")
        if is_infer:
            try:
                router.admit(0)
            except RouterOverloadError as e:
                router.m_requests.labels("http", "shed").inc()
                return json_response({"error": e.message()}, status=429,
                                     headers={"Retry-After": f"{e.retry_after_s:g}"})
        started = router.now()
        outcome = "error"
        try:
            response = await self._forward_http(method, target, headers, body)
            outcome = "ok" if response.status < 500 else "error"
            return response
        finally:
            if is_infer:
                router.release()
                router.m_proxy.observe(router.now() - started)
                router.m_requests.labels("http", outcome).inc()

    async def _forward_http(self, method, target, headers, body) -> Response:
        router = self.router
        forwarded = {k: v for k, v in headers.items() if k not in _HOP_HEADERS}
        allow = {url for url, http_url in router.http_urls.items() if http_url}
        if not allow:
            return Response(503, b"no HTTP-capable backend")
        unavailable = Response(503, b"backend unavailable", {"Retry-After": "1"})
        exclude = None
        max_attempts = max(2, len(allow))
        for attempt in range(max_attempts):
            ep = router.pool.pick(exclude=exclude, allow=allow)
            address = router.http_urls.get(ep.url)
            if address is None:
                break
            host, _, port = address.rpartition(":")
            head = _request_head(method, target, address, forwarded,
                                 body if body or method not in ("GET", "HEAD") else None)
            started = router.pool.begin(ep)
            try:
                status, payload, upstream = await self._connections.request(
                    ("http", host, int(port)), head, body, method, lambda: None)
            except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError, ValueError):
                router.pool.finish(ep, started, ok=False, token="503")
                router.pool.observe(ep, ok=False, token="503")
                if attempt + 1 < max_attempts and router.pool.has_alternative(ep):
                    exclude = ep
                    continue
                return unavailable
            ok = status < 500
            token = None if ok else str(status)
            router.pool.finish(ep, started, ok=ok, token=token)
            router.pool.observe(ep, ok=ok, token=token)
            if status == 503 and attempt + 1 < max_attempts and router.pool.has_alternative(ep):
                exclude = ep
                continue
            return Response(status, payload, {k: v for k, v in upstream.items()
                                              if k.lower() not in _HOP_HEADERS})
        return Response(503, b"backend unavailable")


# -- lifecycle ----------------------------------------------------------------


class RouterServer:
    """Both router fronts on a background event loop in a daemon thread
    (the InProcessServer harness shape). ``backends`` maps each
    backend's gRPC address to its HTTP address (or None)."""

    def __init__(
        self,
        backends: Dict[str, Optional[str]],
        host: str = "127.0.0.1",
        http: bool = True,
        http_port: int = 0,
        grpc_port: int = 0,
        routing_policy="least_outstanding",
        hedge=None,
        max_inflight: int = 0,
        shed_retry_after_s: float = 0.25,
        probe_interval_s: float = 0.25,
        logger=None,
    ):
        self._backends = dict(backends)
        self._host = host
        self._want_http = http
        self._http_bind_port = http_port
        self._grpc_bind_port = grpc_port
        self._routing_policy = routing_policy
        self._hedge = hedge
        self._max_inflight = max_inflight
        self._shed_retry_after_s = shed_retry_after_s
        self._probe_interval_s = probe_interval_s
        self._logger = logger
        self.router: Optional[RouterCore] = None
        self.http_port: Optional[int] = None
        self.grpc_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stop = None  # asyncio.Event created on the loop
        self._error: Optional[BaseException] = None
        self._bridge: Optional[_RouterBridge] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RouterServer":
        self._thread = threading.Thread(
            target=self._run, name="client-tpu-router", daemon=True
        )
        self._thread.start()
        self._ready.wait(timeout=60)
        if self._error is not None:
            raise self._error
        if not self._ready.is_set():
            raise RuntimeError("router failed to start in 60s")
        return self

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except BaseException as e:  # noqa: BLE001 - propagate to starter
            self._error = e
            self._ready.set()
        finally:
            self._loop.close()

    async def _serve(self) -> None:
        self._stop = asyncio.Event()
        self.router = RouterCore(
            self._backends,
            routing_policy=self._routing_policy,
            hedge=self._hedge,
            max_inflight=self._max_inflight,
            shed_retry_after_s=self._shed_retry_after_s,
            logger=self._logger,
        )
        prober = ReadinessProber(
            self.router, self.router.links, interval_s=self._probe_interval_s
        )
        # resolve the model table before taking traffic; link creation
        # is lazy, so touch every backend's link first
        for url in list(self.router.pool.urls):
            self.router.link_for(url)
        try:
            await prober.probe_once()
        except Exception:  # noqa: BLE001 - backends may still be booting
            pass
        prober.start()
        bridge = self._bridge = _RouterBridge(self.router, asyncio.get_running_loop())
        http_front = None
        try:
            bridge.start(self._host, self._grpc_bind_port)
            self.grpc_port = bridge.port
            if self._want_http:
                http_front = _HttpFront(bridge)
                self.http_port = await http_front.start(self._host, self._http_bind_port)
        except BaseException:
            bridge.stop()
            await prober.stop()
            await self.router.close()
            raise
        self._ready.set()
        await self._stop.wait()
        # flip readiness first so router-pool clients fail over cleanly,
        # then a second's grace for the calls in flight
        bridge.draining = True
        await prober.stop()
        for _ in range(50):
            if not bridge.busy:
                break
            await asyncio.sleep(0.02)
        bridge.stop()
        if http_front is not None:
            await http_front.close()
        await self.router.close()

    def stop(self) -> None:
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass  # the loop already ended
        if self._thread is not None:
            self._thread.join(timeout=30)

    def __enter__(self) -> "RouterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- membership (called from any thread) ---------------------------------

    def add_backend(self, grpc_url: str, http_url: Optional[str] = None):
        """Thread-safe: schedule the join on the router loop (the
        autoscaler calls this from the fleet thread)."""

        async def _add():
            self.router.add_backend(grpc_url, http_url)

        asyncio.run_coroutine_threadsafe(_add(), self._loop).result(timeout=10)

    def remove_backend(self, grpc_url: str) -> None:
        """Thread-safe: pull the backend from routing NOW, close its
        link once its in-flights have drained out."""

        async def _remove():
            link = self.router.remove_backend(grpc_url)
            if link is not None:
                # in-flights already forwarded keep their sinks; give
                # them a moment to drain before the channel closes
                for _ in range(50):
                    if link.pending == 0:
                        break
                    await asyncio.sleep(0.1)
                await link.close()

        asyncio.run_coroutine_threadsafe(_remove(), self._loop).result(
            timeout=30
        )

    # -- convenience ---------------------------------------------------------

    @property
    def grpc_url(self) -> str:
        return f"{self._host}:{self.grpc_port}"

    @property
    def http_url(self) -> str:
        return f"{self._host}:{self.http_port}"
