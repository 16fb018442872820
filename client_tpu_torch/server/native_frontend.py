"""Python bridge for the native C++ gRPC front-end.

An own copy of ``client_tpu/server/native_frontend.py``, over a plain C ABI
(``csrc/frontend/grpc_frontend.cc``, built and bound by
``client_tpu_torch.frontend_build``) instead of a CPython extension.

C++ owns the sockets, TLS when asked for (``csrc/frontend/tls.cc``, ALPN
``h2``), HTTP/2, HPACK, flow control, the gRPC framing, ``grpc-timeout``
and the trailers; it hands up each whole request message
as bytes through one event queue. This bridge:

* runs one pump thread that drains that queue in batches
  (``ctpu_grpc_wait_events``; ctypes releases the GIL while it blocks),
  decodes each ModelInfer message (``_grpc_codec.FastInferCodec``: the
  protobuf-free fast path, then the message codec), and hands each
  model's unary requests to that model's worker thread, which runs them
  through :meth:`ServerCore.infer_direct` and completes them;
* sends stream requests and every other method to the core's event loop
  (the non-inference RPCs answer there through ``_grpc_codec``, as the
  other front-ends' routes do);
* turns a cancel (the peer reset the stream, dropped the connection, or
  its deadline passed) into the cancellation of the request's task.

Unlike the reference, the pump never executes a model: the reference runs
every unary batch on its one pump thread, so one slow request on one model
stalls every model's answers. Here each model has its own worker, so a
request held on one model delays only that model's queue. Each worker
drains everything of its model that arrived while its last batch ran, so
the dynamic-batching window of the reference remains, per model.
"""

import asyncio
import ctypes
import struct
import threading
import traceback
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from client_tpu_torch import frontend_build
from client_tpu_torch.server import _grpc_codec as codec
from client_tpu_torch.server.core import CoreRequest, CoreResponse, ServerCore
from client_tpu_torch.utils import InferenceServerException

# event kinds of csrc/frontend/grpc_frontend.cc
EVENT_INFER = 0
EVENT_STREAM_INFER = 1
EVENT_RPC = 2
EVENT_CANCEL = 3
EVENT_STREAM_END = 4  # no more requests on a ModelStreamInfer stream key
_EVENT_HEAD = struct.Struct("<BBQQHHQ")
GRPC_CANCELLED = 1


def native_available() -> bool:
    """Whether the front-end builds and loads here (a host C++ compiler
    is all it needs)."""
    try:
        frontend_build.load()
    except Exception:  # noqa: BLE001 - any build or load failure
        return False
    return True


def parse_events(buf: bytes) -> List[Tuple[int, int, int, str, str, bytes, int]]:
    """Unpack one ``ctpu_grpc_wait_events`` buffer: (kind, handle, stream
    key, method, traceparent, message, compression) per event."""
    events = []
    pos = 0
    view = memoryview(buf)
    while pos < len(buf):
        kind, compression, handle, stream_key, n_method, n_trace, n_message = \
            _EVENT_HEAD.unpack_from(buf, pos)
        pos += _EVENT_HEAD.size
        method = bytes(view[pos:pos + n_method]).decode()
        pos += n_method
        trace = bytes(view[pos:pos + n_trace]).decode()
        pos += n_trace
        message = view[pos:pos + n_message]
        pos += n_message
        events.append((kind, handle, stream_key, method, trace, message, compression))
    return events


def inflate(message, compression: int) -> bytes:
    """A request message as the front-end handed it up, inflated when its
    event flags it gzip (1) or deflate (2)."""
    data = bytes(message)
    if not compression:
        return data
    try:
        return zlib.decompress(data, 15 + 32)  # gzip or zlib header
    except zlib.error:
        kind = "gzip" if compression == 1 else "deflate"
        raise InferenceServerException(
            f"corrupt {kind}-compressed gRPC message") from None


def pump_events(lib, fid: int, batch: int, dispatch) -> None:
    """Drain front-end ``fid``'s event queue until it stops, handing each
    batch of parsed events to ``dispatch`` (on this thread; a failing
    batch is printed and the pump goes on)."""
    out = ctypes.c_void_p()
    out_len = ctypes.c_uint64()
    while True:
        n = lib.ctpu_grpc_wait_events(fid, batch, 200, ctypes.byref(out),
                                      ctypes.byref(out_len))
        if n < 0:
            return  # stopped
        if n == 0:
            continue
        try:
            buf = ctypes.string_at(out.value, out_len.value)
        finally:
            lib.ctpu_grpc_free(out)
        try:
            dispatch(parse_events(buf))
        except Exception:  # noqa: BLE001 - the pump must survive
            traceback.print_exc()


class _ModelWorker:
    """One model's unary requests: a thread that runs each batch that
    piled up while the previous one executed, with a codec of its own
    (the codec's scratch buffer is per thread)."""

    def __init__(self, frontend: "NativeGrpcFrontend", name: str):
        self._frontend = frontend
        self.codec = codec.FastInferCodec(frontend._core)
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=f"ctpu-grpc-model-{name or 'other'}", daemon=True)
        self._thread.start()

    def submit(self, items) -> None:
        with self._cv:
            self._items.extend(items)
            self._cv.notify()

    def _run(self) -> None:
        limit = self._frontend._batch
        while True:
            with self._cv:
                while not self._items and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                batch = [self._items.popleft()
                         for _ in range(min(limit, len(self._items)))]
            try:
                self._frontend._run_direct(batch, self.codec)
            except Exception:  # noqa: BLE001 - the worker must survive
                traceback.print_exc()
                for handle, _request in batch:
                    self._frontend._complete_error(
                        handle, "internal error completing request batch",
                        codec.GRPC_INTERNAL)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=10)


class NativeGrpcFrontend:
    """The native gRPC server bound to one ServerCore + event loop."""

    def __init__(self, core: ServerCore, loop: asyncio.AbstractEventLoop):
        self._lib = frontend_build.load()
        self._core = core
        self._loop = loop
        self._id: Optional[int] = None
        self.port: Optional[int] = None
        # handle -> asyncio.Task of a stream request; loop thread only
        self._tasks: Dict[int, Any] = {}
        self._pump: Optional[threading.Thread] = None
        self._pump_codec = codec.FastInferCodec(core)  # decode, pump thread
        self._loop_codec = codec.FastInferCodec(core)  # streams, loop thread
        self._workers: Dict[str, _ModelWorker] = {}
        # events drained per wakeup, and the most a worker runs at once
        self._batch = 128

    # -- lifecycle -------------------------------------------------------------

    def start(self, host: str = "0.0.0.0", port: int = 0,
              tls_cert: Optional[str] = None, tls_key: Optional[str] = None) -> None:
        """Bind and serve. ``tls_cert`` and ``tls_key`` (PEM paths) make the
        port speak TLS with ALPN ``h2``; a context the C++ side cannot
        build (no ``libssl.so.3``, a PEM it cannot read) raises OSError
        naming the cause, and nothing is served."""
        if bool(tls_cert) != bool(tls_key):
            raise OSError("gRPC TLS needs both a certificate chain and a key")
        err = ctypes.create_string_buffer(1024)
        fid = self._lib.ctpu_grpc_start(
            host.encode(), int(port), tls_cert.encode() if tls_cert else None,
            tls_key.encode() if tls_key else None, err, len(err))
        if not fid:
            raise OSError(f"gRPC front-end failed to start: "
                          f"{err.value.decode('utf-8', 'replace')}")
        self._id = fid
        self.port = self._lib.ctpu_grpc_port(fid)
        self._pump = threading.Thread(
            target=pump_events, args=(self._lib, fid, self._batch, self._dispatch),
            name="ctpu-grpc-pump", daemon=True)
        self._pump.start()

    def stop(self) -> None:
        """Close the port and every connection (on the loop thread). A
        stream request still running is cancelled, not abandoned: its
        client sees the connection close (UNAVAILABLE, retryable) and its
        task ends while the loop still runs."""
        if self._id is None:
            return
        fid, self._id = self._id, None
        self._lib.ctpu_grpc_stop(fid)
        if self._pump is not None:
            self._pump.join(timeout=10)
            self._pump = None
        for task in list(self._tasks.values()):
            task.cancel()
        for worker in list(self._workers.values()):
            worker.stop()
        self._workers.clear()

    # -- the pump ----------------------------------------------------------------

    def _dispatch(self, events) -> None:
        by_model: Dict[str, List[Tuple[int, CoreRequest]]] = {}
        prof = self._core.profiling
        for kind, handle, _key, method, trace, message, compression in events:
            if kind == EVENT_CANCEL:
                self._cancel(handle)
                continue
            if kind == EVENT_STREAM_END:
                continue  # each stream request is complete on its own
            try:
                data = inflate(message, compression)
            except InferenceServerException as e:
                self._complete_error(handle, e.message(), codec.GRPC_INTERNAL)
                continue
            if kind == EVENT_RPC:
                self._call_on_loop(self._rpc, handle, method, data)
            elif kind == EVENT_STREAM_INFER:
                self._call_on_loop(self._submit_stream, handle, data, trace)
            else:
                try:
                    if prof.take():
                        c0 = prof.cpu_now()
                        request = self._decode(data, trace)
                        prof.account("frontend_decode", prof.cpu_now() - c0)
                    else:
                        request = self._decode(data, trace)
                except Exception as e:  # noqa: BLE001 - wire-level badness
                    self._complete_error(handle, *self._error_of(
                        e, default=codec.GRPC_INVALID_ARGUMENT))
                    continue
                name = request.model_name
                if self._core.repository.peek(name) is None:
                    name = ""  # unknown names share one worker: they fail fast
                by_model.setdefault(name, []).append((handle, request))
        for name, items in by_model.items():
            worker = self._workers.get(name)
            if worker is None:
                worker = self._workers[name] = _ModelWorker(self, name)
            worker.submit(items)

    def _decode(self, data: bytes, traceparent: str,
                decoder: Optional[codec.FastInferCodec] = None) -> CoreRequest:
        core = self._core
        try:
            request = (decoder or self._pump_codec).decode_infer(data)
        except InferenceServerException:
            core.metrics.observe_frontend_error("grpc")
            raise
        request.trace = core.trace_manager.begin(
            request.model_name, model_version=request.model_version,
            traceparent=traceparent or None, request_id=request.id)
        return request

    def _call_on_loop(self, fn, handle: int, *args) -> None:
        try:
            self._loop.call_soon_threadsafe(fn, handle, *args)
        except RuntimeError:  # the loop closed under us
            self._complete_error(handle, "server shutting down", codec.GRPC_UNAVAILABLE)

    # -- unary: a model's worker thread ----------------------------------------------

    def _run_direct(self, items, encoder: codec.FastInferCodec) -> None:
        """Execute a batch of one model's unary requests through
        ``ServerCore.infer_direct`` and complete each."""
        core = self._core
        handles = [h for h, _ in items]
        requests = [r for _, r in items]
        results = core.infer_direct(requests)
        prof = core.profiling
        measured = prof.take()
        c0 = prof.cpu_now() if measured else 0
        log = core.logger
        for handle, request, result in zip(handles, requests, results):
            trace = request.trace
            if isinstance(result, Exception):
                if request.shm_ring is not None:
                    request.shm_ring.fail()
                if trace is not None:
                    trace.end(error=str(result))
                self._complete_error(handle, *self._error_of(result))
                continue
            try:
                if request.shm_ring is not None:
                    result = request.shm_ring.complete(result)
                body = encoder.encode_response(result)
            except Exception as e:  # noqa: BLE001 - this request only
                if trace is not None:
                    trace.end(error=str(e))
                self._complete_error(handle, *self._error_of(
                    e, default=codec.GRPC_INVALID_ARGUMENT))
                continue
            if trace is not None:
                trace.end()
            if log.verbose_hot:
                log.verbose("request", model=result.model_name, protocol="grpc-native",
                            status="ok", request_id=result.id)
            self._lib.ctpu_grpc_complete(handle, body, len(body), 0, None, 1)
        if measured and requests:
            prof.account("encode", prof.cpu_now() - c0, count=len(requests))

    # -- errors and completions ---------------------------------------------------------

    def _error_of(self, e: Exception, default: Optional[int] = None) -> Tuple[str, int]:
        """(message, status) of a failed request. ``default`` is the
        status of an error that is not an InferenceServerException
        (INTERNAL when unset: the execution's fault)."""
        if isinstance(e, InferenceServerException):
            message = e.message()
            status = codec.status_code_for(message, exc=e)
        else:
            message = str(e)
            status = codec.GRPC_INTERNAL if default is None else default
        log = self._core.logger
        if log.verbose_hot:
            log.verbose("request", protocol="grpc-native", status="error",
                        error=message, grpc_status=status)
        return message, status

    def _complete_error(self, handle: int, message: str, status: int) -> None:
        """Fail a handle with ``status`` in its trailers (a stream
        request's errors travel in-band instead: :meth:`_run_stream`)."""
        lib = self._lib
        encoded = message.encode("utf-8", "replace")
        if lib.ctpu_grpc_complete(handle, None, 0, status, encoded, 1) < 0:
            lib.ctpu_grpc_complete_rpc(handle, None, 0, status, encoded)

    def _complete_stream(self, handle: int, frame: bytes, final: bool) -> None:
        self._lib.ctpu_grpc_complete(handle, frame, len(frame), 0, None, 1 if final else 0)

    def _cancel(self, handle: int) -> None:
        """Pump thread: the peer reset the stream, dropped the connection,
        or its deadline passed. Cancels a stream request's task; the
        handle is freed in any case (a later completion is a no-op)."""
        try:
            self._loop.call_soon_threadsafe(self._cancel_on_loop, handle)
        except RuntimeError:
            pass
        self._complete_error(handle, "request cancelled", GRPC_CANCELLED)

    def _cancel_on_loop(self, handle: int) -> None:
        task = self._tasks.pop(handle, None)
        if task is not None:
            task.cancel()

    # -- streams: the event loop ----------------------------------------------------------

    def _submit_stream(self, handle: int, data: bytes, traceparent: str) -> None:
        if self._id is None:
            return  # posted before the stop: the handle went with the connection
        prof = self._core.profiling
        try:
            if prof.take():
                c0 = prof.cpu_now()
                request = self._decode(data, traceparent, self._loop_codec)
                prof.account("frontend_decode", prof.cpu_now() - c0)
            else:
                request = self._decode(data, traceparent, self._loop_codec)
        except Exception as e:  # noqa: BLE001 - wire-level badness
            message, _ = self._error_of(e, default=codec.GRPC_INVALID_ARGUMENT)
            self._complete_stream(handle, self._loop_codec.encode_stream_error(message),
                                  final=True)
            return
        task = self._loop.create_task(self._run_stream(handle, request))
        self._tasks[handle] = task
        task.add_done_callback(lambda _t, h=handle: self._tasks.pop(h, None))

    def _stream_frame(self, request: CoreRequest, response: CoreResponse) -> bytes:
        prof = self._core.profiling
        if request.shm_ring is not None:
            response = request.shm_ring.complete(response)
        if not prof.take():
            return self._loop_codec.encode_stream_response(response)
        c0 = prof.cpu_now()
        try:
            return self._loop_codec.encode_stream_response(response)
        finally:
            prof.account("encode", prof.cpu_now() - c0)

    async def _run_stream(self, handle: int, request: CoreRequest) -> None:
        """One request on a ModelStreamInfer stream: 0..N responses, sent
        with one-item lookahead so the last goes out with ``final`` (which
        frees the handle). Errors travel in-band as error frames."""
        core = self._core
        trace = request.trace
        held: Optional[CoreResponse] = None
        try:
            core.reject_if_draining(request.model_name)
            if request.shm_ring is not None:
                # ring slots hold exactly one response
                response = await core.infer(request)
                self._complete_stream(handle, self._stream_frame(request, response), True)
                if trace is not None:
                    trace.end()
                return
            async for response in core.infer_decoupled(request):
                if held is not None:
                    self._complete_stream(handle, self._stream_frame(request, held), False)
                held = response
        except asyncio.CancelledError:
            if request.shm_ring is not None:
                request.shm_ring.fail()
            if trace is not None:
                trace.end(error="cancelled")
            if not core.lifecycle.accepting:
                # torn down by a drain deadline, not by the peer: a clean
                # retryable error, never a bare cancellation
                message = ("server is draining and not accepting new inference "
                           "requests")
            else:
                message = "request cancelled"
            self._complete_stream(
                handle, self._loop_codec.encode_stream_error(message, request.id), True)
            raise
        except Exception as e:  # noqa: BLE001 - in-band stream error
            if request.shm_ring is not None:
                request.shm_ring.fail()
            if trace is not None:
                trace.end(error=str(e))
            message, _ = self._error_of(e)
            self._complete_stream(
                handle, self._loop_codec.encode_stream_error(message, request.id), True)
            return
        if trace is not None:
            trace.end()
        if held is None:
            # a stream of no response: Triton's final empty response, so
            # the client's request completes
            held = CoreResponse(model_name=request.model_name,
                                model_version=request.model_version, id=request.id,
                                outputs=[], parameters={"triton_final_response": True})
        self._complete_stream(handle, self._stream_frame(request, held), True)

    # -- the other methods: the event loop --------------------------------------------------

    def _rpc(self, handle: int, method: str, payload: bytes) -> None:
        try:
            body = codec.handle_method_bytes(self._core, method, payload)
        except codec.RpcError as e:
            self._lib.ctpu_grpc_complete_rpc(handle, None, 0, e.status,
                                             e.message.encode("utf-8", "replace"))
            return
        except Exception as e:  # noqa: BLE001
            self._lib.ctpu_grpc_complete_rpc(handle, None, 0, codec.GRPC_INTERNAL,
                                             str(e).encode("utf-8", "replace"))
            return
        self._lib.ctpu_grpc_complete_rpc(handle, body, len(body), 0, None)


async def serve_grpc_native(core: ServerCore, host: str = "0.0.0.0", port: int = 8001,
                            tls_cert: Optional[str] = None, tls_key: Optional[str] = None):
    """Start the native gRPC front-end (over TLS with ``tls_cert`` and
    ``tls_key``); returns (frontend, bound_port). ``frontend.stop()`` is
    synchronous."""
    frontend = NativeGrpcFrontend(core, asyncio.get_running_loop())
    frontend.start(host, port, tls_cert=tls_cert, tls_key=tls_key)
    return frontend, frontend.port
