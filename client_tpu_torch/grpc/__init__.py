"""Synchronous gRPC client for KServe v2 inference servers.

An own copy of ``client_tpu/grpc/__init__.py`` without grpcio, which the
port does not import: a synchronous veneer over the asyncio client
in ``client_tpu_torch.grpc.aio`` (one private event-loop thread per client),
as ``client_tpu_torch.http`` is over its aio client. The same methods, from
``is_server_live`` to ``stop_stream``: health, metadata and config,
repository control, statistics, trace and log settings, system, CUDA and
TPU shared memory, unary, prepared and async inference, and the decoupled
bidirectional stream (:class:`~client_tpu_torch.grpc._infer_stream.InferStream`,
which reconnects on UNAVAILABLE under a retry policy). The message classes
are the port's own (``service_pb2``, ``model_config_pb2``); ``as_json=True``
gives what ``json_format.MessageToDict`` gives. ``stream_mode=True`` sends
every unary infer over one multiplexed ``ModelStreamInfer`` stream
(the aio client's
:class:`~client_tpu_torch.grpc._mux.AioStreamMultiplexer`, on the client's
loop); ``ssl=True`` speaks TLS with ALPN ``h2``.
"""

import concurrent.futures
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Union

from client_tpu_torch._sync_runner import EventLoopRunner
from client_tpu_torch.grpc import aio as _aio
from client_tpu_torch.grpc._generated import grpc_service_pb2 as service_pb2
from client_tpu_torch.grpc._generated import model_config_pb2
from client_tpu_torch.grpc._infer_input import InferInput
from client_tpu_torch.grpc._infer_result import InferResult
from client_tpu_torch.grpc._infer_stream import InferStream
from client_tpu_torch.grpc._requested_output import InferRequestedOutput
from client_tpu_torch.grpc._utils import (
    MAX_GRPC_MESSAGE_SIZE,
    KeepAliveOptions,
    RpcError,
    StatusCode,
    _grpc_compression,
    get_inference_request,
    rpc_error_to_exception,
)
from client_tpu_torch.resilience import CircuitBreakerOpenError, record_breaker_outcome
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "KeepAliveOptions",
    "CallContext",
    "MAX_GRPC_MESSAGE_SIZE",
    "RpcError",
    "StatusCode",
    "service_pb2",
    "model_config_pb2",
]


class CallContext:
    """Handle to an in-flight async_infer call (supports cancellation)."""

    def __init__(self, future: concurrent.futures.Future):
        self._future = future

    def cancel(self) -> bool:
        """Cancel the request if still in flight."""
        return self._future.cancel()

    def get_result(self, timeout: Optional[float] = None) -> InferResult:
        """Block for and return the InferResult."""
        try:
            return InferResult(self._future.result(timeout=timeout))
        except RpcError as e:
            raise rpc_error_to_exception(e) from None
        except concurrent.futures.TimeoutError:
            raise InferenceServerException("timeout waiting for async infer result") from None
        except concurrent.futures.CancelledError:
            raise InferenceServerException("request was cancelled") from None


class SyncStreamCall:
    """A blocking face of one aio ``ModelStreamInfer`` call, as the
    reference's :class:`InferStream` reads a grpcio call: iterating yields
    responses (raising RpcError when the call fails), a writer thread
    feeds it from a blocking request iterator, ``cancel()`` ends it."""

    def __init__(self, runner: EventLoopRunner, stub, request_iterator, metadata,
                 timeout, compression):
        self._runner = runner
        self._call = stub.ModelStreamInfer.open(metadata, timeout, compression)
        self._requests = request_iterator
        self._writer = threading.Thread(target=self._write_all, name="client-tpu-grpc-writer",
                                        daemon=True)
        self._writer.start()

    def _write_all(self) -> None:
        try:
            for request in self._requests:
                self._runner.run(self._call.write(request.SerializeToString()))
            self._runner.run(self._call.done_writing())
        except Exception:  # noqa: BLE001 - the reader reports the call's end
            pass

    def __iter__(self):
        return self

    def __next__(self):
        response = self._runner.run(self._call.read())
        if response is None:
            raise StopIteration
        return service_pb2.ModelStreamInferResponse.FromString(response)

    def cancel(self) -> bool:
        self._runner.loop.call_soon_threadsafe(self._call.cancel)
        return True


def _delegated(name: str):
    """A sync method running the aio client's coroutine of that name."""

    def method(self, *args, **kwargs):
        return self._runner.run(getattr(self._aio_client, name)(*args, **kwargs))

    method.__name__ = name
    method.__doc__ = getattr(_aio.InferenceServerClient, name).__doc__
    return method


class InferenceServerClient:
    """Synchronous client for the KServe v2 gRPC protocol."""

    def __init__(
        self,
        url=None,
        verbose: bool = False,
        ssl: bool = False,
        root_certificates: Optional[str] = None,
        private_key: Optional[str] = None,
        certificate_chain: Optional[str] = None,
        creds=None,
        keepalive_options: Optional[KeepAliveOptions] = None,
        channel_args=None,
        retry_policy=None,
        circuit_breaker=None,
        tracer=None,
        urls=None,
        endpoint_cooldown_s: float = 1.0,
        logger=None,
        stream_mode: bool = False,
        routing_policy=None,
        hedge_policy=None,
    ):
        """The aio client's arguments (see
        :class:`client_tpu_torch.grpc.aio.InferenceServerClient`). The
        client may be used from several threads: calls run on its loop.
        With ``stream_mode=True`` unary :meth:`infer` and
        :meth:`infer_prepared` ride the aio client's multiplexed stream."""
        self._verbose = verbose
        self._runner = EventLoopRunner(name="client-tpu-torch-grpc")
        self._aio_client = _aio.InferenceServerClient(
            url, verbose=verbose, ssl=ssl, root_certificates=root_certificates,
            private_key=private_key, certificate_chain=certificate_chain, creds=creds,
            keepalive_options=keepalive_options,
            channel_args=channel_args, retry_policy=retry_policy,
            circuit_breaker=circuit_breaker, tracer=tracer, urls=urls,
            endpoint_cooldown_s=endpoint_cooldown_s, logger=logger,
            routing_policy=routing_policy, hedge_policy=hedge_policy,
            stream_mode=stream_mode)
        self._pool = self._aio_client._pool
        self._retry_policy = self._aio_client._retry_policy
        self._circuit_breaker = circuit_breaker
        self._stream: Optional[InferStream] = None
        self._stream_endpoint = None

    def close(self) -> None:
        """Close every endpoint channel (stops any active stream first)."""
        self.stop_stream()
        if not self._runner.loop.is_closed():
            self._runner.run(self._aio_client.close())
        self._runner.close()

    def endpoint_snapshot(self) -> dict:
        """Live per-endpoint pool telemetry (see
        :meth:`~client_tpu_torch.lifecycle.EndpointPool.snapshot`)."""
        return self._pool.snapshot()

    def __enter__(self) -> "InferenceServerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    is_server_live = _delegated("is_server_live")
    is_server_ready = _delegated("is_server_ready")
    is_model_ready = _delegated("is_model_ready")
    get_server_metadata = _delegated("get_server_metadata")
    get_model_metadata = _delegated("get_model_metadata")
    get_model_config = _delegated("get_model_config")
    get_model_repository_index = _delegated("get_model_repository_index")
    load_model = _delegated("load_model")
    unload_model = _delegated("unload_model")
    get_inference_statistics = _delegated("get_inference_statistics")
    update_trace_settings = _delegated("update_trace_settings")
    get_trace_settings = _delegated("get_trace_settings")
    update_log_settings = _delegated("update_log_settings")
    get_log_settings = _delegated("get_log_settings")
    get_system_shared_memory_status = _delegated("get_system_shared_memory_status")
    register_system_shared_memory = _delegated("register_system_shared_memory")
    unregister_system_shared_memory = _delegated("unregister_system_shared_memory")
    get_cuda_shared_memory_status = _delegated("get_cuda_shared_memory_status")
    register_cuda_shared_memory = _delegated("register_cuda_shared_memory")
    unregister_cuda_shared_memory = _delegated("unregister_cuda_shared_memory")
    get_tpu_shared_memory_status = _delegated("get_tpu_shared_memory_status")
    register_tpu_shared_memory = _delegated("register_tpu_shared_memory")
    unregister_tpu_shared_memory = _delegated("unregister_tpu_shared_memory")
    infer = _delegated("infer")
    infer_prepared = _delegated("infer_prepared")
    prepare_request = staticmethod(_aio.InferenceServerClient.prepare_request)

    # -- asynchronous inference ---------------------------------------------------------

    def async_infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        callback: Callable,
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: Union[int, str] = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        client_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> CallContext:
        """Issue an inference without blocking.

        ``callback(result, error)`` fires from the client's loop thread on
        completion. Returns a :class:`CallContext` whose ``cancel()``
        aborts the call. The callback contract rules out transparent
        retries (the caller would see duplicate callbacks), but a
        configured circuit breaker is honored: an open breaker fails fast
        here, and outcomes feed its accounting."""
        breaker = self._circuit_breaker
        if breaker is not None and not breaker.allow():
            raise CircuitBreakerOpenError(
                "circuit breaker is open; gRPC async ModelInfer failed fast")
        aio_client = self._aio_client
        try:
            request = get_inference_request(
                model_name, inputs, model_version=model_version, request_id=request_id,
                outputs=outputs, sequence_id=sequence_id, sequence_start=sequence_start,
                sequence_end=sequence_end, priority=priority, timeout=timeout,
                parameters=parameters)
            if self._verbose:
                print(f"gRPC async ModelInfer: {{{str(request)[:200]}}}")
            metadata = aio_client._metadata(headers)
            compression = _grpc_compression(compression_algorithm)
            endpoint = self._pool.pick()

            async def _once():
                return await aio_client._stub_for(endpoint.url).ModelInfer(
                    request, metadata=metadata, timeout=client_timeout,
                    compression=compression)

            future = self._runner.submit(_once())
        except BaseException as e:
            # a local failure before the call exists says nothing about the
            # server: release a half-open probe slot instead of wedging it
            record_breaker_outcome(breaker, e)
            raise

        def _done(f):
            # build (result, error) first, then call back exactly once
            result, error = None, None
            try:
                result = InferResult(f.result())
            except RpcError as e:
                error = rpc_error_to_exception(e)
            except concurrent.futures.CancelledError:
                error = InferenceServerException("request was cancelled")
            except Exception as e:  # noqa: BLE001
                error = InferenceServerException(str(e))
            if breaker is not None:
                if error is None:
                    breaker.record_success()
                else:
                    record_breaker_outcome(breaker, error)
            callback(result, error)

        future.add_done_callback(_done)
        return CallContext(future)

    # -- decoupled streaming ------------------------------------------------------------

    def start_stream(
        self,
        callback: Callable,
        stream_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
    ) -> None:
        """Open the bidirectional inference stream.

        Only one stream per client at a time. ``callback(result, error)``
        fires once per *response*: decoupled models may produce many
        responses per request. Under a ``retry_policy``, a stream torn
        down with UNAVAILABLE reconnects (with the policy's backoff);
        requests in flight on the dead connection surface to the callback
        as errors, never replayed, and requests still queued carry over."""
        if self._stream is not None and self._stream.is_active():
            raise InferenceServerException(
                "stream is already active; call stop_stream() first")
        metadata = self._aio_client._metadata(headers)
        compression = _grpc_compression(compression_algorithm)

        def _open(request_iterator, timeout=stream_timeout):
            # bound to the pool's current endpoint at each (re)open, so a
            # reconnect fails over; the stream pin moves with it
            endpoint = self._pool.pick()
            if self._stream_endpoint is not None:
                self._pool.unpin_stream(self._stream_endpoint)
            self._stream_endpoint = endpoint
            self._pool.pin_stream(endpoint)
            return SyncStreamCall(self._runner, self._aio_client._stub_for(endpoint.url),
                                  request_iterator, metadata, timeout, compression)

        self._stream = InferStream(callback, verbose=self._verbose,
                                   retry_policy=self._retry_policy,
                                   stream_budget_s=stream_timeout)
        self._stream.init_handler(_open(self._stream.request_iterator), reconnect=_open)

    def async_stream_infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: Union[int, str] = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        enable_empty_final_response: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Send one request on the active stream (non-blocking)."""
        if self._stream is None or not self._stream.is_active():
            raise InferenceServerException(
                "stream is not active; call start_stream() first")
        request = get_inference_request(
            model_name, inputs, model_version=model_version, request_id=request_id,
            outputs=outputs, sequence_id=sequence_id, sequence_start=sequence_start,
            sequence_end=sequence_end, priority=priority, timeout=timeout,
            parameters=parameters)
        if enable_empty_final_response:
            request.parameters["triton_enable_empty_final_response"].bool_param = True
        self._stream.enqueue_request(request)

    def stop_stream(self, cancel_requests: bool = False) -> None:
        """Close the active stream (if any)."""
        if self._stream is not None:
            self._stream.close(cancel_requests=cancel_requests)
            self._stream = None
        if self._stream_endpoint is not None:
            self._pool.unpin_stream(self._stream_endpoint)
            self._stream_endpoint = None
