"""Asyncio gRPC client for KServe v2 inference servers.

An own copy of ``client_tpu/grpc/aio/__init__.py`` on the port's h2c
transport (``client_tpu_torch.grpc._h2``) instead of ``grpc.aio``: the
port imports no grpcio. The same methods, ``retry_policy=``,
``circuit_breaker=``, ``tracer=``, endpoint pools, routing and hedging,
plus the trace, log and CUDA shared-memory methods of the sync client (on
which ``client_tpu_torch.grpc`` builds). ``stream_infer`` is an async
iterator over the decoupled bidirectional stream, with cancellation.
``stream_mode=True`` sends every unary infer over one multiplexed
``ModelStreamInfer`` stream (:mod:`client_tpu_torch.grpc._mux`).
``ssl=True`` speaks TLS with ALPN ``h2`` through stdlib :mod:`ssl`;
``creds`` (a grpcio ``ChannelCredentials`` object) is refused, as the port
does not use grpcio.
"""

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Union

from client_tpu_torch._client import InferenceServerClientBase
from client_tpu_torch._request import Request
from client_tpu_torch.grpc import _h2
from client_tpu_torch.grpc._generated import grpc_service_pb2 as service_pb2
from client_tpu_torch.grpc._infer_input import InferInput
from client_tpu_torch.grpc._infer_result import InferResult
from client_tpu_torch.grpc._requested_output import InferRequestedOutput
from client_tpu_torch.grpc._service_stubs import EOF, GRPCInferenceServiceStub
from client_tpu_torch.grpc._utils import (
    MAX_GRPC_MESSAGE_SIZE,
    KeepAliveOptions,
    RpcError,
    _grpc_compression,
    _to_json,
    client_ssl_context,
    get_inference_request,
    is_sequence_request as _is_sequence_request,
    request_is_hedgeable,
    request_routing_key,
    rpc_error_to_exception,
)
from client_tpu_torch.lifecycle import (
    EndpointPool,
    failover_retry_policy,
    grpc_status_is_endpoint_outage,
    hedged_send_async,
    resolve_hedge_policy,
    status_is_unavailable,
)
from client_tpu_torch.observability.trace import (
    NOOP_TRACE,
    TRACEPARENT_HEADER,
    Tracer,
    start_trace,
)
from client_tpu_torch.resilience import (
    CircuitBreaker,
    RetryPolicy,
    run_with_resilience_async,
    sequence_is_idempotent,
)
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "KeepAliveOptions",
]


class InferenceServerClient(InferenceServerClientBase):
    """Asyncio client for the KServe v2 gRPC protocol."""

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
        channel_args: Optional[List] = None,
        retry_policy: Optional[RetryPolicy] = None,
        circuit_breaker: Optional[CircuitBreaker] = None,
        tracer: Optional[Tracer] = None,
        urls=None,
        endpoint_cooldown_s: float = 1.0,
        logger=None,
        stream_mode: bool = False,
        routing_policy=None,
        hedge_policy=None,
    ):
        """``url`` may be a single ``host:port``, a comma list, or an
        :class:`~client_tpu_torch.lifecycle.EndpointPool`; ``urls=[...]`` names
        replica endpoints. One channel per endpoint (created lazily);
        unary RPCs route per ``routing_policy`` — sticky primary by
        default, or ``round_robin`` / ``least_outstanding`` / ``p2c`` /
        ``consistent_hash`` (affinity on the ``routing_key`` request
        parameter) — and fail over, immediately, no backoff sleep, when
        an endpoint answers UNAVAILABLE or the connection dies;
        recovering endpoints must pass a ``ServerReady`` probe first.
        ``stream_infer`` binds to the endpoint current at stream open.

        ``hedge_policy`` (seconds, ``"p95"``, or a
        :class:`~client_tpu_torch.lifecycle.HedgePolicy`) arms request
        hedging: an idempotent infer that outlives the hedge delay
        launches one duplicate on a different endpoint, first response
        wins, the loser is cancelled without touching telemetry or retry
        counts. Sequence requests and requests carrying shm-ring tickets
        never hedge.

        ``stream_mode=True`` routes every unary :meth:`infer` over one
        long-lived multiplexed ``ModelStreamInfer`` stream (correlation
        ids, concurrent server-side execution), amortizing per-RPC setup
        — the small-request fast path. Requests carrying explicit
        ``request_id`` must keep them unique while in flight.

        ``ssl=True`` speaks TLS (ALPN ``h2``), the server verified against
        ``root_certificates`` (a PEM path; the system's roots when None),
        with ``private_key`` and ``certificate_chain`` for mutual TLS.
        ``creds`` (grpcio's ``ChannelCredentials``) raises: the port does
        not use grpcio.

        ``keepalive_options`` (:class:`KeepAliveOptions`) sends HTTP/2
        PINGs on each connection; ``channel_args`` may set the
        ``grpc.max_send_message_length``, ``max_receive_message_length``
        and ``primary_user_agent`` options."""
        ssl_context = client_ssl_context(ssl, creds, root_certificates, private_key,
                                         certificate_chain)
        super().__init__()
        self._verbose = verbose
        self._stream_mode = stream_mode
        self._mux = None
        self._pool = EndpointPool.resolve(
            url,
            urls,
            cooldown_s=endpoint_cooldown_s,
            logger=logger,
            routing_policy=routing_policy,
        )
        self._hedge = resolve_hedge_policy(hedge_policy)
        if self._pool.size > 1 and retry_policy is None:
            retry_policy = failover_retry_policy(self._pool.size)
        self._retry_policy = retry_policy
        self._circuit_breaker = circuit_breaker
        self._tracer = tracer
        options = {
            "grpc.max_send_message_length": MAX_GRPC_MESSAGE_SIZE,
            "grpc.max_receive_message_length": MAX_GRPC_MESSAGE_SIZE,
            "grpc.primary_user_agent": "client-tpu-torch-grpc-aio",
        }
        options.update(dict(channel_args or ()))
        self._channel_options = options
        self._ssl_context = ssl_context
        self._keepalive = keepalive_options
        self._channels: Dict[str, _h2.Channel] = {}
        self._stubs: Dict[str, GRPCInferenceServiceStub] = {}
        # live stream_infer iterators whose endpoint pin is still open
        # (close() releases any a caller abandoned without cancelling)
        self._pinned_stream_iterators = set()
        # primary-bound aliases (stream_infer uses them)
        self._channel = self._channel_for(self._pool.urls[0])
        self._client_stub = self._stub_for(self._pool.urls[0])

    def _channel_for(self, url: str) -> _h2.Channel:
        channel = self._channels.get(url)
        if channel is None:
            options = self._channel_options
            channel = _h2.Channel(
                url,
                keepalive=self._keepalive,
                user_agent=options["grpc.primary_user_agent"],
                max_send_message_length=options["grpc.max_send_message_length"],
                max_receive_message_length=options[
                    "grpc.max_receive_message_length"
                ],
                ssl_context=self._ssl_context,
            )
            self._channels[url] = channel
        return channel

    def _stub_for(self, url: str) -> GRPCInferenceServiceStub:
        stub = self._stubs.get(url)
        if stub is None:
            stub = GRPCInferenceServiceStub(self._channel_for(url))
            self._stubs[url] = stub
        return stub

    async def _probe_endpoint(self, endpoint, timeout: float = 1.0) -> bool:
        """ServerReady against a specific endpoint (the gRPC face of the
        /v2/health/ready check the pool demands of recovering members)."""
        try:
            response = await self._stub_for(endpoint.url).ServerReady(
                service_pb2.ServerReadyRequest(), timeout=timeout
            )
            return bool(response.ready)
        except RpcError:
            return False

    async def _pick_endpoint(
        self,
        budget_s: Optional[float] = None,
        exclude=None,
        key=None,
    ):
        """Pool choice for the next attempt; recovering endpoints pass a
        ServerReady probe first, budgeted against the attempt timeout.
        ``exclude`` asks for an endpoint other than the one given (the
        hedge path); ``key`` is the consistent-hash routing key."""
        pool = self._pool
        probe_timeout = 1.0
        if budget_s:
            probe_timeout = min(1.0, max(0.05, budget_s / pool.size))
        for _ in range(pool.size):
            endpoint = pool.pick(key=key, exclude=exclude)
            if not pool.needs_probe(endpoint):
                return endpoint
            if await self._probe_endpoint(endpoint, timeout=probe_timeout):
                pool.mark_up(endpoint)
                return endpoint
            pool.mark_down(endpoint)
        return pool.pick(key=key, exclude=exclude)

    def _metadata(self, headers: Optional[Dict[str, str]]):
        request = Request(headers or {})
        self._call_plugin(request)
        return tuple((k.lower(), v) for k, v in request.headers.items()) or None

    async def _call(
        self,
        name,
        request,
        headers=None,
        client_timeout=None,
        compression=None,
        idempotent=True,
        probe=False,
        trace=NOOP_TRACE,
        routing_key=None,
        hedgeable=True,
    ):
        """One RPC under the retry/deadline/breaker rules.

        ``client_timeout`` is the total budget across attempts; each
        attempt's gRPC timeout is derived from what remains of it.
        ``probe`` marks liveness/readiness checks: single attempt, no
        breaker accounting (a probe reports current state; its failures
        during a restart must not poison a shared breaker). An active
        ``trace`` records one "request" span per attempt.
        ``routing_key`` feeds consistent-hash affinity; ``hedgeable``
        (with the client's hedge policy armed and ``idempotent``) lets
        the attempt launch a tail hedge on a second endpoint.
        """
        metadata = self._metadata(headers)
        if probe:
            try:
                return await getattr(
                    self._stub_for(self._pool.pick().url), name
                )(
                    request,
                    metadata=metadata,
                    timeout=client_timeout,
                    compression=compression,
                )
            except RpcError as e:
                raise rpc_error_to_exception(e) from None
        pool = self._pool

        async def _raw_send(endpoint, attempt_timeout):
            # one attempt against a SPECIFIC endpoint; pool begin/finish
            # bracketing belongs to the caller (plain or hedged)
            try:
                value = await getattr(self._stub_for(endpoint.url), name)(
                    request,
                    metadata=metadata,
                    timeout=attempt_timeout,
                    compression=compression,
                )
            except RpcError as e:
                exc = rpc_error_to_exception(e)
                if grpc_status_is_endpoint_outage(exc.status()):
                    # draining/dead endpoint — or a server that CANCELLED
                    # an accepted RPC mid-shutdown (local cancellation
                    # raises CancelledError, never an RpcError): bench
                    # it; with an alternative, skip the backoff and fail
                    # over NOW
                    pool.observe(
                        endpoint, token="StatusCode.UNAVAILABLE"
                    )
                    if pool.has_alternative(endpoint):
                        exc.retry_backoff_cap_s = 0.0
                raise exc from None
            pool.observe(endpoint, ok=True)
            return value

        hedge = self._hedge if (hedgeable and idempotent) else None
        if hedge is not None:

            async def _send(attempt_timeout):
                return await hedged_send_async(
                    pool,
                    hedge,
                    lambda budget, exclude: self._pick_endpoint(
                        budget, exclude=exclude, key=routing_key
                    ),
                    _raw_send,
                    attempt_timeout,
                )

        else:

            async def _send(attempt_timeout):
                endpoint = await self._pick_endpoint(
                    attempt_timeout, key=routing_key
                )
                started = pool.begin(endpoint)
                try:
                    value = await _raw_send(endpoint, attempt_timeout)
                except asyncio.CancelledError:
                    # cancellation says nothing about the endpoint: close
                    # the bracket without booking an error
                    pool.finish(endpoint, started, ok=False, cancelled=True)
                    raise
                except InferenceServerException as e:
                    # the token keeps client-fault codes (INVALID_ARGUMENT
                    # and kin) out of consecutive-error ejection
                    pool.finish(
                        endpoint, started, ok=False, token=e.status()
                    )
                    raise
                except BaseException:
                    # an unwrapped failure: close the bracket so the
                    # outstanding gauge never leaks
                    pool.finish(endpoint, started, ok=False)
                    raise
                pool.finish(endpoint, started, ok=True)
                return value

        return await run_with_resilience_async(
            trace.wrap_attempt_async(_send),
            retry_policy=self._retry_policy,
            circuit_breaker=self._circuit_breaker,
            budget_s=client_timeout,
            idempotent=idempotent,
            description=f"gRPC {name}",
        )

    def _use_mux(self, trace, headers, compression_algorithm) -> bool:
        # per-request headers and compression need the unary path, and so
        # does a sampled traceparent, which must ride per-request metadata
        # that the long-lived stream cannot carry
        return (self._stream_mode and headers is None and compression_algorithm is None
                and not trace.traceparent)

    async def _mux_infer(
        self,
        trace,
        client_timeout,
        idempotent: bool,
        **kwargs,
    ) -> InferResult:
        """One multiplexed-stream infer under the retry/breaker rules,
        with per-request endpoint-pool telemetry (the stream pins its
        endpoint at open; every request brackets it); finishes ``trace``."""
        if self._mux is None:
            from client_tpu_torch.grpc._mux import AioStreamMultiplexer

            self._mux = AioStreamMultiplexer(self)
        mux = self._mux
        pool = self._pool

        async def _send(attempt_timeout):
            mux._ensure_open()
            endpoint = mux.endpoint
            started = pool.begin(endpoint)
            try:
                value = await mux.infer(
                    client_timeout=attempt_timeout, **kwargs
                )
            except InferenceServerException as e:
                pool.finish(endpoint, started, ok=False)
                if status_is_unavailable(e.status()):
                    pool.observe(endpoint, token=e.status())
                    if pool.has_alternative(endpoint):
                        e.retry_backoff_cap_s = 0.0
                raise
            except BaseException:
                pool.finish(endpoint, started, ok=False)
                raise
            pool.finish(endpoint, started, ok=True)
            pool.observe(endpoint, ok=True)
            return value

        try:
            response = await run_with_resilience_async(
                trace.wrap_attempt_async(_send),
                retry_policy=self._retry_policy,
                circuit_breaker=self._circuit_breaker,
                budget_s=client_timeout,
                idempotent=idempotent,
                description="gRPC mux ModelInfer",
            )
            with trace.stage("deserialize"):
                result = InferResult(response)
        except BaseException as e:
            trace.finish(error=e)
            raise
        trace.finish()
        return result

    async def close(self) -> None:
        if self._mux is not None:
            mux, self._mux = self._mux, None
            await mux.close()
        # release pins of stream iterators the caller abandoned without
        # cancelling — the snapshot's pinned_streams must not outlive
        # the client that counted them
        for iterator in list(self._pinned_stream_iterators):
            iterator._unpin()
        for channel in self._channels.values():
            await channel.close()

    def endpoint_snapshot(self) -> dict:
        """Live per-endpoint pool telemetry — outstanding requests, EWMA
        latency, error/reroute counters per endpoint (see
        :meth:`~client_tpu_torch.lifecycle.EndpointPool.snapshot`). Unary
        calls are begin/finish-bracketed; the bidirectional stream pins
        its endpoint at open and is not counted per-request."""
        return self._pool.snapshot()

    async def __aenter__(self) -> "InferenceServerClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- health -------------------------------------------------------------

    async def is_server_live(self, headers=None, client_timeout=None) -> bool:
        r = await self._call(
            "ServerLive",
            service_pb2.ServerLiveRequest(),
            headers,
            client_timeout,
            probe=True,
        )
        return r.live

    async def is_server_ready(self, headers=None, client_timeout=None) -> bool:
        r = await self._call(
            "ServerReady",
            service_pb2.ServerReadyRequest(),
            headers,
            client_timeout,
            probe=True,
        )
        return r.ready

    async def is_model_ready(
        self, model_name, model_version="", headers=None, client_timeout=None
    ) -> bool:
        r = await self._call(
            "ModelReady",
            service_pb2.ModelReadyRequest(name=model_name, version=model_version),
            headers,
            client_timeout,
            probe=True,
        )
        return r.ready

    # -- metadata / config / repository / stats ------------------------------

    async def get_server_metadata(
        self, headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "ServerMetadata",
            service_pb2.ServerMetadataRequest(),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def get_model_metadata(
        self,
        model_name,
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelMetadata",
            service_pb2.ModelMetadataRequest(
                name=model_name, version=model_version
            ),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def get_model_config(
        self,
        model_name,
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelConfig",
            service_pb2.ModelConfigRequest(name=model_name, version=model_version),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def get_model_repository_index(
        self, headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "RepositoryIndex",
            service_pb2.RepositoryIndexRequest(),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def load_model(
        self, model_name, headers=None, config=None, files=None, client_timeout=None
    ) -> None:
        request = service_pb2.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"].string_param = config
        if files:
            for name, content in files.items():
                request.parameters[name].bytes_param = content
        await self._call(
            "RepositoryModelLoad",
            request,
            headers,
            client_timeout,
            idempotent=False,
        )

    async def unload_model(
        self,
        model_name,
        headers=None,
        unload_dependents=False,
        client_timeout=None,
    ) -> None:
        request = service_pb2.RepositoryModelUnloadRequest(model_name=model_name)
        request.parameters["unload_dependents"].bool_param = unload_dependents
        await self._call(
            "RepositoryModelUnload",
            request,
            headers,
            client_timeout,
            idempotent=False,
        )

    async def get_inference_statistics(
        self,
        model_name="",
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelStatistics",
            service_pb2.ModelStatisticsRequest(
                name=model_name, version=model_version
            ),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    # -- shared memory -------------------------------------------------------

    async def get_system_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "SystemSharedMemoryStatus",
            service_pb2.SystemSharedMemoryStatusRequest(name=region_name),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "SystemSharedMemoryRegister",
            service_pb2.SystemSharedMemoryRegisterRequest(
                name=name, key=key, offset=offset, byte_size=byte_size
            ),
            headers,
            client_timeout,
            idempotent=False,
        )

    async def unregister_system_shared_memory(
        self, name="", headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "SystemSharedMemoryUnregister",
            service_pb2.SystemSharedMemoryUnregisterRequest(name=name),
            headers,
            client_timeout,
            idempotent=False,
        )

    async def update_trace_settings(
        self,
        model_name=None,
        settings: Optional[Dict[str, Any]] = None,
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        request = service_pb2.TraceSettingRequest(model_name=model_name or "")
        for key, value in (settings or {}).items():
            if value is None:
                # empty entry = clear/reset this setting (Triton semantics)
                request.settings[key].SetInParent()
                continue
            values = value if isinstance(value, (list, tuple)) else [value]
            request.settings[key].value.extend(str(v) for v in values)
        response = await self._call("TraceSetting", request, headers, client_timeout)
        return _to_json(response) if as_json else response

    async def get_trace_settings(
        self, model_name=None, headers=None, as_json=False, client_timeout=None
    ):
        request = service_pb2.TraceSettingRequest(model_name=model_name or "")
        response = await self._call("TraceSetting", request, headers, client_timeout)
        return _to_json(response) if as_json else response

    async def update_log_settings(
        self, settings: Dict[str, Any], headers=None, as_json=False, client_timeout=None
    ):
        request = service_pb2.LogSettingsRequest()
        for key, value in settings.items():
            if isinstance(value, bool):
                request.settings[key].bool_param = value
            elif isinstance(value, int):
                request.settings[key].uint32_param = value
            else:
                request.settings[key].string_param = str(value)
        response = await self._call("LogSettings", request, headers, client_timeout)
        return _to_json(response) if as_json else response

    async def get_log_settings(self, headers=None, as_json=False, client_timeout=None):
        response = await self._call(
            "LogSettings", service_pb2.LogSettingsRequest(), headers, client_timeout
        )
        return _to_json(response) if as_json else response

    async def get_cuda_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        response = await self._call(
            "CudaSharedMemoryStatus",
            service_pb2.CudaSharedMemoryStatusRequest(name=region_name),
            headers,
            client_timeout,
        )
        return _to_json(response) if as_json else response

    async def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "CudaSharedMemoryRegister",
            service_pb2.CudaSharedMemoryRegisterRequest(
                name=name,
                raw_handle=raw_handle,
                device_id=device_id,
                byte_size=byte_size,
            ),
            headers,
            client_timeout,
            idempotent=False,
        )

    async def unregister_cuda_shared_memory(
        self, name="", headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "CudaSharedMemoryUnregister",
            service_pb2.CudaSharedMemoryUnregisterRequest(name=name),
            headers,
            client_timeout,
            idempotent=False,
        )

    async def get_tpu_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "TpuSharedMemoryStatus",
            service_pb2.TpuSharedMemoryStatusRequest(name=region_name),
            headers,
            client_timeout,
        )
        return _to_json(r) if as_json else r

    async def register_tpu_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "TpuSharedMemoryRegister",
            service_pb2.TpuSharedMemoryRegisterRequest(
                name=name,
                raw_handle=raw_handle,
                device_id=device_id,
                byte_size=byte_size,
            ),
            headers,
            client_timeout,
            idempotent=False,
        )

    async def unregister_tpu_shared_memory(
        self, name="", headers=None, client_timeout=None
    ) -> None:
        await self._call(
            "TpuSharedMemoryUnregister",
            service_pb2.TpuSharedMemoryUnregisterRequest(name=name),
            headers,
            client_timeout,
            idempotent=False,
        )

    # -- inference -----------------------------------------------------------

    @staticmethod
    def prepare_request(
        model_name: str,
        inputs: Sequence[InferInput],
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: Union[int, str] = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ):
        """Build a reusable ``ModelInferRequest`` for :meth:`infer_prepared`.

        The reference reuses the request proto across sends
        (reference grpc_client.cc:1419-1580 PreRunProcessing); building
        once and resending skips per-send input marshalling entirely.
        """
        return get_inference_request(
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

    async def infer_prepared(
        self,
        request,
        client_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
    ) -> InferResult:
        """Send a request built by :meth:`prepare_request` (reusable)."""
        trace = start_trace(
            self._tracer, "infer", surface="grpc", model=request.model_name
        )
        if self._use_mux(trace, headers, compression_algorithm):
            return await self._mux_infer(trace, client_timeout,
                                         not _is_sequence_request(request),
                                         prepared_request=request)
        if trace.traceparent:
            headers = {
                **(headers or {}),
                TRACEPARENT_HEADER: trace.traceparent,
            }
        try:
            response = await self._call(
                "ModelInfer",
                request,
                headers,
                client_timeout,
                compression=_grpc_compression(compression_algorithm),
                idempotent=not _is_sequence_request(request),
                trace=trace,
                routing_key=self._request_routing_key(request),
                hedgeable=self._request_hedgeable(request),
            )
            with trace.stage("deserialize"):
                result = InferResult(response)
        except BaseException as e:
            trace.finish(error=e)
            raise
        trace.finish()
        return result

    def _request_routing_key(self, request):
        """The consistent-hash key of a built request, read from the
        policy's key parameter (zero work unless such a policy is on)."""
        return request_routing_key(request, self._pool.key_parameter)

    def _request_hedgeable(self, request) -> bool:
        """Requests referencing single-writer buffers (shm-ring tickets,
        shared-memory regions) never hedge — shared classification in
        :func:`client_tpu_torch.grpc._utils.request_is_hedgeable` (checked
        only while hedging is armed)."""
        return self._hedge is None or request_is_hedgeable(request)

    async def infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
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
    ) -> InferResult:
        trace = start_trace(
            self._tracer, "infer", surface="grpc", model=model_name
        )
        if self._use_mux(trace, headers, compression_algorithm):
            # serialization happens inside the mux (protobuf-free builder)
            return await self._mux_infer(
                trace,
                client_timeout,
                sequence_is_idempotent(sequence_id),
                model_name=model_name,
                inputs=inputs,
                model_version=model_version,
                request_id=request_id,
                outputs=outputs,
                parameters=parameters,
                priority=priority,
                timeout=timeout,
                sequence_id=sequence_id,
                sequence_start=sequence_start,
                sequence_end=sequence_end,
            )
        try:
            with trace.stage("serialize"):
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
            if trace.traceparent:
                headers = {
                    **(headers or {}),
                    TRACEPARENT_HEADER: trace.traceparent,
                }
            response = await self._call(
                "ModelInfer",
                request,
                headers,
                client_timeout,
                compression=_grpc_compression(compression_algorithm),
                idempotent=sequence_is_idempotent(sequence_id),
                trace=trace,
                routing_key=self._request_routing_key(request),
                hedgeable=self._request_hedgeable(request),
            )
            with trace.stage("deserialize"):
                result = InferResult(response)
        except BaseException as e:
            trace.finish(error=e)
            raise
        trace.finish()
        return result

    def stream_infer(
        self,
        inputs_iterator: AsyncIterator[Dict[str, Any]],
        stream_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        compression_algorithm: Optional[str] = None,
    ) -> AsyncIterator:
        """Run inferences over the decoupled bidirectional stream.

        ``inputs_iterator`` yields dicts of :meth:`infer`-style kwargs (at
        minimum ``model_name`` and ``inputs``). Returns an async iterator of
        ``(InferResult, error)`` tuples carrying a ``cancel()`` method.
        """

        async def _request_iterator():
            async for kwargs in inputs_iterator:
                enable_empty_final = kwargs.pop(
                    "enable_empty_final_response", False
                )
                request = get_inference_request(
                    kwargs.pop("model_name"),
                    kwargs.pop("inputs"),
                    **kwargs,
                )
                if enable_empty_final:
                    request.parameters[
                        "triton_enable_empty_final_response"
                    ].bool_param = True
                yield request

        # bound to the pool's current endpoint at open (draining/dead
        # endpoints are routed around; the stream then stays on it).
        # Stream traffic is counted as a PINNED STREAM on the endpoint,
        # not per request: a decoupled request may produce N responses,
        # so there is no per-request begin/finish to bracket — routing
        # policies deliberately exclude pinned-stream load from their
        # signals (snapshot() surfaces the pin count for visibility).
        pool = self._pool
        endpoint = pool.pick()
        call = self._stub_for(endpoint.url).ModelStreamInfer(
            _request_iterator(),
            metadata=self._metadata(headers),
            timeout=stream_timeout,
            compression=_grpc_compression(compression_algorithm),
        )
        pool.pin_stream(endpoint)
        registry = self._pinned_stream_iterators

        class _ResponseIterator:
            """Async iterator of (result, error); cancellable."""

            def __init__(self, grpc_call):
                self._call = grpc_call
                self._pinned = True
                registry.add(self)

            def _unpin(self):
                if self._pinned:
                    self._pinned = False
                    pool.unpin_stream(endpoint)
                    registry.discard(self)

            def cancel(self) -> bool:
                cancelled = self._call.cancel()
                self._unpin()
                return cancelled

            def __aiter__(self):
                return self

            async def __anext__(self):
                try:
                    response = await self._call.read()
                except asyncio.CancelledError:
                    self._unpin()
                    raise StopAsyncIteration from None
                except RpcError as e:
                    self._unpin()
                    raise rpc_error_to_exception(e) from None
                if response is EOF:
                    self._unpin()
                    raise StopAsyncIteration
                if response.error_message:
                    return None, InferenceServerException(
                        response.error_message
                    )
                return InferResult(response.infer_response), None

        return _ResponseIterator(call)
