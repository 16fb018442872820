"""Asyncio HTTP/REST client for KServe v2 inference servers.

An own copy of ``client_tpu/http/aio`` rewritten on stdlib asyncio
streams (``asyncio.open_connection``) in place of ``aiohttp``, which the
card's machine does not have. Every public method keeps the JAX
package's name, signature and wire contract; the sync client in
``client_tpu_torch.http`` delegates to this one through a background
event loop.

Transport, as the reference's ``aiohttp`` session had it: HTTP/1.1 with
keep-alive connections pooled per endpoint, at most ``concurrency`` open
at once across the client (the reference's ``TCPConnector`` limit);
``connection_timeout`` bounds connecting and ``network_timeout`` (or a
call's ``client_timeout``) a whole attempt, through ``asyncio.wait_for``.
Transport failures carry the ``CONNECTION_ERROR`` status, so retries and
endpoint failover classify them as they do the reference's. A connection
the server marks ``Connection: close`` is not reused; an idle one the
server closed in the meantime is replaced and the request sent again.
Bodies come with a ``Content-Length`` or chunked; no response is
decompressed here (``InferResult.from_response`` reads
``Content-Encoding``).
"""

import asyncio
import json
import ssl as ssl_module
from typing import Any, Dict, Optional, Sequence
from urllib.parse import urlsplit

from client_tpu_torch._client import InferenceServerClientBase
from client_tpu_torch._request import Request
from client_tpu_torch.http._infer_input import InferInput
from client_tpu_torch.http._infer_result import InferResult
from client_tpu_torch.http._requested_output import InferRequestedOutput
from client_tpu_torch.http._utils import (
    HEADER_CONTENT_LENGTH,
    build_query_string,
    compress_body,
    get_inference_request_body,
    model_infer_uri,
    parse_json_response,
    raise_if_error,
    read_chunked,
    retry_after_seconds,
)
from client_tpu_torch.lifecycle import (
    EndpointPool,
    failover_retry_policy,
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
    CONNECTION_ERROR_STATUS,
    CircuitBreaker,
    RetryPolicy,
    run_with_resilience_async,
    sequence_is_idempotent,
)
from client_tpu_torch.utils import InferenceServerException

__all__ = ["InferenceServerClient", "InferInput", "InferRequestedOutput", "InferResult"]



def _request_head(method: str, target: str, host: str, headers: Dict[str, str],
                  body: Optional[bytes]) -> bytes:
    """The request line and headers. Without an ``Accept-Encoding`` of the
    caller's the client asks for ``identity``, as the reference's session
    does by default."""
    lines = [f"{method} {target} HTTP/1.1", f"Host: {host}"]
    for name, value in headers.items():
        name, value = str(name), str(value)
        if any(c in name + value for c in "\r\n") or ":" in name:
            raise InferenceServerException(f"invalid HTTP header {name!r}: {value!r}")
        lines.append(f"{name}: {value}")
    if not any(name.lower() == "accept-encoding" for name in headers):
        lines.append("Accept-Encoding: identity")
    if body is not None:
        lines.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# methods resent once when the server drops the connection before its
# response head arrives, as the reference's aiohttp session does (RFC 9112
# section 9.3.1); a POST is never resent by the transport
_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE", "PUT", "DELETE"})


class _Disconnected(Exception):
    """The server closed or reset the connection before the response head
    was read."""


class _Connections:
    """Keep-alive HTTP/1.1 connections, idle ones kept per endpoint
    address, at most ``limit`` in use at once."""

    def __init__(self, limit: int, connect_timeout: float, ssl_context=None):
        self._slots = asyncio.Semaphore(limit)
        self._connect_timeout = connect_timeout
        self._ssl_context = ssl_context
        self._idle: Dict[tuple, list] = {}

    async def request(self, address, head, body, method, headers_arrived) -> tuple:
        """(status, body, headers) of one exchange with ``address``
        (scheme, host, port); ``headers_arrived()`` is called when the
        response head has been read."""
        resend = method in _IDEMPOTENT_METHODS
        async with self._slots:
            while True:
                reader, writer = self._take_idle(address) or await self._open(address)
                try:
                    return await self._exchange(address, reader, writer, head, body,
                                                method, headers_arrived)
                except _Disconnected as e:
                    if not resend:
                        raise e.__cause__ from None
                    resend = False

    def _take_idle(self, address):
        idle = self._idle.get(address)
        while idle:
            reader, writer = idle.pop()
            if not (reader.at_eof() or writer.is_closing()):
                return reader, writer
            writer.close()
        return None

    async def _open(self, address):
        scheme, host, port = address
        ssl_context = None
        if scheme == "https":
            ssl_context = self._ssl_context or ssl_module.create_default_context()
        return await asyncio.wait_for(
            asyncio.open_connection(host, port, ssl=ssl_context), self._connect_timeout)

    async def _exchange(self, address, reader, writer, head, body, method,
                        headers_arrived):
        reusable = False  # set once the whole response has been read
        try:
            try:
                writer.write(head)
                if body:
                    writer.write(body)
                await writer.drain()
                response_head = await reader.readuntil(b"\r\n\r\n")
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                raise _Disconnected() from e
            headers_arrived()
            lines = response_head.decode("latin-1").split("\r\n")
            version, _, rest = lines[0].partition(" ")
            status = int(rest[:3])
            headers, lowered = {}, {}
            for line in lines[1:]:
                if line:
                    name, _, value = line.partition(":")
                    headers[name.strip()] = value.strip()
                    lowered[name.strip().lower()] = value.strip()
            connection = lowered.get("connection", "").lower()
            keep = connection != "close" and (version == "HTTP/1.1" or connection == "keep-alive")
            if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
                data = b""
            elif "chunked" in lowered.get("transfer-encoding", "").lower():
                data = await read_chunked(reader)
            elif "content-length" in lowered:
                data = await reader.readexactly(int(lowered["content-length"]))
            else:  # delimited by the end of the connection
                data = await reader.read()
                keep = False
            reusable = keep
            return status, data, headers
        finally:
            if reusable:
                self._idle.setdefault(address, []).append((reader, writer))
            else:
                writer.close()

    async def close(self) -> None:
        writers = [w for conns in self._idle.values() for _, w in conns]
        self._idle.clear()
        for writer in writers:
            writer.close()
        await asyncio.gather(*(w.wait_closed() for w in writers), return_exceptions=True)

class InferenceServerClient(InferenceServerClientBase):
    """An asyncio client for the KServe v2 HTTP/REST protocol.

    Parameters
    ----------
    url:
        Host:port of the server, e.g. ``"localhost:8000"``. May also be
        a comma-separated list of endpoints or an
        :class:`~client_tpu_torch.lifecycle.EndpointPool` (see ``urls``).
    urls:
        Optional list of equivalent endpoints (replicas behind no load
        balancer). Requests target a sticky primary; endpoints that
        return 503 / connection errors (draining or dead servers) are
        benched for ``endpoint_cooldown_s`` (or their ``Retry-After``
        hint) and traffic fails over to the next healthy endpoint —
        immediately, skipping the retry backoff. Recovering endpoints
        must pass a ``/v2/health/ready`` probe before carrying real
        traffic again. With more than one endpoint and no explicit
        ``retry_policy``, a small failover retry policy is installed so
        idempotent requests actually reroute instead of failing.
    verbose:
        Print request/response traffic.
    concurrency:
        Connection-pool size (the reference's greenlet concurrency knob).
    connection_timeout / network_timeout:
        Connect / total-read timeouts in seconds.
    ssl:
        Use https. ``ssl_context`` may carry a preconfigured
        ``ssl.SSLContext``.
    retry_policy:
        Optional :class:`client_tpu_torch.resilience.RetryPolicy`. When set,
        idempotent requests that fail with connect errors or retryable
        HTTP statuses (429/502/503/504) are retried with capped
        exponential backoff; sequence inference is never auto-retried.
        Off by default (single attempt, as before).
    circuit_breaker:
        Optional :class:`client_tpu_torch.resilience.CircuitBreaker` shared
        per client (or across clients): when open, requests fail fast
        with ``CircuitBreakerOpenError`` instead of piling up backoff.
    tracer:
        Optional :class:`client_tpu_torch.observability.Tracer`. When set,
        each ``infer``/``infer_with_body`` call records client spans
        (serialize, per-attempt send/wait, deserialize) and propagates a
        W3C ``traceparent`` header the server front-ends extract. Off by
        default (no spans, no header).
    routing_policy:
        None (sticky primary) or ``round_robin`` / ``least_outstanding``
        / ``p2c`` / ``consistent_hash`` (affinity on the ``routing_key``
        request parameter) — selection over the pool's live
        per-endpoint outstanding/EWMA signals.
    hedge_policy:
        Arms request hedging for idempotent requests: seconds (fixed
        trigger), ``"p95"`` (latency-derived), or a
        :class:`~client_tpu_torch.lifecycle.HedgePolicy`. First response wins;
        the losing attempt is cancelled and never double-counted in
        pool telemetry or retries. Requests referencing shared-memory
        regions or shm-ring tickets never hedge.
    """

    def __init__(
        self,
        url=None,
        verbose: bool = False,
        concurrency: int = 16,
        connection_timeout: float = 60.0,
        network_timeout: float = 60.0,
        ssl: bool = False,
        ssl_context=None,
        retry_policy: Optional[RetryPolicy] = None,
        circuit_breaker: Optional[CircuitBreaker] = None,
        tracer: Optional[Tracer] = None,
        urls=None,
        endpoint_cooldown_s: float = 1.0,
        logger=None,
        routing_policy=None,
        hedge_policy=None,
    ):
        super().__init__()
        scheme = "https" if ssl else "http"
        self._pool = EndpointPool.resolve(
            url,
            urls,
            cooldown_s=endpoint_cooldown_s,
            logger=logger,
            routing_policy=routing_policy,
        )
        self._hedge = resolve_hedge_policy(hedge_policy)
        for endpoint_url in self._pool.urls:
            if "://" in endpoint_url:
                raise InferenceServerException(
                    f"url should not include the scheme: '{endpoint_url}'"
                )
        self._scheme = scheme
        if self._pool.size > 1 and retry_policy is None:
            # Failover needs attempts to spend: give multi-endpoint
            # clients a small retry budget (the backoff is skipped
            # entirely when another endpoint is available).
            retry_policy = failover_retry_policy(self._pool.size)
        self._verbose = verbose
        self._connections = _Connections(concurrency, connection_timeout, ssl_context)
        self._network_timeout = network_timeout
        self._retry_policy = retry_policy
        self._circuit_breaker = circuit_breaker
        self._tracer = tracer

    # -- connection pool lifecycle -------------------------------------------

    async def close(self) -> None:
        """Close the connection pool's idle connections."""
        await self._connections.close()

    def endpoint_snapshot(self) -> dict:
        """Live per-endpoint telemetry (outstanding requests, EWMA
        latency, error/reroute counters) — every request this client
        sends is bracketed through its :class:`~client_tpu_torch.lifecycle.
        EndpointPool`; see :meth:`EndpointPool.snapshot`."""
        return self._pool.snapshot()

    async def __aenter__(self) -> "InferenceServerClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- low-level request helpers ----------------------------------------

    def _prepare_headers(
        self, headers: Optional[Dict[str, str]]
    ) -> Dict[str, str]:
        request = Request(headers or {})
        self._call_plugin(request)
        return request.headers

    async def _request_once(
        self, method, url, data, headers, timeout, trace=NOOP_TRACE
    ) -> tuple:
        """One attempt; transport failures (connect errors, resets, a
        malformed or truncated response, the attempt's timeout) surface
        as InferenceServerException with status CONNECTION_ERROR (URL
        and cause in the message). ``timeout`` bounds the whole attempt
        (the client's ``network_timeout`` when None); connecting is
        bounded by ``connection_timeout`` as well. With an active
        ``trace`` the attempt records a "send" span (until response
        headers arrive) and a "wait" span (body read)."""
        parts = urlsplit(url)
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        head = _request_head(method, target, parts.netloc, headers, data)
        address = (parts.scheme, parts.hostname,
                   parts.port or (443 if parts.scheme == "https" else 80))
        spans = [trace.begin_span("send", attempt=trace.attempt_index())]

        def headers_arrived():
            trace.end_span(spans[0])
            spans[0] = trace.begin_span("wait")

        try:
            result = await asyncio.wait_for(
                self._connections.request(address, head, data, method, headers_arrived),
                timeout or self._network_timeout,
            )
        except (OSError, EOFError, TimeoutError, ValueError,
                asyncio.LimitOverrunError) as e:
            trace.end_span(spans[0], error=f"{type(e).__name__}: {e}")
            raise InferenceServerException(
                f"{method} {url} failed: {type(e).__name__}: {e}",
                status=CONNECTION_ERROR_STATUS,
            ) from e
        trace.end_span(spans[0])
        return result

    def _endpoint_base(self, endpoint) -> str:
        return f"{self._scheme}://{endpoint.url}"

    async def _probe_endpoint(self, endpoint, timeout: float = 1.0) -> bool:
        """One /v2/health/ready probe against a specific endpoint (used
        before trusting a recovering pool member with real traffic)."""
        try:
            status, _, _ = await self._request_once(
                "GET",
                f"{self._endpoint_base(endpoint)}/v2/health/ready",
                None,
                {},
                timeout,
            )
        except InferenceServerException:
            return False
        return status == 200

    async def _pick_endpoint(
        self,
        budget_s: Optional[float] = None,
        exclude=None,
        key=None,
    ):
        """The pool's choice for the next attempt; endpoints coming back
        from a down period must pass a readiness probe first (a draining
        server answers its health endpoint long before it serves).
        Probes are budgeted against ``budget_s`` (the remaining attempt
        timeout) so they can never blow the caller's deadline.
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

    @staticmethod
    def _result_ok(result) -> bool:
        return str(result[0]).startswith("2")

    async def _execute(
        self,
        method,
        path,
        data,
        headers,
        query_params,
        timeout=None,
        idempotent=True,
        probe=False,
        trace=NOOP_TRACE,
        routing_key=None,
        hedgeable=True,
    ) -> tuple:
        suffix = f"/{path}{build_query_string(query_params)}"
        prepared_headers = self._prepare_headers(headers)
        if probe:
            # liveness/readiness probes report CURRENT state: retrying
            # one would invert its purpose, and its failures while a
            # server restarts must not poison a shared circuit breaker
            url = self._endpoint_base(self._pool.pick()) + suffix
            return await self._request_once(
                method, url, data, prepared_headers, timeout
            )
        pool = self._pool
        hedge = self._hedge if (hedgeable and idempotent) else None

        async def _raw(endpoint, attempt_timeout, attempt_trace):
            # one attempt against a SPECIFIC endpoint; the pool
            # begin/finish bracket belongs to the caller
            url = self._endpoint_base(endpoint) + suffix
            if self._verbose:
                size = f" ({len(data)} bytes)" if data else ""
                print(f"{method} {url}{size}")
            try:
                result = await self._request_once(
                    method, url, data, prepared_headers, attempt_timeout,
                    trace=attempt_trace,
                )
            except InferenceServerException as e:
                if e.status() == CONNECTION_ERROR_STATUS:
                    # dead endpoint: bench it; with an alternative
                    # available the retry loop skips the backoff sleep
                    pool.observe(endpoint, token=CONNECTION_ERROR_STATUS)
                    if pool.has_alternative(endpoint):
                        e.retry_backoff_cap_s = 0.0
                raise
            token = str(result[0])
            if status_is_unavailable(token):
                # draining server: bench it for its own Retry-After hint
                pool.observe(
                    endpoint,
                    token=token,
                    retry_after_s=retry_after_seconds(result[2]),
                )
            else:
                pool.observe(endpoint, ok=True)
            return result

        if hedge is not None:

            async def _attempt(attempt_timeout):
                # two racing attempts would interleave send/wait spans on
                # one trace; the hedged pair records none (wrap_attempt
                # still records the enclosing "request" span)
                return await hedged_send_async(
                    pool,
                    hedge,
                    lambda budget, exclude: self._pick_endpoint(
                        budget, exclude=exclude, key=routing_key
                    ),
                    lambda endpoint, attempt_timeout: _raw(
                        endpoint, attempt_timeout, NOOP_TRACE
                    ),
                    attempt_timeout,
                    value_ok=self._result_ok,
                    value_token=lambda result: str(result[0]),
                )

        else:

            async def _attempt(attempt_timeout):
                endpoint = await self._pick_endpoint(
                    attempt_timeout, key=routing_key
                )
                started = pool.begin(endpoint)
                try:
                    result = await _raw(endpoint, attempt_timeout, trace)
                except asyncio.CancelledError:
                    # cancellation says nothing about the endpoint: close
                    # the bracket without booking an error
                    pool.finish(endpoint, started, ok=False, cancelled=True)
                    raise
                except InferenceServerException as e:
                    pool.finish(
                        endpoint, started, ok=False, token=e.status()
                    )
                    raise
                except BaseException:
                    # an unwrapped failure: close the bracket so the
                    # outstanding gauge never leaks
                    pool.finish(endpoint, started, ok=False)
                    raise
                ok = self._result_ok(result)
                pool.finish(
                    endpoint,
                    started,
                    ok=ok,
                    # a 4xx is an error but proves the endpoint healthy:
                    # the token keeps it out of consecutive-error ejection
                    token=None if ok else str(result[0]),
                )
                return result

        status, rbody, rheaders = await run_with_resilience_async(
            _attempt,
            retry_policy=self._retry_policy,
            circuit_breaker=self._circuit_breaker,
            budget_s=timeout or None,
            idempotent=idempotent,
            result_status=lambda value: str(value[0]),
            description=f"{method} {suffix.lstrip('/')}",
            # a 429 shed response's Retry-After is the server's own
            # backoff estimate — honored as the retry floor
            result_backoff_hint=lambda value: retry_after_seconds(value[2]),
            # ...unless the failure is endpoint-scoped (503/UNAVAILABLE)
            # and the pool has somewhere else to go: fail over NOW
            result_backoff_cap=lambda value: (
                0.0
                if status_is_unavailable(str(value[0]))
                and pool.has_alternative(None)
                else None
            ),
        )
        if self._verbose:
            print(f"-> {status} ({len(rbody)} bytes)")
        return status, rbody, rheaders

    async def _get(self, path, headers, query_params, probe=False) -> tuple:
        return await self._execute(
            "GET", path, None, headers, query_params, probe=probe
        )

    async def _post(
        self, path, body: bytes, headers, query_params, timeout=None,
        idempotent=True, trace=NOOP_TRACE, routing_key=None, hedgeable=True,
    ) -> tuple:
        return await self._execute(
            "POST",
            path,
            body,
            headers,
            query_params,
            timeout=timeout,
            idempotent=idempotent,
            trace=trace,
            routing_key=routing_key,
            hedgeable=hedgeable,
        )

    async def _get_json(self, path, headers, query_params) -> Dict[str, Any]:
        status, body, _ = await self._get(path, headers, query_params)
        return parse_json_response(status, body)

    async def _post_json(
        self,
        path,
        request: Optional[Dict[str, Any]],
        headers,
        query_params,
        idempotent: bool = True,
    ) -> Dict[str, Any]:
        body = json.dumps(request).encode("utf-8") if request is not None else b""
        status, rbody, _ = await self._post(
            path, body, headers, query_params, idempotent=idempotent
        )
        return parse_json_response(status, rbody)

    # -- health ------------------------------------------------------------

    async def is_server_live(self, headers=None, query_params=None) -> bool:
        status, _, _ = await self._get(
            "v2/health/live", headers, query_params, probe=True
        )
        return status == 200

    async def is_server_ready(self, headers=None, query_params=None) -> bool:
        status, _, _ = await self._get(
            "v2/health/ready", headers, query_params, probe=True
        )
        return status == 200

    async def is_model_ready(
        self, model_name, model_version="", headers=None, query_params=None
    ) -> bool:
        path = f"v2/models/{model_name}"
        if model_version:
            path += f"/versions/{model_version}"
        status, _, _ = await self._get(
            f"{path}/ready", headers, query_params, probe=True
        )
        return status == 200

    # -- metadata / config -------------------------------------------------

    async def get_server_metadata(self, headers=None, query_params=None):
        return await self._get_json("v2", headers, query_params)

    async def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        path = f"v2/models/{model_name}"
        if model_version:
            path += f"/versions/{model_version}"
        return await self._get_json(path, headers, query_params)

    async def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        path = f"v2/models/{model_name}"
        if model_version:
            path += f"/versions/{model_version}"
        return await self._get_json(f"{path}/config", headers, query_params)

    # -- repository control ------------------------------------------------

    async def get_model_repository_index(self, headers=None, query_params=None):
        return await self._post_json(
            "v2/repository/index", None, headers, query_params
        )

    async def load_model(
        self,
        model_name,
        headers=None,
        query_params=None,
        config: Optional[str] = None,
        files: Optional[Dict[str, bytes]] = None,
    ) -> None:
        """Load (or reload) a model, optionally overriding config/files.

        ``config`` is a JSON model-config string; ``files`` maps
        ``file:<relative-path>`` names to raw content (base64'd on the wire),
        matching the reference contract
        (reference src/python/library/tritonclient/http/_client.py:620-672).
        """
        load_request: Dict[str, Any] = {}
        if config is not None or files:
            params: Dict[str, Any] = {}
            if config is not None:
                params["config"] = config
            if files:
                import base64

                for name, content in files.items():
                    params[name] = base64.b64encode(content).decode("ascii")
            load_request["parameters"] = params
        await self._post_json(
            f"v2/repository/models/{model_name}/load",
            load_request,
            headers,
            query_params,
            idempotent=False,
        )

    async def unload_model(
        self,
        model_name,
        headers=None,
        query_params=None,
        unload_dependents: bool = False,
    ) -> None:
        request = {
            "parameters": {"unload_dependents": unload_dependents}
        }
        await self._post_json(
            f"v2/repository/models/{model_name}/unload",
            request,
            headers,
            query_params,
            idempotent=False,
        )

    # -- statistics / settings ----------------------------------------------

    async def get_inference_statistics(
        self, model_name="", model_version="", headers=None, query_params=None
    ):
        if model_name:
            path = f"v2/models/{model_name}"
            if model_version:
                path += f"/versions/{model_version}"
            path += "/stats"
        else:
            path = "v2/models/stats"
        return await self._get_json(path, headers, query_params)

    async def update_trace_settings(
        self, model_name=None, settings=None, headers=None, query_params=None
    ):
        path = (
            f"v2/models/{model_name}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        return await self._post_json(
            path, settings or {}, headers, query_params
        )

    async def get_trace_settings(
        self, model_name=None, headers=None, query_params=None
    ):
        path = (
            f"v2/models/{model_name}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        return await self._get_json(path, headers, query_params)

    async def update_log_settings(
        self, settings, headers=None, query_params=None
    ):
        return await self._post_json("v2/logging", settings, headers, query_params)

    async def get_log_settings(self, headers=None, query_params=None):
        return await self._get_json("v2/logging", headers, query_params)

    # -- shared memory ------------------------------------------------------

    async def get_system_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        path = "v2/systemsharedmemory"
        if region_name:
            path += f"/region/{region_name}"
        return await self._get_json(f"{path}/status", headers, query_params)

    async def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, query_params=None
    ) -> None:
        request = {"key": key, "offset": offset, "byte_size": byte_size}
        await self._post_json(
            f"v2/systemsharedmemory/region/{name}/register",
            request,
            headers,
            query_params,
            idempotent=False,
        )

    async def unregister_system_shared_memory(
        self, name="", headers=None, query_params=None
    ) -> None:
        path = "v2/systemsharedmemory"
        if name:
            path += f"/region/{name}"
        await self._post_json(
            f"{path}/unregister", None, headers, query_params,
            idempotent=False,
        )

    async def get_cuda_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        path = "v2/cudasharedmemory"
        if region_name:
            path += f"/region/{region_name}"
        return await self._get_json(f"{path}/status", headers, query_params)

    async def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, query_params=None
    ) -> None:
        """Register a CUDA-IPC region (only meaningful against GPU servers)."""
        import base64

        request = {
            "raw_handle": {
                "b64": base64.b64encode(raw_handle).decode("ascii")
            },
            "device_id": device_id,
            "byte_size": byte_size,
        }
        await self._post_json(
            f"v2/cudasharedmemory/region/{name}/register",
            request,
            headers,
            query_params,
            idempotent=False,
        )

    async def unregister_cuda_shared_memory(
        self, name="", headers=None, query_params=None
    ) -> None:
        path = "v2/cudasharedmemory"
        if name:
            path += f"/region/{name}"
        await self._post_json(
            f"{path}/unregister", None, headers, query_params,
            idempotent=False,
        )

    async def get_tpu_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        path = "v2/tpusharedmemory"
        if region_name:
            path += f"/region/{region_name}"
        return await self._get_json(f"{path}/status", headers, query_params)

    async def register_tpu_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, query_params=None
    ) -> None:
        """Register a TPU shared-memory region (client_tpu extension).

        ``raw_handle`` comes from
        :func:`client_tpu_torch.utils.tpu_shared_memory.get_raw_handle`.
        """
        import base64

        request = {
            "raw_handle": {
                "b64": base64.b64encode(raw_handle).decode("ascii")
            },
            "device_id": device_id,
            "byte_size": byte_size,
        }
        await self._post_json(
            f"v2/tpusharedmemory/region/{name}/register",
            request,
            headers,
            query_params,
            idempotent=False,
        )

    async def unregister_tpu_shared_memory(
        self, name="", headers=None, query_params=None
    ) -> None:
        path = "v2/tpusharedmemory"
        if name:
            path += f"/region/{name}"
        await self._post_json(
            f"{path}/unregister", None, headers, query_params,
            idempotent=False,
        )

    # -- inference ----------------------------------------------------------

    @staticmethod
    def generate_request_body(
        inputs,
        request_id="",
        outputs=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout=None,
        parameters=None,
    ):
        """Build an inference request body offline.

        Returns ``(body, json_size)`` — json_size is None for pure-JSON
        bodies (reference http/_client.py:1219-1300 static twin).
        """
        return get_inference_request_body(
            inputs,
            request_id=request_id,
            outputs=outputs,
            sequence_id=sequence_id,
            sequence_start=sequence_start,
            sequence_end=sequence_end,
            priority=priority,
            timeout=timeout,
            parameters=parameters,
        )

    @staticmethod
    def parse_response_body(response_body, header_length=None):
        """Parse a raw response body built by :meth:`generate_request_body`'s
        round trip (reference http/_client.py:1304-1330 static twin)."""
        return InferResult(response_body, header_length)

    async def infer_with_body(
        self,
        model_name: str,
        body: bytes,
        json_size: Optional[int],
        model_version: str = "",
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
        client_timeout: Optional[float] = None,
        idempotent: bool = True,
        routing_key=None,
    ) -> InferResult:
        """Send a body built by :meth:`generate_request_body` (reusable —
        deterministic request bodies can be built once and resent; the
        reference's static GenerateRequestBody serves the same offline
        role, reference http_client.cc:1286-1351).

        Pass ``idempotent=False`` when the prepared body carries sequence
        state so a configured retry policy never auto-retries it; as a
        safety net, bodies whose JSON header names a ``sequence_id`` are
        detected and demoted to non-idempotent automatically. The same
        header scan keeps shared-memory bodies out of request hedging
        (single-writer buffers must not race a duplicate).
        ``routing_key`` feeds consistent-hash affinity (prepared bodies
        are opaque here, so the key is the caller's to supply)."""
        if idempotent and self._retry_policy is not None:
            header = body[:json_size] if json_size is not None else body
            if b'"sequence_id"' in header:
                idempotent = False
        hedgeable = True
        if self._hedge is not None:
            header = body[:json_size] if json_size is not None else body
            hedgeable = (
                b"shared_memory_region" not in header
                and b"shm_ring_region" not in header
            )
        extra_headers = dict(headers) if headers else {}
        if json_size is not None:
            extra_headers[HEADER_CONTENT_LENGTH] = str(json_size)
        trace = start_trace(
            self._tracer, "infer", surface="http", model=model_name
        )
        if trace.traceparent:
            extra_headers[TRACEPARENT_HEADER] = trace.traceparent
        try:
            status, rbody, rheaders = await self._post(
                model_infer_uri(model_name, model_version),
                body,
                extra_headers,
                query_params,
                timeout=client_timeout,
                idempotent=idempotent,
                trace=trace,
                routing_key=routing_key,
                hedgeable=hedgeable,
            )
            with trace.stage("deserialize"):
                raise_if_error(status, rbody)
                result = InferResult.from_response(rbody, rheaders)
        except BaseException as e:
            trace.finish(error=e)
            raise
        trace.finish()
        return result

    async def infer(
        self,
        model_name: str,
        inputs: Sequence[InferInput],
        model_version: str = "",
        outputs: Optional[Sequence[InferRequestedOutput]] = None,
        request_id: str = "",
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout: Optional[int] = None,
        client_timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
        query_params: Optional[Dict[str, Any]] = None,
        request_compression_algorithm: Optional[str] = None,
        response_compression_algorithm: Optional[str] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ) -> InferResult:
        """Run a synchronous (from the caller's view: awaited) inference.

        ``priority`` and ``timeout`` match the gRPC client surface
        (``client_tpu_torch.grpc.InferenceServerClient.infer``): both travel as
        KServe request *parameters* — ``priority`` picks the server-side
        scheduler queue level (1 = highest) and ``timeout`` is the queue
        timeout in MICROSECONDS the server may enforce before execution.
        ``client_timeout`` (seconds) is this client's own transport
        budget across attempts — the two deadlines are independent."""
        if timeout is not None and not isinstance(timeout, int):
            # fail LOUDLY: this kwarg used to be a seconds-float transport
            # budget; a silently truncated float would reach the server as
            # a microsecond queue deadline and shed every request
            raise InferenceServerException(
                "infer(timeout=...) is the server queue timeout in "
                "MICROSECONDS (int), matching the gRPC client; use "
                "client_timeout= (seconds) for the transport budget"
            )
        trace = start_trace(
            self._tracer, "infer", surface="http", model=model_name
        )
        try:
            with trace.stage("serialize"):
                body, json_size = get_inference_request_body(
                    inputs,
                    request_id=request_id,
                    outputs=outputs,
                    sequence_id=sequence_id,
                    sequence_start=sequence_start,
                    sequence_end=sequence_end,
                    priority=priority,
                    timeout=int(timeout) if timeout else None,
                    parameters=parameters,
                )
                extra_headers = dict(headers) if headers else {}
                body, encoding = compress_body(
                    body, request_compression_algorithm
                )
                if encoding:
                    extra_headers["Content-Encoding"] = encoding
                if response_compression_algorithm:
                    extra_headers["Accept-Encoding"] = (
                        response_compression_algorithm
                    )
                if json_size is not None:
                    extra_headers[HEADER_CONTENT_LENGTH] = str(json_size)
            if trace.traceparent:
                extra_headers[TRACEPARENT_HEADER] = trace.traceparent

            routing_key = None
            key_param = self._pool.key_parameter
            if key_param is not None and parameters:
                routing_key = parameters.get(key_param)
            hedgeable = True
            if self._hedge is not None:
                # shm-ring tickets (and any shared-memory region ref) are
                # single-writer buffers: a hedged duplicate would race
                hedgeable = not (
                    (parameters and "shm_ring_region" in parameters)
                    or any(
                        inp._parameters.get("shared_memory_region")
                        for inp in inputs
                    )
                    or any(
                        out._parameters.get("shared_memory_region")
                        for out in (outputs or ())
                    )
                )
            status, rbody, rheaders = await self._post(
                model_infer_uri(model_name, model_version),
                body,
                extra_headers,
                query_params,
                timeout=client_timeout,
                idempotent=sequence_is_idempotent(sequence_id),
                trace=trace,
                routing_key=routing_key,
                hedgeable=hedgeable,
            )
            with trace.stage("deserialize"):
                raise_if_error(status, rbody)
                result = InferResult.from_response(rbody, rheaders)
        except BaseException as e:
            trace.finish(error=e)
            raise
        trace.finish()
        return result
