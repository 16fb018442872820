"""Client-backend abstraction for the port's perf harness.

The port's own copy of ``client_tpu/perf/backend.py`` (the Python twin of
the reference's ClientBackend layer, reference
src/c++/perf_analyzer/client_backend/client_backend.h:266-650): one async
interface, a backend over the port's HTTP client
(:mod:`client_tpu_torch.http.aio`), an in-process backend calling a
:class:`~client_tpu_torch.server.core.ServerCore` directly (measures
client-overhead-free server performance), a mock backend with injectable
latency and errors, the REST backends — OpenAI (SSE streams read
event by event), TensorFlow-Serving and TorchServe — over stdlib asyncio
streams (the reference's run on aiohttp, which the port does not use), and
the gRPC backend over the port's gRPC client
(:mod:`client_tpu_torch.grpc.aio`, on its own h2c transport).
"""

import asyncio
import base64
import contextlib
import json
from typing import Any, Callable, Dict, List, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from client_tpu_torch.http.aio import _request_head
from client_tpu_torch.resilience import sequence_is_idempotent
from client_tpu_torch.utils import TF_TO_KSERVE_DTYPE, InferenceServerException


class PerfInferInput:
    """Backend-independent input tensor description.

    When ``shm_region`` is set the request carries only the region
    reference (the shared-memory data plane); ``data`` is then the staged
    content for bookkeeping, not serialized onto the wire.
    """

    def __init__(
        self,
        name: str,
        shape: Sequence[int],
        datatype: str,
        data: np.ndarray,
        shm_region: Optional[str] = None,
        shm_byte_size: int = 0,
        shm_offset: int = 0,
    ):
        self.name = name
        self.shape = list(shape)
        self.datatype = datatype
        self.data = data
        self.shm_region = shm_region
        self.shm_byte_size = shm_byte_size
        self.shm_offset = shm_offset


class PerfBackend:
    """Async backend interface."""

    kind = "abstract"
    supports_streaming = False

    async def connect(self) -> None:
        pass

    async def close(self) -> None:
        pass

    def endpoint_snapshot(self) -> Optional[Dict]:
        """Per-endpoint pool telemetry (outstanding/EWMA/errors per
        endpoint), for backends whose client routes through an
        :class:`~client_tpu_torch.lifecycle.EndpointPool`; None otherwise."""
        return None

    async def get_model_metadata(self, model_name: str, model_version: str = "") -> Dict:
        raise NotImplementedError

    async def get_model_config(self, model_name: str, model_version: str = "") -> Dict:
        raise NotImplementedError

    # Backends that can reuse a prepared wire request for deterministic
    # corpus coordinates set this True and accept a ``cache_token`` kwarg
    # on infer() (the load manager probes the flag before passing one —
    # the C++ twin is BackendContext::HasPrepared/SetNextCacheToken).
    supports_prepared = False

    def has_prepared(self, cache_token) -> bool:
        """True when infer(cache_token=...) will reuse a stored wire
        request — the caller may then skip input preparation entirely."""
        return False

    async def infer(
        self,
        model_name: str,
        inputs: Sequence[PerfInferInput],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
        priority: int = 0,
        timeout_us: Optional[int] = None,
    ) -> None:
        """One request -> one response (payload discarded; timing is the
        caller's job). ``priority``/``timeout_us`` are the server-side
        scheduling parameters (overload mode); backends without a way to
        express them ignore them."""
        raise NotImplementedError

    async def stream_infer(
        self,
        model_name: str,
        inputs: Sequence[PerfInferInput],
        on_response: Callable[[], None],
        model_version: str = "",
        request_id: str = "",
        parameters: Optional[Dict[str, Any]] = None,
        sequence_id: int = 0,
        sequence_start: bool = False,
        sequence_end: bool = False,
    ) -> None:
        """One request -> many responses; ``on_response()`` fires per
        response; returns when the final response arrives."""
        raise NotImplementedError

    async def get_inference_statistics(self, model_name: str = "") -> Dict:
        return {}

    # -- repository control --------------------------------------------------

    async def unload_model(self, model_name: str) -> None:
        raise InferenceServerException(
            f"model repository control not supported by the "
            f"'{self.kind}' backend"
        )

    async def load_model(self, model_name: str) -> None:
        raise InferenceServerException(
            f"model repository control not supported by the "
            f"'{self.kind}' backend"
        )

    # -- shared-memory data plane (reference client_backend.h:433-485) ------

    async def register_system_shared_memory(
        self, name: str, key: str, byte_size: int
    ) -> None:
        raise InferenceServerException(
            f"shared memory not supported by the '{self.kind}' backend"
        )

    async def unregister_system_shared_memory(self, name: str = "") -> None:
        raise InferenceServerException(
            f"shared memory not supported by the '{self.kind}' backend"
        )

    async def register_tpu_shared_memory(
        self, name: str, raw_handle: bytes, device_id: int, byte_size: int
    ) -> None:
        raise InferenceServerException(
            f"TPU shared memory not supported by the '{self.kind}' backend"
        )

    async def unregister_tpu_shared_memory(self, name: str = "") -> None:
        raise InferenceServerException(
            f"TPU shared memory not supported by the '{self.kind}' backend"
        )


def _build_client_input(mod, t: PerfInferInput):
    """PerfInferInput -> client InferInput: shm reference or inline data."""
    x = mod.InferInput(t.name, t.shape, t.datatype)
    if t.shm_region is not None:
        x.set_shared_memory(t.shm_region, t.shm_byte_size, t.shm_offset)
    else:
        x.set_data_from_numpy(t.data)
    return x


# ---------------------------------------------------------------------------


class _PreparedRequestCacheMixin:
    """Prepared-request reuse: corpus token -> built wire request,
    size-capped like the C++ twin so huge corpora fall back to per-send
    builds instead of doubling their memory. Cache misses build with an
    EMPTY wire id (a baked per-send id would repeat on every resend)."""

    supports_prepared = True
    _PREPARED_CAP_BYTES = 64 << 20

    def _init_prepared(self):
        self._prepared: Dict[Any, Any] = {}
        self._prepared_bytes = 0

    def has_prepared(self, cache_token) -> bool:
        return cache_token in self._prepared

    def _get_or_build_prepared(self, cache_token, build, weigh):
        """Cached value for the token, building (and cap-accounting via
        ``weigh(value)``) on a miss. asyncio single-thread: no await
        between probe and store, so no duplicate-build race."""
        value = self._prepared.get(cache_token)
        if value is None:
            value = build()
            if self._prepared_bytes < self._PREPARED_CAP_BYTES:
                self._prepared_bytes += weigh(value)
                self._prepared[cache_token] = value
        return value


class HttpPerfBackend(_PreparedRequestCacheMixin, PerfBackend):
    kind = "http"

    def __init__(
        self,
        url: str,
        concurrency: int = 128,
        retry_policy=None,
        circuit_breaker=None,
        tracer=None,
        logger=None,
        routing_policy=None,
        hedge_policy=None,
    ):
        from client_tpu_torch.http import aio as httpclient

        self._mod = httpclient
        self._client = httpclient.InferenceServerClient(
            url,
            concurrency=concurrency,
            retry_policy=retry_policy,
            circuit_breaker=circuit_breaker,
            tracer=tracer,
            logger=logger,
            routing_policy=routing_policy,
            hedge_policy=hedge_policy,
        )
        self._init_prepared()

    async def close(self) -> None:
        await self._client.close()

    def endpoint_snapshot(self) -> Optional[Dict]:
        return self._client.endpoint_snapshot()

    async def get_model_metadata(self, model_name, model_version=""):
        return await self._client.get_model_metadata(model_name, model_version)

    async def get_model_config(self, model_name, model_version=""):
        return await self._client.get_model_config(model_name, model_version)

    async def get_inference_statistics(self, model_name=""):
        return await self._client.get_inference_statistics(model_name)

    async def unload_model(self, model_name):
        await self._client.unload_model(model_name)

    async def load_model(self, model_name):
        await self._client.load_model(model_name)

    def _build_inputs(self, inputs):
        return [_build_client_input(self._mod, t) for t in inputs]

    async def register_system_shared_memory(self, name, key, byte_size):
        await self._client.register_system_shared_memory(name, key, byte_size)

    async def unregister_system_shared_memory(self, name=""):
        await self._client.unregister_system_shared_memory(name)

    async def register_tpu_shared_memory(
        self, name, raw_handle, device_id, byte_size
    ):
        await self._client.register_tpu_shared_memory(
            name, raw_handle, device_id, byte_size
        )

    async def unregister_tpu_shared_memory(self, name=""):
        await self._client.unregister_tpu_shared_memory(name)

    async def infer(
        self,
        model_name,
        inputs,
        model_version="",
        request_id="",
        parameters=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout_us=None,
        cache_token=None,
    ):
        if cache_token is not None:
            body, json_size = self._get_or_build_prepared(
                cache_token,
                lambda: self._client.generate_request_body(
                    self._build_inputs(inputs),
                    parameters=parameters,
                    sequence_id=sequence_id,
                    sequence_start=sequence_start,
                    sequence_end=sequence_end,
                    priority=priority,
                    timeout=timeout_us,
                ),
                lambda prepared: len(prepared[0]),
            )
            await self._client.infer_with_body(
                model_name,
                body,
                json_size,
                model_version=model_version,
                # the prepared body may carry sequence state: keep the
                # never-auto-retry-sequences guarantee on this path too
                idempotent=sequence_is_idempotent(sequence_id),
            )
            return
        await self._client.infer(
            model_name,
            self._build_inputs(inputs),
            model_version=model_version,
            request_id=request_id,
            parameters=parameters,
            sequence_id=sequence_id,
            sequence_start=sequence_start,
            sequence_end=sequence_end,
            priority=priority,
            timeout=timeout_us,
        )


class GrpcPerfBackend(_PreparedRequestCacheMixin, PerfBackend):
    """The harness over the port's gRPC client
    (:mod:`client_tpu_torch.grpc.aio`). ``stream_mode`` sends every unary
    infer over one multiplexed ``ModelStreamInfer`` stream."""

    kind = "grpc"
    supports_streaming = True

    def __init__(
        self,
        url: str,
        retry_policy=None,
        circuit_breaker=None,
        tracer=None,
        logger=None,
        stream_mode: bool = False,
        routing_policy=None,
        hedge_policy=None,
        root_certificates=None,
    ):
        from client_tpu_torch.grpc import aio as grpcclient

        self._mod = grpcclient
        self._stream_mode = stream_mode
        self._client = grpcclient.InferenceServerClient(
            url,
            ssl=root_certificates is not None,
            root_certificates=root_certificates,
            retry_policy=retry_policy,
            circuit_breaker=circuit_breaker,
            tracer=tracer,
            logger=logger,
            stream_mode=stream_mode,
            routing_policy=routing_policy,
            hedge_policy=hedge_policy,
        )
        self._init_prepared()

    async def close(self) -> None:
        await self._client.close()

    def endpoint_snapshot(self) -> Optional[Dict]:
        return self._client.endpoint_snapshot()

    async def get_model_metadata(self, model_name, model_version=""):
        return await self._client.get_model_metadata(
            model_name, model_version, as_json=True
        )

    async def get_model_config(self, model_name, model_version=""):
        config = await self._client.get_model_config(
            model_name, model_version, as_json=True
        )
        return config.get("config", config)

    async def get_inference_statistics(self, model_name=""):
        return await self._client.get_inference_statistics(
            model_name, as_json=True
        )

    async def unload_model(self, model_name):
        await self._client.unload_model(model_name)

    async def load_model(self, model_name):
        await self._client.load_model(model_name)

    def _build_inputs(self, inputs):
        return [_build_client_input(self._mod, t) for t in inputs]

    async def register_system_shared_memory(self, name, key, byte_size):
        await self._client.register_system_shared_memory(name, key, byte_size)

    async def unregister_system_shared_memory(self, name=""):
        await self._client.unregister_system_shared_memory(name)

    async def register_tpu_shared_memory(
        self, name, raw_handle, device_id, byte_size
    ):
        await self._client.register_tpu_shared_memory(
            name, raw_handle, device_id, byte_size
        )

    async def unregister_tpu_shared_memory(self, name=""):
        await self._client.unregister_tpu_shared_memory(name)

    async def infer(
        self,
        model_name,
        inputs,
        model_version="",
        request_id="",
        parameters=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout_us=None,
        cache_token=None,
    ):
        if cache_token is not None and not self._stream_mode:
            # stream mode skips the prepared-proto cache: the mux's
            # protobuf-free builder memoizes templates itself, and a
            # shared prepared proto would race the per-send correlation id
            request = self._get_or_build_prepared(
                cache_token,
                lambda: self._client.prepare_request(
                    model_name,
                    self._build_inputs(inputs),
                    model_version=model_version,
                    parameters=parameters,
                    sequence_id=sequence_id,
                    sequence_start=sequence_start,
                    sequence_end=sequence_end,
                    priority=priority,
                    timeout=timeout_us,
                ),
                lambda request: request.ByteSize(),
            )
            await self._client.infer_prepared(request)
            return
        await self._client.infer(
            model_name,
            self._build_inputs(inputs),
            model_version=model_version,
            request_id=request_id,
            parameters=parameters,
            sequence_id=sequence_id,
            sequence_start=sequence_start,
            sequence_end=sequence_end,
            priority=priority,
            timeout=timeout_us,
        )

    async def stream_infer(
        self,
        model_name,
        inputs,
        on_response,
        model_version="",
        request_id="",
        parameters=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
    ):
        built = self._build_inputs(inputs)

        async def requests():
            yield {
                "model_name": model_name,
                "inputs": built,
                "model_version": model_version,
                "request_id": request_id,
                "parameters": parameters,
                "sequence_id": sequence_id,
                "sequence_start": sequence_start,
                "sequence_end": sequence_end,
            }

        iterator = self._client.stream_infer(requests())
        async for result, error in iterator:
            if error is not None:
                raise error
            on_response()
            params = result.get_response().parameters
            if (
                "triton_final_response" in params
                and params["triton_final_response"].bool_param
            ):
                break


class LocalPerfBackend(PerfBackend):
    """In-process backend over a ServerCore (triton_c_api analogue).

    Its calls must run on the event loop the core serves on."""

    kind = "local"
    supports_streaming = True

    def __init__(self, core):
        from client_tpu_torch.server.core import CoreRequest, CoreTensor

        self._core = core
        self._CoreRequest = CoreRequest
        self._CoreTensor = CoreTensor

    def _build_request(
        self,
        model_name,
        inputs,
        model_version,
        request_id,
        parameters,
        priority=0,
        timeout_us=None,
    ):

        params = dict(parameters or {})
        # scheduling parameters ride the same wire slot the remote
        # front-ends decode them from
        if priority:
            params["priority"] = priority
        if timeout_us:
            params["timeout"] = timeout_us
        request = self._CoreRequest(
            model_name=model_name,
            model_version=model_version,
            id=request_id,
            parameters=params,
        )
        for t in inputs:
            request.inputs.append(
                self._CoreTensor(
                    name=t.name,
                    datatype=t.datatype,
                    shape=t.shape,
                    data=t.data,
                )
            )
        return request

    async def get_model_metadata(self, model_name, model_version=""):
        return self._core.repository.get(model_name, model_version).metadata()

    async def get_model_config(self, model_name, model_version=""):
        return self._core.repository.get(model_name, model_version).config()

    async def get_inference_statistics(self, model_name=""):
        return self._core.statistics(model_name)

    async def unload_model(self, model_name):
        # drain-aware: through the core, not the bare repository
        self._core.unload_model(model_name)

    async def load_model(self, model_name):
        self._core.load_model(model_name)

    async def infer(
        self,
        model_name,
        inputs,
        model_version="",
        request_id="",
        parameters=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout_us=None,
    ):
        await self._core.infer(
            self._build_request(
                model_name,
                inputs,
                model_version,
                request_id,
                parameters,
                priority=priority,
                timeout_us=timeout_us,
            )
        )

    async def stream_infer(
        self,
        model_name,
        inputs,
        on_response,
        model_version="",
        request_id="",
        parameters=None,
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
    ):
        async for _ in self._core.infer_decoupled(
            self._build_request(
                model_name, inputs, model_version, request_id, parameters
            )
        ):
            on_response()


class MockPerfBackend(PerfBackend):
    """Injectable-latency/error backend for hermetic harness tests
    (reference mock_client_backend.h:289-318 role)."""

    kind = "mock"
    supports_streaming = True

    def __init__(
        self,
        latency_s: float = 0.001,
        responses_per_request: int = 1,
        error_every: int = 0,
        metadata: Optional[Dict] = None,
    ):
        self.latency_s = latency_s
        self.responses_per_request = responses_per_request
        self.error_every = error_every
        self.request_count = 0
        self.inflight = 0
        self.max_inflight = 0
        # per-request kwargs as issued, for assertions
        self.requests: List[Dict[str, Any]] = []
        # shared-memory registration accounting (for data-plane tests)
        self.shm_registrations: List[Dict[str, Any]] = []
        self.shm_unregistrations: List[str] = []
        self._metadata = metadata or {
            "name": "mock",
            "versions": ["1"],
            "platform": "mock",
            "inputs": [{"name": "IN", "datatype": "FP32", "shape": [8]}],
            "outputs": [{"name": "OUT", "datatype": "FP32", "shape": [8]}],
        }

    async def get_model_metadata(self, model_name, model_version=""):
        return dict(self._metadata, name=model_name)

    async def unload_model(self, model_name):
        self.unload_count = getattr(self, "unload_count", 0) + 1

    async def load_model(self, model_name):
        self.load_count = getattr(self, "load_count", 0) + 1

    async def get_model_config(self, model_name, model_version=""):
        return {
            "name": model_name,
            "platform": "mock",
            "backend": "mock",
            "max_batch_size": 8,
            "input": [],
            "output": [],
            "model_transaction_policy": {
                "decoupled": self.responses_per_request != 1
            },
        }

    async def infer(self, model_name, inputs, **kwargs):
        self.request_count += 1
        self.requests.append(dict(kwargs, model_name=model_name))
        n = self.request_count
        self.inflight += 1
        self.max_inflight = max(self.max_inflight, self.inflight)
        try:
            await asyncio.sleep(self.latency_s)
            if self.error_every and n % self.error_every == 0:
                raise InferenceServerException("mock injected failure")
        finally:
            self.inflight -= 1

    async def stream_infer(
        self, model_name, inputs, on_response, **kwargs
    ):
        self.request_count += 1
        self.requests.append(dict(kwargs, model_name=model_name))
        for _ in range(self.responses_per_request):
            await asyncio.sleep(self.latency_s / self.responses_per_request)
            on_response()

    async def register_system_shared_memory(self, name, key, byte_size):
        self.shm_registrations.append(
            {"kind": "system", "name": name, "key": key, "byte_size": byte_size}
        )

    async def unregister_system_shared_memory(self, name=""):
        self.shm_unregistrations.append(name)

    async def register_tpu_shared_memory(
        self, name, raw_handle, device_id, byte_size
    ):
        self.shm_registrations.append(
            {
                "kind": "tpu",
                "name": name,
                "raw_handle": raw_handle,
                "device_id": device_id,
                "byte_size": byte_size,
            }
        )

    async def unregister_tpu_shared_memory(self, name=""):
        self.shm_unregistrations.append(name)


# ---------------------------------------------------------------------------
# REST transport for the OpenAI backend (stdlib asyncio in place of the
# reference's aiohttp session)
# ---------------------------------------------------------------------------


class _BadResponse(Exception):
    """A response whose framing is malformed or that ends early."""


class _RestResponse:
    """One HTTP/1.1 response: the status and headers, and the body read
    piece by piece as it arrives (``Content-Length``, chunked, or ended
    by the server closing the connection)."""

    def __init__(self, head: bytes, reader: asyncio.StreamReader):
        lines = head.decode("latin-1").split("\r\n")
        version, _, rest = lines[0].partition(" ")
        if not rest[:3].isdigit():
            raise _BadResponse(f"bad status line {lines[0][:60]!r}")
        self.status = int(rest[:3])
        self.headers: Dict[str, str] = {}
        for line in lines[1:]:
            if line:
                name, _, value = line.partition(":")
                self.headers[name.strip().lower()] = value.strip()
        connection = self.headers.get("connection", "").lower()
        self.keep_alive = connection != "close" and (
            version == "HTTP/1.1" or connection == "keep-alive"
        )
        self.done = False  # set once the whole body has been read
        self._reader = reader

    async def iter_any(self):
        """The body's bytes, yielded as soon as each piece is read."""
        reader = self._reader
        if "chunked" in self.headers.get("transfer-encoding", "").lower():
            while True:
                line = await reader.readuntil(b"\r\n")
                size_text = line[:-2].split(b";", 1)[0].strip()
                if not size_text or size_text.strip(b"0123456789abcdefABCDEF"):
                    raise _BadResponse(f"bad chunk size line {line[:40]!r}")
                remaining = int(size_text, 16)
                if remaining == 0:
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailer fields
                    break
                while remaining:
                    piece = await reader.read(min(remaining, 1 << 16))
                    if not piece:
                        raise _BadResponse("chunked body ends early")
                    remaining -= len(piece)
                    yield piece
                if await reader.readexactly(2) != b"\r\n":
                    raise _BadResponse("chunk data not followed by CRLF")
        elif "content-length" in self.headers:
            remaining = int(self.headers["content-length"])
            while remaining:
                piece = await reader.read(min(remaining, 1 << 16))
                if not piece:
                    raise _BadResponse("body ends before its Content-Length")
                remaining -= len(piece)
                yield piece
        else:  # delimited by the end of the connection
            self.keep_alive = False
            while True:
                piece = await reader.read(1 << 16)
                if not piece:
                    break
                yield piece
        self.done = True

    async def read(self) -> bytes:
        return b"".join([piece async for piece in self.iter_any()])


class _RestSessionMixin:
    """Keep-alive HTTP/1.1 connections for REST backends, idle ones kept
    per (host, port) and no cap on how many are open (a capped pool would
    queue client-side and corrupt latency). A connection is reused only
    after its whole response was read; close() drops the idle ones, so a
    reused backend reopens cleanly.

    ``_rest()`` is the request path: it maps transport-level failures
    (connection refused, reset, a malformed or cut response) to
    InferenceServerException so callers — the CLI's connect handler in
    particular — see one error type for both protocol and transport
    problems."""

    _idle: Optional[Dict[tuple, list]] = None

    async def _connection(self, address):
        if self._idle is None:
            self._idle = {}
        idle = self._idle.get(address)
        while idle:
            reader, writer = idle.pop()
            if not (reader.at_eof() or writer.is_closing()):
                return reader, writer
            writer.close()
        return await asyncio.open_connection(*address)

    @contextlib.asynccontextmanager
    async def _rest(self, method: str, url: str, data: bytes = b"",
                    headers: Optional[Dict[str, str]] = None):
        parts = urlsplit(url)
        address = (parts.hostname, parts.port or 80)
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        writer = None
        response = None
        try:
            head = _request_head(method, target or "/", parts.netloc,
                                 headers or {}, data)
            reader, writer = await self._connection(address)
            writer.write(head + data)
            await writer.drain()
            response = _RestResponse(await reader.readuntil(b"\r\n\r\n"), reader)
            yield response
        except (OSError, asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                _BadResponse) as e:
            raise InferenceServerException(
                f"{method} {url} failed: {e!r}"
            ) from e
        finally:
            if writer is not None:
                if response is not None and response.done and response.keep_alive:
                    self._idle.setdefault(address, []).append((reader, writer))
                else:
                    writer.close()

    async def close(self) -> None:
        writers = [w for conns in (self._idle or {}).values() for _, w in conns]
        self._idle = None
        for writer in writers:
            writer.close()
        await asyncio.gather(*(w.wait_closed() for w in writers),
                             return_exceptions=True)


class OpenAiPerfBackend(_RestSessionMixin, PerfBackend):
    """OpenAI-compatible endpoint backend with SSE streaming (role of the
    reference openai client backend, client_backend/openai/openai_client.h).

    Requests come from a BYTES input named ``payload`` whose element is the
    JSON request body (the genai-perf openai-* input formats). A stream
    is timed event by event as its bytes arrive; one that ends without
    ``data: [DONE]`` was cut short and fails the request."""

    kind = "openai"
    supports_streaming = True

    def __init__(self, url: str, endpoint: str = "v1/chat/completions"):
        self._base = f"http://{url}/{endpoint.lstrip('/')}"
        # payload -> stream-enabled payload (corpora are small and cycled,
        # so the upgrade parse runs once per distinct payload).
        self._stream_payloads: Dict[str, str] = {}

    async def get_model_metadata(self, model_name, model_version=""):
        # No KServe metadata on OpenAI endpoints; fabricate the payload
        # contract (reference model_parser InitOpenAI).
        return {
            "name": model_name,
            "platform": "openai",
            "inputs": [
                {"name": "payload", "datatype": "BYTES", "shape": [1]}
            ],
            "outputs": [],
        }

    async def get_model_config(self, model_name, model_version=""):
        return {
            "name": model_name,
            "max_batch_size": 0,
            "model_transaction_policy": {"decoupled": True},
        }

    @staticmethod
    def _payload(inputs) -> str:
        for t in inputs:
            if t.name == "payload":
                element = np.asarray(t.data, dtype=object).reshape(-1)[0]
                if isinstance(element, bytes):
                    return element.decode("utf-8")
                return str(element)
        raise InferenceServerException(
            "openai backend needs a BYTES input named 'payload'"
        )

    async def infer(self, model_name, inputs, **kwargs):
        async with self._rest(
            "POST",
            self._base,
            data=self._payload(inputs).encode(),
            headers={"Content-Type": "application/json"},
        ) as resp:
            body = await resp.read()
            if resp.status != 200:
                raise InferenceServerException(
                    f"openai endpoint HTTP {resp.status}: {body[:200]!r}"
                )

    @staticmethod
    def sse_event_is_token(data: bytes) -> bool:
        """True if an SSE data event carries generated content. Empty-delta
        finish chunks must not count as tokens, and in-band errors raise —
        otherwise token counts/ITL would be silently wrong."""
        try:
            doc = json.loads(data)
        except ValueError:
            return True  # unknown shape: count rather than drop
        if "error" in doc:
            message = doc["error"]
            if isinstance(message, dict):
                message = message.get("message", str(message))
            raise InferenceServerException(f"openai stream error: {message}")
        for choice in doc.get("choices", []):
            delta = choice.get("delta", {})
            if delta.get("content"):
                return True
            if choice.get("text"):
                return True
        return False

    async def stream_infer(self, model_name, inputs, on_response, **kwargs):
        payload = self._payload(inputs)
        upgraded = self._stream_payloads.get(payload)
        if upgraded is None:
            doc = json.loads(payload)
            upgraded = payload if doc.get("stream") else json.dumps(
                {**doc, "stream": True}
            )
            self._stream_payloads[payload] = upgraded
        payload = upgraded
        finished = False
        async with self._rest(
            "POST",
            self._base,
            data=payload.encode(),
            headers={"Content-Type": "application/json"},
        ) as resp:
            if resp.status != 200:
                body = await resp.read()
                raise InferenceServerException(
                    f"openai endpoint HTTP {resp.status}: {body[:200]!r}"
                )
            buf = b""
            async for chunk in resp.iter_any():
                buf += chunk
                while True:
                    for sep in (b"\n\n", b"\r\n\r\n"):
                        pos = buf.find(sep)
                        if pos >= 0:
                            event, buf = buf[:pos], buf[pos + len(sep):]
                            break
                    else:
                        break
                    if not event.startswith(b"data:"):
                        continue
                    data = event[5:].strip()
                    if data == b"[DONE]":
                        finished = True
                    elif self.sse_event_is_token(data):
                        on_response()
        if not finished:
            raise InferenceServerException(
                "openai stream ended without 'data: [DONE]'"
            )


class TfsPerfBackend(_PreparedRequestCacheMixin, _RestSessionMixin, PerfBackend):
    """TensorFlow-Serving REST backend (reference
    client_backend/tensorflow_serving/ role): row-format ``:predict``,
    metadata normalized from the signature block. Unlike the reference's,
    it builds a corpus entry's JSON body once and resends it (the
    prepared-request cache the KServe backend has): a ResNet-50 image is
    3.2 MB of JSON, whose build would otherwise be what the harness
    measures."""

    kind = "tfserving"

    def __init__(self, url: str):
        self._base = url if url.startswith("http") else f"http://{url}"
        self._init_prepared()

    async def _get_json(self, url: str, what: str):
        async with self._rest("GET", url) as resp:
            body = await resp.read()
            if resp.status != 200:
                raise InferenceServerException(f"{what} returned HTTP {resp.status}")
        try:
            return json.loads(body)
        except ValueError as e:
            raise InferenceServerException(f"{what}: malformed JSON: {e}") from None

    async def get_model_metadata(self, model_name, model_version=""):
        doc = await self._get_json(f"{self._base}/v1/models/{model_name}/metadata",
                                   "TFS metadata")
        sig = (doc.get("metadata", {}).get("signature_def", {})
               .get("signature_def", {}).get("serving_default", {}))

        def convert(block):
            tensors = []
            for name, desc in block.items():
                dtype = TF_TO_KSERVE_DTYPE.get(desc.get("dtype", ""))
                if dtype is None:
                    raise InferenceServerException(
                        f"signature tensor '{name}' has unsupported dtype "
                        f"'{desc.get('dtype')}'"
                    )
                dims = [int(d.get("size", -1))
                        for d in desc.get("tensor_shape", {}).get("dim", [])]
                tensors.append({"name": name, "datatype": dtype, "shape": dims})
            return tensors

        return {"name": model_name, "inputs": convert(sig.get("inputs", {})),
                "outputs": convert(sig.get("outputs", {}))}

    async def get_model_config(self, model_name, model_version=""):
        # TFS has no Triton-style config; the signature's leading -1 dims
        # play the batch dim's role
        return {"name": model_name, "max_batch_size": 0}

    async def infer(self, model_name, inputs, model_version="", request_id="",
                    parameters=None, sequence_id=0, sequence_start=False,
                    sequence_end=False, priority=0, timeout_us=None, cache_token=None):
        if cache_token is not None:
            body = self._get_or_build_prepared(cache_token, lambda: self._body(inputs), len)
        else:
            body = self._body(inputs)
        async with self._rest(
            "POST", f"{self._base}/v1/models/{model_name}:predict", data=body,
            headers={"Content-Type": "application/json"},
        ) as resp:
            payload = await resp.read()
            if resp.status != 200:
                raise InferenceServerException(
                    f"TFS predict HTTP {resp.status}: {payload[:200]!r}"
                )

    @staticmethod
    def _body(inputs) -> bytes:
        """The row-format ``{"instances": [...]}`` JSON of ``inputs``."""
        def rows_for(t):
            values = np.asarray(t.data)
            if t.datatype == "BYTES":
                # TFS REST string tensors ride as {"b64": ...} objects
                def b64(v):
                    if isinstance(v, str):
                        v = v.encode("utf-8")
                    return {"b64": base64.b64encode(v).decode("ascii")}

                if values.ndim <= 1:
                    return [b64(v) for v in values.reshape(-1)]
                return [[b64(v) for v in row.reshape(-1)] for row in values]
            return values.tolist()

        if len(inputs) == 1:
            instances = rows_for(inputs[0])
        else:
            rows = None
            per_input = {}
            for t in inputs:
                values = rows_for(t)
                if rows is None:
                    rows = len(values)
                elif len(values) != rows:
                    raise InferenceServerException("TFS row format needs a shared batch dim")
                per_input[t.name] = values
            instances = [{name: per_input[name][r] for name in per_input}
                         for r in range(rows or 0)]
        return json.dumps({"instances": instances}).encode()


class TorchServePerfBackend(_RestSessionMixin, PerfBackend):
    """TorchServe REST backend (reference client_backend/torchserve/
    role): raw-body ``/predictions/<m>``, a fabricated single-BYTES-input
    contract."""

    kind = "torchserve"

    def __init__(self, url: str):
        self._base = url if url.startswith("http") else f"http://{url}"

    async def connect(self) -> None:
        async with self._rest("GET", f"{self._base}/ping") as resp:
            await resp.read()
            if resp.status != 200:
                raise InferenceServerException(f"TorchServe /ping failed: HTTP {resp.status}")

    async def get_model_metadata(self, model_name, model_version=""):
        return {"name": model_name,
                "inputs": [{"name": "data", "datatype": "BYTES", "shape": [-1]}],
                "outputs": []}

    async def get_model_config(self, model_name, model_version=""):
        return {"name": model_name, "max_batch_size": 0}

    async def infer(self, model_name, inputs, model_version="", request_id="",
                    parameters=None, sequence_id=0, sequence_start=False,
                    sequence_end=False, priority=0, timeout_us=None):
        if not inputs:
            raise InferenceServerException("torchserve backend needs input")
        t = inputs[0]
        if t.datatype == "BYTES":
            flat = np.asarray(t.data, dtype=object).reshape(-1)
            body = flat[0] if len(flat) else b""
            if isinstance(body, str):
                body = body.encode("utf-8")
        else:
            body = np.ascontiguousarray(t.data).tobytes()
        async with self._rest(
            "POST", f"{self._base}/predictions/{model_name}", data=body,
            headers={"Content-Type": "application/octet-stream"},
        ) as resp:
            payload = await resp.read()
            if resp.status != 200:
                raise InferenceServerException(
                    f"TorchServe predict HTTP {resp.status}: {payload[:200]!r}"
                )


def create_backend(
    kind: str,
    url: str = "",
    core=None,
    **kwargs,
) -> PerfBackend:
    """Factory (reference ClientBackendFactory::Create)."""
    if kind == "http":
        return HttpPerfBackend(url, **kwargs)
    if kind == "grpc":
        return GrpcPerfBackend(url, **kwargs)
    if kind == "openai":
        return OpenAiPerfBackend(url, **kwargs)
    if kind == "tfserving":
        return TfsPerfBackend(url)
    if kind == "torchserve":
        return TorchServePerfBackend(url)
    if kind == "local":
        if core is None:
            raise InferenceServerException(
                "local backend requires an in-process ServerCore"
            )
        return LocalPerfBackend(core)
    if kind == "mock":
        return MockPerfBackend(**kwargs)
    raise InferenceServerException(f"unknown backend kind '{kind}'")
