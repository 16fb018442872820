"""HTTP/1.1 front-end on stdlib asyncio streams.

Serves the KServe v2 REST protocol — health, server and model metadata,
model config, statistics, and inference with the binary-tensor extension
(a JSON header followed by raw tensor buffers, its size in the
``Inference-Header-Content-Length`` header) and the system and TPU
shared-memory extensions (``/v2/{system,tpu}sharedmemory``; the
``cudasharedmemory`` routes answer as the JAX server's do: an empty
status and a refused registration) — and the OpenAI-compatible
routes (``server/openai_frontend.py``), with Server-Sent Events over a
chunked response when a request asks to stream. Connections are kept
alive between requests unless the client sends ``Connection: close``.
Request bodies come with a ``Content-Length`` or chunked, up to 1 GiB
(the JAX server's limit); gzip and deflate request bodies are inflated,
and responses are compressed when the client's ``Accept-Encoding`` asks
for it. An inference request may name a shared-memory ring slot
(``shm_ring_region``/``shm_ring_slot``/``shm_ring_seq`` parameters,
``server/shm_ring.py``): its inputs are read from the slot and its
outputs written back there.

The observability routes are the reference's: ``/metrics`` (Prometheus
text, ``?exemplars=true`` for OpenMetrics exemplars), the trace and
logging settings (``/v2/trace/setting``, ``/v2/logging``, global and per
model), ``/v2/debug/{requests,state,slo}``, the stage CPU toggle
``/v2/debug/profiling`` and the on-demand sampler ``/v2/debug/profile``
(``jax_trace_dir`` adds a ``torch.profiler`` Chrome trace of the whole
process, CUDA kernels included on a card, written inside the temp
directory and named in ``X-Device-Trace``; one run at a time, a second
gets 409; a capture that fails, or that recorded kernel launches and no
kernel, answers an error. On an H100 serving ResNet-50 under load a CUDA
capture kills the server in about one 2 s window in eleven, inside
CUPTI's worker thread: see ``observability/profiling.py``).

Lifecycle and repository control are the reference's too:
``/v2/health/ready`` answers 503 (with ``Retry-After`` while the server
drains) unless the server is live, accepting and its ready set whole,
while ``/v2/health/live`` stays 200 through a drain; ``/infer`` refuses
a draining server's requests before decoding them; ``POST
/v2/repository/index`` and ``/v2/repository/models/<m>/{load,unload}``
drive :meth:`ServerCore.load_model` / :meth:`ServerCore.unload_model`. A
load runs on the serving loop, as the reference's does, so the loop
stalls for the model's warmup. The TensorFlow-Serving and TorchServe
REST routes come from ``server/compat_frontends.py``.

``HttpServer(core, chaos=...)`` injects faults from a
:class:`~client_tpu_torch.resilience.ChaosPolicy` into the requests whose
path it matches: an added latency, injected errors, resets and truncated
bodies, as the reference's chaos middleware does.
"""

import asyncio
import base64
import binascii
import gzip
import json
import os
import re
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qsl

import numpy as np

from client_tpu_torch.http._utils import read_chunked
from client_tpu_torch.observability.profiling import (
    WallProfiler,
    maybe_torch_trace,
    stage_range,
    stage_scope,
)
from client_tpu_torch.observability.trace import TRACEPARENT_HEADER
from client_tpu_torch.server import shm_ring
from client_tpu_torch.server.core import (
    SERVER_EXTENSIONS,
    SERVER_NAME,
    SERVER_VERSION,
    CoreRequest,
    CoreRequestedOutput,
    CoreResponse,
    ServerCore,
)
from client_tpu_torch.utils import InferenceServerException, serialize_byte_tensor

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 1 << 30
HEADER_CONTENT_LENGTH = "Inference-Header-Content-Length"


class HttpError(Exception):
    """A request the server cannot parse; answered, then the connection
    closes."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)


def json_response(doc: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    out = {"Content-Type": "application/json"}
    out.update(headers or {})
    return Response(status, json.dumps(doc).encode(), out)


def error_response(e: InferenceServerException) -> Response:
    """An exception's own wire face (``http_status``, ``Retry-After``
    from ``retry_after_s``), 400 when it carries none."""
    headers = {}
    retry_after_s = getattr(e, "retry_after_s", None)
    if retry_after_s:
        headers["Retry-After"] = str(max(1, int(round(retry_after_s))))
    return json_response({"error": e.message()},
                         status=getattr(e, "http_status", None) or 400,
                         headers=headers)


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{name}: {value}" for name, value in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response written piece by piece as a chunked body."""

    def __init__(self, writer: asyncio.StreamWriter, status: int,
                 headers: Dict[str, str]):
        self._writer = writer
        self._status = status
        self._headers = dict(headers)
        self._headers["Transfer-Encoding"] = "chunked"

    async def prepare(self) -> None:
        self._writer.write(_head(self._status, self._headers))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("client went away mid-stream")
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


@dataclass
class Request:
    method: str
    path: str
    headers: Dict[str, str]  # lower-case names
    body: bytes
    params: Dict[str, str]  # path parameters of the matched route
    writer: asyncio.StreamWriter
    streamed: bool = False
    query: Dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    async def stream(self, status: int = 200,
                     headers: Optional[Dict[str, str]] = None) -> StreamResponse:
        """Commit the status and headers and return the body writer; the
        handler then returns None."""
        self.streamed = True
        response = StreamResponse(self.writer, status, headers or {})
        await response.prepare()
        return response


async def _read_request(reader: asyncio.StreamReader):
    """(method, path, query string, version, headers, body) of the next
    request, or None at a clean end of stream."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HttpError(400, "truncated request head") from None
    except asyncio.LimitOverrunError:
        raise HttpError(431, "request head too large") from None
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"bad request line {lines[0]!r}")
    method, target, version = parts
    headers = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, f"bad header line {line!r}")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        try:
            body = await read_chunked(reader, MAX_BODY_BYTES)
        except ValueError as e:
            raise HttpError(400, f"malformed chunked body: {e}") from None
        except OverflowError:
            raise HttpError(413, f"chunked body over {MAX_BODY_BYTES} bytes refused") from None
    else:
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "bad Content-Length") from None
        # checked before the read: readexactly allocates the whole body
        if length < 0 or length > MAX_BODY_BYTES:
            raise HttpError(413, f"body of {length} bytes refused")
        try:
            body = await reader.readexactly(length) if length else b""
        except asyncio.IncompleteReadError:
            raise HttpError(400, "truncated request body") from None
    path, _, query = target.partition("?")
    return method, path, query, version, headers, body


async def write_response(writer: asyncio.StreamWriter, response: Response) -> None:
    headers = dict(response.headers)
    headers["Content-Length"] = str(len(response.body))
    writer.write(_head(response.status, headers) + response.body)
    await writer.drain()


async def serve_connection(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           respond) -> None:
    """Serve one HTTP/1.1 connection, kept alive until the client closes it
    or asks to: each request goes to ``await respond(method, path, query
    string, headers, body)``, whose :class:`Response` is written back (None:
    the handler wrote its own); a request that cannot be parsed is answered
    and ends the connection, which is closed on the way out."""
    try:
        while True:
            try:
                parsed = await _read_request(reader)
            except HttpError as e:
                response = json_response({"error": str(e)}, status=e.status)
                response.headers["Connection"] = "close"
                await write_response(writer, response)
                return
            if parsed is None:
                return
            method, path, query, version, headers, body = parsed
            response = await respond(method, path, query, headers, body)
            if response is not None:
                await write_response(writer, response)
            connection = headers.get("connection", "").lower()
            if connection == "close" or (
                version == "HTTP/1.0" and connection != "keep-alive"
            ):
                return
    except ConnectionError:
        pass  # the client went away
    finally:
        writer.close()


class HttpServer:
    """The port's HTTP front-end over a :class:`ServerCore`."""

    def __init__(self, core: ServerCore, chaos=None):
        from client_tpu_torch.server.compat_frontends import CompatFrontends
        from client_tpu_torch.server.openai_frontend import OpenAiFrontend

        self.core = core
        # a ChaosPolicy (client_tpu_torch.resilience) injects faults into
        # the requests whose path it matches; None injects nothing
        self.chaos = chaos
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()  # open connections, closed by close()
        # one sampling run at a time: a second concurrent
        # /v2/debug/profile gets 409 instead of doubling the overhead
        self._profiling_busy = False
        openai = OpenAiFrontend(core)
        compat = CompatFrontends(core)
        model = r"/v2/models/(?P<model>[^/]+)(/versions/(?P<version>[^/]+))?"
        self._routes = [
            ("GET", re.compile(r"/v2/health/live"), self.handle_live),
            ("GET", re.compile(r"/v2/health/ready"), self.handle_ready),
            ("GET", re.compile(r"/v2/?"), self.handle_server_metadata),
            ("GET", re.compile(r"/v2/models/stats"), self.handle_stats),
            ("GET", re.compile(model + "/stats"), self.handle_stats),
            ("GET", re.compile(model + "/ready"), self.handle_model_ready),
            ("GET", re.compile(model + "/config"), self.handle_model_config),
            ("POST", re.compile(model + "/infer"), self.handle_infer),
            ("GET", re.compile(model + "/trace/setting"), self.handle_get_trace),
            ("POST", re.compile(model + "/trace/setting"), self.handle_update_trace),
            ("GET", re.compile(model + "/logging"), self.handle_get_logging),
            ("POST", re.compile(model + "/logging"), self.handle_update_logging),
            ("GET", re.compile(model), self.handle_model_metadata),
            ("POST", re.compile(r"/v2/repository/index"), self.handle_repository_index),
            ("POST", re.compile(r"/v2/repository/models/(?P<model>[^/]+)/load"),
             self.handle_repository_load),
            ("POST", re.compile(r"/v2/repository/models/(?P<model>[^/]+)/unload"),
             self.handle_repository_unload),
            *self._shm_routes(),
            ("GET", re.compile(r"/v2/trace/setting"), self.handle_get_trace),
            ("POST", re.compile(r"/v2/trace/setting"), self.handle_update_trace),
            ("GET", re.compile(r"/v2/logging"), self.handle_get_logging),
            ("POST", re.compile(r"/v2/logging"), self.handle_update_logging),
            ("GET", re.compile(r"/v2/debug/requests"), self.handle_debug_requests),
            ("GET", re.compile(r"/v2/debug/state"), self.handle_debug_state),
            ("GET", re.compile(r"/v2/debug/slo"), self.handle_debug_slo),
            ("GET", re.compile(r"/metrics"), self.handle_metrics),
            ("GET", re.compile(r"/v2/debug/profiling"), self.handle_get_profiling),
            ("POST", re.compile(r"/v2/debug/profiling"), self.handle_update_profiling),
            ("GET", re.compile(r"/v2/debug/profile"), self.handle_profile),
            ("GET", re.compile(r"/v1/models"), openai.handle_models),
            ("POST", re.compile(r"/v1/chat/completions"), openai.handle_chat),
            ("POST", re.compile(r"/v1/completions"), openai.handle_chat),
            # after the OpenAI list: fullmatch keeps "/v1/models" there
            *compat.routes(),
        ]

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on ``host:port`` (0 = any free port); returns the port."""
        self._server = await asyncio.start_server(
            self._serve_connection, host, port, limit=MAX_HEADER_BYTES
        )
        return self.port

    async def close(self) -> None:
        """Stop listening and close every open connection."""
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)

        async def respond(method, path, query, headers, body):
            request = Request(method, path, headers, body, {}, writer,
                              query=dict(parse_qsl(query)))
            if self.chaos is not None and self.chaos.applies_to(path):
                return await self._dispatch_chaos(request)
            return await self._dispatch(request)

        try:
            await serve_connection(reader, writer, respond)
        finally:
            self._writers.discard(writer)

    async def _dispatch_chaos(self, request: Request) -> Optional[Response]:
        """:meth:`_dispatch` under the chaos plan (the reference's chaos
        middleware, ``client_tpu/server/http_server.py``): the added
        latency as a loop sleep, then one drawn fate. ``error`` answers
        the policy's ``http_status``; ``reset`` aborts the connection
        before anything is written; ``truncate`` declares the full
        ``Content-Length``, writes half the body and aborts. A fate is
        counted only where it fired: not when the peer is already gone,
        nor for a body under two bytes or a streamed one."""
        chaos = self.chaos
        if chaos.latency_s:
            await asyncio.sleep(chaos.latency_s)
        fate = chaos.draw()
        transport = request.writer.transport
        if fate == "error":
            chaos.record("error")
            return json_response({"error": "chaos: injected unavailability"},
                                 status=chaos.http_status)
        if fate == "reset" and not transport.is_closing():
            chaos.record("reset")
            transport.abort()
            raise ConnectionResetError("chaos: injected reset")
        response = await self._dispatch(request)
        if fate != "truncate" or response is None or len(response.body) < 2 \
                or transport.is_closing():
            return response
        chaos.record("truncate")
        body = response.body
        headers = dict(response.headers)
        headers["Content-Length"] = str(len(body))
        request.writer.write(_head(response.status, headers) + body[: len(body) // 2])
        await request.writer.drain()
        transport.abort()
        raise ConnectionResetError("chaos: injected truncation")

    async def _dispatch(self, request: Request) -> Optional[Response]:
        allowed = []
        for method, pattern, handler in self._routes:
            match = pattern.fullmatch(request.path)
            if match is None:
                continue
            if method != request.method:
                allowed.append(method)
                continue
            request.params = {k: v for k, v in match.groupdict().items() if v}
            try:
                return await handler(request)
            except ConnectionError:
                raise
            except Exception as e:  # noqa: BLE001 - answer, keep serving
                if request.streamed:
                    # the status is committed: all that is left is to
                    # cut the stream, which the client sees as truncated
                    self.core.logger.error("stream_failed", exc=e,
                                           rate_key=("stream_failed", request.path),
                                           path=request.path, protocol="http")
                    raise ConnectionResetError("stream failed") from e
                if isinstance(e, InferenceServerException):
                    return error_response(e)
                self.core.logger.error("internal_error", exc=e,
                                       rate_key=("internal_error", request.path),
                                       path=request.path, protocol="http")
                return json_response({"error": f"internal error: {e}"}, status=500)
        if allowed:
            return json_response({"error": "method not allowed"}, status=405,
                                 headers={"Allow": ", ".join(allowed)})
        return json_response({"error": f"no route {request.path}"}, status=404)

    # -- KServe v2 routes ----------------------------------------------------

    async def handle_live(self, request: Request) -> Response:
        # process health only: stays 200 through a drain, so an
        # orchestrator does not kill a draining server
        return Response(200 if self.core.live else 400)

    async def handle_ready(self, request: Request) -> Response:
        # live, accepting and not degraded; the 503 is what takes a
        # draining server out of a load balancer while /live stays 200
        core = self.core
        if core.ready:
            return Response(200)
        headers = {}
        if core.live and not core.lifecycle.accepting:
            headers["Retry-After"] = str(max(1, int(round(core.lifecycle.retry_after_s))))
        return Response(503, headers=headers)

    async def handle_model_ready(self, request: Request) -> Response:
        ready = self.core.repository.is_ready(
            request.params["model"], request.params.get("version", "")
        )
        return Response(200 if ready else 400)

    async def handle_server_metadata(self, request: Request) -> Response:
        return json_response({
            "name": SERVER_NAME,
            "version": SERVER_VERSION,
            "extensions": SERVER_EXTENSIONS,
            "devices": self.core.device_topology(),
        })

    def _model(self, request: Request):
        return self.core.repository.get(
            request.params["model"], request.params.get("version", "")
        )

    async def handle_model_metadata(self, request: Request) -> Response:
        return json_response(self._model(request).metadata())

    async def handle_model_config(self, request: Request) -> Response:
        return json_response(self._model(request).config())

    # -- repository control ------------------------------------------------

    async def handle_repository_index(self, request: Request) -> Response:
        return json_response(self.core.repository.index())

    async def handle_repository_load(self, request: Request) -> Response:
        """Load or reload, on this loop (the reference's order: the loop
        waits for the model's warmup)."""
        config_override = None
        if request.body:
            try:
                payload = request.json()
                config_override = payload.get("parameters", {}).get("config")
            except (UnicodeDecodeError, ValueError, AttributeError) as e:
                raise InferenceServerException(f"malformed load request: {e}") from None
        self.core.load_model(request.params["model"], config_override=config_override)
        return Response(200)

    async def handle_repository_unload(self, request: Request) -> Response:
        # the model stops admitting at once; its queued and in-flight work
        # drains in the background before the index reads "unloaded"
        self.core.unload_model(request.params["model"])
        return Response(200)

    async def handle_stats(self, request: Request) -> Response:
        # the harness's per-window snapshots are part of the server's CPU
        # bill: booked as the "rpc" stage
        with stage_scope(self.core.profiling, "rpc"):
            return json_response(self.core.statistics(
                request.params.get("model", ""), request.params.get("version", "")
            ))

    async def handle_metrics(self, request: Request) -> Response:
        """Prometheus text from the core's registry; its render is booked
        as the "rpc" stage, so the harness's own scrapes show up."""
        exemplars = request.query.get("exemplars", "").lower() in ("1", "true", "yes")
        with stage_scope(self.core.profiling, "rpc"):
            text = self.core.metrics.render(exemplars=exemplars)
        return Response(200, text.encode(), {"Content-Type": "text/plain; charset=utf-8"})

    # -- trace / logging settings ---------------------------------------------

    @staticmethod
    def _settings_body(request: Request) -> Dict[str, Any]:
        if not request.body:
            return {}
        try:
            updates = request.json()
        except (UnicodeDecodeError, ValueError) as e:
            raise InferenceServerException(f"malformed settings request: {e}") from None
        if not isinstance(updates, dict):
            raise InferenceServerException("settings request must be a JSON object")
        return updates

    async def handle_get_trace(self, request: Request) -> Response:
        return json_response(self.core.trace_manager.settings(request.params.get("model", "")))

    async def handle_update_trace(self, request: Request) -> Response:
        # the manager validates the whole update before applying any of
        # it; a null value clears a per-model override / resets a setting
        return json_response(self.core.trace_manager.update(
            self._settings_body(request), request.params.get("model", "")))

    async def handle_get_logging(self, request: Request) -> Response:
        return json_response(self.core.logger.settings(request.params.get("model", "")))

    async def handle_update_logging(self, request: Request) -> Response:
        """The model scope is the route's or a "model" key of the body."""
        updates = self._settings_body(request)
        model = request.params.get("model", "")
        body_model = updates.pop("model", None)
        if body_model is not None:
            if not isinstance(body_model, str):
                raise InferenceServerException(
                    f"log setting 'model' expects a string, got {body_model!r}")
            model = body_model
        return json_response(self.core.logger.update(updates, model))

    # -- flight recorder, live state, profiling ---------------------------------

    async def handle_debug_requests(self, request: Request) -> Response:
        """Recent, failed and slowest requests (``?model=``, ``?limit=``)."""
        limit = request.query.get("limit")
        if limit is not None:
            try:
                limit = int(limit)
            except ValueError:
                raise InferenceServerException(
                    f"debug requests limit must be an integer, got '{limit}'") from None
        return json_response(self.core.flight_recorder.snapshot(
            model=request.query.get("model") or None, limit=limit))

    async def handle_debug_state(self, request: Request) -> Response:
        return json_response(self.core.debug_state())

    async def handle_debug_slo(self, request: Request) -> Response:
        return json_response(self.core.debug_slo())

    async def handle_get_profiling(self, request: Request) -> Response:
        return json_response(self.core.profiling.config())

    async def handle_update_profiling(self, request: Request) -> Response:
        """Turn stage CPU accounting on or off (``{"stage_cpu": bool}``)."""
        updates = self._settings_body(request)
        unknown = set(updates) - {"stage_cpu"}
        if unknown:
            raise InferenceServerException(
                f"unknown profiling setting '{sorted(unknown)[0]}'")
        value = updates.get("stage_cpu")
        if value is not None:
            if not isinstance(value, bool):
                raise InferenceServerException(
                    f"profiling setting 'stage_cpu' expects a boolean, got {value!r}")
            if value:
                # enabling calibrates the clocks (up to ~20 ms): off the loop
                await asyncio.get_running_loop().run_in_executor(
                    None, self.core.profiling.enable)
            else:
                self.core.profiling.disable()
        return json_response(self.core.profiling.config())

    async def handle_profile(self, request: Request) -> Response:
        """On-demand wall-stack sampling: ``?duration_s=&hz=&format=
        collapsed|speedscope[&jax_trace_dir=]``. The sampler runs on an
        executor thread and leaves its own out. ``jax_trace_dir`` (the JAX
        package's name, kept for both harnesses) must lie inside the
        server's temp directory; the ``torch.profiler`` Chrome trace is
        written there and named in ``X-Device-Trace``."""
        query = request.query
        try:
            duration_s = float(query.get("duration_s", "1.0"))
            hz = float(query.get("hz", "99"))
        except ValueError as e:
            raise InferenceServerException(f"malformed profile request: {e}") from None
        if not 0 < duration_s <= 120:
            raise InferenceServerException(
                f"profile duration_s must be in (0, 120], got {duration_s}")
        if not 1 <= hz <= 1000:
            raise InferenceServerException(f"profile hz must be in [1, 1000], got {hz}")
        fmt = query.get("format", "collapsed")
        if fmt not in ("collapsed", "speedscope"):
            raise InferenceServerException(
                f"profile format must be 'collapsed' or 'speedscope', got '{fmt}'")
        trace_dir = query.get("jax_trace_dir") or None
        if trace_dir is not None:
            # a wire-controlled write target stays inside the temp dir
            temp_root = os.path.realpath(tempfile.gettempdir())
            resolved = os.path.realpath(trace_dir)
            if not (resolved == temp_root or resolved.startswith(temp_root + os.sep)):
                raise InferenceServerException(
                    f"jax_trace_dir must be inside the server's temp directory ({temp_root})")
            trace_dir = resolved
        if self._profiling_busy:
            return json_response({"error": "a profiling run is already in progress"},
                                 status=409)
        self._profiling_busy = True
        try:
            profiler = WallProfiler(hz=hz)

            def run():
                with maybe_torch_trace(trace_dir) as trace:
                    result = profiler.run(duration_s)
                return result, trace.get("path", "")

            result, trace_path = await asyncio.get_running_loop().run_in_executor(None, run)
        finally:
            self._profiling_busy = False
        headers = {"X-Profile-Samples": str(result.sample_count),
                   "X-Profile-Hz-Effective": f"{result.hz_effective:.1f}"}
        if trace_path:
            headers["X-Device-Trace"] = trace_path
        if fmt == "speedscope":
            return json_response(result.speedscope(), headers=headers)
        headers["Content-Type"] = "text/plain; charset=utf-8"
        return Response(200, result.collapsed().encode(), headers)

    # -- shared memory -------------------------------------------------------

    def _shm_routes(self):
        routes = []
        for kind in ("system", "cuda", "tpu"):
            base = f"/v2/{kind}sharedmemory"
            region = base + r"/region/(?P<name>[^/]+)"
            routes += [
                ("GET", re.compile(base + "/status"), self._shm_status(kind)),
                ("GET", re.compile(region + "/status"), self._shm_status(kind)),
                ("POST", re.compile(region + "/register"), self._shm_register(kind)),
                ("POST", re.compile(base + "/unregister"), self._shm_unregister(kind)),
                ("POST", re.compile(region + "/unregister"), self._shm_unregister(kind)),
            ]
        return routes

    def _shm_status(self, kind: str):
        async def handler(request: Request) -> Response:
            regions = {} if kind == "cuda" else self.core.shm.status(
                kind, request.params.get("name", ""))
            return json_response(list(regions.values()))  # a list of region dicts
        return handler

    def _shm_register(self, kind: str):
        async def handler(request: Request) -> Response:
            if kind == "cuda":
                raise InferenceServerException(
                    "this server has no CUDA shared memory; use TPU or system "
                    "shared memory"
                )
            name = request.params["name"]
            try:
                payload = request.json()
                byte_size = int(payload["byte_size"])
                if kind == "system":
                    self.core.shm.register_system(
                        name, payload["key"], int(payload.get("offset", 0)), byte_size)
                else:
                    raw_handle = base64.b64decode(payload["raw_handle"]["b64"], validate=True)
                    self.core.shm.register_tpu(
                        name, raw_handle, int(payload.get("device_id", 0)), byte_size)
            except (ValueError, KeyError, TypeError, AttributeError, binascii.Error) as e:
                raise InferenceServerException(
                    f"malformed {kind} shared-memory registration for '{name}': {e!r}"
                ) from None
            return Response(200)
        return handler

    def _shm_unregister(self, kind: str):
        async def handler(request: Request) -> Response:
            name = request.params.get("name", "")
            if name:
                self.core.shm.unregister(name, kind=kind)
            else:
                self.core.shm.unregister_all(kind=kind)
            return Response(200)
        return handler

    # -- inference -----------------------------------------------------------

    async def handle_infer(self, request: Request) -> Response:
        core = self.core
        # drain fast path: refuse before paying for the decode
        core.reject_if_draining(request.params["model"])
        prof = core.profiling
        # one take() covers this request's decode and encode brackets
        measured = prof.take()
        decode_cpu0 = prof.cpu_now() if measured else 0
        decode_start = time.monotonic_ns()
        with stage_range("frontend_decode"):
            try:
                body = _inflate(request.body, request.headers.get("content-encoding", ""))
                payload, binary = self._parse_infer_body(request, body)
                core_request = self._build_core_request(
                    request.params["model"], request.params.get("version", ""), payload,
                    binary,
                )
            except InferenceServerException:
                # refused before the core: the statistics never see it
                core.metrics.observe_frontend_error("http")
                raise
        decode_ns = time.monotonic_ns() - decode_start
        if measured:
            prof.account("frontend_decode", prof.cpu_now() - decode_cpu0)
        # sampling, or a sampled W3C traceparent, opens a server trace
        trace = core.trace_manager.begin(
            core_request.model_name, model_version=core_request.model_version,
            traceparent=request.headers.get(TRACEPARENT_HEADER.lower()),
            request_id=core_request.id,
        )
        core_request.trace = trace
        ticket = core_request.shm_ring
        try:
            try:
                core_response = await core.infer(core_request)
            except BaseException:
                if ticket is not None:
                    ticket.fail()
                raise
            encode_cpu0 = prof.cpu_now() if measured else 0
            encode_start = time.monotonic_ns()
            with stage_range("encode"):
                if ticket is not None:
                    core_response = ticket.complete(core_response)
                response = self._build_response(
                    payload, core_response, request.headers.get("accept-encoding", "")
                )
            encode_ns = time.monotonic_ns() - encode_start
            if measured:
                prof.account("encode", prof.cpu_now() - encode_cpu0)
            # an answered request books its decode and encode, once each
            core.record_stages(core_request.model_name,
                               {"frontend_decode": decode_ns, "encode": encode_ns})
        except BaseException as e:
            if trace is not None:
                trace.end(error=str(e))
            if core.logger.verbose_hot:
                core.logger.verbose("request", model=core_request.model_name,
                                    protocol="http", status="error", error=str(e))
            raise
        if trace is not None:
            trace.end()
        if core.logger.verbose_hot:
            core.logger.verbose("request", model=core_request.model_name, protocol="http",
                                status="ok", request_id=core_request.id)
        return response

    @staticmethod
    def _parse_infer_body(request: Request, body: bytes):
        """(JSON header, binary tail) of an inference request body."""
        header_len = request.headers.get(HEADER_CONTENT_LENGTH.lower())
        try:
            if header_len is not None:
                header_len = int(header_len)
                if not 0 <= header_len <= len(body):
                    raise ValueError(f"{HEADER_CONTENT_LENGTH} {header_len} is outside "
                                     f"the body of {len(body)} bytes")
                payload = json.loads(body[:header_len].decode("utf-8"))
                binary = body[header_len:]
            else:
                payload = json.loads(body.decode("utf-8"))
                binary = b""
            if not isinstance(payload, dict):
                raise ValueError("the inference header is not a JSON object")
        except (UnicodeDecodeError, ValueError) as e:
            raise InferenceServerException(
                f"malformed inference request: {e}"
            ) from None
        return payload, binary

    def _build_core_request(self, model_name: str, model_version: str,
                            payload: Dict[str, Any], binary: bytes) -> CoreRequest:
        try:
            return self._decode_core_request(model_name, model_version, payload, binary)
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise InferenceServerException(
                f"malformed inference request: {e!r}"
            ) from None

    def _decode_core_request(self, model_name: str, model_version: str,
                             payload: Dict[str, Any], binary: bytes) -> CoreRequest:
        parameters = dict(payload.get("parameters", {}))
        parameters.pop("binary_data_output", None)  # an encoding choice, read by _build_response
        request = CoreRequest(
            model_name=model_name,
            model_version=model_version,
            id=payload.get("id", ""),
            parameters=parameters,
        )
        offset = 0
        for tensor in payload.get("inputs", []):
            params = tensor.get("parameters", {})
            name = tensor.get("name")
            datatype = tensor.get("datatype")
            if name is None or datatype is None:
                raise InferenceServerException(
                    "inference input must have 'name' and 'datatype'"
                )
            shape = [int(s) for s in tensor.get("shape", [])]
            raw = None
            json_data = None
            shm_region = params.get("shared_memory_region")
            if "binary_data_size" in params:
                size = int(params["binary_data_size"])
                if size < 0 or offset + size > len(binary):
                    raise InferenceServerException(
                        f"binary section truncated for input '{name}'"
                    )
                raw = binary[offset:offset + size]
                offset += size
            elif shm_region is None:
                json_data = tensor.get("data")
            request.inputs.append(self.core.decode_input(
                name, datatype, shape, raw=raw, json_data=json_data,
                shm_region=shm_region,
                shm_byte_size=int(params.get("shared_memory_byte_size", 0)),
                shm_offset=int(params.get("shared_memory_offset", 0)),
            ))
        for out in payload.get("outputs", []):
            params = out.get("parameters", {})
            request.outputs.append(CoreRequestedOutput(
                name=out["name"],
                classification=int(params.get("classification", 0)),
                shm_region=params.get("shared_memory_region"),
                shm_byte_size=int(params.get("shared_memory_byte_size", 0)),
                shm_offset=int(params.get("shared_memory_offset", 0)),
            ))
        # a ring request: its inputs come from the slot, and its ring
        # parameters leave the request here, before the batch signature
        shm_ring.attach(self.core, request)
        return request

    @staticmethod
    def _build_response(payload: Dict[str, Any], core_response: CoreResponse,
                        accept: str) -> Response:
        requested = {
            o.get("name"): o.get("parameters", {}) for o in payload.get("outputs", [])
        }
        # JSON is the spec default; only the explicit binary_data_output
        # request parameter flips unlisted outputs to binary
        want_binary_default = bool(
            payload.get("parameters", {}).get("binary_data_output", False)
        )
        header: Dict[str, Any] = {
            "model_name": core_response.model_name,
            "model_version": core_response.model_version,
            "outputs": [],
        }
        if core_response.id:
            header["id"] = core_response.id
        if core_response.parameters:
            header["parameters"] = core_response.parameters
        chunks: List[bytes] = []
        for tensor in core_response.outputs:
            out_json: Dict[str, Any] = {
                "name": tensor.name,
                "datatype": tensor.datatype,
                "shape": tensor.shape,
            }
            binary = bool(requested.get(tensor.name, {}).get("binary_data",
                                                              want_binary_default))
            if tensor.name in core_response.shm_outputs:
                region, size, shm_offset = core_response.shm_outputs[tensor.name]
                out_json["parameters"] = {"shared_memory_region": region,
                                          "shared_memory_byte_size": size}
                if shm_offset:
                    out_json["parameters"]["shared_memory_offset"] = shm_offset
            elif binary or tensor.datatype == "BF16":  # BF16 has no JSON form
                if tensor.datatype == "BYTES":
                    raw = serialize_byte_tensor(tensor.data).tobytes()
                else:
                    raw = np.ascontiguousarray(tensor.data).tobytes()
                chunks.append(raw)
                out_json["parameters"] = {"binary_data_size": len(raw)}
            elif tensor.datatype == "BYTES":
                out_json["data"] = [
                    b.decode("utf-8", errors="replace") for b in tensor.data.reshape(-1)
                ]
            else:
                out_json["data"] = tensor.data.reshape(-1).tolist()
            header["outputs"].append(out_json)

        header_bytes = json.dumps(header).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        body = header_bytes
        if chunks:
            body = b"".join([header_bytes] + chunks)
            headers = {"Content-Type": "application/octet-stream",
                       HEADER_CONTENT_LENGTH: str(len(header_bytes))}
        accept = accept.lower()
        if "gzip" in accept:
            body = gzip.compress(body)
            headers["Content-Encoding"] = "gzip"
        elif "deflate" in accept:
            body = zlib.compress(body)
            headers["Content-Encoding"] = "deflate"
        return Response(200, body, headers)


def _inflate(body: bytes, encoding: str) -> bytes:
    """A request body as sent, inflated per its ``Content-Encoding``."""
    encoding = encoding.strip().lower()
    try:
        if encoding == "gzip":
            return gzip.decompress(body)
        if encoding == "deflate":
            return zlib.decompress(body)
    except (OSError, EOFError, zlib.error) as e:
        raise InferenceServerException(f"malformed {encoding} body: {e}") from None
    if encoding not in ("", "identity"):
        raise InferenceServerException(f"unsupported Content-Encoding '{encoding}'")
    return body


async def serve_http(core: ServerCore, host: str = "127.0.0.1",
                     port: int = 0, chaos=None) -> HttpServer:
    """Start the HTTP front-end; ``server.port`` is the bound port.
    ``chaos`` (a :class:`~client_tpu_torch.resilience.ChaosPolicy`)
    injects faults into the requests it matches."""
    server = HttpServer(core, chaos=chaos)
    await server.start(host, port)
    return server
