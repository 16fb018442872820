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
Request bodies need a ``Content-Length``; gzip and deflate request bodies
are inflated, and responses are compressed when the client's
``Accept-Encoding`` asks for it.
"""

import asyncio
import base64
import binascii
import gzip
import json
import logging
import re
import zlib
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Any, Dict, List, Optional

import numpy as np

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
MAX_BODY_BYTES = 64 * 1024 * 1024
HEADER_CONTENT_LENGTH = "Inference-Header-Content-Length"

_log = logging.getLogger(__name__)


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
    """(method, path, version, headers, body) of the next request, or
    None at a clean end of stream."""
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
        raise HttpError(501, "chunked request bodies are not supported")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise HttpError(400, "bad Content-Length") from None
    if length < 0 or length > MAX_BODY_BYTES:
        raise HttpError(413, f"body of {length} bytes refused")
    try:
        body = await reader.readexactly(length) if length else b""
    except asyncio.IncompleteReadError:
        raise HttpError(400, "truncated request body") from None
    path = target.split("?", 1)[0]
    return method, path, version, headers, body


class HttpServer:
    """The port's HTTP front-end over a :class:`ServerCore`."""

    def __init__(self, core: ServerCore):
        from client_tpu_torch.server.openai_frontend import OpenAiFrontend

        self.core = core
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()  # open connections, closed by close()
        openai = OpenAiFrontend(core)
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
            ("GET", re.compile(model), self.handle_model_metadata),
            *self._shm_routes(),
            ("GET", re.compile(r"/v1/models"), openai.handle_models),
            ("POST", re.compile(r"/v1/chat/completions"), openai.handle_chat),
            ("POST", re.compile(r"/v1/completions"), openai.handle_chat),
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
        try:
            while True:
                try:
                    parsed = await _read_request(reader)
                except HttpError as e:
                    response = json_response({"error": str(e)}, status=e.status)
                    response.headers["Connection"] = "close"
                    await self._write(writer, response)
                    return
                if parsed is None:
                    return
                method, path, version, headers, body = parsed
                request = Request(method, path, headers, body, {}, writer)
                response = await self._dispatch(request)
                if response is not None:
                    await self._write(writer, response)
                connection = headers.get("connection", "").lower()
                if connection == "close" or (
                    version == "HTTP/1.0" and connection != "keep-alive"
                ):
                    return
        except ConnectionError:
            pass  # the client went away
        finally:
            self._writers.discard(writer)
            writer.close()

    @staticmethod
    async def _write(writer: asyncio.StreamWriter, response: Response) -> None:
        headers = dict(response.headers)
        headers["Content-Length"] = str(len(response.body))
        writer.write(_head(response.status, headers) + response.body)
        await writer.drain()

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
                    _log.exception("stream failed on %s", request.path)
                    raise ConnectionResetError("stream failed") from e
                if isinstance(e, InferenceServerException):
                    return error_response(e)
                _log.exception("internal error on %s %s", request.method,
                               request.path)
                return json_response({"error": f"internal error: {e}"}, status=500)
        if allowed:
            return json_response({"error": "method not allowed"}, status=405,
                                 headers={"Allow": ", ".join(allowed)})
        return json_response({"error": f"no route {request.path}"}, status=404)

    # -- KServe v2 routes ----------------------------------------------------

    async def handle_live(self, request: Request) -> Response:
        return Response(200 if self.core.live else 400)

    async def handle_ready(self, request: Request) -> Response:
        return Response(200 if self.core.ready else 503)

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
        })

    def _model(self, request: Request):
        return self.core.repository.get(
            request.params["model"], request.params.get("version", "")
        )

    async def handle_model_metadata(self, request: Request) -> Response:
        return json_response(self._model(request).metadata())

    async def handle_model_config(self, request: Request) -> Response:
        return json_response(self._model(request).config())

    async def handle_stats(self, request: Request) -> Response:
        return json_response(self.core.statistics(
            request.params.get("model", ""), request.params.get("version", "")
        ))

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
        body = _inflate(request.body, request.headers.get("content-encoding", ""))
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
        try:
            core_request = self._build_core_request(
                request.params["model"], request.params.get("version", ""), payload,
                binary,
            )
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise InferenceServerException(
                f"malformed inference request: {e!r}"
            ) from None
        core_response = await self.core.infer(core_request)
        return self._build_response(
            payload, core_response, request.headers.get("accept-encoding", "")
        )

    def _build_core_request(self, model_name: str, model_version: str,
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
                     port: int = 0) -> HttpServer:
    """Start the HTTP front-end; ``server.port`` is the bound port."""
    server = HttpServer(core)
    await server.start(host, port)
    return server
