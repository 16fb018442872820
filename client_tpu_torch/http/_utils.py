"""KServe v2 HTTP/REST binary protocol: request construction & response parse.

An own copy of ``client_tpu/http/_utils.py``, plus :func:`read_chunked`,
the chunked-body decoder the port's client and server share. Wire format (KServe v2 binary tensor extension, as implemented by Triton;
reference src/python/library/tritonclient/http/_utils.py:85-156):

- request body = JSON inference header, immediately followed by the
  concatenated raw tensor buffers of every input that uses binary data;
- the ``Inference-Header-Content-Length`` HTTP header carries the JSON size;
- each binary input declares ``parameters.binary_data_size``; outputs
  requested with ``parameters.binary_data`` come back the same way.

BF16 tensors always travel binary: JSON has no sane BF16 representation
(the reference simply errors; here the builder enforces binary for BF16).
"""

import asyncio
import gzip
import json
import zlib
from typing import Any, Dict, List, Optional, Tuple

from client_tpu_torch.utils import InferenceServerException

HEADER_CONTENT_LENGTH = "Inference-Header-Content-Length"


def build_query_string(query_params: Optional[Dict[str, Any]]) -> str:
    """Render query params (scalars or lists) into a ``?a=1&b=2`` suffix."""
    if not query_params:
        return ""
    from urllib.parse import quote

    parts: List[str] = []
    for key, value in query_params.items():
        if isinstance(value, (list, tuple)):
            for v in value:
                parts.append(f"{quote(str(key))}={quote(str(v))}")
        else:
            parts.append(f"{quote(str(key))}={quote(str(value))}")
    return "?" + "&".join(parts)


def model_infer_uri(model_name: str, model_version: str = "") -> str:
    from urllib.parse import quote

    name = quote(model_name)
    if model_version:
        return f"v2/models/{name}/versions/{model_version}/infer"
    return f"v2/models/{name}/infer"


def compress_body(body: bytes, algorithm: Optional[str]) -> Tuple[bytes, Optional[str]]:
    """Compress a request body; returns (body, Content-Encoding value)."""
    if algorithm is None:
        return body, None
    if algorithm == "gzip":
        return gzip.compress(body), "gzip"
    if algorithm == "deflate":
        return zlib.compress(body), "deflate"
    raise InferenceServerException(
        f"unsupported request compression algorithm '{algorithm}'"
    )


def decompress_body(body: bytes, content_encoding: Optional[str]) -> bytes:
    """Decompress a response body per its Content-Encoding header."""
    if not content_encoding:
        return body
    encoding = content_encoding.strip().lower()
    if encoding == "gzip":
        return gzip.decompress(body)
    if encoding == "deflate":
        return zlib.decompress(body)
    if encoding == "identity":
        return body
    raise InferenceServerException(
        f"unsupported response compression algorithm '{encoding}'"
    )


def get_inference_request_body(
    inputs,
    request_id: str = "",
    outputs=None,
    sequence_id: int = 0,
    sequence_start: bool = False,
    sequence_end: bool = False,
    priority: int = 0,
    timeout: Optional[int] = None,
    parameters: Optional[Dict[str, Any]] = None,
) -> Tuple[bytes, Optional[int]]:
    """Build the request body for an inference request.

    Returns ``(body, json_size)`` where ``json_size`` is the value for the
    ``Inference-Header-Content-Length`` header, or None when the body is pure
    JSON (no binary tensor data attached).
    """
    infer_request: Dict[str, Any] = {}
    if request_id:
        infer_request["id"] = request_id

    request_parameters: Dict[str, Any] = dict(parameters) if parameters else {}
    if sequence_id != 0 and sequence_id != "":
        request_parameters["sequence_id"] = sequence_id
        request_parameters["sequence_start"] = bool(sequence_start)
        request_parameters["sequence_end"] = bool(sequence_end)
    if priority != 0:
        request_parameters["priority"] = priority
    if timeout is not None:
        request_parameters["timeout"] = timeout
    if request_parameters:
        infer_request["parameters"] = request_parameters

    binary_chunks: List[bytes] = []
    infer_request["inputs"] = [
        inp._get_tensor_json(binary_chunks) for inp in inputs
    ]
    if outputs:
        infer_request["outputs"] = [out._get_tensor_json() for out in outputs]
    else:
        # No outputs requested: ask the server to return all outputs as
        # binary data (reference http/_utils.py:131-139 semantics).
        infer_request["parameters"] = infer_request.get("parameters", {})
        infer_request["parameters"]["binary_data_output"] = True

    header = json.dumps(infer_request).encode("utf-8")
    if binary_chunks:
        return b"".join([header] + binary_chunks), len(header)
    return header, None


def retry_after_seconds(headers) -> Optional[float]:
    """Parse a ``Retry-After`` header (delta-seconds form) from a header
    mapping; returns None when absent or unparsable (HTTP-date form is
    ignored — the servers this client talks to emit seconds)."""
    if not headers:
        return None
    for key, value in headers.items():
        if key.lower() == "retry-after":
            try:
                parsed = float(value)
            except (TypeError, ValueError):
                return None
            return parsed if parsed > 0 else None
    return None


def parse_error_response(body: bytes, status: int) -> InferenceServerException:
    """Map an HTTP error response to an InferenceServerException."""
    try:
        msg = json.loads(body.decode("utf-8", errors="replace")).get("error", "")
    except Exception:
        msg = body.decode("utf-8", errors="replace")
    if not msg:
        msg = f"inference server returned HTTP status {status}"
    return InferenceServerException(msg, status=str(status))


def raise_if_error(status: int, body: bytes) -> None:
    if status != 200:
        raise parse_error_response(body, status)


def parse_json_response(status: int, body: bytes) -> Dict[str, Any]:
    raise_if_error(status, body)
    if not body:
        return {}
    try:
        return json.loads(body.decode("utf-8"))
    except json.JSONDecodeError as e:
        raise InferenceServerException(
            f"malformed JSON in server response: {e}"
        ) from None


async def read_chunked(reader: asyncio.StreamReader,
                       max_bytes: Optional[int] = None) -> bytes:
    """The body of a ``Transfer-Encoding: chunked`` message from
    ``reader`` (chunk extensions ignored, trailers read and dropped).
    Raises ValueError on malformed framing or a stream that ends early,
    and OverflowError once the body would pass ``max_bytes``."""
    pieces: List[bytes] = []
    total = 0
    try:
        while True:
            line = await reader.readuntil(b"\r\n")
            size_text = line[:-2].split(b";", 1)[0].strip()
            if not size_text or size_text.strip(b"0123456789abcdefABCDEF"):
                raise ValueError(f"bad chunk size line {line[:40]!r}")
            size = int(size_text, 16)
            if size == 0:
                break
            total += size
            if max_bytes is not None and total > max_bytes:
                raise OverflowError(f"chunked body over {max_bytes} bytes")
            pieces.append(await reader.readexactly(size))
            if await reader.readexactly(2) != b"\r\n":
                raise ValueError("chunk data not followed by CRLF")
        while await reader.readuntil(b"\r\n") != b"\r\n":
            pass  # trailer fields
    except asyncio.IncompleteReadError:
        raise ValueError("chunked body ends early") from None
    except asyncio.LimitOverrunError:
        raise ValueError("chunk size or trailer line too long") from None
    return b"".join(pieces)
