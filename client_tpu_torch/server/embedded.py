"""In-process runner for an embedded ("local") perf backend.

The port's own copy of ``client_tpu/server/embedded.py``: a native
harness that embeds the interpreter imports this module and drives a
:class:`ServerCore` directly, with no sockets and no HTTP parsing in the
hot path beyond the KServe binary body decode.

Wire format (the HTTP binary protocol's, so a caller reuses its request
and response codecs):
  infer(model, body, header_len) -> bytes:
      4-byte LE status (0 ok / 1 error) + 8-byte LE response-header length
      + response body (JSON header + binary section, or error JSON).
"""

import asyncio
import json
import struct
import threading
from typing import Optional

from client_tpu_torch.utils import InferenceServerException


class EmbeddedRunner:
    """A :class:`ServerCore` over :func:`build_repository` on an event
    loop of its own thread; every model runs on ``device`` (``cuda``
    unless the caller passes ``"cpu"``)."""

    def __init__(self, zoo: bool = False, model_repository: str = "", device=None):
        from client_tpu_torch.server.core import ServerCore
        from client_tpu_torch.server.http_server import HttpServer
        from client_tpu_torch.server.model_repository import build_repository

        repository = build_repository(model_repository or None, zoo=zoo, device=device)
        self.core = ServerCore(repository, device=device)
        # the HTTP front-end's request and response codecs, with no
        # network in the path
        self._http = HttpServer(self.core)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="ctpu-torch-embedded", daemon=True)
        self._thread.start()

    def infer(self, model_name: str, body: bytes, header_len: int) -> bytes:
        try:
            if header_len <= 0:
                header_len = len(body)
            payload = json.loads(body[:header_len].decode("utf-8"))
            binary = body[header_len:]
            core_request = self._http._build_core_request(model_name, "", payload, binary)
            future = asyncio.run_coroutine_threadsafe(self.core.infer(core_request),
                                                      self._loop)
            core_response = future.result(timeout=600)
            resp = self._http._build_response(payload, core_response, "")
            resp_body = resp.body or b""
            resp_header_len = int(resp.headers.get("Inference-Header-Content-Length",
                                                   len(resp_body)))
            return struct.pack("<IQ", 0, resp_header_len) + bytes(resp_body)
        except InferenceServerException as e:
            msg = json.dumps({"error": e.message()}).encode()
            return struct.pack("<IQ", 1, len(msg)) + msg
        except Exception as e:  # noqa: BLE001 - cross the C boundary safely
            msg = json.dumps({"error": f"embedded runner: {e}"}).encode()
            return struct.pack("<IQ", 1, len(msg)) + msg

    def model_metadata_json(self, model_name: str) -> str:
        return json.dumps(self.core.repository.get(model_name, "").metadata())

    def model_config_json(self, model_name: str) -> str:
        return json.dumps(self.core.repository.get(model_name, "").config())

    def statistics_json(self, model_name: str = "") -> str:
        return json.dumps(self.core.statistics(model_name))

    def shutdown(self) -> None:
        """Stop the models' background work on the loop, then the loop,
        then the core."""
        async def stop():
            self.core._shutdown_model_hooks()

        global _runner
        asyncio.run_coroutine_threadsafe(stop(), self._loop).result(60)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(60)
        self.core.close()
        if _runner is self:
            _runner = None


_runner: Optional[EmbeddedRunner] = None


def start(zoo: bool = False, model_repository: str = "", device=None) -> EmbeddedRunner:
    """Create (or return) the process-wide runner."""
    global _runner
    if _runner is None:
        _runner = EmbeddedRunner(zoo=zoo, model_repository=model_repository, device=device)
    return _runner
