"""Run the port's KServe v2 server in-process on a background event loop.

The port's twin of ``client_tpu/testing/inprocess.py``: the port's
:class:`~client_tpu_torch.server.core.ServerCore` and HTTP front-end on a
thread of their own, so a test or a benchmark drives the full client /
server path without a separate server process. The port has no gRPC
front-end and no drain yet: :meth:`InProcessServer.stop` closes the
front-end, then the core.
"""

import asyncio
import threading
from typing import Optional

from client_tpu_torch.server.core import ServerCore
from client_tpu_torch.server.model_repository import ModelRepository


class InProcessServer:
    """Starts the HTTP front-end over one ServerCore in a thread."""

    def __init__(
        self,
        core: Optional[ServerCore] = None,
        host: str = "127.0.0.1",
        builtin_models: bool = True,
        http_port: int = 0,
        device=None,
    ):
        """``builtin_models`` installs the built-in models on ``device``
        (``cuda`` unless the caller passes ``"cpu"``; with no card the
        default raises), which is also the device of the core made here.
        ``http_port`` 0 takes any free port."""
        if core is None:
            core = ServerCore(ModelRepository(), device=device)
        self.core = core
        if builtin_models:
            from client_tpu_torch.server.models import register_builtin_models

            register_builtin_models(self.core.repository, device=device)
        self._host = host
        self._http_bind_port = http_port
        self.http_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stop = None  # asyncio.Event created on the loop
        self._error: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "InProcessServer":
        self._thread = threading.Thread(
            target=self._run, name="client-tpu-torch-server", daemon=True
        )
        self._thread.start()
        self._ready.wait(timeout=60)
        if self._error is not None:
            raise self._error
        if not self._ready.is_set():
            raise RuntimeError("in-process server failed to start in 60s")
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
        from client_tpu_torch.server.http_server import serve_http

        self._stop = asyncio.Event()
        server = await serve_http(self.core, self._host, self._http_bind_port)
        self.http_port = server.port
        self._ready.set()
        try:
            await self._stop.wait()
        finally:
            await server.close()
            # on the loop, while it runs: an engine model's shutdown fails
            # its live streams through queues bound to this loop
            self.core.close()

    def stop(self) -> None:
        """Close the front-end and its connections, then the core (on the
        server's loop; again here, idempotently, if it never started)."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        if self._thread is not None:
            self._thread.join(timeout=30)
        self.core.close()

    def __enter__(self) -> "InProcessServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- convenience --------------------------------------------------------

    @property
    def http_url(self) -> str:
        return f"{self._host}:{self.http_port}"
