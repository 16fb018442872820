"""Run the port's KServe v2 server in-process on a background event loop.

The port's twin of ``client_tpu/testing/inprocess.py``: the port's
:class:`~client_tpu_torch.server.core.ServerCore` and HTTP front-end on a
thread of their own, so a test or a benchmark drives the full client /
server path without a separate server process. ``grpc=True`` (or
``"native"``) adds the native gRPC front-end, as the reference's does;
unlike the reference, gRPC is off by default, and ``"aio"`` (the grpc.aio
server, on grpcio, which the port does not import) is refused;
``tls=(cert, key)`` serves that port over TLS; ``chaos`` (a
:class:`~client_tpu_torch.resilience.ChaosPolicy`) injects faults into the
HTTP front-end, and is refused beside gRPC, since the native front-end has
no injection hooks and the port has no grpc.aio server to fall back to, as
the reference does. :meth:`InProcessServer.stop`
drains first, as the reference's does: readiness flips false, in-flight
and queued work finishes inside the drain deadline, and only then do the
front-ends and the core close.
"""

import asyncio
import threading
from typing import Optional

from client_tpu_torch.server.core import ServerCore
from client_tpu_torch.server.model_repository import ModelRepository


class InProcessServer:
    """Starts the HTTP (and optionally the gRPC) front-end over one
    ServerCore in a thread."""

    def __init__(
        self,
        core: Optional[ServerCore] = None,
        host: str = "127.0.0.1",
        builtin_models: bool = True,
        http_port: int = 0,
        device=None,
        drain_timeout_s: float = 5.0,
        grpc=False,
        grpc_port: int = 0,
        tls=None,
        chaos=None,
    ):
        """``builtin_models`` installs the built-in models on ``device``
        (``cuda`` unless the caller passes ``"cpu"``; with no card the
        default raises), which is also the device of the core made here.
        ``http_port`` 0 takes any free port; a restarted server passes
        its predecessor's so it comes back at the same address.
        ``drain_timeout_s`` bounds the graceful half of :meth:`stop`.
        ``grpc`` True or ``"native"`` starts the native gRPC front-end on
        ``grpc_port`` (0: any free port); ``tls=(cert_path, key_path)``
        makes that port speak TLS (ALPN ``h2``), and a pair the front-end
        cannot load fails :meth:`start`. ``chaos`` injects faults into
        the HTTP front-end's matched requests (errors, latency, resets,
        truncated bodies); it cannot be combined with ``grpc``."""
        if grpc == "aio":
            raise ValueError("the grpc.aio server stands on grpcio and is not ported; "
                             "use grpc='native'")
        if grpc not in (True, False, "native"):
            raise ValueError(f"grpc must be True, False or 'native', not {grpc!r}")
        if tls is not None and not grpc:
            raise ValueError("tls= needs the gRPC front-end (grpc=True)")
        if grpc and chaos is not None:
            raise ValueError(
                "chaos injection is not supported by the native gRPC "
                "front-end, and the port has no grpc.aio server; use grpc=False"
            )
        if core is None:
            core = ServerCore(ModelRepository(), device=device)
        self.core = core
        if builtin_models:
            from client_tpu_torch.server.models import register_builtin_models

            register_builtin_models(self.core.repository, device=device)
        self.chaos = chaos
        self._host = host
        self._http_bind_port = http_port
        self.grpc_impl: Optional[str] = "native" if grpc else None
        self._grpc_bind_port = grpc_port
        self._tls = tuple(tls) if tls is not None else None
        self.grpc_port: Optional[int] = None
        self._drain_timeout_s = drain_timeout_s
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
        server = await serve_http(self.core, self._host, self._http_bind_port,
                                  chaos=self.chaos)
        self.http_port = server.port
        grpc_frontend = None
        try:
            if self.grpc_impl:
                from client_tpu_torch.server.native_frontend import serve_grpc_native

                cert, key = self._tls or (None, None)
                grpc_frontend, self.grpc_port = await serve_grpc_native(
                    self.core, self._host, self._grpc_bind_port, tls_cert=cert,
                    tls_key=key)
        except BaseException:
            await server.close()
            raise
        self._ready.set()
        try:
            await self._stop.wait()
            # the graceful half before the front-end closes: in-flight and
            # queued work finishes inside the deadline, the rest fails
            # with a clean 503, never a cancelled future
            try:
                await self.core.drain(self._drain_timeout_s)
            except Exception:  # noqa: BLE001 - shutdown must proceed
                pass
        finally:
            if grpc_frontend is not None:
                grpc_frontend.stop()
            await server.close()
            # on the loop, while it runs: an engine model's shutdown fails
            # its live streams through queues bound to this loop
            self.core.close()

    def stop(self) -> None:
        """Drain (bounded by the server's ``drain_timeout_s``), then close
        the front-end and its connections and the core (on the server's
        loop; again here, idempotently, if it never started)."""
        if self._loop is not None and self._stop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._stop.set)
        if self._thread is not None:
            self._thread.join(timeout=self._drain_timeout_s + 30)
        self.core.close()

    def __enter__(self) -> "InProcessServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- convenience --------------------------------------------------------

    @property
    def http_url(self) -> str:
        return f"{self._host}:{self.http_port}"

    @property
    def grpc_url(self) -> str:
        return f"{self._host}:{self.grpc_port}"
