"""Backend transport for the router tier: persistent raw-byte streams.

An own copy of ``client_tpu/router/backends.py`` on the port's own h2c
transport (:class:`client_tpu_torch.grpc._h2.Channel`) instead of a
``grpc.aio`` channel.

One :class:`BackendLink` per replica holds a single long-lived
``ModelStreamInfer`` call carrying RAW serialized bytes both ways (the
channel moves bytes; nothing here builds a message). Forwarding a request
is one ``write()``; the reader loop splits each response frame with
:func:`client_tpu_torch.grpc._wire.split_stream_frame` and dispatches it
by the router's correlation id.

A dead stream (replica restart, UNAVAILABLE) fails every in-flight sink
with a retryable error and the next send opens a fresh stream: the
router-side mirror of the client mux's reconnect-on-UNAVAILABLE.

:class:`ReadinessProber` keeps the router's endpoint pool and
model→replica table fresh: per interval it asks every backend
``ServerReady`` (the gRPC face of ``/v2/health/ready``: a draining
replica answers not-ready) and, when ready, ``RepositoryIndex`` for the
models it serves, and ``ModelConfig`` once for each model name the
router has not seen, to learn whether it is decoupled.
"""

import asyncio
from typing import Any, Callable, Dict, Optional, Tuple

from client_tpu_torch.grpc import _wire as wire
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb
from client_tpu_torch.grpc._h2 import Channel
from client_tpu_torch.grpc._service_stubs import SERVICE, GRPCInferenceServiceStub
from client_tpu_torch.grpc._utils import RpcError, StatusCode, rpc_error_to_exception
from client_tpu_torch.utils import InferenceServerException

STREAM_METHOD = f"/{SERVICE}/ModelStreamInfer"

# deadline of a ModelConfig lookup, from the prober or the stream front
CONFIG_TIMEOUT_S = 5.0


class BackendLink:
    """One backend replica: a shared channel, a stub for the
    control-plane RPCs (probes, metadata proxying), and one persistent
    raw-bytes inference stream.

    Sinks are ``callback(error_message, response_bytes, failure)``:
    exactly one of ``response_bytes`` (a frame for this id) or
    ``failure`` (an :class:`InferenceServerException` when the stream
    died) is meaningful per call. Unary sends register a one-shot future
    sink; the stream front registers a long-lived sink and receives
    EVERY frame with its id (decoupled models emit many).
    """

    def __init__(
        self,
        url: str,
        channel_factory: Optional[Callable[[str], Any]] = None,
    ):
        self.url = url
        if channel_factory is None:
            self.channel = Channel(url, user_agent="client-tpu-router")
        else:
            self.channel = channel_factory(url)
        self.stub = GRPCInferenceServiceStub(self.channel)
        self._call = None
        self._reader: Optional[asyncio.Task] = None
        self._write_lock = asyncio.Lock()
        # rid -> sink; one-shot sinks are removed on first frame by the
        # reader, long-lived (stream-front) sinks stay until unregister
        self._sinks: Dict[str, Tuple[Callable, bool]] = {}
        self._closed = False
        self.retiring = False  # autoscaler scale-in: drain, don't feed

    # -- stream lifecycle ----------------------------------------------------

    def _ensure_open(self) -> None:
        if self._closed:
            raise InferenceServerException(
                f"backend link {self.url} is closed",
                status="StatusCode.UNAVAILABLE",
            )
        if self._call is None:
            call = self.channel.stream_stream(STREAM_METHOD)
            self._call = call
            self._reader = asyncio.ensure_future(self._read_loop(call))

    async def _read_loop(self, call) -> None:
        try:
            while True:
                frame = await call.read()
                if frame is None:
                    self._fail_sinks(
                        InferenceServerException(
                            f"backend stream {self.url} closed by the server",
                            status="StatusCode.UNAVAILABLE",
                        )
                    )
                    return
                try:
                    error_message, response = wire.split_stream_frame(frame)
                    rid = wire.read_message_id(response)
                except wire.WireError:
                    continue  # unparseable frame: nothing to correlate
                if not rid:
                    # an error the backend could not correlate: no single
                    # sink owns it; fail everything retryably rather
                    # than hang one forever (mux parity)
                    if error_message:
                        self._fail_sinks(
                            InferenceServerException(
                                error_message,
                                status="StatusCode.UNAVAILABLE",
                            )
                        )
                    continue
                entry = self._sinks.get(rid)
                if entry is None:
                    continue
                sink, long_lived = entry
                if not long_lived:
                    self._sinks.pop(rid, None)
                sink(error_message, bytes(response), None)
        except asyncio.CancelledError:
            self._fail_sinks(
                InferenceServerException(
                    f"backend stream {self.url} closed",
                    status="StatusCode.CANCELLED",
                )
            )
            raise
        except RpcError as e:
            self._fail_sinks(rpc_error_to_exception(e))
        except Exception as e:  # noqa: BLE001 - surface to waiters
            self._fail_sinks(InferenceServerException(str(e)))
        finally:
            if self._call is call:
                self._call = None
                self._reader = None

    def _fail_sinks(self, error: InferenceServerException) -> None:
        sinks, self._sinks = self._sinks, {}
        for sink, _long_lived in sinks.values():
            sink(None, None, error)

    # -- sends ---------------------------------------------------------------

    def register(self, rid: str, sink: Callable, long_lived: bool = False):
        self._sinks[rid] = (sink, long_lived)

    def unregister(self, rid: str) -> None:
        self._sinks.pop(rid, None)

    async def write(self, payload: bytes) -> None:
        """Forward one already-spliced request frame (a sink for its id
        must be registered FIRST: the response may race the return)."""
        self._ensure_open()
        call = self._call
        try:
            async with self._write_lock:
                await call.write(payload)
        except RpcError as e:
            raise rpc_error_to_exception(e) from None
        except Exception as e:  # noqa: BLE001 - a dying call object
            raise InferenceServerException(
                f"backend write to {self.url} failed: {e}",
                status="StatusCode.UNAVAILABLE",
            ) from None

    async def unary(
        self, payload: bytes, rid: str, timeout: Optional[float] = None
    ) -> Tuple[str, bytes]:
        """One request → its first (and for unary models only) response
        frame: ``(error_message, response_bytes)``. Stream death raises
        the retryable failure instead."""
        loop = asyncio.get_running_loop()
        future: "asyncio.Future" = loop.create_future()

        def sink(error_message, response, failure):
            if future.done():
                return
            if failure is not None:
                future.set_exception(failure)
            else:
                future.set_result((error_message, response))

        self.register(rid, sink)
        try:
            await self.write(payload)
            if timeout is not None:
                return await asyncio.wait_for(future, timeout)
            return await future
        finally:
            self.unregister(rid)

    async def model_decoupled(self, model_name: str) -> Optional[bool]:
        """Whether this backend's config of ``model_name`` declares it
        decoupled; None when the backend serves no such model. Raises
        :class:`RpcError` when the backend cannot say (unreachable, timed
        out, any other error)."""
        try:
            response = await self.stub.ModelConfig(
                pb.ModelConfigRequest(name=model_name), timeout=CONFIG_TIMEOUT_S
            )
        except RpcError as e:
            if e.code() == StatusCode.NOT_FOUND:
                return None
            raise
        return bool(response.config.model_transaction_policy.decoupled)

    @property
    def pending(self) -> int:
        return len(self._sinks)

    async def close(self) -> None:
        self._closed = True
        if self._reader is not None:
            self._reader.cancel()
            try:
                await self._reader
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._reader = None
        if self._call is not None:
            self._call.cancel()
            self._call = None
        try:
            await self.channel.close()
        except Exception:  # noqa: BLE001 - teardown is best-effort
            pass


class ReadinessProber:
    """Periodic backend health + model-inventory probes.

    Drives the pool's bench/recover transitions exactly like a client
    surface does: a not-ready or unreachable backend is marked down for
    ``2 * interval_s`` (so it stays benched between probes), and a
    benched backend that answers ready again re-enters through
    :meth:`EndpointPool.mark_up`, but only once its cooldown elapsed
    (``needs_probe``), so a deliberate ejection is never overridden
    early. A ready backend also refreshes the model→replica table from
    ``RepositoryIndex`` (ready models only), and the core's decoupled
    table from ``ModelConfig`` for each model name it does not know: a
    model that leaves or joins a backend's index is learned anew, so a
    reload that changes its transaction policy is seen.
    """

    def __init__(
        self,
        core,
        links: Dict[str, BackendLink],
        interval_s: float = 0.5,
        probe_timeout_s: float = 1.0,
    ):
        self.core = core  # RouterCore: pool + tables
        self.links = links
        self.interval_s = interval_s
        self.probe_timeout_s = probe_timeout_s
        self._task: Optional[asyncio.Task] = None

    async def probe_once(self) -> None:
        pool = self.core.pool
        for ep in pool.endpoints:
            link = self.links.get(ep.url)
            if link is None or link.retiring:
                continue
            ready = False
            models = None
            try:
                response = await link.stub.ServerReady(
                    pb.ServerReadyRequest(), timeout=self.probe_timeout_s
                )
                ready = bool(response.ready)
                if ready:
                    index = await link.stub.RepositoryIndex(
                        pb.RepositoryIndexRequest(ready=True),
                        timeout=self.probe_timeout_s,
                    )
                    models = [m.name for m in index.models]
            except Exception:  # noqa: BLE001 - unreachable == not ready
                ready = False
            if ready:
                if models is not None:
                    await self._learn_models(ep.url, link, models)
                if pool.needs_probe(ep):
                    pool.mark_up(ep)
            elif ep.state(self.core.now()) in ("up", "probe"):
                pool.mark_down(ep, cooldown_s=2 * self.interval_s)

    async def _learn_models(self, url: str, link: BackendLink, models) -> None:
        table, decoupled = self.core.table, self.core.decoupled
        before = set(table.snapshot().get(url, ()))
        table.set_backend_models(url, models)
        for name in before.symmetric_difference(models):
            decoupled.pop(name, None)
        for name in models:
            if name in decoupled:
                continue
            try:
                known = await link.model_decoupled(name)
            except Exception:  # noqa: BLE001 - learned at the next probe
                continue
            if known is not None:
                decoupled[name] = known

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - probing must not die
                pass

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
