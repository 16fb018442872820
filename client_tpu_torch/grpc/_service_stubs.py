"""The method table of inference.GRPCInferenceService, and stubs on it.

An own copy of ``client_tpu/grpc/_service_stubs.py``: the port imports no
grpcio, so the stub's methods run on its own h2c transport
(``client_tpu_torch.grpc._h2``). The table is read from the service block
of the port's ``grpc_service.proto``. Each unary method of
:class:`GRPCInferenceServiceStub` is a coroutine ``(request, metadata=,
timeout=, compression=)`` returning the response message; ``request`` may
be a message or its serialized bytes. ``ModelStreamInfer(request_iterator,
...)`` returns a :class:`StreamStreamCall`, whose ``read()`` gives
responses until :data:`EOF`, as ``grpc.aio`` calls do.
"""

import asyncio
from typing import Any, Dict, Optional, Tuple

from client_tpu_torch.grpc import _proto
from client_tpu_torch.grpc._generated import grpc_service_pb2 as pb

SERVICE = "inference.GRPCInferenceService"

# method name -> (kind, request message, response message);
# kind: 'uu' unary-unary, 'ss' stream-stream
METHODS: Dict[str, Tuple[str, Any, Any]] = {
    name: ("ss" if client_stream and server_stream else "uu",
           getattr(pb, request), getattr(pb, response))
    for name, request, response, client_stream, server_stream in _proto.MODULE.methods
}


class _EOF:
    def __repr__(self) -> str:
        return "EOF"


#: what ``StreamStreamCall.read()`` returns once the call ended cleanly
EOF = _EOF()


def _serialized(message) -> bytes:
    if isinstance(message, (bytes, bytearray, memoryview)):
        return bytes(message)
    return message.SerializeToString()


class _UnaryMethod:
    def __init__(self, channel, name: str, response_cls):
        self._channel = channel
        self._path = f"/{SERVICE}/{name}"
        self._response_cls = response_cls

    async def __call__(self, request, metadata=None, timeout: Optional[float] = None,
                       compression: Optional[str] = None):
        raw = await self._channel.unary_unary(self._path, _serialized(request), metadata,
                                              timeout, compression)
        return self._response_cls.FromString(raw)


class StreamStreamCall:
    """A bidirectional call fed by an async iterator of requests."""

    def __init__(self, call, request_iterator, response_cls):
        self._call = call
        self._requests = request_iterator
        self._response_cls = response_cls
        self._writer: Optional[asyncio.Task] = None

    def _start(self) -> None:
        if self._writer is None:
            self._writer = asyncio.ensure_future(self._write_all())

    async def _write_all(self) -> None:
        try:
            async for request in self._requests:
                await self._call.write(_serialized(request))
            await self._call.done_writing()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - the read side reports the call's end
            pass

    async def read(self):
        """The next response message, or :data:`EOF` after the last."""
        self._start()
        raw = await self._call.read()
        if raw is None:
            return EOF
        return self._response_cls.FromString(raw)

    def cancel(self) -> bool:
        if self._writer is not None:
            self._writer.cancel()
        return self._call.cancel()

    def __aiter__(self):
        return self

    async def __anext__(self):
        response = await self.read()
        if response is EOF:
            raise StopAsyncIteration
        return response


class _StreamMethod:
    def __init__(self, channel, name: str, response_cls):
        self._channel = channel
        self._path = f"/{SERVICE}/{name}"
        self._response_cls = response_cls

    def __call__(self, request_iterator, metadata=None, timeout: Optional[float] = None,
                 compression: Optional[str] = None) -> StreamStreamCall:
        return StreamStreamCall(self.open(metadata, timeout, compression), request_iterator,
                                self._response_cls)

    def open(self, metadata=None, timeout: Optional[float] = None,
             compression: Optional[str] = None):
        """The transport call alone (``_h2.StreamCall``: write, read
        serialized messages), for callers that feed it themselves."""
        return self._channel.stream_stream(self._path, metadata, timeout, compression)


class GRPCInferenceServiceStub:
    """One attribute per method of the service, bound to a channel."""

    def __init__(self, channel):
        for name, (kind, _request_cls, response_cls) in METHODS.items():
            method = (_UnaryMethod if kind == "uu" else _StreamMethod)(
                channel, name, response_cls)
            setattr(self, name, method)
