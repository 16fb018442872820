"""An HTTP/2 gRPC transport on stdlib asyncio: h2c, or TLS with ALPN h2.

The port imports no ``grpcio``, so its gRPC clients speak HTTP/2
themselves: this module is their channel. It implements what a
gRPC client needs of RFC 7540 and RFC 7541:

* the connection preface, SETTINGS and their ACK, PING and its ACK (and
  keepalive PINGs for ``KeepAliveOptions``), GOAWAY, RST_STREAM;
* HEADERS with CONTINUATION, both ways;
* DATA under the connection and stream send windows, with WINDOW_UPDATE
  for what it receives;
* an HPACK encoder (literals without indexing and without Huffman, which
  every decoder reads) and a full decoder: static and dynamic tables,
  size updates and Huffman strings, as grpcio servers Huffman-encode.
  The Huffman code and the static table are read from the port's copy of
  ``csrc/frontend/hpack_tables.h``, the C++ server's own tables;
* gRPC's 5-byte message framing, ``grpc-timeout`` from the call's
  timeout, compressed requests (``grpc-encoding`` gzip or deflate, by
  stdlib ``zlib``), and trailers-only responses.

With an ``ssl.SSLContext`` (stdlib :mod:`ssl`;
``_utils.client_ssl_context`` builds one from the clients' arguments as
grpcio's ``ssl_channel_credentials`` would) the connection
is TLS: the context offers ALPN ``h2`` and a server that does not select
it fails the connection, UNAVAILABLE. Frames are read from the decrypted
byte stream, so TLS records that split or join HTTP/2 frames change
nothing.

:class:`Channel` is one connection per target, opened on first use and
again after it dies. ``unary_unary`` sends one message and returns the
response's; ``stream_stream`` opens a bidirectional call. Failures raise
:class:`~client_tpu_torch.grpc._utils.RpcError` with the gRPC status.
"""

import asyncio
import re
import ssl as _ssl
import struct
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from client_tpu_torch.grpc._utils import RpcError, StatusCode

# -- HPACK tables: the C++ front-end's own (csrc/frontend/hpack_tables.h) ----------

_TABLES = Path(__file__).resolve().parent.parent / "csrc" / "frontend" / "hpack_tables.h"


def _read_tables():
    text = _TABLES.read_text()

    def array(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
        return [int(v.rstrip("u"), 0) for v in re.findall(r"0x[0-9a-fA-F]+u?|\d+u?", body)]

    codes = array("kHuffmanCodes")
    lengths = array("kHuffmanLengths")
    body = re.search(r"kStaticTable\[61\] = \{(.*?)\};", text, re.S).group(1)
    static = re.findall(r'\{"([^"]*)", "([^"]*)"\}', body)
    assert len(codes) == len(lengths) == 257 and len(static) == 61
    return codes, lengths, static


_HUFFMAN_CODES, _HUFFMAN_LENGTHS, STATIC_TABLE = _read_tables()
_EOS = 256


def _huffman_tree():
    """Decoding table: (code length, code) -> symbol."""
    return {(length, code): sym
            for sym, (code, length) in enumerate(zip(_HUFFMAN_CODES, _HUFFMAN_LENGTHS))}


_HUFFMAN_BY_CODE = _huffman_tree()
_MIN_LEN = min(_HUFFMAN_LENGTHS)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = 0
    length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            if length >= _MIN_LEN:
                sym = _HUFFMAN_BY_CODE.get((length, code))
                if sym is not None:
                    if sym == _EOS:
                        raise ValueError("HPACK: EOS inside a Huffman string")
                    out.append(sym)
                    code = 0
                    length = 0
        if length > 30:
            raise ValueError("HPACK: bad Huffman code")
    # padding: up to 7 bits, all ones (a prefix of EOS)
    if length > 7 or code != (1 << length) - 1:
        raise ValueError("HPACK: bad Huffman padding")
    return bytes(out)


def _encode_int(out: bytearray, prefix_bits: int, flags: int, value: int) -> None:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        out.append(flags | value)
        return
    out.append(flags | limit)
    value -= limit
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("HPACK: truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 56:
            raise ValueError("HPACK: integer too large")


def hpack_encode(headers: Sequence[Tuple[str, str]]) -> bytes:
    """Literal header fields without indexing, new names, no Huffman."""
    out = bytearray()
    for name, value in headers:
        n = name.encode("ascii")
        v = value.encode("latin-1")
        out.append(0x00)
        _encode_int(out, 7, 0x00, len(n))
        out += n
        _encode_int(out, 7, 0x00, len(v))
        out += v
    return bytes(out)


class HpackDecoder:
    """RFC 7541 decoder: static + dynamic tables, size updates, Huffman."""

    def __init__(self, max_size: int = 4096):
        self._dynamic: List[Tuple[str, str]] = []  # newest first
        self._size = 0
        self._capacity = max_size
        self._protocol_max = max_size

    @staticmethod
    def _entry_size(name: str, value: str) -> int:
        return len(name.encode("latin-1")) + len(value.encode("latin-1")) + 32

    def _evict(self, target: int) -> None:
        while self._size > target and self._dynamic:
            name, value = self._dynamic.pop()
            self._size -= self._entry_size(name, value)

    def _insert(self, name: str, value: str) -> None:
        size = self._entry_size(name, value)
        if size > self._capacity:
            self._dynamic.clear()
            self._size = 0
            return
        self._evict(self._capacity - size)
        self._dynamic.insert(0, (name, value))
        self._size += size

    def _lookup(self, index: int) -> Tuple[str, str]:
        if index == 0:
            raise ValueError("HPACK: index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        index -= len(STATIC_TABLE) + 1
        if index >= len(self._dynamic):
            raise ValueError("HPACK: index out of range")
        return self._dynamic[index]

    @staticmethod
    def _string(data: bytes, pos: int) -> Tuple[str, int]:
        huffman = data[pos] & 0x80
        length, pos = _decode_int(data, pos, 7)
        raw = data[pos:pos + length]
        if len(raw) != length:
            raise ValueError("HPACK: truncated string")
        if huffman:
            raw = huffman_decode(raw)
        return raw.decode("latin-1"), pos + length

    def decode(self, data: bytes) -> List[Tuple[str, str]]:
        headers = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed
                index, pos = _decode_int(data, pos, 7)
                headers.append(self._lookup(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = _decode_int(data, pos, 6)
                if index:
                    name = self._lookup(index)[0]
                else:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                self._insert(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = _decode_int(data, pos, 5)
                if size > self._protocol_max:
                    raise ValueError("HPACK: table size update over the limit")
                self._capacity = size
                self._evict(size)
            else:  # literal without indexing / never indexed
                index, pos = _decode_int(data, pos, 4)
                if index:
                    name = self._lookup(index)[0]
                else:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                headers.append((name, value))
        return headers


# -- HTTP/2 frames -------------------------------------------------------------------

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
_RECV_WINDOW = (1 << 31) - 1
_WINDOW_TOPUP = 1 << 24
_MAX_MESSAGE = (1 << 31) - 1

# RST_STREAM error codes -> gRPC status (the gRPC HTTP/2 mapping)
_RST_STATUS = {
    0x7: StatusCode.UNAVAILABLE,  # REFUSED_STREAM
    0x8: StatusCode.CANCELLED,  # CANCEL
    0xB: StatusCode.RESOURCE_EXHAUSTED,  # ENHANCE_YOUR_CALM
    0xC: StatusCode.PERMISSION_DENIED,  # INADEQUATE_SECURITY
}


def _frame(kind: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return struct.pack(">I", len(payload))[1:] + bytes((kind, flags)) + \
        struct.pack(">I", stream_id & 0x7FFFFFFF) + payload


def grpc_timeout(seconds: float) -> str:
    """``grpc-timeout`` for a budget in seconds (at most 8 digits)."""
    micros = max(1, int(seconds * 1_000_000))
    for unit, scale in (("u", 1), ("m", 1000), ("S", 1_000_000), ("M", 60_000_000)):
        value = -(-micros // scale)
        if value < 100_000_000:
            return f"{value}{unit}"
    return f"{min(-(-micros // 3_600_000_000), 99_999_999)}H"


def _percent_decode(value: str) -> str:
    try:
        return re.sub(r"%([0-9A-Fa-f]{2})", lambda m: chr(int(m.group(1), 16)),
                      value).encode("latin-1").decode("utf-8", "replace")
    except UnicodeEncodeError:
        return value


class _Stream:
    """One HTTP/2 stream of a call: its inbound messages and status."""

    def __init__(self, conn: "_Connection", stream_id: int):
        self.conn = conn
        self.id = stream_id
        self.send_window = conn.peer_initial_window
        self.recv_consumed = 0
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.buf = bytearray()
        self.messages: asyncio.Queue = asyncio.Queue()
        self.closed_remote = False
        self.closed_local = False
        self.error: Optional[RpcError] = None
        self.done = asyncio.Event()

    # inbound, on the connection's reader

    def on_headers(self, headers, end_stream: bool) -> None:
        if self.headers is None and not any(n == "grpc-status" for n, _ in headers):
            self.headers = headers
            status = dict(headers).get(":status")
            if status is not None and status != "200":
                self.fail(RpcError(_http_status(status), f"HTTP status {status}"))
                return
        else:
            self.trailers = headers
            if self.headers is None:  # trailers-only
                self.headers = []
        if end_stream:
            self.finish()

    def on_data(self, data: bytes, end_stream: bool) -> None:
        self.buf += data
        while len(self.buf) >= 5:
            flag = self.buf[0]
            length = int.from_bytes(self.buf[1:5], "big")
            if len(self.buf) < 5 + length:
                break
            message = bytes(self.buf[5:5 + length])
            del self.buf[:5 + length]
            if flag:
                try:
                    message = zlib.decompress(message, 15 + 32)
                except zlib.error:
                    self.fail(RpcError(StatusCode.INTERNAL, "corrupt compressed message"))
                    return
            self.messages.put_nowait(message)
        if end_stream:
            self.finish()

    def finish(self) -> None:
        """The server closed its side: trailers decide the status."""
        self.closed_remote = True
        if self.error is None:
            trailers = dict(self.trailers or ())
            code = trailers.get("grpc-status")
            if code is None:
                self.error = RpcError(StatusCode.INTERNAL,
                                      "server closed the stream without a grpc-status")
            elif code != "0":
                self.error = RpcError(StatusCode.from_int(int(code)),
                                      _percent_decode(trailers.get("grpc-message", "")),
                                      trailing_metadata=tuple(self.trailers or ()))
            elif self.buf:
                self.error = RpcError(StatusCode.INTERNAL, "truncated gRPC message")
        self._ended()

    def fail(self, error: RpcError) -> None:
        if self.error is None:
            self.error = error
        self.closed_remote = True
        self._ended()

    def _ended(self) -> None:
        self.messages.put_nowait(None)
        self.done.set()
        self.conn.window_changed.set()  # a sender blocked on the window stops
        self.conn.forget(self)


def _http_status(status: str) -> StatusCode:
    return {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
            "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
            "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
            "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}.get(
                status, StatusCode.UNKNOWN)


class _Connection:
    """One h2c connection: a reader task and a write lock."""

    def __init__(self, reader, writer, authority: str, keepalive=None):
        self.reader = reader
        self.writer = writer
        self.authority = authority
        self.streams: Dict[int, _Stream] = {}
        self.next_id = 1
        self.peer_initial_window = 65535
        self.peer_max_frame = 16384
        self.conn_send_window = 65535
        self.recv_consumed = 0
        self.decoder = HpackDecoder()
        self.window_changed = asyncio.Event()
        self.write_lock = asyncio.Lock()
        self.closed = False
        self.goaway_last: Optional[int] = None
        self.close_reason = "connection closed"
        self.ping_acks: Dict[bytes, asyncio.Future] = {}
        self._reader_task = asyncio.ensure_future(self._read_loop())
        self._keepalive_task = (asyncio.ensure_future(self._keepalive(keepalive))
                                if keepalive is not None
                                and keepalive.keepalive_time_ms < 2**31 - 1 else None)

    @classmethod
    async def open(cls, host: str, port: int, timeout: Optional[float], keepalive=None,
                   ssl_context: Optional[_ssl.SSLContext] = None):
        tls = {} if ssl_context is None else {"ssl": ssl_context, "server_hostname": host}
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port, limit=1 << 22, **tls), timeout)
        except (OSError, asyncio.TimeoutError) as e:
            # ssl.SSLError (a failed handshake, a certificate that does not
            # verify) is an OSError too
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to {host}:{port}: {e or type(e).__name__}") from None
        if ssl_context is not None:
            tls_object = writer.get_extra_info("ssl_object")
            selected = tls_object.selected_alpn_protocol() if tls_object else None
            if selected != "h2":
                writer.close()
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect to {host}:{port}: the server did not "
                               f"select ALPN h2 (selected {selected!r})")
        conn = cls(reader, writer, f"{host}:{port}", keepalive)
        settings = struct.pack(">HI", SETTINGS_ENABLE_PUSH, 0) + \
            struct.pack(">HI", SETTINGS_INITIAL_WINDOW_SIZE, _RECV_WINDOW)
        writer.write(PREFACE + _frame(SETTINGS, 0, 0, settings) +
                     _frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", _RECV_WINDOW - 65535)))
        return conn

    @property
    def usable(self) -> bool:
        return not self.closed and self.goaway_last is None and self.next_id < (1 << 31) - 2

    # -- writing --------------------------------------------------------------------

    async def _write(self, data: bytes) -> None:
        if self.closed:
            raise RpcError(StatusCode.UNAVAILABLE, self.close_reason)
        self.writer.write(data)
        try:
            await self.writer.drain()
        except (OSError, RuntimeError) as e:
            self._close(f"connection lost: {e}")
            raise RpcError(StatusCode.UNAVAILABLE, self.close_reason) from None

    async def open_stream(self, headers: Sequence[Tuple[str, str]],
                          end_stream: bool) -> _Stream:
        async with self.write_lock:
            if not self.usable:
                raise RpcError(StatusCode.UNAVAILABLE, self.close_reason)
            stream = _Stream(self, self.next_id)
            self.next_id += 2
            self.streams[stream.id] = stream
            block = hpack_encode(headers)
            max_frame = self.peer_max_frame
            first, rest = block[:max_frame], block[max_frame:]
            flags = (FLAG_END_STREAM if end_stream else 0) | (0 if rest else FLAG_END_HEADERS)
            frames = [_frame(HEADERS, flags, stream.id, first)]
            while rest:
                chunk, rest = rest[:max_frame], rest[max_frame:]
                frames.append(_frame(CONTINUATION, 0 if rest else FLAG_END_HEADERS,
                                     stream.id, chunk))
            if end_stream:
                stream.closed_local = True
            await self._write(b"".join(frames))
            return stream

    async def send_data(self, stream: _Stream, data: bytes, end_stream: bool) -> None:
        view = memoryview(data)
        while True:
            if stream.done.is_set():
                if stream.error is not None:
                    raise stream.error
                return  # the server answered before taking it all
            async with self.write_lock:
                if self.closed:
                    raise RpcError(StatusCode.UNAVAILABLE, self.close_reason)
                avail = min(self.conn_send_window, stream.send_window, self.peer_max_frame)
                if len(view) == 0 or avail > 0:
                    n = min(avail, len(view))
                    chunk, view = view[:n], view[n:]
                    last = end_stream and len(view) == 0
                    self.conn_send_window -= n
                    stream.send_window -= n
                    if last:
                        stream.closed_local = True
                    await self._write(_frame(DATA, FLAG_END_STREAM if last else 0,
                                             stream.id, bytes(chunk)))
                    if len(view) == 0:
                        return
                    continue
                self.window_changed.clear()
            await self.window_changed.wait()

    async def reset(self, stream: _Stream, code: int = 0x8) -> None:
        self.forget(stream)
        if self.closed or stream.closed_remote and stream.closed_local:
            return
        try:
            async with self.write_lock:
                await self._write(_frame(RST_STREAM, 0, stream.id, struct.pack(">I", code)))
        except RpcError:
            pass

    def forget(self, stream: _Stream) -> None:
        self.streams.pop(stream.id, None)

    # -- reading --------------------------------------------------------------------

    async def _read_loop(self) -> None:
        header_block = bytearray()
        header_stream = 0
        header_end_stream = False
        try:
            while True:
                head = await self.reader.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                kind, flags = head[3], head[4]
                stream_id = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
                payload = await self.reader.readexactly(length) if length else b""
                if header_stream and kind != CONTINUATION:
                    raise ValueError("expected CONTINUATION")
                if kind == DATA:
                    self._on_data(stream_id, flags, payload)
                elif kind in (HEADERS, CONTINUATION):
                    if kind == HEADERS:
                        payload = _strip_padding(payload, flags)
                        if flags & FLAG_PRIORITY:
                            payload = payload[5:]
                        header_stream = stream_id
                        header_end_stream = bool(flags & FLAG_END_STREAM)
                        header_block = bytearray(payload)
                    else:
                        header_block += payload
                    if flags & FLAG_END_HEADERS:
                        headers = self.decoder.decode(bytes(header_block))
                        stream = self.streams.get(header_stream)
                        header_stream = 0
                        if stream is not None:
                            stream.on_headers(headers, header_end_stream)
                elif kind == SETTINGS:
                    if not flags & FLAG_ACK:
                        self._on_settings(payload)
                        self.writer.write(_frame(SETTINGS, FLAG_ACK, 0))
                elif kind == WINDOW_UPDATE:
                    increment = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
                    if stream_id == 0:
                        self.conn_send_window += increment
                    elif stream_id in self.streams:
                        self.streams[stream_id].send_window += increment
                    self.window_changed.set()
                elif kind == PING:
                    if flags & FLAG_ACK:
                        future = self.ping_acks.pop(payload, None)
                        if future is not None and not future.done():
                            future.set_result(True)
                    else:
                        self.writer.write(_frame(PING, FLAG_ACK, 0, payload))
                elif kind == RST_STREAM:
                    stream = self.streams.get(stream_id)
                    if stream is not None:
                        code = int.from_bytes(payload[:4], "big")
                        stream.fail(RpcError(_RST_STATUS.get(code, StatusCode.INTERNAL),
                                             f"stream reset by the server (code {code})"))
                elif kind == GOAWAY:
                    last = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
                    code = int.from_bytes(payload[4:8], "big")
                    self.goaway_last = last
                    self.close_reason = f"the server sent GOAWAY (code {code})"
                    for sid, stream in list(self.streams.items()):
                        if sid > last:
                            stream.fail(RpcError(StatusCode.UNAVAILABLE, self.close_reason))
                # PRIORITY, PUSH_PROMISE (refused by ENABLE_PUSH 0), unknown: ignored
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self._close("connection closed by the server")
        except ValueError as e:
            self._close(f"protocol error: {e}")
        except asyncio.CancelledError:
            self._close("connection closed")
            raise

    def _on_data(self, stream_id: int, flags: int, payload: bytes) -> None:
        size = len(payload)
        payload = _strip_padding(payload, flags)
        self.recv_consumed += size
        updates = b""
        if self.recv_consumed >= _WINDOW_TOPUP:
            updates += _frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self.recv_consumed))
            self.recv_consumed = 0
        stream = self.streams.get(stream_id)
        if stream is not None:
            stream.recv_consumed += size
            if stream.recv_consumed >= _WINDOW_TOPUP and not flags & FLAG_END_STREAM:
                updates += _frame(WINDOW_UPDATE, 0, stream_id,
                                  struct.pack(">I", stream.recv_consumed))
                stream.recv_consumed = 0
            stream.on_data(payload, bool(flags & FLAG_END_STREAM))
        if updates:
            self.writer.write(updates)

    def _on_settings(self, payload: bytes) -> None:
        for i in range(0, len(payload) - len(payload) % 6, 6):
            key, value = struct.unpack(">HI", payload[i:i + 6])
            if key == SETTINGS_INITIAL_WINDOW_SIZE:
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta
                self.window_changed.set()
            elif key == SETTINGS_MAX_FRAME_SIZE:
                self.peer_max_frame = value

    async def ping(self, timeout: float) -> bool:
        data = struct.pack(">Q", time.monotonic_ns() & (2**64 - 1))
        future = asyncio.get_running_loop().create_future()
        self.ping_acks[data] = future
        try:
            async with self.write_lock:
                await self._write(_frame(PING, 0, 0, data))
            await asyncio.wait_for(future, timeout)
            return True
        except (RpcError, asyncio.TimeoutError):
            return False
        finally:
            self.ping_acks.pop(data, None)

    async def _keepalive(self, options) -> None:
        """PING every ``keepalive_time_ms`` (while calls are open, or
        always with ``keepalive_permit_without_calls``); a PING not
        answered within ``keepalive_timeout_ms`` closes the connection,
        failing its calls with UNAVAILABLE."""
        while not self.closed:
            await asyncio.sleep(options.keepalive_time_ms / 1000)
            if not self.streams and not options.keepalive_permit_without_calls:
                continue
            if not await self.ping(options.keepalive_timeout_ms / 1000):
                self._close("keepalive watchdog timeout")
                return

    def _close(self, reason: str) -> None:
        if self.closed:
            return
        self.closed = True
        self.close_reason = reason
        self.window_changed.set()
        for stream in list(self.streams.values()):
            stream.fail(RpcError(StatusCode.UNAVAILABLE, reason))
        self.streams.clear()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 - already gone
            pass

    async def close(self) -> None:
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if not self.closed:
            try:
                async with self.write_lock:
                    self.writer.write(_frame(GOAWAY, 0, 0, struct.pack(">II", 0, 0)))
            except Exception:  # noqa: BLE001
                pass
        self._close("channel closed")
        self._reader_task.cancel()
        try:
            await self._reader_task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass


def _strip_padding(payload: bytes, flags: int) -> bytes:
    if flags & FLAG_PADDED:
        pad = payload[0]
        return payload[1:len(payload) - pad]
    return payload


def _frame_message(message: bytes, compression: Optional[str]) -> bytes:
    if compression in ("gzip", "deflate"):
        if compression == "gzip":
            c = zlib.compressobj(wbits=31)
        else:
            c = zlib.compressobj()
        body = c.compress(message) + c.flush()
        return b"\x01" + len(body).to_bytes(4, "big") + body
    if len(message) > _MAX_MESSAGE:
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED, "message larger than 2 GiB")
    return b"\x00" + len(message).to_bytes(4, "big") + message


def _reset_when_open(opening: asyncio.Future) -> None:
    """A stream cancelled while it was opening: reset it once open."""
    if not opening.cancelled() and opening.exception() is None:
        stream = opening.result()
        asyncio.ensure_future(stream.conn.reset(stream))


class StreamCall:
    """A bidirectional call: :meth:`write` messages, :meth:`done_writing`,
    :meth:`read` responses until ``None`` (the end), :meth:`cancel`."""

    def __init__(self, channel: "Channel", method: str, metadata, timeout, compression):
        self._channel = channel
        self._method = method
        self._metadata = metadata
        self._timeout = timeout
        self._compression = compression
        self._stream: Optional[_Stream] = None
        self._deadline = None if timeout is None else time.monotonic() + timeout
        self._opening: Optional[asyncio.Future] = None
        self._cancelled = False

    async def _ensure_open(self) -> _Stream:
        if self._stream is None:
            if self._opening is None:
                self._opening = asyncio.ensure_future(self._channel._open(
                    self._method, self._metadata, self._timeout, self._compression,
                    end_stream=False))
            self._stream = await asyncio.shield(self._opening)
        return self._stream

    def _remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    async def write(self, message: bytes) -> None:
        stream = await self._ensure_open()
        if self._cancelled:
            raise RpcError(StatusCode.CANCELLED, "call cancelled")
        await stream.conn.send_data(stream, _frame_message(message, self._compression), False)

    async def done_writing(self) -> None:
        stream = await self._ensure_open()
        if not stream.closed_local and not stream.closed_remote:
            await stream.conn.send_data(stream, b"", True)

    async def read(self) -> Optional[bytes]:
        """The next response message, or None once the call ended OK;
        raises RpcError when it ended otherwise."""
        stream = await self._ensure_open()
        remaining = self._remaining()
        try:
            if remaining is None:
                message = await stream.messages.get()
            else:
                message = await asyncio.wait_for(stream.messages.get(), max(remaining, 0))
        except asyncio.TimeoutError:
            await stream.conn.reset(stream)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        if message is None:
            stream.messages.put_nowait(None)  # later reads see the end too
            if self._cancelled:
                raise RpcError(StatusCode.CANCELLED, "Locally cancelled by application!")
            if stream.error is not None:
                raise stream.error
            return None
        return message

    def cancel(self) -> bool:
        if self._cancelled:
            return False
        self._cancelled = True
        stream = self._stream
        if stream is not None and not stream.done.is_set():
            asyncio.ensure_future(stream.conn.reset(stream))
            stream.fail(RpcError(StatusCode.CANCELLED, "Locally cancelled by application!"))
        elif self._opening is not None and not self._opening.done():
            self._opening.add_done_callback(_reset_when_open)
        return True


class Channel:
    """One HTTP/2 connection to ``target`` (``host:port``), h2c or over
    ``ssl_context``, opened on first use and again after it dies; calls
    multiplex on it. Over TLS the server's certificate must name the
    target's host."""

    def __init__(self, target: str, keepalive=None, user_agent: str = "client-tpu-torch-grpc",
                 max_send_message_length: int = _MAX_MESSAGE,
                 max_receive_message_length: int = _MAX_MESSAGE,
                 ssl_context: Optional[_ssl.SSLContext] = None):
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"gRPC target must be host:port, got {target!r}")
        self.target = target
        self._host = host.strip("[]")
        self._port = int(port)
        self._keepalive = keepalive
        self._user_agent = user_agent
        self._max_send = max_send_message_length
        self._max_receive = max_receive_message_length
        self._ssl_context = ssl_context
        self._scheme = "http" if ssl_context is None else "https"
        self._conn: Optional[_Connection] = None
        self._connecting: Optional[asyncio.Future] = None

    async def _connection(self, timeout: Optional[float]) -> _Connection:
        conn = self._conn
        if conn is not None and conn.usable:
            return conn
        if self._connecting is None or self._connecting.done():
            self._connecting = asyncio.ensure_future(
                _Connection.open(self._host, self._port, timeout, self._keepalive,
                                 self._ssl_context))
        try:
            conn = await asyncio.shield(self._connecting)
        finally:
            if self._connecting is not None and self._connecting.done():
                self._connecting = None
        old, self._conn = self._conn, conn
        if old is not None and old is not conn:
            asyncio.ensure_future(old.close())
        return conn

    def _headers(self, method: str, metadata, timeout, compression) -> List[Tuple[str, str]]:
        headers = [(":method", "POST"), (":scheme", self._scheme), (":path", method),
                   (":authority", self.target), ("content-type", "application/grpc"),
                   ("te", "trailers"), ("user-agent", self._user_agent),
                   ("grpc-accept-encoding", "identity,deflate,gzip")]
        if timeout is not None:
            headers.append(("grpc-timeout", grpc_timeout(timeout)))
        if compression in ("gzip", "deflate"):
            headers.append(("grpc-encoding", compression))
        for key, value in metadata or ():
            headers.append((key.lower(), str(value)))
        return headers

    async def _open(self, method, metadata, timeout, compression, end_stream) -> _Stream:
        if timeout is not None and timeout <= 0:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        conn = await self._connection(timeout)
        return await conn.open_stream(self._headers(method, metadata, timeout, compression),
                                      end_stream)

    async def unary_unary(self, method: str, request: bytes, metadata=None,
                          timeout: Optional[float] = None,
                          compression: Optional[str] = None) -> bytes:
        """One request message, one response message."""
        if len(request) > self._max_send:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"Sent message larger than max ({len(request)} vs. {self._max_send})")
        deadline = None if timeout is None else time.monotonic() + timeout
        stream = None
        try:
            stream = await self._open(method, metadata, timeout, compression, False)
            await asyncio.wait_for(
                stream.conn.send_data(stream, _frame_message(request, compression), True),
                None if deadline is None else max(deadline - time.monotonic(), 0))
            remaining = None if deadline is None else max(deadline - time.monotonic(), 0)
            await asyncio.wait_for(stream.done.wait(), remaining)
        except asyncio.TimeoutError:
            if stream is not None:
                await stream.conn.reset(stream)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        except asyncio.CancelledError:
            if stream is not None:
                await asyncio.shield(stream.conn.reset(stream))
            raise
        if stream.error is not None:
            raise stream.error
        messages = []
        while not stream.messages.empty():
            message = stream.messages.get_nowait()
            if message is not None:
                messages.append(message)
        if len(messages) != 1:
            raise RpcError(StatusCode.INTERNAL,
                           f"expected one response message, got {len(messages)}")
        if len(messages[0]) > self._max_receive:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED, "Received message larger than max")
        return messages[0]

    def stream_stream(self, method: str, metadata=None, timeout: Optional[float] = None,
                      compression: Optional[str] = None) -> StreamCall:
        return StreamCall(self, method, metadata, timeout, compression)

    async def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()
