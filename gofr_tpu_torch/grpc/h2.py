"""HTTP/2 over cleartext with prior knowledge (RFC 9113), the transport of
the port's gRPC.

:class:`H2Core` is the state both halves share, with no I/O: the frame
codec, the settings of each side, the HPACK contexts, and flow control.
It parses what the peer sends into events, answers ``SETTINGS`` and
``PING`` itself, and returns the connection's receive credit as soon as
``DATA`` arrives, so a stream whose reader stalls holds back only its own
window. Stream credit goes back as the stream's reader consumes
(:meth:`H2Core.consumed`). On the send side it tracks the connection's and
each stream's window and the peer's ``SETTINGS_MAX_FRAME_SIZE``.

:class:`ServerConnection` is the asyncio half. One connection's writes all
go through its event loop, each frame run (``HEADERS`` with its
``CONTINUATION`` frames, a ``DATA`` frame) as one ``transport.write``, so no
other stream's frame can split a header block. :class:`ClientConnection` is
the threaded half: a reader thread and a write lock that holds a whole
frame run.
"""

from __future__ import annotations

import asyncio
import queue
import socket
import struct
import threading
from typing import Awaitable, Callable, Optional

from gofr_tpu_torch.grpc import hpack

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 0x5, 0x6, 0x7, 0x8, 0x9

END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20

HEADER_TABLE_SIZE, ENABLE_PUSH, INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE = 0x1, 0x2, 0x4, 0x5

NO_ERROR, PROTOCOL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x3
FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = 0x6, 0x7, 0x8, 0x9
ENHANCE_YOUR_CALM = 0xB

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = 2**31 - 1
# What this side lets a peer send: each stream's window (the initial
# window setting) and the connection's (raised by a WINDOW_UPDATE at
# start). Credit goes back once a quarter of a window is consumed.
LOCAL_STREAM_WINDOW = 1 << 22
LOCAL_CONN_WINDOW = 1 << 24


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes((ftype, flags))
            + (stream_id & 0x7FFFFFFF).to_bytes(4, "big") + payload)


class H2Error(Exception):
    """A connection error: the connection ends with GOAWAY(code)."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


class H2Core:
    """One connection's state, either half, no I/O."""

    def __init__(self, client: bool) -> None:
        self.client = client
        self.encoder = hpack.Encoder()
        self.decoder = hpack.Decoder()
        self.peer = {HEADER_TABLE_SIZE: 4096, INITIAL_WINDOW_SIZE: DEFAULT_WINDOW,
                     MAX_FRAME_SIZE: DEFAULT_MAX_FRAME}
        self.send_window = DEFAULT_WINDOW  # the connection's, granted by the peer
        self.stream_windows: dict[int, int] = {}  # each open stream's send window
        self._consumed: dict[int, int] = {}  # stream credit not yet returned
        self._conn_unacked = 0
        self._buf = bytearray()
        self._need_preface = not client
        self._block: Optional[tuple] = None  # (stream id, end_stream, bytearray)
        self.out = bytearray()  # frames the core queues: acks, credit

    def preamble(self) -> bytes:
        settings = {INITIAL_WINDOW_SIZE: LOCAL_STREAM_WINDOW}
        if self.client:
            settings[ENABLE_PUSH] = 0
        payload = b"".join(struct.pack(">HI", k, v) for k, v in settings.items())
        return ((PREFACE if self.client else b"") + frame(SETTINGS, 0, 0, payload)
                + frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", LOCAL_CONN_WINDOW - DEFAULT_WINDOW)))

    # -- send side ----------------------------------------------------------

    def open_stream(self, stream_id: int) -> None:
        self.stream_windows[stream_id] = self.peer[INITIAL_WINDOW_SIZE]

    def close_stream(self, stream_id: int) -> None:
        self.stream_windows.pop(stream_id, None)
        self._consumed.pop(stream_id, None)

    def headers(self, stream_id: int, headers: list, end_stream: bool) -> bytes:
        """A HEADERS frame and as many CONTINUATION frames as the peer's
        frame size needs: one run, to be written whole."""
        block = self.encoder.encode(headers)
        size = self.peer[MAX_FRAME_SIZE]
        chunks = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        flags = END_STREAM if end_stream else 0
        out = bytearray()
        for i, chunk in enumerate(chunks):
            last = END_HEADERS if i == len(chunks) - 1 else 0
            out += frame(HEADERS if i == 0 else CONTINUATION,
                         (flags if i == 0 else 0) | last, stream_id, chunk)
        return bytes(out)

    def sendable(self, stream_id: int, want: int) -> int:
        """How many DATA bytes the windows and frame size allow now."""
        return max(0, min(want, self.send_window, self.stream_windows.get(stream_id, 0),
                          self.peer[MAX_FRAME_SIZE]))

    def data(self, stream_id: int, chunk: bytes, end_stream: bool) -> bytes:
        self.send_window -= len(chunk)
        if stream_id in self.stream_windows:
            self.stream_windows[stream_id] -= len(chunk)
        return frame(DATA, END_STREAM if end_stream else 0, stream_id, chunk)

    # -- receive side -------------------------------------------------------

    def consumed(self, stream_id: int, n: int) -> None:
        """The stream's reader took ``n`` bytes: return stream credit once a
        quarter window has gathered."""
        if stream_id not in self._consumed:
            return
        total = self._consumed[stream_id] + n
        if total >= LOCAL_STREAM_WINDOW // 4:
            self.out += frame(WINDOW_UPDATE, 0, stream_id, struct.pack(">I", total))
            total = 0
        self._consumed[stream_id] = total

    def track(self, stream_id: int) -> None:
        """Start returning credit for a stream the peer sends on."""
        self._consumed.setdefault(stream_id, 0)

    def untrack(self, stream_id: int) -> None:
        self._consumed.pop(stream_id, None)

    def feed(self, data: bytes) -> list[tuple]:
        """Parse what arrived. Events: ``("headers", id, headers,
        end_stream)``, ``("data", id, bytes, end_stream)``, ``("reset", id,
        code)``, ``("window", id)`` (0 = the connection or every stream),
        ``("goaway", last_id, code)``. Raises :class:`H2Error`."""
        self._buf += data
        events: list[tuple] = []
        if self._need_preface:
            if len(self._buf) < len(PREFACE):
                if not PREFACE.startswith(bytes(self._buf)):
                    raise H2Error(PROTOCOL_ERROR, "not an HTTP/2 preface")
                return events
            if bytes(self._buf[:len(PREFACE)]) != PREFACE:
                raise H2Error(PROTOCOL_ERROR, "not an HTTP/2 preface")
            del self._buf[:len(PREFACE)]
            self._need_preface = False
        while len(self._buf) >= 9:
            length = int.from_bytes(self._buf[:3], "big")
            if length > DEFAULT_MAX_FRAME:  # the size this side advertises
                raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes")
            if len(self._buf) < 9 + length:
                break
            ftype, flags = self._buf[3], self._buf[4]
            stream_id = int.from_bytes(self._buf[5:9], "big") & 0x7FFFFFFF
            payload = bytes(self._buf[9:9 + length])
            del self._buf[:9 + length]
            self._frame(ftype, flags, stream_id, payload, events)
        return events

    def _unpad(self, flags: int, payload: bytes) -> bytes:
        if not flags & PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise H2Error(PROTOCOL_ERROR, "padding longer than the frame")
        return payload[1:len(payload) - payload[0]]

    def _frame(self, ftype: int, flags: int, sid: int, payload: bytes, events: list) -> None:
        if self._block is not None and ftype != CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "a header block was interrupted")
        if ftype == DATA:
            if sid == 0:
                raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
            self._conn_unacked += len(payload)
            if self._conn_unacked >= LOCAL_CONN_WINDOW // 4:
                self.out += frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self._conn_unacked))
                self._conn_unacked = 0
            body = self._unpad(flags, payload)
            padding = len(payload) - len(body)
            if padding and not flags & END_STREAM:
                self.consumed(sid, padding)  # padding is never read
            events.append(("data", sid, body, bool(flags & END_STREAM)))
        elif ftype in (HEADERS, CONTINUATION):
            if ftype == HEADERS:
                if sid == 0:
                    raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
                body = self._unpad(flags, payload)
                if flags & PRIORITY_FLAG:
                    body = body[5:]
                self._block = (sid, bool(flags & END_STREAM), bytearray(body))
            else:
                if self._block is None or self._block[0] != sid:
                    raise H2Error(PROTOCOL_ERROR, "CONTINUATION without its HEADERS")
                self._block[2].extend(payload)
            if len(self._block[2]) > hpack.MAX_HEADER_LIST:
                raise H2Error(ENHANCE_YOUR_CALM, f"header block past {hpack.MAX_HEADER_LIST} bytes")
            if flags & END_HEADERS:
                bsid, end, block = self._block
                self._block = None
                try:
                    decoded = self.decoder.decode(bytes(block))
                except hpack.HeaderListTooLarge as exc:
                    raise H2Error(ENHANCE_YOUR_CALM, str(exc)) from exc
                except hpack.HPACKError as exc:
                    raise H2Error(COMPRESSION_ERROR, str(exc)) from exc
                events.append(("headers", bsid, decoded, end))
        elif ftype == RST_STREAM:
            if sid == 0 or len(payload) != 4:
                raise H2Error(PROTOCOL_ERROR, "malformed RST_STREAM")
            self.close_stream(sid)
            events.append(("reset", sid, struct.unpack(">I", payload)[0]))
        elif ftype == SETTINGS:
            if sid != 0:
                raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
            if flags & ACK:
                return
            if len(payload) % 6:
                raise H2Error(FRAME_SIZE_ERROR, "SETTINGS of a partial entry")
            for off in range(0, len(payload), 6):
                key, value = struct.unpack_from(">HI", payload, off)
                self._setting(key, value)
            self.out += frame(SETTINGS, ACK, 0)
            events.append(("window", 0))
        elif ftype == PING:
            if sid != 0 or len(payload) != 8:
                raise H2Error(PROTOCOL_ERROR, "malformed PING")
            if not flags & ACK:
                self.out += frame(PING, ACK, 0, payload)
        elif ftype == GOAWAY:
            if len(payload) < 8:
                raise H2Error(FRAME_SIZE_ERROR, "short GOAWAY")
            last, code = struct.unpack_from(">II", payload)
            events.append(("goaway", last & 0x7FFFFFFF, code))
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2Error(FRAME_SIZE_ERROR, "malformed WINDOW_UPDATE")
            inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
            if sid == 0:
                if inc == 0:
                    raise H2Error(PROTOCOL_ERROR, "zero WINDOW_UPDATE")
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "connection window overflow")
            elif sid in self.stream_windows:
                if inc == 0:
                    self.close_stream(sid)
                    self.out += frame(RST_STREAM, 0, sid, struct.pack(">I", PROTOCOL_ERROR))
                    events.append(("reset", sid, PROTOCOL_ERROR))
                    return
                self.stream_windows[sid] += inc
            events.append(("window", sid))
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE is not enabled")
        # PRIORITY and unknown frame types are ignored (RFC 9113 §5.5).

    def _setting(self, key: int, value: int) -> None:
        if key == INITIAL_WINDOW_SIZE:
            if value > MAX_WINDOW:
                raise H2Error(FLOW_CONTROL_ERROR, "initial window above 2^31-1")
            delta = value - self.peer[INITIAL_WINDOW_SIZE]
            for sid in self.stream_windows:
                self.stream_windows[sid] += delta
        elif key == MAX_FRAME_SIZE and not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
            raise H2Error(PROTOCOL_ERROR, "max frame size out of range")
        elif key == HEADER_TABLE_SIZE and value != self.peer[HEADER_TABLE_SIZE]:
            self.encoder.peer_table_size_changed()
        elif key == ENABLE_PUSH and value > 1:
            raise H2Error(PROTOCOL_ERROR, "ENABLE_PUSH above 1")
        self.peer[key] = value

    def goaway_frame(self, last_stream_id: int, code: int = NO_ERROR, debug: bytes = b"") -> bytes:
        return frame(GOAWAY, 0, 0, struct.pack(">II", last_stream_id, code) + debug)


class StreamReset(Exception):
    """The stream ended under the writer: a reset, or the connection closed."""


class ServerStream:
    def __init__(self, stream_id: int, headers: list) -> None:
        self.id = stream_id
        self.headers = headers
        self.body = bytearray()
        self.remote_ended = False  # the peer sent END_STREAM
        self.dispatched = False  # handed to on_request
        self.overflow = False  # the body passed max_body: it holds its first 5 bytes only
        self.closed = False  # reset, ended by this side, or connection gone
        self.on_reset: Optional[Callable[[int], None]] = None


class ServerConnection:
    """The asyncio half: ``on_request(conn, stream)`` runs as a task once a
    request's headers and body have ended, or as soon as its body passes
    ``max_body`` bytes (``stream.overflow``; the rest of the body is
    dropped, and the stream is reset with NO_ERROR once the reply ends)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 on_request: Callable[["ServerConnection", ServerStream], Awaitable[None]],
                 max_body: int) -> None:
        self.reader, self.writer = reader, writer
        self.max_body = max_body
        self.core = H2Core(client=False)
        self.on_request = on_request
        self.streams: dict[int, ServerStream] = {}
        self.last_stream_id = 0
        self.closed = False
        self.tasks: set[asyncio.Task] = set()
        self._window = asyncio.Event()

    def _write(self, data: bytes) -> None:
        if not self.closed and data:
            self.writer.write(data)

    def _flush_core(self) -> None:
        if self.core.out:
            self._write(bytes(self.core.out))
            self.core.out.clear()

    async def serve(self) -> None:
        try:
            self._write(self.core.preamble())
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    break
                try:
                    events = self.core.feed(data)
                except H2Error as exc:
                    self._write(self.core.goaway_frame(self.last_stream_id, exc.code,
                                                       str(exc).encode()))
                    break
                for event in events:
                    self._event(event)
                # No drain here: the reader keeps reading while the stream
                # tasks wait on the transport, so a peer blocked writing
                # its request never waits on this side's replies.
                self._flush_core()
        except (ConnectionError, OSError):
            pass
        finally:
            self._close()

    def _event(self, event: tuple) -> None:
        kind, sid = event[0], event[1]
        if kind == "headers":
            stream = self.streams.get(sid)
            if stream is None:
                if sid % 2 == 0 or sid <= self.last_stream_id:
                    return  # trailers of a stream this side has ended
                self.last_stream_id = sid
                stream = self.streams[sid] = ServerStream(sid, event[2])
                self.core.open_stream(sid)
                self.core.track(sid)
            if event[3]:
                stream.remote_ended = True
                self._dispatch(stream)
        elif kind == "data":
            stream = self.streams.get(sid)
            self.core.consumed(sid, len(event[2]))
            if stream is None:
                return
            stream.remote_ended = stream.remote_ended or event[3]
            if stream.dispatched:
                return
            stream.body += event[2]
            if len(stream.body) > self.max_body:
                stream.overflow = True
                del stream.body[5:]
                self._dispatch(stream)
            elif event[3]:
                self._dispatch(stream)
        elif kind == "reset":
            stream = self.streams.pop(sid, None)
            if stream is not None:
                self._reset(stream, event[2])
        elif kind == "window":
            self._window.set()

    def _dispatch(self, stream: ServerStream) -> None:
        if stream.dispatched:
            return
        stream.dispatched = True
        self.core.untrack(stream.id)  # the request has ended
        task = asyncio.get_running_loop().create_task(self.on_request(self, stream))
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    def _reset(self, stream: ServerStream, code: int) -> None:
        stream.closed = True
        self._window.set()
        if stream.on_reset is not None:
            stream.on_reset(code)

    def _close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for stream in list(self.streams.values()):
            self._reset(stream, CANCEL)
        self.streams.clear()
        self._window.set()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 — the transport is already gone
            pass

    # -- writes from the stream tasks ----------------------------------------

    async def send_headers(self, stream: ServerStream, headers: list, end_stream: bool = False) -> None:
        if stream.closed or self.closed:
            raise StreamReset(stream.id)
        self._write(self.core.headers(stream.id, headers, end_stream))
        if end_stream:
            self._end(stream)
        await self.writer.drain()

    async def send_data(self, stream: ServerStream, data: bytes, end_stream: bool = False) -> None:
        view = memoryview(data)
        while True:
            if stream.closed or self.closed:
                raise StreamReset(stream.id)
            n = self.core.sendable(stream.id, len(view))
            if n == 0 and len(view):
                self._window.clear()
                await self._window.wait()
                continue
            last = n == len(view)
            self._write(self.core.data(stream.id, bytes(view[:n]), end_stream and last))
            view = view[n:]
            await self.writer.drain()
            if last:
                break
        if end_stream:
            self._end(stream)

    def reset(self, stream: ServerStream, code: int = CANCEL) -> None:
        if not stream.closed:
            self._write(frame(RST_STREAM, 0, stream.id, struct.pack(">I", code)))
            self._end(stream, reset=True)

    def _end(self, stream: ServerStream, reset: bool = False) -> None:
        if not reset and not stream.remote_ended:
            # The reply is whole and the rest of the request is not wanted
            # (RFC 9113 §8.1).
            self._write(frame(RST_STREAM, 0, stream.id, struct.pack(">I", NO_ERROR)))
        stream.closed = True
        self.streams.pop(stream.id, None)
        self.core.close_stream(stream.id)

    async def goaway(self) -> None:
        self._write(self.core.goaway_frame(self.last_stream_id))
        try:
            await self.writer.drain()
        except (ConnectionError, OSError):
            pass

    def abort(self) -> None:
        self._close()


class ClientStream:
    """A request stream on the client half. Events arrive on ``events``:
    ``("headers", list)``, ``("data", bytes)``, ``("end",)``, ``("reset",
    code)`` and ``("closed", message)``."""

    def __init__(self, conn: "ClientConnection", stream_id: int) -> None:
        self.conn = conn
        self.id = stream_id
        self.events: queue.Queue = queue.Queue()
        self.done = False

    def consumed(self, n: int) -> None:
        self.conn.consumed(self.id, n)

    def cancel(self, code: int = CANCEL) -> None:
        self.conn.reset(self, code)


class ClientConnection:
    """The threaded half: many streams over one socket."""

    def __init__(self, host: str, port: int, timeout: Optional[float] = None) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.core = H2Core(client=True)
        self._wlock = threading.Lock()  # owns the socket's writes, a frame run at a time
        self._cond = threading.Condition()  # guards the core and the streams
        self.streams: dict[int, ClientStream] = {}
        self._next_id = 1
        self.closed: Optional[str] = None  # why, once the connection is gone
        self.accepting = True  # False after GOAWAY: new calls open a new connection
        self._send(self.core.preamble())
        self._reader = threading.Thread(target=self._read_loop, name="h2-client-reader",
                                        daemon=True)
        self._reader.start()

    def _send(self, data: bytes) -> None:
        if data:
            with self._wlock:
                self.sock.sendall(data)

    def _flush_core(self) -> bytes:
        out = bytes(self.core.out)
        self.core.out.clear()
        return out

    def _read_loop(self) -> None:
        why = "connection closed by the server"
        try:
            while True:
                data = self.sock.recv(1 << 16)
                if not data:
                    break
                # The write lock first: a SETTINGS ACK is on the wire
                # before any DATA that the new settings' windows allow.
                with self._wlock:
                    with self._cond:
                        events = self.core.feed(data)
                        for event in events:
                            self._event(event)
                        out = self._flush_core()
                        self._cond.notify_all()
                    if out:
                        self.sock.sendall(out)
        except H2Error as exc:
            why = f"protocol error: {exc}"
            try:
                self._send(self.core.goaway_frame(0, exc.code))
            except OSError:
                pass
        except OSError as exc:
            why = f"connection lost: {exc}"
        self._shutdown(why)

    def _event(self, event: tuple) -> None:
        kind = event[0]
        if kind == "goaway":
            self.accepting = False
            for sid, stream in list(self.streams.items()):
                if sid > event[1]:
                    self._finish(stream, ("closed", "the server is going away"))
            return
        if kind == "window":
            return
        stream = self.streams.get(event[1])
        if stream is None:
            return
        if kind == "headers":
            stream.events.put(("headers", event[2]))
            if event[3]:
                self._finish(stream, ("end",))
        elif kind == "data":
            if event[2]:
                stream.events.put(("data", event[2]))
            if event[3]:
                self._finish(stream, ("end",))
        elif kind == "reset":
            self._finish(stream, ("reset", event[2]))

    def _finish(self, stream: ClientStream, last: tuple) -> None:
        stream.done = True
        self.streams.pop(stream.id, None)
        self.core.close_stream(stream.id)
        stream.events.put(last)

    def _shutdown(self, why: str) -> None:
        with self._cond:
            if self.closed is None:
                self.closed = why
            self.accepting = False
            for stream in list(self.streams.values()):
                self._finish(stream, ("closed", why))
            self._cond.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass

    def open(self, headers: list, body: bytes) -> ClientStream:
        """Send a request's HEADERS, then its body as flow-controlled DATA
        ending the stream. Raises ``ConnectionError`` once closed."""
        with self._wlock:
            with self._cond:
                if self.closed is not None or not self.accepting:
                    raise ConnectionError(self.closed or "the server is going away")
                sid = self._next_id
                self._next_id += 2
                stream = self.streams[sid] = ClientStream(self, sid)
                self.core.open_stream(sid)
                self.core.track(sid)
                run = self.core.headers(sid, headers, end_stream=False)
            self.sock.sendall(run)
        view = memoryview(body)
        while True:
            with self._cond:
                while True:
                    if stream.done or self.closed is not None:
                        return stream  # the events say why
                    n = self.core.sendable(sid, len(view))
                    if n or not len(view):
                        break
                    self._cond.wait()
                last = n == len(view)
                chunk = self.core.data(sid, bytes(view[:n]), end_stream=last)
            self._send(chunk)
            view = view[n:]
            if last:
                return stream

    def consumed(self, stream_id: int, n: int) -> None:
        with self._cond:
            self.core.consumed(stream_id, n)
            out = self._flush_core()
        try:
            self._send(out)
        except OSError:
            pass

    def reset(self, stream: ClientStream, code: int = CANCEL) -> None:
        with self._cond:
            if stream.done:
                return
            self._finish(stream, ("reset", code))
        try:
            self._send(frame(RST_STREAM, 0, stream.id, struct.pack(">I", code)))
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._send(self.core.goaway_frame(0))
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._shutdown("the channel was closed")
        self._reader.join(timeout=5)
