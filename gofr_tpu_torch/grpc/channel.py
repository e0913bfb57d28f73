"""A synchronous gRPC client channel on the port's HTTP/2 (the port's
stand-in for ``grpc.insecure_channel``).

``insecure_channel("host:port")`` gives a :class:`Channel` whose
``unary_unary`` and ``unary_stream`` build callables as grpc's do: a call
takes ``timeout=`` (sent as ``grpc-timeout`` and enforced here too:
``DEADLINE_EXCEEDED`` and a ``RST_STREAM(CANCEL)`` when it passes) and
``metadata=``; a stream call iterates its replies and has ``.cancel()``.
A failed call raises :class:`RpcError`, with ``code()`` and ``details()``.
All calls multiplex over one connection, opened at the first call and
again after the server goes away.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

from gofr_tpu_torch.grpc import h2
from gofr_tpu_torch.grpc.server import (
    ACCEPT_ENCODING,
    MAX_RECEIVE_MESSAGE,
    USER_AGENT,
    StatusCode,
    decode_grpc_message,
    RpcStatus,
    format_timeout,
    frame_message,
    gunzip,
    metadata_headers,
)

_HTTP_TO_STATUS = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                   403: StatusCode.PERMISSION_DENIED, 404: StatusCode.UNIMPLEMENTED,
                   429: StatusCode.UNAVAILABLE, 502: StatusCode.UNAVAILABLE,
                   503: StatusCode.UNAVAILABLE, 504: StatusCode.UNAVAILABLE}
CONNECT_TIMEOUT_S = 20.0
_RESET_TO_STATUS = {h2.CANCEL: StatusCode.CANCELLED, h2.REFUSED_STREAM: StatusCode.UNAVAILABLE}


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code, self._details = code, details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Call:
    """One RPC's reply side: reads messages off its stream and ends in a
    status."""

    def __init__(self, stream: h2.ClientStream, deserializer: Optional[Callable],
                 deadline: Optional[float]) -> None:
        self._stream = stream
        self._des = deserializer
        self._deadline = deadline
        self._buf = bytearray()
        self._encoding = "identity"
        self._headers_seen = False
        self._status: Optional[RpcError] = None  # set once the call ended

    def _end(self, code: StatusCode, details: str = "") -> RpcError:
        if self._status is None:
            self._status = RpcError(code, details)
        return self._status

    def _headers(self, headers: list) -> None:
        hdr = dict(headers)
        if not self._headers_seen and ":status" in hdr:
            self._headers_seen = True
            status = int(hdr[":status"])
            if status != 200:
                raise self._end(_HTTP_TO_STATUS.get(status, StatusCode.UNKNOWN),
                                f"Received http2 header with status: {status}")
            self._encoding = hdr.get("grpc-encoding", "identity")
            if "grpc-status" not in hdr:
                return
        if "grpc-status" not in hdr:
            raise self._end(StatusCode.UNKNOWN, "trailers without grpc-status")
        code = StatusCode(int(hdr["grpc-status"]))
        raise self._end(code, decode_grpc_message(hdr.get("grpc-message", "")))

    def _next_message(self) -> bytes:
        """The next whole message, or raise the call's status (``RpcError``
        with code OK at a clean end)."""
        while True:
            if len(self._buf) >= 5:
                n = int.from_bytes(self._buf[1:5], "big")
                if n > MAX_RECEIVE_MESSAGE:
                    self._stream.cancel()
                    raise self._end(StatusCode.RESOURCE_EXHAUSTED,
                                    f"Received message larger than max ({n} vs. "
                                    f"{MAX_RECEIVE_MESSAGE})")
                if len(self._buf) >= 5 + n:
                    flag = self._buf[0]
                    payload = bytes(self._buf[5:5 + n])
                    del self._buf[:5 + n]
                    self._stream.consumed(5 + n)
                    if flag == 1:
                        if self._encoding != "gzip":
                            raise self._end(StatusCode.INTERNAL, "compressed reply without gzip")
                        try:
                            payload = gunzip(payload)
                        except RpcStatus as status:
                            self._stream.cancel()
                            raise self._end(status.code, status.details) from None
                    return payload
            if self._status is not None:
                raise self._status
            event = self._wait()
            kind = event[0]
            try:
                if kind == "headers":
                    self._headers(event[1])
                elif kind == "data":
                    self._buf += event[1]
                elif kind == "end":
                    raise self._end(StatusCode.INTERNAL, "stream ended without trailers")
                elif kind == "reset":
                    raise self._end(_RESET_TO_STATUS.get(event[1], StatusCode.INTERNAL),
                                    f"Received RST_STREAM with error code {event[1]}")
                else:
                    raise self._end(StatusCode.UNAVAILABLE, event[1])
            except RpcError:
                if self._buf:  # messages that came before the status go first
                    continue
                raise

    def _wait(self) -> tuple:
        if self._deadline is None:
            return self._stream.events.get()
        remaining = self._deadline - time.monotonic()
        try:
            if remaining <= 0:
                raise queue.Empty
            return self._stream.events.get(timeout=remaining)
        except queue.Empty:
            self._stream.cancel()
            raise self._end(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None

    def _message(self) -> Any:
        payload = self._next_message()
        return self._des(payload) if self._des is not None else payload

    def _finish(self) -> None:
        """Read to the call's status; raise it unless OK."""
        try:
            extra = self._next_message()
        except RpcError as status:
            if status.code() != StatusCode.OK:
                raise
            return
        self._stream.cancel()
        raise self._end(StatusCode.INTERNAL, f"unexpected second reply ({len(extra)} bytes)")

    def code(self) -> Optional[StatusCode]:
        return None if self._status is None else self._status.code()

    def details(self) -> Optional[str]:
        return None if self._status is None else self._status.details()


class StreamCall(_Call):
    """A server-streaming call: iterate it for the replies."""

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        try:
            return self._message()
        except RpcError as status:
            if status.code() == StatusCode.OK:
                raise StopIteration from None
            raise

    def cancel(self) -> bool:
        if self._status is not None:
            return False
        self._end(StatusCode.CANCELLED, "Locally cancelled by application!")
        self._stream.cancel()
        return True


class Channel:
    def __init__(self, target: str) -> None:
        host, _, port = target.rpartition(":")
        self._host = host.strip("[]") or "127.0.0.1"
        self._port = int(port)
        self._authority = target
        self._lock = threading.Lock()
        self._conn: Optional[h2.ClientConnection] = None
        self._closed = False

    def _connection(self) -> h2.ClientConnection:
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "Channel closed!")
            conn = self._conn
            if conn is None or conn.closed is not None or not conn.accepting:
                try:
                    conn = self._conn = h2.ClientConnection(self._host, self._port,
                                                            CONNECT_TIMEOUT_S)
                except OSError as exc:
                    raise RpcError(StatusCode.UNAVAILABLE, f"failed to connect: {exc}") from exc
            return conn

    def _start(self, method: str, request: bytes, timeout: Optional[float],
               metadata) -> tuple:
        headers = [(":method", "POST"), (":scheme", "http"), (":path", method),
                   (":authority", self._authority), ("content-type", "application/grpc"),
                   ("te", "trailers"), ("grpc-accept-encoding", ACCEPT_ENCODING),
                   ("user-agent", USER_AGENT)]
        deadline = None
        if timeout is not None:
            deadline = time.monotonic() + timeout
            headers.append(("grpc-timeout", format_timeout(timeout)))
        headers += metadata_headers(metadata)
        for attempt in range(2):
            conn = self._connection()
            try:
                return conn.open(headers, frame_message(request)), deadline
            except ConnectionError as exc:
                if attempt:
                    raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
            except OSError as exc:
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
        raise AssertionError("unreachable")

    def unary_unary(self, method: str, request_serializer: Optional[Callable] = None,
                    response_deserializer: Optional[Callable] = None) -> Callable:
        def call(request, timeout: Optional[float] = None, metadata=None) -> Any:
            payload = request_serializer(request) if request_serializer else request
            stream, deadline = self._start(method, payload, timeout, metadata)
            c = _Call(stream, response_deserializer, deadline)
            try:
                reply = c._message()
            except RpcError as status:
                if status.code() == StatusCode.OK:
                    raise RpcError(StatusCode.INTERNAL, "no reply message") from None
                raise
            c._finish()
            return reply

        return call

    def unary_stream(self, method: str, request_serializer: Optional[Callable] = None,
                     response_deserializer: Optional[Callable] = None) -> Callable:
        def call(request, timeout: Optional[float] = None, metadata=None) -> StreamCall:
            payload = request_serializer(request) if request_serializer else request
            stream, deadline = self._start(method, payload, timeout, metadata)
            return StreamCall(stream, response_deserializer, deadline)

        return call

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


def insecure_channel(target: str) -> Channel:
    return Channel(target)
