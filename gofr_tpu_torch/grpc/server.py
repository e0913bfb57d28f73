"""The gRPC server: the gRPC-over-HTTP/2 protocol on the port's own
HTTP/2 (``grpc/h2.py``), with logging and recovery interceptors.

The port's copy of ``gofr_tpu/grpc/server.py`` (reference parity:
``grpc.go:15-46`` starts the server only when services are registered;
``grpc/log.go:58-96`` gives each RPC a span and a structured ``RPCLog``).
The reference runs ``grpc.aio``; this module carries what the port's
services need of it:

* ``StatusCode`` with grpc's names and numbers, ``RpcMethodHandler`` and
  the ``unary_unary_rpc_method_handler`` / ``unary_stream_rpc_method_handler``
  / ``method_handlers_generic_handler`` factories that ``add_*`` functions
  call, and ``add_generic_rpc_handlers`` on the server;
* a servicer context with ``abort`` (which raises :class:`AbortError`, an
  ``Exception`` as in grpc.aio: a second abort raises :class:`UsageError`,
  and the client sees the first), ``invocation_metadata``,
  ``time_remaining``, ``set_code`` and ``set_details``;
* the protocol: length-prefixed messages, identity and gzip requests
  (another ``grpc-encoding`` is ``UNIMPLEMENTED``), ``grpc-timeout``
  (``DEADLINE_EXCEEDED`` and the handler cancelled when it expires),
  trailers carrying ``grpc-status`` and a percent-encoded
  ``grpc-message``, and a trailers-only reply for an error before the
  first message. A client's ``RST_STREAM`` or a dropped connection
  cancels the handler's task. As grpc does, a request may hold one
  message of at most ``MAX_RECEIVE_MESSAGE`` bytes after decompression:
  a body that passes it is answered ``RESOURCE_EXHAUSTED`` as soon as it
  does (the rest is not held), and gzip inflates no further than it.

``GRPCServer`` binds ``[::]:{port}`` as the reference does, dual-stack; a
host without IPv6 fails the bind with an error.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import inspect
import socket
import time
import traceback
import urllib.parse
import zlib
from typing import Callable, NamedTuple, Optional

from gofr_tpu_torch.grpc import h2
from gofr_tpu_torch.tracing import extract_traceparent, get_tracer

MAX_RECEIVE_MESSAGE = 4 * 1024 * 1024  # grpc's default receive limit
ACCEPT_ENCODING = "identity,gzip"
USER_AGENT = "grpc-python-gofr-tpu-torch"
# Headers of the protocol itself, not the caller's metadata.
_RESERVED = {"content-type", "te", "grpc-timeout", "grpc-encoding", "grpc-accept-encoding",
             "grpc-status", "grpc-message", "grpc-status-details-bin"}
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


class StatusCode(enum.Enum):
    """gRPC status codes, grpc's names and numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class AbortError(Exception):
    """Raised by ``context.abort`` (grpc.aio's ``AbortError``)."""


class UsageError(Exception):
    """An API misuse, as a second ``abort`` (grpc.aio's ``UsageError``)."""


# -- the protocol's small pieces ----------------------------------------------

def encode_grpc_message(text: str) -> str:
    """Percent-encode ``grpc-message``: bytes outside 0x20-0x7E and ``%``."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def decode_grpc_message(text: str) -> str:
    return urllib.parse.unquote(text, errors="replace")


def parse_timeout(value: str) -> Optional[float]:
    """``grpc-timeout``: up to eight digits and a unit of H M S m u n."""
    if not 2 <= len(value) <= 9 or not value[:-1].isdigit() or value[-1] not in _TIMEOUT_UNITS:
        return None
    return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]


def format_timeout(seconds: float) -> str:
    """The shortest ``grpc-timeout`` of eight digits at most."""
    seconds = max(seconds, 0.0)
    for unit, scale in (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0), ("M", 60.0)):
        n = int(-(-seconds // scale))
        if n < 100_000_000:
            return f"{n}{unit}"
    return f"{min(int(-(-seconds // 3600)), 99_999_999)}H"


def frame_message(payload: bytes) -> bytes:
    """One uncompressed length-prefixed message."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


def gunzip(payload: bytes, limit: int = MAX_RECEIVE_MESSAGE) -> bytes:
    """A gzip-compressed message, decompressed no further than ``limit``
    bytes: RESOURCE_EXHAUSTED past it, as grpc counts the limit after
    decompression."""
    inflater = zlib.decompressobj(16 + zlib.MAX_WBITS)
    try:
        out = inflater.decompress(payload, limit + 1)
    except zlib.error as exc:
        raise RpcStatus(StatusCode.INTERNAL, f"bad gzip message: {exc}") from exc
    if len(out) > limit:
        raise RpcStatus(StatusCode.RESOURCE_EXHAUSTED,
                        f"Received message larger than max (more than {limit} bytes "
                        f"decompressed vs. {limit})")
    if not inflater.eof:
        raise RpcStatus(StatusCode.INTERNAL, "truncated gzip message")
    return out


def split_messages(body: bytes, encoding: str, limit: int = MAX_RECEIVE_MESSAGE) -> list:
    """The length-prefixed messages of a body, decompressed. Raises
    :class:`RpcStatus` for a body that is not such messages."""
    out, i = [], 0
    while i < len(body):
        if len(body) - i < 5:
            raise RpcStatus(StatusCode.INTERNAL, "truncated message prefix")
        flag, n = body[i], int.from_bytes(body[i + 1:i + 5], "big")
        if n > limit:
            raise RpcStatus(StatusCode.RESOURCE_EXHAUSTED,
                            f"Received message larger than max ({n} vs. {limit})")
        if len(body) - i - 5 < n:
            raise RpcStatus(StatusCode.INTERNAL, "truncated message")
        payload = bytes(body[i + 5:i + 5 + n])
        i += 5 + n
        if flag == 1:
            if encoding != "gzip":
                raise RpcStatus(StatusCode.INTERNAL,
                                f"compressed message without a known grpc-encoding ({encoding!r})")
            payload = gunzip(payload, limit)
        elif flag != 0:
            raise RpcStatus(StatusCode.INTERNAL, f"message flag {flag}")
        out.append(payload)
    return out


def metadata_pairs(headers: list) -> tuple:
    """The caller's metadata from request headers: no pseudo headers, no
    protocol headers, ``-bin`` values base64-decoded."""
    out = []
    for key, value in headers:
        if key.startswith(":") or key in _RESERVED:
            continue
        if key.endswith("-bin"):
            value = base64.b64decode(value + "=" * (-len(value) % 4))
        out.append((key, value))
    return tuple(out)


def metadata_headers(metadata) -> list:
    out = []
    for key, value in metadata or ():
        key = str(key).lower()
        if key.endswith("-bin"):
            raw = value if isinstance(value, bytes) else str(value).encode()
            value = base64.b64encode(raw).decode().rstrip("=")
        out.append((key, str(value)))
    return out


class RpcStatus(Exception):
    """A status to end an RPC with, raised inside the server."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(details)
        self.code, self.details = code, details


# -- handlers (grpc's factory functions) ---------------------------------------

class RpcMethodHandler(NamedTuple):
    """A method's behavior and codecs (the two kinds the services use:
    unary request, unary or streamed reply)."""

    request_deserializer: Optional[Callable]
    response_serializer: Optional[Callable]
    unary_unary: Optional[Callable]
    unary_stream: Optional[Callable]


class HandlerCallDetails(NamedTuple):
    method: str
    invocation_metadata: tuple


def unary_unary_rpc_method_handler(behavior, request_deserializer=None,
                                   response_serializer=None) -> RpcMethodHandler:
    return RpcMethodHandler(request_deserializer, response_serializer, behavior, None)


def unary_stream_rpc_method_handler(behavior, request_deserializer=None,
                                    response_serializer=None) -> RpcMethodHandler:
    return RpcMethodHandler(request_deserializer, response_serializer, None, behavior)


class GenericRpcHandler:
    def __init__(self, service: str, handlers: dict) -> None:
        self._service = service
        self._handlers = dict(handlers)

    def service(self, details: HandlerCallDetails) -> Optional[RpcMethodHandler]:
        service, _, method = details.method.lstrip("/").partition("/")
        return self._handlers.get(method) if service == self._service else None


def method_handlers_generic_handler(service: str, handlers: dict) -> GenericRpcHandler:
    return GenericRpcHandler(service, handlers)


# -- the framework's pieces (reference grpc/server.py) --------------------------

def grpc_status_code(exc: BaseException) -> StatusCode:
    """Framework error → gRPC status, honoring the resilience statuses:
    shed (429) → RESOURCE_EXHAUSTED, deadline (504) → DEADLINE_EXCEEDED,
    cancelled (499) → CANCELLED, draining (503) and replica-pool
    exhaustion (502) → UNAVAILABLE; the rest keep the 4xx→INVALID_ARGUMENT
    / 5xx→INTERNAL split."""
    status = getattr(exc, "status_code", 500)
    if status == 429:
        return StatusCode.RESOURCE_EXHAUSTED
    if status == 499:
        return StatusCode.CANCELLED
    if status in (502, 503):
        return StatusCode.UNAVAILABLE
    if status == 504:
        return StatusCode.DEADLINE_EXCEEDED
    if status < 500:
        return StatusCode.INVALID_ARGUMENT
    return StatusCode.INTERNAL


def _metadata_value(context, name: str) -> str:
    meta = getattr(context, "invocation_metadata", None)
    if not callable(meta):
        return ""
    try:
        for key, value in meta() or ():
            if str(key).lower() == name:
                return str(value)
    except Exception:  # absent or stub metadata APIs mean "not given", not an error
        return ""
    return ""


def tenant_from_context(context) -> str:
    """The ``x-tenant-id`` invocation-metadata value ("" when absent)."""
    return _metadata_value(context, "x-tenant-id")


def slo_class_from_context(context) -> str:
    """The ``x-slo-class`` invocation-metadata value ("" when absent)."""
    return _metadata_value(context, "x-slo-class")


def deadline_from_context(context) -> Optional[float]:
    """Seconds remaining on the caller's gRPC deadline, or None."""
    tr = getattr(context, "time_remaining", None)
    if not callable(tr):
        return None
    try:
        remaining = tr()
    except Exception:  # absent or stub deadline APIs mean "no deadline", not an error
        return None
    if remaining is None or remaining <= 0:
        return None
    return float(remaining)


class RPCLog:
    """Structured RPC log (reference ``grpc/log.go:22-28``)."""

    def __init__(self, method: str, status: str, duration_us: int, trace_id: str) -> None:
        self.rpc = method
        self.status = status
        self.duration = duration_us
        self.trace_id = trace_id

    def to_log_dict(self) -> dict:
        return {
            "rpc": self.rpc,
            "status": self.status,
            "duration": self.duration,
            "trace_id": self.trace_id,
        }

    def pretty_print(self, fp) -> None:
        fp.write(
            f"\x1b[38;5;8mRPC\x1b[0m {self.duration:>8}µs {self.status:>2} {self.rpc}\n"
        )


class _LoggingInterceptor:
    """Span + RPCLog per call, panic recovery → INTERNAL
    (reference ``grpc/log.go:58-96`` + grpc_recovery). As in the
    reference, an abort inside the handler is an ``Exception`` too: it is
    logged as a panic, the log's status reads INTERNAL, and the client
    still gets the first abort's status."""

    def __init__(self, logger) -> None:
        self._logger = logger

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        logger = self._logger
        # W3C trace adoption from the caller's metadata: its traceparent
        # makes this RPC's span a child in the caller's trace.
        trace_id = parent_id = None
        try:
            md = {
                str(k).lower(): str(v)
                for k, v in (handler_call_details.invocation_metadata or ())
            }
            trace_id, parent_id = extract_traceparent(md)
        except Exception:  # absent or stub metadata means "no caller trace context"
            pass

        def wrap_unary(behavior):
            async def wrapped(request, context):
                span = get_tracer().start_span(
                    f"gRPC {method}",
                    trace_id=trace_id, parent_span_id=parent_id,
                )
                start = time.time()
                status = "OK"
                try:
                    return await behavior(request, context)
                except Exception:
                    status = "INTERNAL"
                    logger.errorf(
                        "rpc %s panicked:\n%s", method, traceback.format_exc()
                    )
                    await context.abort(StatusCode.INTERNAL, "internal error")
                finally:
                    span.end()
                    logger.info(
                        RPCLog(method, status, int((time.time() - start) * 1e6), span.trace_id)
                    )

            return wrapped

        def wrap_stream(behavior):
            async def wrapped(request, context):
                span = get_tracer().start_span(
                    f"gRPC {method}",
                    trace_id=trace_id, parent_span_id=parent_id,
                )
                start = time.time()
                status = "OK"
                try:
                    async for item in behavior(request, context):
                        yield item
                except Exception:
                    status = "INTERNAL"
                    logger.errorf(
                        "rpc %s panicked:\n%s", method, traceback.format_exc()
                    )
                    await context.abort(StatusCode.INTERNAL, "internal error")
                finally:
                    span.end()
                    logger.info(
                        RPCLog(method, status, int((time.time() - start) * 1e6), span.trace_id)
                    )

            return wrapped

        if handler.unary_unary is not None:
            return unary_unary_rpc_method_handler(
                wrap_unary(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        if handler.unary_stream is not None:
            return unary_stream_rpc_method_handler(
                wrap_stream(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer,
            )
        return handler


def json_method_handlers(service_name: str, unary: dict, streams: dict | None = None):
    """Build a generic handler for a service whose messages are JSON bytes."""
    import json

    def ser(obj) -> bytes:
        return json.dumps(obj, default=str).encode()

    def des(data: bytes):
        return json.loads(data or b"{}")

    handlers = {}
    for name, fn in unary.items():
        handlers[name] = unary_unary_rpc_method_handler(
            fn, request_deserializer=des, response_serializer=ser
        )
    for name, fn in (streams or {}).items():
        handlers[name] = unary_stream_rpc_method_handler(
            fn, request_deserializer=des, response_serializer=ser
        )
    return method_handlers_generic_handler(service_name, handlers)


# -- one RPC on the server -------------------------------------------------------

class ServicerContext:
    """What a handler gets beside its request (grpc.aio's
    ``ServicerContext``, the parts the port's services use)."""

    def __init__(self, headers: list, deadline: Optional[float]) -> None:
        self._metadata = metadata_pairs(headers)
        self._deadline = deadline  # time.monotonic() seconds, or None
        self.code: Optional[StatusCode] = None
        self.details = ""
        self._aborted: Optional[tuple] = None

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(self._deadline - time.monotonic(), 0.0)

    def set_code(self, code: StatusCode) -> None:
        self.code = code

    def set_details(self, details: str) -> None:
        self.details = details

    async def abort(self, code: StatusCode, details: str = "", trailing_metadata=()) -> None:
        if self._aborted is not None:
            raise UsageError("Abort was already called!")
        if code == StatusCode.OK:
            code = StatusCode.UNKNOWN
        self._aborted = (code, details)
        raise AbortError("Locally aborted.")


class GRPCServer:
    def __init__(self, port: int, logger, container=None) -> None:
        self.port = port
        self._logger = logger
        self.container = container
        self._registrations: list = []
        self._generic: list = []
        self._interceptors = [_LoggingInterceptor(logger)]
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[h2.ServerConnection] = set()
        self._conn_tasks: set[asyncio.Task] = set()

    def register(self, add_fn, servicer) -> None:
        """add_fn(server, servicer, container) or codegen add_*_to_server."""
        self._registrations.append((add_fn, servicer))

    def add_generic_rpc_handlers(self, handlers) -> None:
        self._generic.extend(handlers)

    async def start(self) -> None:
        for add_fn, servicer in self._registrations:
            # Two calling conventions: this framework's
            # add_fn(server, servicer, container) vs protoc codegen's
            # add_*_to_server(servicer, server). Decide by arity, not by
            # catching TypeError (which would swallow real bugs in add_fn).
            try:
                n_params = len(inspect.signature(add_fn).parameters)
            except (TypeError, ValueError):
                n_params = 3
            if n_params >= 3:
                add_fn(self, servicer, self.container)
            else:
                add_fn(servicer, self)
        # [::]:{port}, dual-stack, as grpc binds it; no IPv4 fallback.
        sock = socket.socket(socket.AF_INET6, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
            sock.bind(("::", self.port))
            sock.listen(128)
            sock.setblocking(False)
        except OSError:
            sock.close()
            raise
        self._server = await asyncio.start_server(self._connection, sock=sock)
        self.port = sock.getsockname()[1]
        self._logger.infof("gRPC server started on :%d", self.port)

    async def stop(self, grace: float = 5.0) -> None:
        if self._server is None:
            return
        self._server.close()
        for conn in list(self._conns):
            await conn.goaway()
        rpcs = [t for conn in self._conns for t in conn.tasks]
        if rpcs and grace:
            await asyncio.wait(rpcs, timeout=grace)
        for conn in list(self._conns):
            for task in list(conn.tasks):
                task.cancel()
            conn.abort()
        if self._conn_tasks:
            await asyncio.wait(list(self._conn_tasks), timeout=5)
        self._server = None

    # -- connections and RPCs ---------------------------------------------------

    async def _connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = h2.ServerConnection(reader, writer, self._rpc, max_body=MAX_RECEIVE_MESSAGE + 5)
        self._conns.add(conn)
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            await conn.serve()
        finally:
            self._conns.discard(conn)
            self._conn_tasks.discard(task)
            for rpc in list(conn.tasks):
                rpc.cancel()

    async def _lookup(self, details: HandlerCallDetails) -> Optional[RpcMethodHandler]:
        async def resolve(d: HandlerCallDetails):
            for generic in self._generic:
                handler = generic.service(d)
                if handler is not None:
                    return handler
            return None

        continuation = resolve
        for interceptor in reversed(self._interceptors):
            continuation = (lambda i, c: lambda d: i.intercept_service(c, d))(interceptor, continuation)
        return await continuation(details)

    async def _rpc(self, conn: h2.ServerConnection, stream: h2.ServerStream) -> None:
        """One RPC: its task runs the handler in a child task, so a reset
        or an expired deadline cancels the handler and the reply still
        gets its status."""
        headers = stream.headers
        hdr = {}
        for key, value in headers:
            hdr.setdefault(key, value)
        sent = {"headers": False}

        async def reply_headers() -> None:
            if not sent["headers"]:
                sent["headers"] = True
                await conn.send_headers(stream, [
                    (":status", "200"), ("content-type", "application/grpc"),
                    ("grpc-accept-encoding", ACCEPT_ENCODING)])

        async def finish(code: StatusCode, details: str = "") -> None:
            trailers = [("grpc-status", str(code.value))]
            if details:
                trailers.append(("grpc-message", encode_grpc_message(details)))
            if not sent["headers"]:  # trailers-only
                trailers = [(":status", "200"), ("content-type", "application/grpc")] + trailers
                sent["headers"] = True
            await conn.send_headers(stream, trailers, end_stream=True)

        try:
            if hdr.get(":method") != "POST" or not hdr.get("content-type", "").startswith(
                    "application/grpc"):
                raise RpcStatus(StatusCode.UNIMPLEMENTED, "not a gRPC request")
            encoding = hdr.get("grpc-encoding", "identity")
            if encoding not in ("identity", "gzip"):
                raise RpcStatus(StatusCode.UNIMPLEMENTED,
                                f"grpc-encoding {encoding!r} is not supported")
            if stream.overflow:
                n = int.from_bytes(stream.body[1:5], "big") if len(stream.body) == 5 else 0
                raise RpcStatus(StatusCode.RESOURCE_EXHAUSTED,
                                f"Received message larger than max ({n} vs. {MAX_RECEIVE_MESSAGE})"
                                if n > MAX_RECEIVE_MESSAGE else
                                f"Received a body larger than one message of at most "
                                f"{MAX_RECEIVE_MESSAGE} bytes")
            timeout = parse_timeout(hdr["grpc-timeout"]) if "grpc-timeout" in hdr else None
            deadline = None if timeout is None else time.monotonic() + timeout
            method = hdr.get(":path", "")
            context = ServicerContext(headers, deadline)
            handler = await self._lookup(HandlerCallDetails(method, context.invocation_metadata()))
            if handler is None or (handler.unary_unary is None and handler.unary_stream is None):
                raise RpcStatus(StatusCode.UNIMPLEMENTED, "Method not found!")
            messages = split_messages(stream.body, encoding)
            if len(messages) != 1:
                raise RpcStatus(StatusCode.INTERNAL,
                                f"expected one request message, got {len(messages)}")
            try:
                des = handler.request_deserializer
                request = des(messages[0]) if des is not None else messages[0]
            except Exception as exc:  # noqa: BLE001 — a bad request, not a server fault
                raise RpcStatus(StatusCode.INTERNAL, "Exception deserializing request!") from exc
            ser = handler.response_serializer or (lambda m: m)
            code, details = await self._run(conn, stream, handler, request, context, ser,
                                             reply_headers, deadline)
            if code is not None:
                await finish(code, details)
        except RpcStatus as status:
            try:
                await finish(status.code, status.details)
            except h2.StreamReset:
                pass
        except h2.StreamReset:
            pass
        except Exception:  # the RPC's boundary: a fault here ends this RPC only
            self._logger.errorf("rpc %s failed in the server:\n%s", hdr.get(":path", ""),
                                traceback.format_exc())
            try:
                await finish(StatusCode.INTERNAL, "internal error")
            except Exception:  # noqa: BLE001 — the stream may be half written or gone
                conn.reset(stream, h2.CANCEL)

    async def _run(self, conn, stream, handler, request, context, ser, reply_headers,
                   deadline) -> tuple:
        """Run the handler to its end, a reset, or the deadline. Returns the
        status to send, or (None, "") when the stream is already gone."""

        async def body() -> None:
            if handler.unary_unary is not None:
                payload = ser(await handler.unary_unary(request, context))
                await reply_headers()
                await conn.send_data(stream, frame_message(payload))
                return
            async for item in handler.unary_stream(request, context):
                await reply_headers()
                await conn.send_data(stream, frame_message(ser(item)))

        task = asyncio.get_running_loop().create_task(body())
        why = {"reset": None}

        def on_reset(code: int) -> None:
            why["reset"] = code
            task.cancel()

        stream.on_reset = on_reset
        if stream.closed:
            task.cancel()
        timer = None
        if deadline is not None:
            timer = asyncio.get_running_loop().call_later(
                max(deadline - time.monotonic(), 0.0), task.cancel)
        try:
            await task
        except asyncio.CancelledError:
            if why["reset"] is not None or stream.closed:
                return None, ""
            if asyncio.current_task().cancelling():
                raise  # the server is stopping
            return StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded"
        except h2.StreamReset:
            return None, ""
        except AbortError:
            pass
        except Exception as exc:  # noqa: BLE001 — a handler's error ends the RPC
            if context._aborted is None:
                return StatusCode.UNKNOWN, f"Unexpected {type(exc)}: {exc}"
        finally:
            if timer is not None:
                timer.cancel()
            stream.on_reset = None
        if context._aborted is not None:
            return context._aborted
        return context.code or StatusCode.OK, context.details
