"""Wire-level HTTP/1.1 request/response structs and (de)serialization.

This is the layer Go's ``net/http`` provides the reference for free; here it
is implemented natively on asyncio streams: request-line/header parsing with
size limits, Content-Length and chunked bodies, keep-alive accounting.

The port's copy of ``gofr_tpu/http/proto.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

MAX_REQUEST_LINE = 8192
MAX_HEADER_COUNT = 100
MAX_HEADER_LINE = 8192
MAX_BODY_BYTES = 64 * 1024 * 1024  # matches a generous server default

STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    206: "Partial Content", 301: "Moved Permanently", 302: "Found",
    304: "Not Modified", 307: "Temporary Redirect", 308: "Permanent Redirect",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 409: "Conflict",
    411: "Length Required", 413: "Payload Too Large", 415: "Unsupported Media Type",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout", 505: "HTTP Version Not Supported",
}


class ProtocolError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


@dataclass
class RawRequest:
    method: str
    target: str  # path?query as received
    version: str  # "HTTP/1.1"
    headers: dict[str, str]  # keys lower-cased; repeated headers comma-joined
    body: bytes
    peer: Optional[tuple] = None
    # Filled by the router at match time; read by middleware/handlers.
    route_template: str = ""
    path_params: dict = field(default_factory=dict)
    # Cross-middleware request-scoped values (e.g. JWT claims, trace span) —
    # the role context.WithValue plays in the reference middleware.
    ctx_data: dict = field(default_factory=dict)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # Streaming body (SSE, chunked downloads): an async iterator of bytes.
    # When set, the server sends Transfer-Encoding: chunked and writes
    # chunks as they arrive; ``body`` is ignored.
    body_stream: Optional[Any] = None

    def set_header(self, key: str, value: str) -> None:
        self.headers[key] = value


async def read_request(reader, peer=None, first_line: Optional[bytes] = None) -> Optional[RawRequest]:
    """Parse one request off the stream. Returns None on clean EOF before a
    request line; raises ProtocolError on malformed input. ``first_line``
    lets the server read the request line itself (to detect when a request
    starts arriving) and hand the rest off here."""
    line = first_line if first_line is not None else await reader.readline()
    if not line:
        return None
    if len(line) > MAX_REQUEST_LINE:
        raise ProtocolError(414, "request line too long")
    try:
        method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ", 2)
    except ValueError:
        raise ProtocolError(400, "malformed request line") from None
    if version not in ("HTTP/1.1", "HTTP/1.0"):
        raise ProtocolError(505, "unsupported HTTP version")

    headers: dict[str, str] = {}
    for _ in range(MAX_HEADER_COUNT + 1):
        hline = await reader.readline()
        if len(hline) > MAX_HEADER_LINE:
            raise ProtocolError(431, "header line too long")
        if hline in (b"\r\n", b"\n", b""):
            break
        try:
            key, _, value = hline.decode("latin-1").partition(":")
        except UnicodeDecodeError:
            raise ProtocolError(400, "bad header encoding") from None
        key = key.strip().lower()
        value = value.strip()
        if not key or not _:
            raise ProtocolError(400, "malformed header")
        if key in headers:
            headers[key] += ", " + value
        else:
            headers[key] = value
    else:
        raise ProtocolError(431, "too many headers")

    body = b""
    if headers.get("transfer-encoding", "").lower() == "chunked":
        chunks = []
        total = 0
        while True:
            size_line = await reader.readline()
            try:
                size = int(size_line.strip().split(b";")[0], 16)
            except ValueError:
                raise ProtocolError(400, "bad chunk size") from None
            if size == 0:
                # trailing headers until blank line
                while True:
                    t = await reader.readline()
                    if t in (b"\r\n", b"\n", b""):
                        break
                break
            total += size
            if total > MAX_BODY_BYTES:
                raise ProtocolError(413, "body too large")
            chunks.append(await reader.readexactly(size))
            await reader.readexactly(2)  # CRLF
        body = b"".join(chunks)
    elif "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError:
            raise ProtocolError(400, "bad content-length") from None
        if length < 0:
            raise ProtocolError(400, "bad content-length")
        if length > MAX_BODY_BYTES:
            raise ProtocolError(413, "body too large")
        body = await reader.readexactly(length)

    return RawRequest(
        method=method, target=target, version=version, headers=headers,
        body=body, peer=peer,
    )


def serialize_response(resp: Response, *, head_only: bool = False, keep_alive: bool = True) -> bytes:
    status_text = STATUS_TEXT.get(resp.status, "Unknown")
    headers = dict(resp.headers)
    headers.setdefault("Date", time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime()))
    headers.setdefault("Server", "gofr-tpu")
    streaming = resp.body_stream is not None and not head_only
    if streaming:
        headers["Transfer-Encoding"] = "chunked"
        headers.pop("Content-Length", None)
    elif resp.status not in (204, 304):
        headers["Content-Length"] = str(len(resp.body))
    if not keep_alive:
        headers["Connection"] = "close"
    head = f"HTTP/1.1 {resp.status} {status_text}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers.items()
    ) + "\r\n"
    out = head.encode("latin-1")
    if not head_only and not streaming and resp.status not in (204, 304):
        out += resp.body
    return out


def chunk_encode(data: bytes) -> bytes:
    """One HTTP/1.1 chunked-transfer chunk."""
    return f"{len(data):x}\r\n".encode("latin-1") + data + b"\r\n"


CHUNKED_TERMINATOR = b"0\r\n\r\n"
